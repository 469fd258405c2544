"""The standard-library PNG encoder the viewer and offline renders use."""

import struct
import zlib

import numpy as np
import pytest

from digital_earth.utils.png import decode_png, encode_png, write_png


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        out.append((tag, body))
        pos += 12 + n
    return out


@pytest.mark.parametrize("channels,color_type", [(3, 2), (4, 6), (None, 0)])
def test_header_and_pixels_decode_with_zlib(channels, color_type):
    rng = np.random.default_rng(1)
    shape = (7, 11) if channels is None else (7, 11, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks = _chunks(data)
    assert [t for t, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1]
    )
    assert (w, h, depth, ctype, comp, filt, interlace) == (
        11, 7, 8, color_type, 0, 0, 0
    )
    c = 1 if channels is None else channels
    raw = np.frombuffer(zlib.decompress(chunks[1][1]), np.uint8)
    raw = raw.reshape(7, 1 + 11 * c)
    assert (raw[:, 0] == 0).all()  # filter type 0 on every row
    np.testing.assert_array_equal(raw[:, 1:].reshape(7, 11, c),
                                  img.reshape(7, 11, c))


def test_round_trip_and_write(tmp_path):
    img = np.arange(5 * 4 * 3, dtype=np.uint8).reshape(5, 4, 3)
    np.testing.assert_array_equal(decode_png(encode_png(img, level=9)), img)
    path = tmp_path / "f.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), img)


@pytest.mark.parametrize("bad", [
    np.zeros((4, 4, 3), np.float32), np.zeros((4, 4, 2), np.uint8),
    np.zeros((4,), np.uint8),
])
def test_rejects_what_it_cannot_encode(bad):
    with pytest.raises(ValueError):
        encode_png(bad)
