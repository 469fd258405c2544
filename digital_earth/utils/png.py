"""Minimal 8-bit PNG encoder and decoder (standard library + numpy only).

The viewer's ``/frame.png``, its screenshots and ``render_offline`` write
8-bit grey, RGB or RGBA images; ``zlib`` and ``struct`` are all that takes,
so the main path needs no imaging library. ``decode_png`` reads back what
``encode_png`` writes (filter type 0 on every row), for tests and checks.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """(H, W), (H, W, 3) or (H, W, 4) uint8 -> PNG bytes. ``level`` is the
    zlib level: 1 keeps a 1080p encode in the tens of milliseconds, and the
    viewer's localhost bandwidth is free."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png needs (H, W[, 1|3|4]), got {img.shape}")
    h, w, c = img.shape
    raw = np.zeros((h, 1 + w * c), dtype=np.uint8)  # column 0: filter type 0
    raw[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (
        _SIGNATURE
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, level))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes as ``encode_png`` writes them -> (H, W, C) uint8."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, color_type, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPE.items()}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"unsupported PNG header {header}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw.reshape(h, 1 + w * channels)
    if raw[:, 0].any():
        raise ValueError("only filter type 0 rows are supported")
    return raw[:, 1:].reshape(h, w, channels)
