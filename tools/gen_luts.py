#!/usr/bin/env python
"""Generate the spectral LUT assets under digital_earth/assets/data/.

Run offline (results are committed); mirrors the role of the reference's
LUT/*_generator.py tools but everything here is generated from public data /
analytic fits by this script:

- cie_lut.npz     : CIE 1931 2-deg CMFs from the Wyman-Sloan-Shirley (2013)
                    multi-lobe Gaussian analytic fit, sampled per nm on
                    [390, 831); plus the trapezoid-integrated, per-channel
                    normalized cumulative row used for hero-wavelength
                    inverse-CDF sampling. Layout matches the semantics of the
                    reference LUT/CIE.dat (row v=0.25 CDF / v=0.75 response,
                    see reference renderer.py:97-107, lib/colour.py:12-48).
                    NOTE: the reference ships a different observer (its peaks
                    match the CIE 2006/2012 2-deg curves); we use the
                    analytic 1931 fit — a documented, public-domain choice.
- srgb2spec.npz   : 300x3 (400-700 nm) linear sRGB->spectrum basis, fit here
                    by projected-gradient least squares (round-trip through
                    the CMFs ~ identity, rows ~ partition of unity, smooth,
                    non-negative). Same role/format as reference
                    LUT/srgb2spec.dat (lib/colour.py:62-71).
- ozone_lut.npz   : 441 per-nm bins (390-830 nm) of the Serdyuchenko et al.
                    2014 measured O3 cross sections, averaged per integer nm
                    like the reference LUT/ozone_cross_section_generator.py.
                    Source dataset: the published high-resolution text file
                    (public scientific data); path passed via --serdyuchenko.
- crf_pack.npz    : stack of Columbia DoRF camera response functions
                    (1024, n_films, 3) + names, Neutral first — same content
                    the reference loads from LUT/camera_response_functions/
                    (renderer.py:147-167). Source: public DoRF database files
                    passed via --crf-dir.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "digital_earth",
    "assets",
    "data",
)

WAVELENGTHS = np.arange(390.0, 831.0)  # 441 per-nm samples


# ---------------------------------------------------------------------------
# CIE 1931 2-deg CMFs — Wyman, Sloan, Shirley, "Simple Analytic Approximations
# to the CIE XYZ Color Matching Functions", JCGT 2(2), 2013. Public formulas.
# ---------------------------------------------------------------------------


def _piecewise_gauss(x, alpha, mu, sigma1, sigma2):
    sigma = np.where(x < mu, sigma1, sigma2)
    return alpha * np.exp(-0.5 * ((x - mu) / sigma) ** 2)


def cie_xyz_fit(wl):
    x = (
        _piecewise_gauss(wl, 1.056, 599.8, 37.9, 31.0)
        + _piecewise_gauss(wl, 0.362, 442.0, 16.0, 26.7)
        + _piecewise_gauss(wl, -0.065, 501.1, 20.4, 26.2)
    )
    y = _piecewise_gauss(wl, 0.821, 568.8, 46.9, 40.5) + _piecewise_gauss(
        wl, 0.286, 530.9, 16.3, 31.1
    )
    z = _piecewise_gauss(wl, 1.217, 437.0, 11.8, 36.0) + _piecewise_gauss(
        wl, 0.681, 459.0, 26.0, 13.8
    )
    return np.stack([x, y, z], axis=-1)


def gen_cie_lut():
    resp = cie_xyz_fit(WAVELENGTHS).astype(np.float64)
    # Normalize x/z to the same integral as y (the CIE curves are designed
    # with equal integrals; the analytic fit is off by <1%) so the per-channel
    # CDFs share one domain and pdf = sum of channels, as the reference's
    # table does (its CDF row ends at exactly (1,1,1)).
    sums = np.trapezoid(resp, axis=0)
    resp = resp * (sums[1] / sums)
    # Exclusive trapezoid cumulative, matching the reference's CDF row
    # (cdf[0] = 0, cdf[i] = trapz(resp[:i+1]) / trapz(resp)).
    seg = 0.5 * (resp[:-1] + resp[1:])
    cdf = np.concatenate([np.zeros((1, 3)), np.cumsum(seg, axis=0)], axis=0)
    cdf = cdf / cdf[-1]
    out = os.path.join(DATA_DIR, "cie_lut.npz")
    np.savez_compressed(
        out,
        response=resp.astype(np.float32),
        cdf=cdf.astype(np.float32),
        wavelengths=WAVELENGTHS.astype(np.float32),
    )
    print(f"wrote {out}: response {resp.shape}, cdf ends at {cdf[-1]}")


# ---------------------------------------------------------------------------
# sRGB -> spectrum basis fit
# ---------------------------------------------------------------------------


def gen_srgb2spec():
    wl = np.arange(400.0, 700.0)  # 300 bins, matching the reference LUT span
    n = wl.size
    cmf = cie_xyz_fit(wl)  # (300, 3)
    xyz_to_rgb = np.array(
        [
            [3.2409699419, -1.5373831776, -0.4986107603],
            [-0.9692436363, 1.8759675015, 0.0415550574],
            [0.0556300797, -0.2039769589, 1.0569715142],
        ]
    )
    # rgb(s) = M @ (cmf^T s) / norm ; norm chosen so a flat unit spectrum maps
    # to luminance 1 (equal-energy illuminant convention)
    a = xyz_to_rgb @ cmf.T / cmf[:, 1].sum()  # (3, 300)

    # Quadratic objective in the basis matrix B (300x3):
    #   w_rt  ||A B - I||^2      round-trip through the observer ~ identity
    #   w_sum ||B 1 - 1||^2      rows are a partition of unity (white -> flat)
    #   w_sm  ||D2 B||^2         second-difference smoothness
    # Solved exactly for vec(B) (column stacking), then clipped to >= 0 and
    # re-solved once with the active set pinned.
    d2 = np.zeros((n - 2, n))
    for i in range(n - 2):
        d2[i, i : i + 3] = (1.0, -2.0, 1.0)
    w_rt, w_sum, w_sm = 1000.0, 20000.0, 1.0

    per_col = w_rt * (a.T @ a) + w_sm * (d2.T @ d2)
    h = np.kron(np.eye(3), per_col) + w_sum * np.kron(np.ones((3, 3)), np.eye(n))
    rhs = np.concatenate(
        [w_rt * a.T @ np.eye(3)[:, j] + w_sum * np.ones(n) for j in range(3)]
    )

    b = np.linalg.solve(h, rhs).reshape(3, n).T  # (300, 3)
    for _ in range(3):  # simple active-set projection passes
        neg = b < 0.0
        if not neg.any():
            break
        mask = neg.T.reshape(-1)
        h_c = h.copy()
        h_c[mask, :] = 0.0
        h_c[:, mask] = 0.0
        h_c[mask, mask] = 1.0
        rhs_c = rhs.copy()
        rhs_c[mask] = 0.0
        b = np.linalg.solve(h_c, rhs_c).reshape(3, n).T
    b = np.clip(b, 0.0, None)
    rt = a @ b - np.eye(3)
    print(
        f"srgb2spec fit: roundtrip rmse {np.sqrt((rt**2).mean()):.4f}, "
        f"white flatness {np.abs(b.sum(axis=1)-1).max():.4f}"
    )
    out = os.path.join(DATA_DIR, "srgb2spec.npz")
    np.savez_compressed(out, basis=b.astype(np.float32), wavelengths=wl.astype(np.float32))
    print(f"wrote {out}")


# ---------------------------------------------------------------------------
# Ozone cross-section binning
# ---------------------------------------------------------------------------


def gen_ozone_lut(serdyuchenko_path):
    data = np.loadtxt(serdyuchenko_path)
    wl = data[:, 0]
    xs = data[:, 1]
    bins = np.floor(wl).astype(int) - 390
    lut = np.zeros(441, dtype=np.float64)
    counts = np.zeros(441, dtype=np.int64)
    valid = (bins >= 0) & (bins < 441)
    np.add.at(lut, bins[valid], xs[valid])
    np.add.at(counts, bins[valid], 1)
    lut = lut / np.maximum(counts, 1)
    out = os.path.join(DATA_DIR, "ozone_lut.npz")
    np.savez_compressed(out, cross_section=lut.astype(np.float32))
    print(
        f"wrote {out}: peak {lut.max():.3e} cm^2 at {390 + lut.argmax()} nm "
        f"({counts.min()}..{counts.max()} samples/bin)"
    )


# ---------------------------------------------------------------------------
# Camera response functions (Columbia DoRF, via the public .rf files)
# ---------------------------------------------------------------------------


def gen_crf_pack(crf_dir):
    names = []
    stacks = []
    filenames = sorted(os.listdir(crf_dir))
    if "Neutral.rf" in filenames:
        filenames.insert(0, filenames.pop(filenames.index("Neutral.rf")))
    for fn in filenames:
        if not (fn.endswith(".rf") or fn.endswith(".txt")) or "README" in fn:
            continue
        rows = []
        with open(os.path.join(crf_dir, fn)) as f:
            for line in f:
                vals = [float(v) for v in line.split()]
                if vals:
                    rows.append(vals[1:4])  # drop the irradiance column
        arr = np.asarray(rows, dtype=np.float32)
        if arr.shape != (1024, 3):
            print(f"skipping {fn}: shape {arr.shape}")
            continue
        names.append(fn.rsplit(".", 1)[0])
        stacks.append(arr)
    pack = np.stack(stacks, axis=1)  # (1024, n_films, 3)
    out = os.path.join(DATA_DIR, "crf_pack.npz")
    np.savez_compressed(out, curves=pack, names=np.array(names))
    print(f"wrote {out}: {pack.shape}, films: {names}")


# ---------------------------------------------------------------------------
# Reference .dat conversion (spectral-parity mode)
# ---------------------------------------------------------------------------


def convert_reference_luts(ref_lut_dir):
    """Convert the reference's shipped spectral tables to our npz layout.

    The reference ships measured-data LUTs (binary formats documented at
    reference renderer.py:97-125): CIE.dat is 441x2x3 float32 with
    data[x, y, c] = raw[(x + y*441)*3 + c] (y=0 the per-channel cumulative
    CMF, y=1 the XYZ response); srgb2spec.dat is 300x3 float16;
    ozone_cross_section.dat is 441 float32. These are the tables the <1%
    spectral-parity gate is defined against, so we convert them verbatim
    into cie_lut_ref.npz / srgb2spec_ref.npz / ozone_lut_ref.npz (measured
    public data: a CIE standard observer and per-nm-binned Serdyuchenko 2014
    cross sections). load_spectral_luts prefers these when present.
    """
    raw = np.fromfile(os.path.join(ref_lut_dir, "CIE.dat"), dtype=np.float32)
    assert raw.size == 441 * 2 * 3, raw.size
    arr = raw.reshape(2, 441, 3)
    cdf, resp = arr[0], arr[1]
    out = os.path.join(DATA_DIR, "cie_lut_ref.npz")
    np.savez_compressed(
        out,
        response=resp.astype(np.float32),
        cdf=cdf.astype(np.float32),
        wavelengths=WAVELENGTHS.astype(np.float32),
    )
    print(f"wrote {out}: cdf ends at {cdf[-1]}, peaks at "
          f"{resp.argmax(axis=0) + 390} nm")

    s2s = np.fromfile(
        os.path.join(ref_lut_dir, "srgb2spec.dat"), dtype=np.float16
    )
    assert s2s.size == 300 * 3, s2s.size
    basis = s2s.reshape(300, 3).astype(np.float32)
    out = os.path.join(DATA_DIR, "srgb2spec_ref.npz")
    np.savez_compressed(
        out, basis=basis, wavelengths=np.arange(400.0, 700.0, dtype=np.float32)
    )
    print(f"wrote {out}: range [{basis.min():.4f}, {basis.max():.4f}]")

    o3 = np.fromfile(
        os.path.join(ref_lut_dir, "ozone_cross_section.dat"), dtype=np.float32
    )
    assert o3.size == 441, o3.size
    out = os.path.join(DATA_DIR, "ozone_lut_ref.npz")
    np.savez_compressed(out, cross_section=o3)
    print(f"wrote {out}: peak {o3.max():.3e} at {390 + o3.argmax()} nm")


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--serdyuchenko", default=None, help="path to the Serdyuchenko 2014 dataset txt")
    p.add_argument("--crf-dir", default=None, help="directory of DoRF .rf files")
    p.add_argument(
        "--reference-luts",
        default=None,
        help="reference LUT/ directory; converts its .dat tables to *_ref.npz",
    )
    p.add_argument("--only", default=None, choices=["cie", "srgb2spec", "ozone", "crf"])
    args = p.parse_args()

    if args.reference_luts:
        convert_reference_luts(args.reference_luts)
        return

    os.makedirs(DATA_DIR, exist_ok=True)
    if args.only in (None, "cie"):
        gen_cie_lut()
    if args.only in (None, "srgb2spec"):
        gen_srgb2spec()
    if args.only in (None, "ozone"):
        if args.serdyuchenko:
            gen_ozone_lut(args.serdyuchenko)
        else:
            print("skipping ozone (no --serdyuchenko path)", file=sys.stderr)
    if args.only in (None, "crf"):
        if args.crf_dir:
            gen_crf_pack(args.crf_dir)
        else:
            print("skipping crf (no --crf-dir path)", file=sys.stderr)


if __name__ == "__main__":
    main()
