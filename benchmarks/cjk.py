"""CJK-regime benchmark: high segment counts per glyph.

DejaVu has no CJK glyphs (its densest glyphs run ~10-60 segments);
real CJK glyphs run 200-500.  This config synthesizes that regime —
1000 glyphs x 288 segments of small closed multi-stroke contours
spread over the em box — and measures:

1. winding atlas @64px / @32px over the 1000-glyph batch (the
   CJK-atlas analog of BASELINE config 4's shapes);
2. SDF atlas @32px / @64px on the same batch (config 4 proper).

Run: ``python -m benchmarks.cjk``
"""

from __future__ import annotations

import sys

import numpy as np

from benchmarks.harness import device_info, emit, setup_cache, timeit

UPEM = 2048


def synthetic_strokes(rng, n_segments: int, y_sorted: bool = True) -> np.ndarray:
    """``[n_segments, 3, 2]`` float32: closed 4-segment diamond strokes
    (winding-valid contours) at random positions over the em box, with
    curved sides.  ``y_sorted`` orders strokes bottom-to-top so segment
    chunks are y-coherent, as real outlines' locally-contiguous
    contours are."""
    n_shapes = n_segments // 4
    cx = rng.integers(100, UPEM - 100, n_shapes)
    cy = rng.integers(100, UPEM - 100, n_shapes)
    if y_sorted:
        order = np.argsort(cy)
        cx, cy = cx[order], cy[order]
    r = rng.integers(20, 90, n_shapes)
    segs = np.zeros((n_shapes, 4, 3, 2), np.float32)
    for k in range(4):
        a0 = k * np.pi / 2
        a1 = (k + 1) * np.pi / 2
        p0 = np.stack([cx + r * np.cos(a0), cy + r * np.sin(a0)], axis=1)
        p2 = np.stack([cx + r * np.cos(a1), cy + r * np.sin(a1)], axis=1)
        mid = (p0 + p2) / 2
        bulge = rng.integers(-15, 15, (n_shapes, 2))
        segs[:, k, 0] = np.round(p0)
        segs[:, k, 1] = np.round(mid + bulge)
        segs[:, k, 2] = np.round(p2)
    # close exactly: each side's p2 is the next side's p0
    for k in range(4):
        segs[:, (k + 1) % 4, 0] = segs[:, k, 2]
    return segs.reshape(-1, 3, 2)[:n_segments]


def make_batch(b: int, n_segments: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    return np.stack([synthetic_strokes(rng, n_segments) for _ in range(b)])


def atlas(b=1000, n_segments=288):
    """Winding atlas at 64 and 32 px over the synthetic batch, with an
    every-pixel oracle check of three glyphs."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.kernels import oracle

    segs = make_batch(b, n_segments)
    engine = RasterEngine()
    dev = device_info()
    for size in (64, 32):
        scale = float(np.float32(size / UPEM))
        mx = np.zeros(b, np.int32)
        my = np.full(b, size - 1, np.int32)

        def fn(size=size, scale=scale, my=my):
            return engine.winding_batch(segs, mx, my, scale, height=size,
                                        width=size)

        t = timeit(fn, n=5)
        out = np.asarray(fn())
        mism = 0
        for i in (0, b // 2, b - 1):
            xs = np.arange(size).astype(np.float32) / np.float32(scale)
            ys = (my[i] - np.arange(size)).astype(np.float32) \
                / np.float32(scale)
            w = oracle.winding_at(segs[i], xs[None, :], ys[:, None],
                                  contract=False)
            mism += int((out[i] != w).sum())
        emit("cjk-winding-atlas", f"glyphs/s {size}px {n_segments}seg winding",
             b / t["median_s"], "glyphs/s", ms_per_atlas=t["median_s"] * 1e3,
             p90_ms=t["p90_s"] * 1e3, n=t["n"], batch=b,
             segments_per_glyph=n_segments, mismatched_pixels=mism,
             device=dev)


def sdf_atlas(b=1000, n_segments=288):
    """SDF atlas at 32 and 64 px over the synthetic batch."""
    from fontrx.engine.raster import RasterEngine

    segs = make_batch(b, n_segments)
    engine = RasterEngine()
    dev = device_info()
    for size in (32, 64):
        args = (segs, np.zeros(b, np.int32), np.full(b, size - 1, np.int32),
                np.float32(size / UPEM))
        t = timeit(lambda: engine.sdf_batch(*args, height=size, width=size),
                   n=5)
        emit("cjk-sdf-atlas", f"glyphs/s {size}px {n_segments}seg SDF",
             b / t["median_s"], "glyphs/s", ms_per_atlas=t["median_s"] * 1e3,
             p90_ms=t["p90_s"] * 1e3, n=t["n"], batch=b,
             segments_per_glyph=n_segments, device=dev)


def main(argv):
    setup_cache()
    which = argv[1:] or ["atlas", "sdf"]
    if "atlas" in which:
        atlas()
    if "sdf" in which:
        sdf_atlas()


if __name__ == "__main__":
    main(sys.argv)
