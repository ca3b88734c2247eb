"""Benchmark: batched glyph rasterization throughput at 256px.

Prints ONE JSON line:
``{"metric": ..., "value": N, "unit": ..., "vs_baseline": N}``

- value: glyphs/sec of the engine's raster call (full ASCII set,
  256x256 nonzero-winding fill, host binning included, compile
  excluded per BASELINE.md), timed with ``block_until_ready``.
- vs_baseline: speedup over the CPU reference implementation (the
  NumPy reimplementation of the reference's float winding rasterizer,
  ``src/tools/render_glyph.zig:11-33`` — the reference publishes no
  numbers of its own, so this oracle IS the baseline).
- correctness gate: every 13th glyph must be BIT-IDENTICAL to the CPU
  oracle — zero mismatched pixels, or the run fails.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from benchmarks.harness import DEJAVU, device_info, setup_cache, timeit

FONT_SIZE = 256
TILE = 256
ASCII = [c for c in range(33, 127)]  # printable, non-space: 94 glyphs


def main() -> None:
    from fontrx.engine.atlas import pack_charset
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.kernels import oracle
    from fontrx.kernels.grid import RasterGrid

    setup_cache()
    font = Font.open(DEJAVU)
    batch = pack_charset(font, ASCII)
    b = len(batch)
    grids = [
        RasterGrid.fixed_tile(tuple(box), FONT_SIZE, font.info.units_per_em, TILE)
        for box in np.asarray(batch.boxes)
    ]
    min_x = np.array([g.min_x for g in grids], np.int32)
    max_y = np.array([g.max_y for g in grids], np.int32)
    scale = np.float32(grids[0].scale)
    engine = RasterEngine()

    def step():
        return engine.winding_batch(
            batch.segments, min_x, max_y, scale, height=TILE, width=TILE)

    out = np.asarray(step())
    mism = 0
    checked = 0
    for i in range(0, b, 13):
        xs, ys = grids[i].sample_coords()
        wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None],
                               contract=False)
        mism += int((wo != out[i]).sum())
        checked += wo.size
    dev = device_info()
    if mism:
        print(json.dumps({
            "metric": "glyphs/sec @256px (FAILED correctness gate)",
            "value": 0.0, "unit": "glyphs/s", "vs_baseline": 0.0,
            "mismatched_pixels": mism, "checked_pixels": checked,
            "device": dev,
        }))
        sys.exit(1)

    t = timeit(step, n=20)
    glyphs_per_s = b / t["median_s"]

    # CPU baseline: the oracle on two glyphs, min over repeats
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(2):
            xs, ys = grids[i].sample_coords()
            oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None])
        reps.append((time.perf_counter() - t0) / 2)
    baseline_glyphs_per_s = 1.0 / min(reps)

    print(json.dumps({
        "metric": "glyphs/sec @256px nonzero-winding fill (94-glyph ASCII batch)",
        "value": glyphs_per_s,
        "unit": "glyphs/s",
        "vs_baseline": glyphs_per_s / baseline_glyphs_per_s,
        "median_ms": t["median_s"] * 1e3,
        "p90_ms": t["p90_s"] * 1e3,
        "n": t["n"],
        "baseline_glyphs_per_s": baseline_glyphs_per_s,
        "mismatched_pixels": mism,
        "checked_pixels": checked,
        "device": dev,
    }))


if __name__ == "__main__":
    main()
