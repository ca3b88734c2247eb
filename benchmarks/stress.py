"""Production-scale stress benchmark: the ENTIRE font as a bucketed
atlas, plus a 10k-instance 4K page — the scales the framework is built
for.  Run: ``python -m benchmarks.stress``"""

from __future__ import annotations

import sys

import numpy as np

from benchmarks.harness import DEJAVU, device_info, emit, setup_cache, timeit


def full_font_atlas(dev, size: int = 64):
    """Every glyph in DejaVu Sans (6k+), bucketed by segment capacity,
    rastered bucket-by-bucket."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.kernels.grid import RasterGrid
    from fontrx.pack.segments import pack_glyphs_bucketed

    font = Font.open(DEJAVU)
    glyphs = [font.load_glyph_safe(i) for i in range(font.num_glyphs)]
    glyphs = [g for g in glyphs if g.num_segments]
    eng = RasterEngine()
    jobs = []
    for batch, _ in pack_glyphs_bucketed(glyphs):
        grids = [
            RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em, size)
            for b in np.asarray(batch.boxes)
        ]
        jobs.append((batch.segments,
                     np.array([g.min_x for g in grids], np.int32),
                     np.array([g.max_y for g in grids], np.int32),
                     grids[0].scale))
    t = timeit(lambda: [eng.winding_batch(*j, height=size, width=size)
                        for j in jobs], n=5)
    emit("stress-full-font", f"glyphs/s {size}px full-font atlas",
         len(glyphs) / t["median_s"], "glyphs/s", glyphs=len(glyphs),
         buckets=len(jobs), ms=t["median_s"] * 1e3, p90_ms=t["p90_s"] * 1e3,
         n=t["n"], device=dev)


def big_page(dev, instances: int = 10000):
    """A 10k-instance 4K page through the direct raster path."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.scene.layout import layout_text
    from fontrx.scene.page import PageRenderer
    from fontrx.scene.transform import ViewTransform

    font = Font.open(DEJAVU)
    line = "The quick brown fox jumps over the lazy dog. 0123456789 "
    n_lines = max(1, instances // len(line))
    text = "\n".join(line for _ in range(n_lines))
    w, h = 3840, 2160
    layout = layout_text(font, text)
    pr = PageRenderer(font, layout, w, h, RasterEngine())
    # zoom out to fit many lines
    view = ViewTransform.init(font.info.units_per_em, w, h).zoomed(
        -8.0, (0.0, 0.0))
    t = timeit(lambda: pr.render_direct(view), n=5)
    slots, _ = layout.instance_arrays()
    emit("stress-4k-page", "ms/frame 4K page re-raster",
         t["median_s"] * 1e3, "ms", p90_ms=t["p90_s"] * 1e3, n=t["n"],
         instances=len(layout.instances),
         live_segments=int(np.asarray(layout.batch.seg_counts)[slots].sum()),
         device=dev)


def main(argv):
    setup_cache()
    dev = device_info()
    which = argv[1:] or ["atlas", "page"]
    if "atlas" in which:
        full_font_atlas(dev)
    if "page" in which:
        big_page(dev)


if __name__ == "__main__":
    main(sys.argv)
