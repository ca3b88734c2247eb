"""The five BASELINE benchmark configs (BASELINE.md).

1. single glyph 'A' 256x256 winding fill -> QOI (oracle parity)
2. "Hello, World!" line, 64px, 4x MSAA supersampled coverage
3. full ASCII atlas (94 printable glyphs) @128px,
   triangulation-equivalent fill
4. SDF atlas, 1000 glyphs @32/64px
5. interactive 1920x1080 page, per-frame zoom/pan re-raster

Every timing is ``harness.timeit`` (block_until_ready after a compile
warm-up) on the default device, which each line names.

Run all: ``python -m benchmarks.configs``
Run one: ``python -m benchmarks.configs 3``
"""

from __future__ import annotations

import sys

import numpy as np

from benchmarks.harness import DEJAVU, device_info, emit, setup_cache, timeit


def config1_single_glyph(dev):
    """Single glyph 'A' 256x256 nonzero-winding fill -> QOI, with
    CPU-oracle parity check."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.io.qoi import encode_rgb
    from fontrx.kernels import oracle
    from fontrx.kernels.grid import RasterGrid
    from fontrx.pack.segments import glyph_segments

    font = Font.open(DEJAVU)
    g, _ = font.get_glyph("A")
    segs = glyph_segments(g)
    grid = RasterGrid.for_glyph_box(
        (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
        256, font.info.units_per_em,
    )
    eng = RasterEngine()
    w = np.asarray(eng.winding_glyph(segs, grid))
    wo = oracle.winding_map(segs, grid, contract=False)
    qoi = encode_rgb(np.repeat(
        np.where(w != 0, 255, 0).astype(np.uint8)[:, :, None], 3, axis=2))
    t = timeit(lambda: eng.winding_glyph(segs, grid))
    emit("1-single-glyph", "ms per 256px glyph raster",
         t["median_s"] * 1e3, "ms", p90_ms=t["p90_s"] * 1e3, n=t["n"],
         mismatched_pixels=int((w != wo).sum()),
         total_pixels=int(wo.size), qoi_bytes=len(qoi), device=dev)


def config2_hello_world_msaa(dev):
    """'Hello, World!' 64px glyphs with 4x (2x2) supersampled coverage."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.kernels.grid import RasterGrid
    from fontrx.scene.layout import layout_text

    font = Font.open(DEJAVU)
    layout = layout_text(font, "Hello, World!")
    grids = [
        RasterGrid.fixed_tile(tuple(b), 64, font.info.units_per_em, 64)
        for b in np.asarray(layout.batch.boxes)
    ]
    args = (layout.batch.segments,
            np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32), grids[0].scale)
    eng = RasterEngine()
    t = timeit(lambda: eng.coverage_batch(*args, height=64, width=64,
                                          samples=2))
    n = len(layout.batch)
    emit("2-hello-msaa", "glyphs/s 64px 4xMSAA coverage",
         n / t["median_s"], "glyphs/s", ms_per_line=t["median_s"] * 1e3,
         p90_ms=t["p90_s"] * 1e3, n=t["n"], unique_glyphs=n,
         instances=len(layout.instances), device=dev)


def config3_ascii_atlas(dev):
    """Full printable-ASCII atlas @128px, triangulation-equivalent fill."""
    import jax.numpy as jnp

    from fontrx.font.font import Font
    from fontrx.geometry import TriangulatedGlyph
    from fontrx.kernels.grid import RasterGrid
    from fontrx.kernels.loopblinn import (
        _pack_triangle_arrays,
        loopblinn_batch,
        pad_triangles,
    )

    font = Font.open(DEJAVU)
    chars = [chr(c) for c in range(33, 127)]
    tgs = [TriangulatedGlyph.from_glyph(font.get_glyph(c)[0]) for c in chars]
    cap = max(len(t.triangles) for t in tgs)
    tris = np.zeros((len(tgs), cap, 3, 4), np.float32)
    cls = np.full((len(tgs), cap), 3, np.int32)
    boxes = []
    for i, (c, tg) in enumerate(zip(chars, tgs)):
        packed, pc = pad_triangles(_pack_triangle_arrays(tg), tg.classes, cap)
        tris[i] = packed
        cls[i] = pc
        g, _ = font.get_glyph(c)
        boxes.append((g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max))
    grids = [
        RasterGrid.fixed_tile(b, 128, font.info.units_per_em, 128)
        for b in boxes
    ]
    args = (
        jnp.asarray(tris), jnp.asarray(cls),
        jnp.array([g.min_x for g in grids], jnp.int32),
        jnp.array([g.max_y for g in grids], jnp.int32),
        jnp.float32(grids[0].scale),
    )
    t = timeit(lambda: loopblinn_batch(*args, height=128, width=128))
    emit("3-ascii-triangulation", "glyphs/s 128px triangle fill",
         len(tgs) / t["median_s"], "glyphs/s",
         ms_per_atlas=t["median_s"] * 1e3, p90_ms=t["p90_s"] * 1e3,
         n=t["n"], device=dev)


def config4_sdf_atlas(dev, size: int = 32, cjk: bool = False):
    """SDF atlas for 1000 glyphs: DejaVu's first 1000 non-empty glyphs
    (10-60 segments each), or the synthetic 288-segment CJK regime
    (``benchmarks/cjk.py``; DejaVu has no CJK)."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.kernels.grid import RasterGrid
    from fontrx.pack.segments import pack_glyphs

    if cjk:
        from benchmarks.cjk import UPEM, make_batch

        segs = make_batch(1000, 288)
        args = (segs, np.zeros(1000, np.int32),
                np.full(1000, size - 1, np.int32), np.float32(size / UPEM))
    else:
        font = Font.open(DEJAVU)
        glyphs = []
        idx = 1
        while len(glyphs) < 1000 and idx < font.num_glyphs:
            g = font.load_glyph_safe(idx)
            if g.num_segments:
                glyphs.append(g)
            idx += 1
        batch = pack_glyphs(glyphs)
        grids = [
            RasterGrid.fixed_tile(tuple(b), size, font.info.units_per_em,
                                  size)
            for b in np.asarray(batch.boxes)
        ]
        segs = batch.segments
        args = (segs, np.array([g.min_x for g in grids], np.int32),
                np.array([g.max_y for g in grids], np.int32),
                grids[0].scale)
    eng = RasterEngine()
    t = timeit(lambda: eng.sdf_batch(*args, height=size, width=size), n=5)
    emit("4-sdf-atlas" + ("-cjk" if cjk else ""), f"glyphs/s {size}px SDF",
         len(segs) / t["median_s"], "glyphs/s",
         ms_per_atlas=t["median_s"] * 1e3, p90_ms=t["p90_s"] * 1e3,
         n=t["n"], seg_capacity=int(segs.shape[1]), device=dev)


def config5_interactive_page(dev):
    """Interactive 1920x1080 text page: per-frame zoom/pan re-raster."""
    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.scene.interactive import InteractiveSession

    font = Font.open(DEJAVU)
    text = "\n".join(
        "The quick brown fox jumps over the lazy dog 0123456789"
        for _ in range(20)
    )
    sess = InteractiveSession(font, text, 1920, 1080, RasterEngine())
    sess.frame()  # compile + first raster
    # alternating zoom/pan event stream, 30 frames
    for i in range(30):
        if i % 3 == 0:
            sess.scroll(0.5 if i % 2 else -0.5, (0.1, 0.1))
        else:
            sess.drag(0.01, 0.005)
        sess.frame()
    stats = sess.stats()
    emit("5-interactive-1080p", "ms/frame 1080p zoom-pan (raster only)",
         stats["compute_ms"], "ms",
         with_host_fetch_ms=stats["mean_ms"], p99_ms=stats["p99_ms"],
         frames=stats["frames"], device=dev)


ALL = {
    "1": config1_single_glyph,
    "2": config2_hello_world_msaa,
    "3": config3_ascii_atlas,
    "4": lambda dev: [config4_sdf_atlas(dev, size, cjk)
                      for cjk in (False, True) for size in (32, 64)],
    "5": config5_interactive_page,
}


def main(argv):
    setup_cache()
    dev = device_info()
    which = argv[1:] or list(ALL)
    for k in which:
        ALL[k](dev)


if __name__ == "__main__":
    main(sys.argv)
