"""Glyph outlines -> padded, fixed-shape segment tensors.

The analog of the reference's per-glyph GPU vertex/index buffers
(``src/Appli.zig:219-302``): instead of triangle meshes, glyphs become
``(S_max, 3, 2)`` float32 quadratic-segment arrays whose zero padding is
*inert* under the winding math (a degenerate all-zero segment has
``a == 0`` and ``p2y == p0y``, which the winding kernel skips —
``src/tools/render_glyph.zig:49-50``), so no validity mask is needed for
correctness, only ``seg_count`` metadata for perf.
"""

from fontrx.pack.segments import (  # noqa: F401
    PackedGlyph,
    PackedBatch,
    pack_glyph,
    pack_glyphs,
)
