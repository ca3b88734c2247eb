"""Atlas batching: rasterize a whole glyph set in one jitted step.

BASELINE configs 3 (ASCII atlas @128px) and 4 (CJK SDF atlas) — the
replacement for the reference's per-glyph GPU residency + per-instance
draws (``src/Appli.zig:219-302``): all glyphs of a set become one
``[B, S, 3, 2]`` tensor and one kernel launch rasterizes every tile.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fontrx.engine.raster import RasterEngine
from fontrx.font.font import Font
from fontrx.pack.segments import PackedBatch, pack_glyphs


@dataclass(frozen=True, slots=True)
class AtlasLayout:
    """Glyph-tile placement in an atlas sheet: ``cols x rows`` tiles of
    ``tile x tile`` pixels, row-major by glyph order."""

    tile: int
    cols: int
    rows: int
    chars: tuple[int, ...]

    @property
    def width(self) -> int:
        return self.cols * self.tile

    @property
    def height(self) -> int:
        return self.rows * self.tile

    def tile_origin(self, i: int) -> tuple[int, int]:
        return (i % self.cols) * self.tile, (i // self.cols) * self.tile


def pack_charset(
    font: Font,
    chars: str | list[int],
    pad_batch_to: int | None = None,
    use_native: bool = True,
) -> PackedBatch:
    """Load + pack a character set from a font (vectorized char->glyph
    resolution).

    Fast path: the native C++ data-loader decodes+packs all simple
    glyphs in one call (``fontrx/native/src/ttf_pack.cc``); compound or
    flagged glyphs fall back to the Python pipeline row by row.
    """
    codes = [ord(c) for c in chars] if isinstance(chars, str) else list(chars)
    idx = font.charmap.glyph_indices(np.array(codes, np.int64))
    widths = np.asarray(font.advance_widths)[idx].astype(np.int32)

    if use_native:
        batch = _pack_charset_native(font, idx, widths, pad_batch_to)
        if batch is not None:
            return batch

    glyphs = [font.load_glyph_safe(int(i)) for i in idx]
    return pack_glyphs(glyphs, widths.tolist(), pad_batch_to=pad_batch_to)


_NATIVE_SCRATCH_CAPACITY = 1024


def _pack_charset_native(font, idx, widths, pad_batch_to):
    from fontrx import native
    from fontrx.pack.segments import SEG_ALIGN, glyph_segments

    res = native.pack_glyphs_native(
        font._reader.data,
        font._loca,
        font.tables[b"glyf"].offset,
        idx.astype(np.int32),
        _NATIVE_SCRATCH_CAPACITY,
    )
    if res is None:
        return None
    segments, counts, boxes, flags = res
    # fill non-simple rows (compound glyphs etc.) via the Python path
    for i in np.nonzero(flags != 0)[0]:
        g = font.load_glyph_safe(int(idx[i]))
        seg = glyph_segments(g)
        if len(seg) > _NATIVE_SCRATCH_CAPACITY:
            return None  # pathological; let the pure path size it
        segments[i] = 0
        segments[i, : len(seg)] = seg
        counts[i] = len(seg)
        boxes[i] = (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max)
    # y-sort each row in place — same ordering as pack_glyphs, so the
    # native and pure paths stay array-equal (and the kernel's y-cull /
    # group elision see coherent chunks)
    from fontrx.pack.segments import ysort_segments

    for i in range(len(idx)):
        n = int(counts[i])
        if n > 1:
            segments[i, :n] = ysort_segments(segments[i, :n])

    b = len(idx)
    if pad_batch_to is not None:
        b = max(b, pad_batch_to)
    cap = max(int(counts.max()) if len(counts) else 0, 1)
    cap = ((cap + SEG_ALIGN - 1) // SEG_ALIGN) * SEG_ALIGN
    final = np.zeros((b, cap, 3, 2), np.float32)
    final[: len(idx), :, :, :] = segments[:, :cap]
    out_counts = np.zeros(b, np.int32)
    out_counts[: len(idx)] = counts
    out_boxes = np.zeros((b, 4), np.int32)
    out_boxes[: len(idx)] = boxes
    out_widths = np.zeros(b, np.int32)
    out_widths[: len(idx)] = widths
    return PackedBatch(final, out_counts, out_boxes, out_widths)


def render_atlas(
    font: Font,
    chars: str | list[int],
    font_size: int,
    tile: int,
    engine: RasterEngine | None = None,
) -> tuple[np.ndarray, AtlasLayout]:
    """Rasterize a character set into one atlas sheet.

    Returns ``(uint8 [H, W] fill atlas, layout)``.  One kernel launch
    computes every glyph tile; the sheet assembly is a reshape.
    """
    engine = engine or RasterEngine()
    codes = [ord(c) for c in chars] if isinstance(chars, str) else list(chars)
    batch = pack_charset(font, codes)
    winding, _grids = engine.winding_packed(
        batch, font_size, font.info.units_per_em, tile
    )
    fills = np.asarray(engine.fill(winding))  # [B, T, T]

    b = len(fills)
    cols = int(np.ceil(np.sqrt(b)))
    rows = (b + cols - 1) // cols
    sheet = np.zeros((rows * tile, cols * tile), np.uint8)
    for i in range(b):
        x0 = (i % cols) * tile
        y0 = (i // cols) * tile
        sheet[y0 : y0 + tile, x0 : x0 + tile] = fills[i]
    layout = AtlasLayout(tile, cols, rows, tuple(codes))
    return sheet, layout
