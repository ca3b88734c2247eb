"""Page rendering: text layout -> full pixel page, on device.

The JAX re-design of the reference's frame loop (``Appli.zig:145-217``,
three pipeline passes x per-instance ``cmdDrawIndexed``): here a frame is
two jitted steps —

1. **glyph pass**: one batched winding raster of the *unique* glyphs at
   the current zoom (cost O(unique glyphs), the same reuse property as
   the reference's mesh cache, SURVEY §5.7), then
2. **composite pass**: a ``lax.scan`` of max-blend ``dynamic_update_slice``
   placements of instance tiles onto the page.

Static shapes: tile size and instance count are bucketed so zooming
never recompiles (``grid.min_x/max_y`` and pen offsets are traced
inputs; only the tile bucket changes shape).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fontrx.engine.raster import RasterEngine
from fontrx.font.font import Font
from fontrx.kernels.grid import RasterGrid
from fontrx.kernels.winding import bucket
from fontrx.scene.layout import TextLayout
from fontrx.scene.transform import ViewTransform
from fontrx.utils.log import get_logger

log = get_logger("Page")


@functools.partial(jax.jit, static_argnames=("page_h", "page_w", "tile"))
def composite_tiles(tiles, slots, xs, ys, *, page_h, page_w, tile):
    """Max-blend fixed-size tiles onto a page.

    ``tiles``: uint8 ``[U, T, T]`` UNIQUE glyph tiles; ``slots``: int32
    ``[N]`` tile index per instance; ``xs``/``ys``: int32 ``[N]``
    top-left page coords (may be out of bounds — the page is padded by
    T on every side here, then cropped, so edge glyphs clip instead of
    smearing).  The scan gathers each instance's tile INSIDE the body:
    only the unique tiles stay resident, so 10k-instance pages don't
    materialize an ``[N, T, T]`` gather (which OOM'd a 16 GB chip at
    page scale — round-5 probe).
    """
    padded = jnp.zeros((page_h + 2 * tile, page_w + 2 * tile), jnp.uint8)

    def body(page, args):
        s, x0, y0 = args
        t = tiles[s]
        x0 = jnp.clip(x0 + tile, 0, page_w + tile)
        y0 = jnp.clip(y0 + tile, 0, page_h + tile)
        cur = jax.lax.dynamic_slice(page, (y0, x0), (tile, tile))
        return (
            jax.lax.dynamic_update_slice(page, jnp.maximum(cur, t), (y0, x0)),
            None,
        )

    padded, _ = jax.lax.scan(body, padded, (slots, xs, ys))
    return padded[tile : tile + page_h, tile : tile + page_w]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class GlyphTileCache:
    """Device-resident LRU of rastered glyph tiles, keyed by
    ``(glyph id, zoom, mode, tile size, variation location)``.

    The reference keeps *meshes* GPU-resident, so pans are free but
    every zoom re-tessellates nothing (vector data).  fontrx's
    composite tiles are rasters, so they are zoom-dependent; this cache
    makes the two interactive hot paths free:

    - **zoom-return**: scroll steps are reversible (1.15^n), so zooming
      in and back out revisits exact scales — every revisited level is
      a full hit and re-rasters nothing;
    - **text edit** (``char_input``): a new layout re-uses every glyph
      already on screen; only genuinely new glyphs raster.

    Eviction is byte-bounded LRU (device tiles; a 512px uint8 tile is
    256 KB).  The cache outlives PageRenderer rebuilds — sessions pass
    one cache into every renderer they create.
    """

    def __init__(self, capacity_bytes: int = 128 * 1024 * 1024):
        from collections import OrderedDict

        self.capacity_bytes = capacity_bytes
        self._tiles: "OrderedDict[tuple, jax.Array]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._tiles)

    @property
    def nbytes(self) -> int:
        return self._bytes

    def get(self, key):
        t = self._tiles.get(key)
        if t is not None:
            self._tiles.move_to_end(key)
            self.hits += 1
        else:
            self.misses += 1
        return t

    def put(self, key, tile) -> None:
        if key in self._tiles:
            self._tiles.move_to_end(key)
            return
        self._tiles[key] = tile
        self._bytes += int(np.prod(tile.shape))  # uint8
        while self._bytes > self.capacity_bytes and len(self._tiles) > 1:
            _, old = self._tiles.popitem(last=False)
            self._bytes -= int(np.prod(old.shape))

    def stats(self) -> dict:
        return {
            "tiles": len(self._tiles),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
        }


def _to_page(stream, seg_inst_idx, inst_offsets, s_px):
    """Em segments -> page pixels (y up): f32 ``[N, 3, 2]``."""
    return stream * s_px + inst_offsets[seg_inst_idx][:, None, :]


@functools.partial(
    jax.jit,
    static_argnames=("n_bands", "cap", "page_w", "out_h", "mode"),
)
def _direct_page_step(
    stream, seg_inst_idx, inst_offsets, s_px, start, count, top, offsets,
    *, n_bands, cap, page_w, out_h, mode="fill",
):
    """One direct-raster frame: map the layout's em segment stream to
    page pixels (y up) and raster its row bands.

    - ``stream``: f32 ``[N, 3, 2]`` em segments, instance-sorted (see
      ``PageRenderer._compact_instances``); ``seg_inst_idx``: owning
      instance per segment; ``inst_offsets``: f32 ``[n, 2]`` page-pixel
      position of each instance's em origin (y up); ``s_px``: pixels
      per font unit
    - ``start``/``count``: int32 ``[n_bands]`` each band's range of the
      stream; ``top``: the y (up) of output row 0 — the page's
      ``page_h - 1`` less the band's first page row, so a band render
      equals the same rows of the full render BIT-FOR-BIT (winding is
      row-local)
    - ``offsets``: f32 ``[k, 2]`` sample offsets; ``mode`` "fill" and
      "winding" take the first, "msaa" averages the binary fills of
      all k (the reference's MSAA resolve)
    """
    from fontrx.kernels.winding import winding_bins_xla

    soa = _to_page(stream, seg_inst_idx, inst_offsets, s_px).reshape(-1, 6).T

    def winding(off):
        return winding_bins_xla(
            soa, start, count, jnp.zeros(1, jnp.int32), top.reshape(1),
            jnp.float32(1.0), off, n_bands=n_bands, cap=cap, width=page_w,
        )[0, :out_h]

    if mode == "msaa":
        acc = None
        for i in range(offsets.shape[0]):
            f = jnp.where(winding(offsets[i]) != 0, 255, 0).astype(jnp.uint16)
            acc = f if acc is None else acc + f
        return (acc // offsets.shape[0]).astype(jnp.uint8)
    w = winding(offsets[0])
    if mode == "winding":
        # debug visualization: the reference's winding coloring
        # (render_glyph.zig:28) instead of the binary fill (Ctrl+D)
        return jnp.clip(w * 20 + 100, 0, 255).astype(jnp.uint8)
    return jnp.where(w != 0, 255, 0).astype(jnp.uint8)


@dataclass
class PageRenderer:
    """Renders a ``TextLayout`` under a ``ViewTransform`` to a page.

    The per-frame flow (``render``) is the analog of
    ``Appli.renderingFn``: update transforms, raster unique glyphs (only
    when zoom changed — the glyph tiles persist across pans like the
    reference's GPU-resident meshes), composite instances.
    """

    font: Font
    layout: TextLayout
    width: int
    height: int
    engine: RasterEngine | None = None
    tile_cache: GlyphTileCache | None = None  # shared LRU (survives re-layout)
    _cached_scale: float | None = None
    _cached_tiles: object = None
    _cached_grids: object = None

    def __post_init__(self):
        if self.engine is None:
            self.engine = RasterEngine()

    # -- glyph pass --------------------------------------------------------

    def _tile_size(self, px_per_unit: float) -> int:
        boxes = np.asarray(self.layout.batch.boxes)
        if len(boxes) == 0:
            return 128
        spans = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
        max_px = float(spans.max()) * px_per_unit
        return min(max(_next_pow2(int(max_px) + 2), 128), 2048)

    def rasterize_glyphs(
        self, px_per_unit: float, msaa: bool = False, debug: bool = False
    ):
        """Raster every unique glyph at the current zoom into fixed
        tiles; cached until the zoom (scale) or render mode changes.

        ``msaa``: tiles are 2x2-supersampled coverage (antialiased
        alpha) instead of the binary fill — the composite-mode analog of
        the reference's MSAA resolve.  ``debug``: tiles carry the
        winding visualization (``render_glyph.zig:28``), so the
        composite shows per-tile extents + winding structure (the
        Ctrl+D analog for this path)."""
        key = (px_per_unit, msaa, debug)
        if self._cached_scale == key and self._cached_tiles is not None:
            return self._cached_tiles, self._cached_grids, self._tile_size(px_per_unit)
        tile = self._tile_size(px_per_unit)
        boxes = np.asarray(self.layout.batch.boxes)
        grids = [
            RasterGrid(
                width=tile,
                height=tile,
                min_x=int(np.floor(np.float32(b[0]) * np.float32(px_per_unit))),
                max_y=int(np.ceil(np.float32(b[3]) * np.float32(px_per_unit))),
                scale=float(np.float32(px_per_unit)),
            )
            for b in boxes
        ]
        gids = self.layout.slot_gids
        cache = self.tile_cache
        if cache is not None and len(gids) == len(grids):
            mode = "msaa" if msaa and not debug else (
                "debug" if debug else "fill"
            )
            # variable fonts: the design location is part of glyph
            # identity (stale-weight tiles otherwise survive axis steps)
            coords = getattr(self.font, "_var_coords", None)
            var_key = None if coords is None else coords.tobytes()
            keys = [
                (gid, float(np.float32(px_per_unit)), mode, tile, var_key)
                for gid in gids
            ]
            got = [cache.get(k) for k in keys]
            missing = [i for i, t in enumerate(got) if t is None]
            if missing:
                sub = self._raster_tiles(
                    self.layout.batch.segments[missing],
                    np.array([grids[i].min_x for i in missing], np.int32),
                    np.array([grids[i].max_y for i in missing], np.int32),
                    px_per_unit, tile, msaa, debug,
                )
                for m, i in enumerate(missing):
                    got[i] = sub[m]
                    cache.put(keys[i], got[i])
            tiles = jnp.stack(got) if got else jnp.zeros(
                (0, tile, tile), jnp.uint8
            )
        else:
            tiles = self._raster_tiles(
                self.layout.batch.segments,
                np.array([g.min_x for g in grids], np.int32),
                np.array([g.max_y for g in grids], np.int32),
                px_per_unit, tile, msaa, debug,
            )
        self._cached_scale = key
        self._cached_tiles = tiles
        self._cached_grids = grids
        return tiles, grids, tile

    def _raster_tiles(
        self, segments, min_x, max_y, px_per_unit, tile, msaa, debug
    ):
        """Raster a batch of glyph tiles in the selected mode: uint8
        ``[B, tile, tile]``."""
        args = (np.asarray(segments), min_x, max_y, np.float32(px_per_unit))
        if msaa and not debug:
            cov = self.engine.coverage_batch(
                *args, height=tile, width=tile, samples=2
            )
            return jnp.clip(jnp.round(cov * 255.0), 0, 255).astype(jnp.uint8)
        winding = self.engine.winding_batch(*args, height=tile, width=tile)
        # debug: winding visualization; else binary fill [B, T, T] u8
        return (
            self.engine.gray(winding) if debug else self.engine.fill(winding)
        )

    # -- direct path -------------------------------------------------------

    def render_direct(
        self, view: ViewTransform, msaa: bool = False, debug: bool = False,
        band: tuple[int, int] | None = None,
    ) -> jax.Array:
        """Render one frame by rasterizing the *page* directly from all
        instance segments — no per-glyph tiles, no composite pass.

        Each 16-row band reads only the stream range of the text lines
        that can reach it; zoom/pan change only traced inputs and the
        bucketed ranges, so they do not recompile.  ``band=(y0, h)``
        renders page rows ``[y0, y0 + h)`` only (fill mode; the
        dirty-strip edit path), bit-equal to those rows of the full
        render.  Returns the device array; callers fetch at IO
        boundaries.
        """
        from fontrx.kernels.coverage import sample_offsets
        from fontrx.kernels.winding import BAND_ROWS

        if band is not None:
            assert not msaa and not debug, "band renders are fill-only"
        y0, out_h = (0, self.height) if band is None else band
        if self.layout.instance_arrays()[0].size == 0:
            return np.zeros((out_h, self.width), np.uint8)
        stream, seg_inst_idx, xs, s_px, base, inst_seg_start, ext = (
            self._frame(view))
        top = self.height - 1 - y0
        n_bands = -(-out_h // BAND_ROWS)
        start, count = self._band_ranges(
            base, inst_seg_start, ext, float(s_px), top, n_bands)
        offsets = (sample_offsets(2) if msaa
                   else np.zeros((1, 2), np.float32))
        return _direct_page_step(
            stream, seg_inst_idx, jnp.asarray(xs), s_px,
            jnp.asarray(start), jnp.asarray(count), np.int32(top),
            jnp.asarray(offsets), n_bands=n_bands, cap=bucket(int(count.max()), 256),
            page_w=self.width, out_h=out_h,
            mode="msaa" if msaa else ("winding" if debug else "fill"),
        )

    def _frame(self, view: ViewTransform):
        """Per-frame inputs of the direct path: the cached stream and
        owners, each instance's em origin in page pixels (y up) ``xs``,
        pixels per unit, and the instance-sorted baselines with their
        stream runs and em extent (for :meth:`_band_ranges`)."""
        if view.scale[0] <= 0 or view.scale[1] <= 0:
            raise ValueError("view scale must be positive")
        slots, offsets_em = self.layout.instance_arrays()
        (stream, seg_inst_idx, order, inst_seg_start,
         ext) = self._compact_instances(slots, offsets_em)
        s_px = np.float32(view.scale[0] * (self.width / 2.0))
        # vectorized in f64 (same IEEE results as the scalar view.apply
        # loop, which cost ~ms/frame at 10k instances)
        em = offsets_em.astype(np.float64)
        ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
        ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) * view.aspect_ratio
        # instance rows bucket to 256 for the same shape-stability
        # reason as the segment stream; padded rows sit far off-page
        # (and own only zero segments), so they contribute nothing
        n_inst = ((len(slots) + 1 + 255) // 256) * 256
        xs = np.full((n_inst, 2), -1e7, np.float32)
        xs[: len(slots), 0] = (ndc_x + 1.0) / 2.0 * self.width
        xs[: len(slots), 1] = (ndc_y + 1.0) / 2.0 * self.height
        return (stream, seg_inst_idx, xs, s_px,
                xs[order, 1].astype(np.float64), inst_seg_start, ext)

    def page_segments(self, view: ViewTransform) -> np.ndarray:
        """The live segments of a frame in page pixels (y up), as the
        direct path computes them on the device: f32 ``[S, 3, 2]``
        (the oracle's input for checking a page)."""
        stream, seg_inst_idx, xs, s_px, _, inst_seg_start, _ = (
            self._frame(view))
        flat = jax.jit(_to_page)(stream, seg_inst_idx, jnp.asarray(xs), s_px)
        return np.asarray(flat)[: int(inst_seg_start[-1])]

    @staticmethod
    def _band_ranges(base, inst_seg_start, ext, s_px, top, n_bands):
        """Each band's contiguous range of the instance-sorted stream:
        the instances whose baseline ``base`` (page px, y up,
        non-decreasing in stream order) puts their ink — em extent
        ``ext`` times ``s_px`` — within reach of the band's rows."""
        from fontrx.kernels.winding import (
            BAND_ROWS,
            HULL_GUARD,
            SAMPLE_MARGIN_PX,
        )

        r0 = np.arange(n_bands) * BAND_ROWS
        pad = SAMPLE_MARGIN_PX + HULL_GUARD
        y_hi = top - r0 + pad
        y_lo = top - (r0 + BAND_ROWS - 1) - pad
        lo = np.searchsorted(base, y_lo - ext[1] * s_px, side="left")
        hi = np.searchsorted(base, y_hi - ext[0] * s_px, side="right")
        start = inst_seg_start[lo]
        return start.astype(np.int32), (inst_seg_start[hi] - start).astype(
            np.int32)

    def _compact_instances(self, slots, offsets_em):
        """Per-layout compaction: every instance's *live* segments
        (padding dropped) in one stream, instances sorted by pen
        position (baseline, then x) — so each text line is one
        contiguous, x-ordered run and a row band reads one range.  The
        order holds at every zoom and pan (page y is increasing affine
        in em y).  Built once; zoom/pan only change traced offsets.

        Returns ``(stream [N, 3, 2], seg_inst_idx [N], order,
        inst_seg_start [n + 1], (em y min, em y max))``: device stream
        and owners, host order and run starts, and the segments' em
        y extent relative to their instance origin."""
        if getattr(self, "_compact_cache", None) is not None:
            return self._compact_cache
        batch = self.layout.batch
        order = np.lexsort((offsets_em[:, 0], offsets_em[:, 1]))
        counts = np.asarray(batch.seg_counts)[slots[order]].astype(np.int64)
        inst_seg_start = np.concatenate([[0], np.cumsum(counts)])
        total = int(inst_seg_start[-1])
        seg = np.zeros((max(total, 1), 3, 2), np.float32)
        idx = np.zeros(max(total, 1), np.int32)
        for k, i in enumerate(order):
            n = int(counts[k])
            if n:
                a = int(inst_seg_start[k])
                seg[a : a + n] = batch.segments[slots[i], :n]
                idx[a : a + n] = i
        ys = seg[:total, :, 1]
        ext = ((float(ys.min()), float(ys.max())) if total else (0.0, 0.0))
        # bucket the stream length so interactive EDITS keep a stable
        # traced shape (every keystroke changes the live segment count;
        # unbucketed, each edit recompiled the page raster).  Padding
        # segments are all-zero (inert in the winding sum) and owned by
        # the off-page sentinel instance render_direct appends.
        cap = ((len(seg) + 2047) // 2048) * 2048
        if cap != len(seg):
            seg = np.concatenate(
                [seg, np.zeros((cap - len(seg), 3, 2), np.float32)])
            idx = np.concatenate(
                [idx, np.full(cap - len(idx), len(slots), np.int32)])
        self._compact_cache = (jnp.asarray(seg), jnp.asarray(idx), order,
                               inst_seg_start, ext)
        return self._compact_cache

    # -- output conversion -------------------------------------------------

    @staticmethod
    def to_rgba(page: np.ndarray, transparent: bool = False) -> np.ndarray:
        """Page coverage -> RGBA.  ``transparent=True`` is the analog of
        the reference's transparent-framebuffer mode (premultiplied
        composite alpha, ``VulkanContext.zig:891`` + Ctrl+T): background
        alpha 0 so the page composites over anything; otherwise opaque
        over black.  Color pages (``[H, W, 3]`` from ``render_color``)
        pass through with an opaque alpha."""
        if page.ndim == 3:
            rgba = np.empty(page.shape[:2] + (4,), np.uint8)
            rgba[..., :3] = page
            rgba[..., 3] = 255
            return rgba
        a = page.astype(np.uint8)
        rgba = np.zeros(page.shape + (4,), np.uint8)
        rgba[..., 0] = a
        rgba[..., 1] = a
        rgba[..., 2] = a
        rgba[..., 3] = a if transparent else 255
        return rgba

    def render_color(
        self, view: ViewTransform, palette: int = 0, samples: int = 2,
    ) -> np.ndarray:
        """Render one COLR/CPAL color frame: uint8 ``[H, W, 3]``.

        The color analog of the composite pipeline: premultiplied RGBA
        glyph tiles raster once per zoom (cached like
        ``rasterize_glyphs``) and composite src-over at the instance
        pen positions (``engine/colorglyphs.py``).  Monochrome glyphs
        ride along as foreground-colored layers."""
        from fontrx.engine.colorglyphs import (
            color_glyph_tiles,
            composite_color_page,
        )

        px_per_unit = view.scale[0] * (self.width / 2.0)
        if px_per_unit <= 0:
            raise ValueError("view scale must be positive")
        tile = self._tile_size(px_per_unit)
        key = (px_per_unit, palette, tile)
        cached = getattr(self, "_color_cache", None)
        if cached is None or cached[0] != key:
            tiles, grids = color_glyph_tiles(
                self.font, [int(g) for g in self.layout.slot_gids],
                px_per_unit * self.font.info.units_per_em,
                self.engine, palette=palette, samples=samples,
                tile=tile,
            )
            self._color_cache = cached = (key, tiles, grids)
        _, tiles, grids = cached

        slots, offsets = self.layout.instance_arrays()
        em = offsets.astype(np.float64)
        ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
        ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) \
            * view.aspect_ratio
        pen = np.empty((len(slots), 2), np.float64)
        pen[:, 0] = (ndc_x + 1.0) / 2.0 * self.width
        pen[:, 1] = (1.0 - ndc_y) / 2.0 * self.height
        return composite_color_page(
            tiles, grids, slots, pen,
            page_h=self.height, page_w=self.width,
        )

    # -- frame -------------------------------------------------------------

    def render(
        self, view: ViewTransform, msaa: bool = False, debug: bool = False
    ) -> np.ndarray:
        """Render one frame: uint8 ``[H, W]`` page.  ``msaa``/``debug``
        select the glyph-tile mode (see ``rasterize_glyphs``)."""
        px_per_unit = view.scale[0] * (self.width / 2.0)
        if px_per_unit <= 0:
            raise ValueError("view scale must be positive")
        tiles, grids, tile = self.rasterize_glyphs(px_per_unit, msaa, debug)

        slots, offsets = self.layout.instance_arrays()
        if len(slots) == 0:
            return np.zeros((self.height, self.width), np.uint8)

        # pen position (em) -> NDC -> page pixels; y flips top-down
        # (vectorized f64, same IEEE results as the scalar loop;
        # np.round == Python round: both round-half-even)
        em = offsets.astype(np.float64)
        ndc_x = em[:, 0] * view.scale[0] + view.offset[0]
        ndc_y = (em[:, 1] * view.scale[1] + view.offset[1]) * view.aspect_ratio
        base_px = (ndc_x + 1.0) / 2.0 * self.width
        base_py = (1.0 - ndc_y) / 2.0 * self.height
        g_minx = np.array([g.min_x for g in grids], np.int64)[slots]
        g_maxy = np.array([g.max_y for g in grids], np.int64)[slots]
        # tile origin: glyph bbox anchor relative to the pen
        xs = (np.round(base_px).astype(np.int64) + g_minx).astype(np.int32)
        ys = (np.round(base_py).astype(np.int64) - g_maxy).astype(np.int32)
        page = composite_tiles(
            jnp.asarray(tiles),
            jnp.asarray(slots),
            jnp.asarray(xs),
            jnp.asarray(ys),
            page_h=self.height,
            page_w=self.width,
            tile=tile,
        )
        return np.asarray(page)
