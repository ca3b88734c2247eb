"""High-level raster engine.

The one place that decides which code rasters.  On the GPU and on the
CPU it is the row-binned plain XLA route (``kernels/winding.py``); any
other platform is an error, never a silent fallback.  A Pallas kernel
through Triton that fused phase A with per-pixel compares was measured
against this route on an H100 and lost on pages and tied on atlases
(``PERF.md``), so it was removed.

Shape discipline: segment streams and per-job capacities are bucketed
to powers of two (``kernels/winding.py:bucket``), so repeated atlases
and interactive edits reuse compiled code (the analog of the reference
building its pipelines once, ``src/Appli.zig:411-428``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fontrx.kernels.grid import RasterGrid
from fontrx.kernels.winding import (
    RowBins,
    bin_glyph_rows,
    full_rows,
    winding_bins_xla,
)
from fontrx.pack.segments import PackedBatch
from fontrx.utils.log import get_logger

log = get_logger("Engine")

PLATFORMS = ("gpu", "cpu")


def check_platform() -> str:
    """The platform JAX runs on, if fontrx has a route for it."""
    platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"fontrx has no raster route for platform {platform!r}")
    return platform


class RasterEngine:
    """Stateless raster dispatcher over the XLA route."""

    def __init__(self):
        self.platform = check_platform()

    # -- core entry points -------------------------------------------------

    def bins(self, segments, max_y, scale, *, height: int) -> RowBins:
        """Row bins of a glyph batch: culled on the host when the
        inputs are concrete, every segment in every band when traced
        (inside ``jit``/``shard_map``)."""
        if isinstance(segments, jax.core.Tracer) or isinstance(
                max_y, jax.core.Tracer):
            return full_rows(segments, height)
        return bin_glyph_rows(np.asarray(segments), np.asarray(max_y),
                              float(scale), height)

    def winding_bins(self, bins: RowBins, min_x, max_y, scale, *,
                     width: int, sample_offset=(0.0, 0.0)) -> jax.Array:
        """Winding maps of binned jobs: int32 ``[B, n_bands * 16, W]``."""
        with jax.profiler.TraceAnnotation("fontrx/raster"):
            return winding_bins_xla(
                bins.soa, bins.start, bins.count,
                jnp.asarray(min_x, jnp.int32), jnp.asarray(max_y, jnp.int32),
                jnp.asarray(scale, jnp.float32),
                jnp.asarray(sample_offset, jnp.float32),
                n_bands=bins.n_bands, cap=bins.cap, width=width,
            )

    def winding_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
        sample_offset=(0.0, 0.0),
    ) -> jax.Array:
        """Batched winding maps: int32 ``[B, H, W]``."""
        bins = self.bins(segments, max_y, scale, height=height)
        return self.winding_bins(
            bins, min_x, max_y, scale, width=width,
            sample_offset=sample_offset)[:, :height]

    def winding_glyph(self, segments, grid: RasterGrid) -> jax.Array:
        """Single-glyph winding map over an oracle-convention grid
        (BASELINE config 1)."""
        out = self.winding_batch(
            np.asarray(segments)[None],
            np.array([grid.min_x], np.int32),
            np.array([grid.max_y], np.int32),
            grid.scale,
            height=grid.height,
            width=grid.width,
        )
        return out[0]

    def winding_packed(
        self, batch: PackedBatch, font_size: int, units_per_em: int, tile: int
    ) -> tuple[jax.Array, list[RasterGrid]]:
        """Raster a ``PackedBatch`` into fixed ``tile x tile`` maps
        anchored at each glyph's bbox corner.  Returns ``([B, T, T]
        winding, per-glyph grids)``."""
        grids = [
            RasterGrid.fixed_tile(tuple(box), font_size, units_per_em, tile)
            for box in np.asarray(batch.boxes)
        ]
        out = self.winding_batch(
            batch.segments,
            np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32),
            grids[0].scale if grids else 1.0,
            height=tile,
            width=tile,
        )
        return out, grids

    def winding_split(
        self, split, font_size: int, units_per_em: int, tile: int
    ) -> tuple[jax.Array, list[RasterGrid]]:
        """Raster a :class:`~fontrx.pack.segments.SplitBatch`: one
        small-capacity launch over all rows, then an on-device
        ``segment_sum`` folds each glyph's rows back into its winding
        map — exact, because winding contributions are integer adds
        that commute across segment subsets.  Returns ``([G, T, T]
        winding, per-glyph grids)``."""
        grids = [
            RasterGrid.fixed_tile(tuple(box), font_size, units_per_em, tile)
            for box in np.asarray(split.boxes)
        ]
        rows = self.winding_batch(
            split.segments,
            np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32),
            grids[0].scale if grids else 1.0,
            height=tile,
            width=tile,
        )
        summed = jax.ops.segment_sum(
            rows,
            jnp.asarray(split.row_owner),
            num_segments=split.num_glyphs,
            indices_are_sorted=True,
        )
        # per-glyph grids: first row of each owner group
        first = np.searchsorted(split.row_owner, np.arange(split.num_glyphs))
        return summed, [grids[i] for i in first]

    def winding_hybrid(
        self, hb, font_size: int, units_per_em: int, tile: int
    ) -> tuple[jax.Array, list[RasterGrid]]:
        """Raster a :class:`~fontrx.pack.segments.HybridBatch`: one
        small-capacity launch over all rows; single-row glyphs (the
        common case) pass through with NO fold, and ``r``-row glyphs
        fold with one dense ``reshape(n, r, T, T).sum(axis=1)`` per
        distinct ``r``.  Returns ``([G, T, T] winding in hb.order, and
        per-glyph grids)``; exact because winding contributions commute
        across segment subsets."""
        grids = [
            RasterGrid.fixed_tile(tuple(box), font_size, units_per_em, tile)
            for box in np.asarray(hb.boxes)
        ]
        rows = self.winding_batch(
            hb.segments,
            np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32),
            grids[0].scale if grids else 1.0,
            height=tile,
            width=tile,
        )
        parts = []
        glyph_grids: list[RasterGrid] = []
        row = 0
        for r, n in hb.groups:
            block = rows[row : row + r * n]
            if r == 1:
                parts.append(block)
            else:
                parts.append(
                    block.reshape(n, r, tile, tile).sum(axis=1)
                )
            glyph_grids.extend(grids[row + k * r] for k in range(n))
            row += r * n
        if not parts:  # empty batch: no groups at all
            return jnp.zeros((0, tile, tile), jnp.int32), glyph_grids
        out = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        return out, glyph_grids

    def sdf_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
    ) -> jax.Array:
        """Batched SDF atlas: float32 ``[B, H, W]`` signed pixel
        distances, unclamped (callers clamp at their spread when
        quantizing)."""
        from fontrx.kernels.sdf import sdf_batch

        return sdf_batch(
            jnp.asarray(segments, jnp.float32),
            jnp.asarray(min_x, jnp.int32), jnp.asarray(max_y, jnp.int32),
            jnp.float32(scale), height=height, width=width,
        )

    def coverage_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
        samples: int = 2, x_shift: float = 0.0,
    ) -> jax.Array:
        """Batched k x k supersampled coverage (MSAA analog): float32
        ``[B, H, W]`` in [0, 1], as k^2 traced-offset passes of the
        winding route over one binning (one compile: the offset is a
        traced input).  ``x_shift`` moves the whole
        lattice horizontally (the LCD channels).  Bit-identical to
        ``kernels.coverage.coverage_batch``: each pass is the route's
        fill at that offset, and the mean of k^2 {0, 1} values is exact
        in f32."""
        from fontrx.kernels.coverage import sample_offsets

        bins = self.bins(segments, max_y, scale, height=height)
        offsets = sample_offsets(samples) + np.array([x_shift, 0.0],
                                                     np.float32)
        hits = None
        for off in offsets:
            w = self.winding_bins(
                bins, min_x, max_y, scale, width=width, sample_offset=off)
            hit = (w[:, :height] != 0).astype(jnp.int32)
            hits = hit if hits is None else hits + hit
        return hits.astype(jnp.float32) / jnp.float32(samples * samples)

    def lcd_coverage_batch(
        self, segments, min_x, max_y, scale, *, height: int, width: int,
        samples: int = 2,
    ) -> jax.Array:
        """LCD subpixel coverage: float32 ``[B, H, W, 3]`` — per RGB
        channel, the k x k coverage lattice shifted to that channel's
        horizontal subpixel center (R -1/3 px, G 0, B +1/3 px), the
        classic 3x1 striped-panel filter.  A capability extension (the
        reference has no subpixel rendering)."""
        return jnp.stack([
            self.coverage_batch(
                segments, min_x, max_y, scale, height=height, width=width,
                samples=samples, x_shift=shift)
            for shift in (-1.0 / 3.0, 0.0, 1.0 / 3.0)
        ], axis=-1)

    # -- fill conversions --------------------------------------------------

    @staticmethod
    def fill(winding: jax.Array) -> jax.Array:
        """Nonzero-winding rule -> 0/255 uint8 (``render_glyph.zig:29``)."""
        return jnp.where(winding != 0, 255, 0).astype(jnp.uint8)

    @staticmethod
    def gray(winding: jax.Array) -> jax.Array:
        """The reference's winding visualization
        (``render_glyph.zig:28``)."""
        return jnp.clip(winding * 20 + 100, 0, 255).astype(jnp.uint8)
