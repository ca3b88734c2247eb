"""Row-binned winding fill on XLA (GPU and CPU), and its binning.

Every raster (an atlas of glyph tiles or a whole page) is cut into
*jobs*: one image ``b`` times one band of ``BAND_ROWS`` pixel rows.
Each job reads one contiguous range ``[start, start + count)`` of a
segment stream; the range holds every segment whose control hull can
reach the band's rows.  A superset is harmless, and a segment left out
contributes nothing: the float program counts a crossing only on rows
inside the segment's control hull, so culling is exact by definition
(and band renders equal the same rows of full renders).  The stream is stored structure of
arrays, ``soa[6, N]`` = ``(p0x, p0y, p1x, p1y, p2x, p2y)``.

A job runs in two phases:

- **phase A**, per (segment, row): the quadratic root solve of
  ``oracle.winding_at``, op for op, giving up to two crossing x
  positions with their winding signs (:func:`phase_a_roots`);
- **phase B**, per pixel: the sum of the signs of the crossings at or
  right of the pixel's sample.

Phase B here is a histogram: sample x positions grow with the column
(an integer add, an f32 add and a correctly rounded f32 divide are all
monotone), so the pixels a crossing reaches are a prefix of the row,
found by a binary search over the row's own sample positions.  Each
crossing adds its sign at the end of its prefix and a reverse
cumulative sum spreads it, which keeps phase B at O(crossings + pixels)
and every decision the oracle's ``xx >= cx`` compare on the same f32
values.  Integer sums commute, so the result is bit-identical to the
oracle whatever the binning or order.

Division and sqrt are the correctly rounded emulations of
``fontrx.kernels.exactmath``: XLA's f32 ``/`` and ``sqrt`` on the GPU are
not IEEE-correct, and the fills' tie pixels turn on their last bit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from fontrx.kernels.exactmath import div_cr, sqrt_cr

BAND_ROWS = 16
# binning slack in segment units: covers the float slop of a root
# solve near the hull edge (em units are ~1e3 and pixels ~1e3, where
# f32 slop is ~1e-4)
HULL_GUARD = 1.0
# sample offsets (MSAA, LCD) move samples by at most this many pixels;
# one binning serves every offset inside it
SAMPLE_MARGIN_PX = 1.0


def phase_a_roots(p0x, p0y, p1x, p1y, p2x, p2y, cy, fdiv, fsqrt):
    """The per-(segment, row) root solve: THE float program whose
    per-crossing semantics match ``oracle.winding_at`` op for op (and
    therefore must never change silently).

    Control points broadcast against the row em-y ``cy``.  Returns
    ``(xx0, xx1, s0, s1)``: crossing x positions with dead crossings at
    -inf, and their int32 signs (0 when dead).  Slot 0 holds the linear
    crossing or the + root, slot 1 the - root.
    """
    a = p0y - 2 * p1y + p2y
    ax = p0x - 2 * p1x + p2x
    bx = 2 * (p1x - p0x)
    lin = a == 0
    denom = p2y - p0y
    py01 = p0y - p1y

    delta = cy * a + p1y * p1y - p0y * p2y
    has = jnp.logical_not(lin) & (delta >= 0)
    sq = fsqrt(jnp.maximum(delta, 0.0))

    # a zero divisor only feeds lanes the masks below discard
    t_lin = fdiv(cy - p0y, denom)
    t_pos = fdiv(py01 + sq, a)
    t_neg = fdiv(py01 - sq, a)

    # the curve never leaves its control hull: a root found for a row
    # outside it is cancellation noise of a near-flat quadratic (page
    # transforms turn straight em segments into a ~ 1e-5 ones)
    in_hull = ((cy >= jnp.minimum(jnp.minimum(p0y, p1y), p2y))
               & (cy <= jnp.maximum(jnp.maximum(p0y, p1y), p2y)))
    t0 = jnp.where(lin, t_lin, t_pos)
    v0_base = (lin & (denom != 0)) | has
    v0 = v0_base & in_hull & (t0 >= 0) & (t0 < 1)
    t1 = t_neg
    v1 = has & in_hull & (t1 >= 0) & (t1 < 1)

    xx0 = (ax * t0 + bx) * t0 + p0x
    xx1 = (ax * t1 + bx) * t1 + p0x
    dy0 = a * t0 + (p1y - p0y)
    sgn_lin = jnp.where(p0y < p2y, -1, 1)
    s0 = jnp.where(
        v0, jnp.where(lin, sgn_lin, jnp.where(dy0 > 0, -1, 1)), 0,
    ).astype(jnp.int32)
    dy1 = a * t1 + (p1y - p0y)
    s1 = jnp.where(v1, jnp.where(dy1 > 0, -1, 1), 0).astype(jnp.int32)
    neg_inf = jnp.float32(-jnp.inf)
    xx0 = jnp.where(s0 != 0, xx0, neg_inf)
    xx1 = jnp.where(s1 != 0, xx1, neg_inf)
    return xx0, xx1, s0, s1


def bucket(n: int, floor: int = 8) -> int:
    """Power-of-two capacity bucket: shapes that depend on data (a
    job's segment count, a stream length) take few values, so edits
    and new atlases reuse compiled code."""
    p = floor
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class RowBins:
    """A binned segment stream (see the module docstring).

    ``soa``: f32 ``[6, N]``; ``start``/``count``: int32 ``[J]`` with
    ``J = images * n_bands`` (job ``b * n_bands + k`` = image ``b``,
    rows ``[k * BAND_ROWS, (k + 1) * BAND_ROWS)``); ``cap``: a static
    bound on ``count``."""

    soa: jax.Array
    start: jax.Array
    count: jax.Array
    n_bands: int
    cap: int


def bin_glyph_rows(segments, max_y, scale, height: int) -> RowBins:
    """Bin HOST glyph segments ``[B, S, 3, 2]`` (em units) by row band.

    ``max_y`` are the per-glyph top-row anchors and ``scale`` pixels
    per unit (the raster grid of ``winding_bins_xla``).  Each job's
    list holds the glyph's live segments whose y hull reaches the band
    (widened by :data:`SAMPLE_MARGIN_PX` and :data:`HULL_GUARD`), in
    pack order."""
    seg = np.asarray(segments, np.float32)
    b, s = seg.shape[:2]
    n_bands = -(-height // BAND_ROWS)
    max_y = np.asarray(max_y, np.float64).reshape(b)
    scale = float(scale)
    live = np.any(seg.reshape(b, s, 6) != 0, axis=-1)
    ys = seg[..., 1]
    r0 = np.arange(n_bands) * BAND_ROWS
    hi = (max_y[:, None] - r0[None, :] + SAMPLE_MARGIN_PX) / scale
    lo = (max_y[:, None] - (r0 + BAND_ROWS - 1)[None, :]
          - SAMPLE_MARGIN_PX) / scale
    hit = (live[:, None, :]
           & (ys.max(-1)[:, None, :] >= lo[:, :, None] - HULL_GUARD)
           & (ys.min(-1)[:, None, :] <= hi[:, :, None] + HULL_GUARD))
    job, pos = np.nonzero(hit.reshape(b * n_bands, s))
    src = (job // n_bands) * s + pos
    count = hit.reshape(b * n_bands, s).sum(axis=1).astype(np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    n = bucket(len(src), 1024)
    soa = np.zeros((6, n), np.float32)
    soa[:, : len(src)] = seg.reshape(b * s, 6)[src].T
    return RowBins(
        soa=jnp.asarray(soa), start=jnp.asarray(start),
        count=jnp.asarray(count), n_bands=n_bands,
        cap=bucket(int(count.max(initial=0))),
    )


def full_rows(segments, height: int) -> RowBins:
    """Traceable, unculled binning: every band of glyph ``b`` reads all
    of ``segments[b]`` (device arrays inside ``jit``/``shard_map``)."""
    b, s = segments.shape[:2]
    n_bands = -(-height // BAND_ROWS)
    soa = jnp.asarray(segments, jnp.float32).reshape(b * s, 6).T
    start = jnp.repeat(jnp.arange(b, dtype=jnp.int32) * s, n_bands)
    count = jnp.full(b * n_bands, s, jnp.int32)
    return RowBins(soa=soa, start=start, count=count, n_bands=n_bands,
                   cap=s)


def _count_le(cx, xx):
    """Per job: how many of the row's (non-decreasing) sample x
    positions ``cx [W]`` are <= each crossing in ``xx``."""
    return jnp.searchsorted(cx, xx, side="right").astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("n_bands", "cap", "width"))
def winding_bins_xla(soa, start, count, min_x, max_y, scale, offset, *,
                     n_bands, cap, width):
    """Winding maps of binned jobs.

    ``min_x``/``max_y``: int32 ``[B]`` grid anchors; ``scale``: f32
    pixels per segment unit; ``offset``: f32 ``(ox, oy)`` sample offset
    in pixels (traced: MSAA passes share one compile).  Returns int32
    ``[B, n_bands * BAND_ROWS, width]``, row 0 at the top.  Sample
    ``(r, c)`` sits at em ``((min_x + c + ox) / scale,
    (max_y - r + oy) / scale)`` (``render_glyph.zig:26-27``)."""
    scale = jnp.asarray(scale, jnp.float32)
    offset = jnp.asarray(offset, jnp.float32)
    n_img = min_x.shape[0]
    n_jobs = start.shape[0]
    job = jnp.arange(n_jobs)
    img = job // n_bands
    k = jnp.arange(cap)
    live = k[None, :] < count[:, None]                        # [J, cap]
    idx = jnp.where(live, start[:, None] + k[None, :], 0)
    p = jnp.where(live[None], soa[:, idx], 0.0)[..., None]    # [6, J, cap, 1]
    rows = (job % n_bands)[:, None] * BAND_ROWS + jnp.arange(BAND_ROWS)
    cy = div_cr((max_y[img][:, None] - rows).astype(jnp.float32)
                + offset[1], scale)                           # [J, BH]
    xx0, xx1, s0, s1 = phase_a_roots(
        p[0], p[1], p[2], p[3], p[4], p[5], cy[:, None, :], div_cr, sqrt_cr)
    cx = div_cr((min_x[:, None] + jnp.arange(width)).astype(jnp.float32)
                + offset[0], scale)                           # [B, W]
    count_le = jax.vmap(_count_le)
    cxj = cx[img]
    flat = (n_jobs, cap * BAND_ROWS)  # explicit: batches may be empty
    col0 = count_le(cxj, xx0.reshape(flat)).reshape(xx0.shape)
    col1 = count_le(cxj, xx1.reshape(flat)).reshape(xx1.shape)
    jj = job[:, None, None]
    rr = jnp.arange(BAND_ROWS)[None, None, :]
    hist = jnp.zeros((n_jobs, BAND_ROWS, width + 1), jnp.int32)
    hist = hist.at[jj, rr, col0].add(s0, mode="drop")
    hist = hist.at[jj, rr, col1].add(s1, mode="drop")
    wind = jax.lax.cumsum(hist, axis=2, reverse=True)[..., 1:]
    return wind.reshape(n_img, n_bands * BAND_ROWS, width)


def winding_batch(segments, min_x, max_y, scale, *, height, width,
                  sample_offset=(0.0, 0.0)):
    """Unculled winding maps of a glyph batch ``[B, S, 3, 2]`` on the
    XLA route, traceable: int32 ``[B, height, width]``."""
    bins = full_rows(segments, height)
    out = winding_bins_xla(
        bins.soa, bins.start, bins.count,
        jnp.asarray(min_x, jnp.int32), jnp.asarray(max_y, jnp.int32),
        scale, jnp.asarray(sample_offset, jnp.float32),
        n_bands=bins.n_bands, cap=bins.cap, width=width,
    )
    return out[:, :height]


def winding_grid(segments, grid):
    """Single glyph over a ``RasterGrid``: int32 ``[H, W]``."""
    return winding_batch(
        jnp.asarray(segments)[None],
        jnp.array([grid.min_x], jnp.int32),
        jnp.array([grid.max_y], jnp.int32),
        jnp.float32(grid.scale),
        height=grid.height, width=grid.width,
    )[0]
