"""Packing normalized glyph outlines into fixed-shape segment tensors.

Everything downstream of this module is static-shape: XLA traces the
raster step once per ``(batch, S_max, H, W)`` bucket and reuses the
compiled executable for every subsequent batch (the equivalent of
the reference uploading each glyph's mesh once and reusing it per frame,
``src/Appli.zig:29,318-341``).

Padding policy: segments are padded with zeros, which contribute zero
winding (see package docstring).  ``S_max`` is rounded up to a multiple
of ``SEG_ALIGN`` to limit the number of distinct compiled shapes
(bucketing — SURVEY §7 "ragged segment counts" design decision).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from fontrx.font.glyph import Glyph

SEG_ALIGN = 64  # segment-count bucket granularity


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclass(frozen=True, slots=True)
class PackedGlyph:
    """One glyph as a padded segment array.

    ``segments``: float32 ``[S, 3, 2]`` — (p0, p1, p2) per quadratic, in
    font units.  ``box``: int ``(x_min, y_min, x_max, y_max)``.
    """

    segments: np.ndarray
    seg_count: int
    box: tuple[int, int, int, int]
    advance_width: int = 0

    @property
    def capacity(self) -> int:
        return self.segments.shape[0]


def ysort_segments(seg: np.ndarray) -> np.ndarray:
    """Reorder a ``[n, 3, 2]`` segment array by y-span midpoint
    (ascending, stable).

    Winding is an order-independent SUM of per-segment integer crossing
    contributions, so rasters are bit-identical under any segment order
    (pinned by ``test_ysort_bitexact``).  y-coherent order is purely a
    performance property: consecutive segments reach the same rows."""
    if len(seg) < 2:
        return seg
    ymid = seg[:, :, 1].min(axis=1) + seg[:, :, 1].max(axis=1)
    order = np.argsort(ymid, kind="stable")
    return seg[order]


def xsort_segments(seg: np.ndarray) -> np.ndarray:
    """Reorder a ``[n, 3, 2]`` segment array by x-span midpoint
    (ascending, stable) — the dense single-strip twin of
    :func:`ysort_segments`.  In a one-strip tile the y-cull has
    nothing to cull; the column-major dense kernel
    (``kernels/winding_dense.py``) instead culls per-chunk crossing
    **x-windows**, which x-coherent order makes narrow.  Bit-exact
    under reordering for the same reason as the y-sort (integer
    winding sums commute)."""
    if len(seg) < 2:
        return seg
    xmid = seg[:, :, 0].min(axis=1) + seg[:, :, 0].max(axis=1)
    order = np.argsort(xmid, kind="stable")
    return seg[order]


def glyph_segments(glyph: Glyph) -> np.ndarray:
    """Flatten a glyph's contours to an un-padded ``[n, 3, 2]`` float32
    segment array, in contour order.  Each contour with points
    ``p[0..2k]`` yields segments ``(p[2i], p[2i+1], p[2i+2])`` (the
    even/odd invariant).  Raster packing re-orders with
    :func:`ysort_segments`; this function preserves outline order for
    geometry consumers."""
    chunks = []
    for contour in glyph.contours:
        pts = contour.points
        k = len(pts) // 2
        if k == 0:
            continue
        seg = np.stack([pts[0 : 2 * k : 2], pts[1 : 2 * k : 2], pts[2 : 2 * k + 1 : 2]], axis=1)
        chunks.append(seg)
    if not chunks:
        return np.empty((0, 3, 2), dtype=np.float32)
    return np.concatenate(chunks, axis=0).astype(np.float32)


def pack_glyph(
    glyph: Glyph, capacity: int | None = None, advance_width: int = 0
) -> PackedGlyph:
    """Pack one glyph, zero-padding to ``capacity`` (default: segment
    count rounded up to ``SEG_ALIGN``)."""
    seg = ysort_segments(glyph_segments(glyph))
    n = len(seg)
    if capacity is None:
        capacity = max(_round_up(n, SEG_ALIGN), SEG_ALIGN)
    if n > capacity:
        raise ValueError(f"glyph has {n} segments > capacity {capacity}")
    padded = np.zeros((capacity, 3, 2), dtype=np.float32)
    padded[:n] = seg
    box = (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max)
    return PackedGlyph(padded, n, box, advance_width)


@dataclass(frozen=True, slots=True)
class PackedBatch:
    """A batch of glyphs padded to a common segment capacity.

    - ``segments``: float32 ``[B, S, 3, 2]``
    - ``seg_counts``: int32 ``[B]``
    - ``boxes``: int32 ``[B, 4]`` (x_min, y_min, x_max, y_max)
    - ``advance_widths``: int32 ``[B]``
    """

    segments: np.ndarray
    seg_counts: np.ndarray
    boxes: np.ndarray
    advance_widths: np.ndarray

    def __len__(self) -> int:
        return self.segments.shape[0]

    @property
    def capacity(self) -> int:
        return self.segments.shape[1]


def pack_glyphs(
    glyphs: Sequence[Glyph],
    advance_widths: Iterable[int] | None = None,
    capacity: int | None = None,
    pad_batch_to: int | None = None,
    sort: str = "y",
) -> PackedBatch:
    """Pack many glyphs into one batch tensor (atlas upload).

    ``pad_batch_to`` optionally pads the batch dimension with empty
    glyphs — used to make the batch divisible by a device-mesh axis.
    ``sort``: segment order — ``"y"`` (default; the multi-strip y-cull
    order) or ``"x"`` (the dense single-strip kernel's x-window order).
    Bit-identical either way (winding sums commute).
    """
    sorter = xsort_segments if sort == "x" else ysort_segments
    seg_arrays = [sorter(glyph_segments(g)) for g in glyphs]
    counts = [len(s) for s in seg_arrays]
    if capacity is None:
        capacity = max(_round_up(max(counts, default=0), SEG_ALIGN), SEG_ALIGN)
    b = len(glyphs)
    if pad_batch_to is not None:
        b = max(b, pad_batch_to)
    segments = np.zeros((b, capacity, 3, 2), dtype=np.float32)
    seg_counts = np.zeros(b, dtype=np.int32)
    boxes = np.zeros((b, 4), dtype=np.int32)
    for i, (g, seg, n) in enumerate(zip(glyphs, seg_arrays, counts)):
        if n > capacity:
            raise ValueError(f"glyph {i} has {n} segments > capacity {capacity}")
        segments[i, :n] = seg
        seg_counts[i] = n
        boxes[i] = (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max)
    aw = np.zeros(b, dtype=np.int32)
    if advance_widths is not None:
        for i, w in enumerate(advance_widths):
            aw[i] = w
    return PackedBatch(segments, seg_counts, boxes, aw)


@dataclass(frozen=True, slots=True)
class SplitBatch:
    """A split-packed glyph set: every glyph occupies
    ``ceil(seg_count / capacity)`` consecutive rows of one
    ``[R, capacity, 3, 2]`` tensor.

    Soundness: the winding number is a SUM of per-segment crossing
    contributions (integer adds, order-independent), so the winding map
    of a glyph equals the elementwise sum of its rows' winding maps —
    exactly, not approximately.  This lets one small-capacity kernel
    launch cover a whole ragged charset with no per-bucket launches and
    bounded padding waste (< capacity segments per glyph).
    """

    segments: np.ndarray        # float32 [R, capacity, 3, 2]
    seg_counts: np.ndarray      # int32 [R] live segments per row
    boxes: np.ndarray           # int32 [R, 4] (glyph box, duplicated)
    row_owner: np.ndarray       # int32 [R] glyph index per row (sorted)
    num_glyphs: int
    advance_widths: np.ndarray  # int32 [num_glyphs]

    def __len__(self) -> int:
        return self.segments.shape[0]

    @property
    def capacity(self) -> int:
        return self.segments.shape[1]


def pack_glyphs_split(
    glyphs: Sequence[Glyph],
    advance_widths: Iterable[int] | None = None,
    capacity: int = 64,
) -> SplitBatch:
    """Split-pack ``glyphs`` into one ``capacity``-segment batch (see
    :class:`SplitBatch`).  Empty glyphs still get one (all-zero) row so
    every glyph owns at least one row."""
    aw = list(advance_widths) if advance_widths is not None else [0] * len(glyphs)
    # y-sorting before the split also makes each SPLIT ROW y-coherent
    seg_arrays = [ysort_segments(glyph_segments(g)) for g in glyphs]
    n_rows = [max((len(s) + capacity - 1) // capacity, 1) for s in seg_arrays]
    total = sum(n_rows)
    segments = np.zeros((total, capacity, 3, 2), dtype=np.float32)
    seg_counts = np.zeros(total, dtype=np.int32)
    boxes = np.zeros((total, 4), dtype=np.int32)
    row_owner = np.zeros(total, dtype=np.int32)
    r = 0
    for gi, (g, seg) in enumerate(zip(glyphs, seg_arrays)):
        box = (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max)
        for start in range(0, max(len(seg), 1), capacity):
            part = seg[start : start + capacity]
            segments[r, : len(part)] = part
            seg_counts[r] = len(part)
            boxes[r] = box
            row_owner[r] = gi
            r += 1
    return SplitBatch(
        segments, seg_counts, boxes, row_owner,
        len(glyphs), np.asarray(aw, np.int32),
    )


def pack_glyphs_bucketed(
    glyphs: Sequence[Glyph],
    advance_widths: Iterable[int] | None = None,
    bucket_sizes: Sequence[int] = (64, 128, 256, 512, 1024),
    min_occupancy: int = 8,
) -> list[tuple[PackedBatch, list[int]]]:
    """Pack glyphs into segment-capacity buckets to bound padding waste
    on ragged sets (SURVEY §7's central packing decision: a CJK charset
    spans 0..1000+ segments; one shared capacity wastes ~90% of the
    segment tensor).

    Buckets holding fewer than ``min_occupancy`` glyphs fold into the
    nearest larger *non-empty* bucket: each raster launch carries a
    fixed dispatch cost, so a near-empty bucket costs more in launches
    than its tighter capacity saves in compute (DejaVuSans' cap-512
    bucket holds 2 glyphs and its cap-1024 bucket 1 — merging them
    turns two launches into one).  Merging into
    an empty larger bucket is never done: that would keep the launch
    count while inflating capacity.

    Returns ``[(batch, original_indices), ...]`` — one batch per
    non-empty bucket, each raster-able independently (compiled once per
    bucket shape); ``original_indices`` maps rows back to the input
    order.
    """
    aw = list(advance_widths) if advance_widths is not None else [0] * len(glyphs)
    buckets: dict[int, list[int]] = {}
    for i, g in enumerate(glyphs):
        n = g.num_segments
        for cap in bucket_sizes:
            if n <= cap:
                buckets.setdefault(cap, []).append(i)
                break
        else:
            raise ValueError(
                f"glyph {i} has {n} segments > max bucket {bucket_sizes[-1]}"
            )
    for cap in sorted(buckets):
        idxs = buckets[cap]
        if not idxs or len(idxs) >= min_occupancy:
            continue
        larger = [c for c in sorted(buckets) if c > cap and buckets[c]]
        if larger:
            buckets[larger[0]] = idxs + buckets[larger[0]]
            buckets[cap] = []
    out = []
    for cap in sorted(buckets):
        idxs = buckets[cap]
        if not idxs:
            continue
        batch = pack_glyphs(
            [glyphs[i] for i in idxs],
            [aw[i] for i in idxs],
            capacity=cap,
        )
        out.append((batch, idxs))
    return out


@dataclass(frozen=True, slots=True)
class HybridBatch:
    """Split-pack with rows grouped by per-glyph row count.

    The tail-bucket economics fix (docs/RESULTS.md "Stress"): capacity
    bucketing pays one kernel launch per bucket, and the plain split
    packing pays a ``segment_sum`` over EVERY row (measured 76 ms on a
    6k-glyph atlas — XLA lowers it as scatter-add).  Here single-row
    glyphs — the overwhelming majority — pass through the raster with
    no fold at all, and glyphs needing ``r`` rows fold with one dense
    ``reshape(n, r, T, T).sum(axis=1)`` per distinct ``r`` (a handful
    of fast, scatter-free reductions).  Exact, because winding
    contributions are integer adds that commute across segment subsets.

    - ``segments``: float32 ``[R, capacity, 3, 2]``, group-major: all
      1-row glyphs' rows, then 2-row glyphs (2 consecutive rows each),
      then 3-row, ...
    - ``groups``: ``((rows_per_glyph, n_glyphs), ...)`` in row order
    - ``order``: int32 ``[G]`` original glyph index per OUTPUT slot
      (group-major)
    """

    segments: np.ndarray
    boxes: np.ndarray           # int32 [R, 4] glyph box per row
    groups: tuple[tuple[int, int], ...]
    order: np.ndarray
    advance_widths: np.ndarray  # int32 [G] in output (group-major) order

    def __len__(self) -> int:
        return self.segments.shape[0]

    @property
    def num_glyphs(self) -> int:
        return len(self.order)

    @property
    def capacity(self) -> int:
        return self.segments.shape[1]


def pack_glyphs_hybrid(
    glyphs: Sequence[Glyph],
    advance_widths: Iterable[int] | None = None,
    capacity: int = 64,
) -> HybridBatch:
    """Pack ``glyphs`` into one ``capacity``-segment batch with rows
    grouped by per-glyph row count (see :class:`HybridBatch`)."""
    aw = list(advance_widths) if advance_widths is not None else [0] * len(glyphs)
    seg_arrays = [ysort_segments(glyph_segments(g)) for g in glyphs]
    n_rows = [max((len(s) + capacity - 1) // capacity, 1) for s in seg_arrays]

    by_r: dict[int, list[int]] = {}
    for gi, r in enumerate(n_rows):
        by_r.setdefault(r, []).append(gi)

    total = sum(n_rows)
    segments = np.zeros((total, capacity, 3, 2), dtype=np.float32)
    boxes = np.zeros((total, 4), dtype=np.int32)
    order: list[int] = []
    groups: list[tuple[int, int]] = []
    row = 0
    for r in sorted(by_r):
        idxs = by_r[r]
        groups.append((r, len(idxs)))
        for gi in idxs:
            g = glyphs[gi]
            seg = seg_arrays[gi]
            boxes[row : row + r] = (
                g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max,
            )
            for k in range(r):
                part = seg[k * capacity : (k + 1) * capacity]
                segments[row + k, : len(part)] = part
            order.append(gi)
            row += r
    return HybridBatch(
        segments, boxes, tuple(groups),
        np.asarray(order, np.int32),
        np.asarray([aw[i] for i in order], np.int32),
    )
