"""Normalized glyph outlines.

Behavioral equivalent of the reference's ``src/font/Glyph.zig``: every
contour is normalized to a pure sequence of quadratic Bezier segments
holding the invariant *even-index points are on-curve, odd-index points
are off-curve controls, and the last point equals the first*
(``Glyph.zig:11-24``).  Implied on-curve midpoints are inserted wherever
two consecutive TrueType points share their on/off state, with the
midpoint truncated to integer coordinates exactly like the reference
(``Glyph.zig:55-57`` notes the rounding; ``geometry.zig:12-17`` is
``@divTrunc``), so downstream rasters stay bit-comparable.

Re-design notes (array-first): points are NumPy ``int32 [n, 2]`` arrays —
contours stay in one flat buffer per glyph with offsets, ready for
zero-copy segment packing (``fontrx.pack``).  The normalization itself
is vectorized (index arithmetic + cumsum) instead of the reference's
per-point loop, which matters when packing thousand-glyph CJK atlases.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fontrx.font import ttf
from fontrx.utils.log import get_logger

log = get_logger("Glyph")


@dataclass(frozen=True, slots=True)
class Box:
    x_min: int
    y_min: int
    x_max: int
    y_max: int


@dataclass(frozen=True, slots=True)
class Contour:
    """One closed contour.  ``points`` is ``int32 [2k+1, 2]`` satisfying
    the even-on-curve / odd-off-curve / closed invariant, so it encodes
    exactly ``k`` quadratic segments ``(p[2i], p[2i+1], p[2i+2])``."""

    points: np.ndarray

    @property
    def num_segments(self) -> int:
        return len(self.points) // 2


@dataclass(frozen=True, slots=True)
class Glyph:
    box: Box
    contours: tuple[Contour, ...]

    @property
    def num_segments(self) -> int:
        return sum(c.num_segments for c in self.contours)

    @classmethod
    def empty(cls) -> "Glyph":
        """Empty glyph (e.g. space) — reference ``initEmpty``
        (``Glyph.zig:77-82``)."""
        return cls(Box(0, 0, 0, 0), ())


def _trunc_midpoint(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Integer midpoint truncated toward zero (``geometry.zig:12-17``)."""
    s = a.astype(np.int64) + b.astype(np.int64)
    return (np.sign(s) * (np.abs(s) // 2)).astype(np.int32)


def _normalize_contour(points: np.ndarray, on_curve: np.ndarray) -> np.ndarray:
    """Normalize one TTF contour to the even/odd invariant.

    Vectorized equivalent of ``Contour.initTTF`` (``Glyph.zig:43-74``):
    walking points with the *previous* point starting at the contour's
    last point, inserting a truncated midpoint whenever prev/curr share
    on-curve state, then closing the loop so ``out[0] == out[-1]`` and
    ``out[0]`` is on-curve.
    """
    n = len(points)
    if n == 0:
        return np.empty((0, 2), dtype=np.int32)
    prev_on = np.roll(on_curve, 1)          # prev of point i is point i-1 (wrap)
    prev_pts = np.roll(points, 1, axis=0)
    insert_mid = prev_on == on_curve        # midpoint precedes point i

    # Output slot of point i: slot0 reserved iff the wrap point (last) is
    # on-curve; each point occupies 1 slot, plus 1 for its midpoint.
    base = 1 if on_curve[-1] else 0
    sizes = insert_mid.astype(np.int64) + 1
    ends = np.cumsum(sizes) + base          # slot just past point i
    point_slots = ends - 1
    mid_slots = ends - 2                    # only valid where insert_mid

    total = int(ends[-1]) + (0 if on_curve[-1] else 1)
    out = np.empty((total, 2), dtype=np.int32)
    out[point_slots] = points
    if insert_mid.any():
        out[mid_slots[insert_mid]] = _trunc_midpoint(
            prev_pts[insert_mid], points[insert_mid]
        )
    if on_curve[-1]:
        out[0] = out[ends[-1] - 1]          # close: first slot = last point
    else:
        out[-1] = out[0]                    # close: append first point
    return out


def from_simple(desc: ttf.GlyphDescription, data: ttf.SimpleGlyph) -> Glyph:
    """Build a normalized glyph from a decoded simple glyph
    (``Glyph.initTTFSimple``, ``Glyph.zig:84-106``).

    Glyph hinting instructions are ignored: the analytic winding fill is
    resolution-independent, so grid-fitting has no effect on coverage
    (the reference panics here, ``Glyph.zig:85``; we degrade gracefully
    per SURVEY §5.3).
    """
    if len(data.instructions) > 0:
        log.debug("ignoring %d bytes of glyph instructions (hinting unsupported)",
                  len(data.instructions))
    contours: list[Contour] = []
    start = 0
    for end in data.end_pts_of_contours:
        stop = int(end) + 1
        pts = _normalize_contour(
            data.coordinates[start:stop].astype(np.int32),
            data.on_curve[start:stop],
        )
        contours.append(Contour(pts))
        start = stop
    box = Box(desc.x_min, desc.y_min, desc.x_max, desc.y_max)
    return Glyph(box, tuple(contours))


def _component_transform(
    points: np.ndarray, part: ttf.ComponentPart
) -> np.ndarray:
    """Apply a component's 2.14 transform + offset to int points, with
    TrueType's shift-compensation quirk.

    Semantics of ``transform1`` (``Glyph.zig:178-182``): for each output
    axis with matrix row ``(m0, m1)`` (raw 2.14 ints) and offset ``e``:

        raw_axis = m0*x + m1*y + max(|m0|,|m1|) * shift
        shift    = 2*e  if ||m0| - |m1|| <= 8  else  e
        value    = raw_axis / 16384

    x' uses (a, c, arg1); y' uses (b, d, arg2) (``Glyph.zig:138-139``).
    Returns float64 values in font units (rounding handled by caller).
    """
    a, b, c, d = (t.data for t in part.transform)
    x = points[:, 0].astype(np.int64)
    y = points[:, 1].astype(np.int64)

    def axis(m0: int, m1: int, e: int) -> np.ndarray:
        tmp = max(abs(m0), abs(m1))
        # wrapped-i16 distance between |m0| and |m1| (``Glyph.zig:180``)
        diff = (abs(m0) - abs(m1)) & 0xFFFF
        if diff >= 0x8000:
            diff -= 0x10000
        shift = e * 2 if abs(diff) <= 8 else e
        raw = m0 * x + m1 * y + tmp * shift
        return raw / 16384.0

    return np.stack([axis(a, c, part.argument1), axis(b, d, part.argument2)], axis=1)


def _round_half_away(v: np.ndarray) -> np.ndarray:
    return (np.sign(v) * np.floor(np.abs(v) + 0.5)).astype(np.int32)


def from_component(
    desc: ttf.GlyphDescription,
    data: ttf.ComponentGlyph,
    resolve: "dict[int, Glyph]",
) -> Glyph:
    """Flatten a compound glyph into one outline
    (``Glyph.initTTFComponent``, ``Glyph.zig:108-165``).

    ``resolve`` maps component glyph indices to already-loaded glyphs
    (the caller — ``Font.load_glyph`` — handles recursion and cycle
    detection, ``Font.zig:204-220``).
    """
    # USE_MY_METRICS (data.metrics_index) is handled by the caller:
    # Font.load_glyph patches the composite's advance from the flagged
    # component's hmtx entry
    contours: list[Contour] = []
    for part in data.parts:
        if not part.args_are_xy_values:
            raise NotImplementedError(
                "compound glyph with point-index arguments not implemented"
            )
        part_glyph = resolve[part.glyph_index]
        for contour in part_glyph.contours:
            vals = _component_transform(contour.points, part)
            if part.round_xy_to_grid:
                pts = _round_half_away(vals)
            else:
                pts = vals.astype(np.int32)  # truncate toward zero
                if not np.array_equal(pts.astype(np.float64), vals):
                    # reference panics on non-integral untransformed points
                    # (``Glyph.zig:146-147``); we round and continue.
                    log.warning("non-integral component points; rounding")
                    pts = _round_half_away(vals)
            contours.append(Contour(pts))
    box = Box(desc.x_min, desc.y_min, desc.x_max, desc.y_max)
    return Glyph(box, tuple(contours))


def transform_glyph(glyph: Glyph, xf) -> Glyph:
    """General affine image of a glyph: ``x' = xx*x + xy*y + dx``,
    ``y' = yx*x + yy*y + dy`` on every control point (COLR v1 paint
    transforms; control points stay float — layer rasters sample the
    exact affine image, and quadratics are affine-invariant)."""
    xx, yx, xy, yy, dx, dy = (float(v) for v in xf)
    if (xx, yx, xy, yy, dx, dy) == (1.0, 0.0, 0.0, 1.0, 0.0, 0.0):
        return glyph
    if not glyph.contours:
        return glyph
    contours = []
    xs = []
    ys = []
    for c in glyph.contours:
        p = c.points.astype(np.float64)
        q = np.empty_like(p)
        q[:, 0] = xx * p[:, 0] + xy * p[:, 1] + dx
        q[:, 1] = yx * p[:, 0] + yy * p[:, 1] + dy
        contours.append(Contour(q.astype(np.float32)))
        xs.append(q[:, 0])
        ys.append(q[:, 1])
    ax = np.concatenate(xs)
    ay = np.concatenate(ys)
    box = Box(
        int(np.floor(ax.min())), int(np.floor(ay.min())),
        int(np.ceil(ax.max())), int(np.ceil(ay.max())),
    )
    return Glyph(box, tuple(contours))


def shear_glyph(glyph: Glyph, slant: float) -> Glyph:
    """Synthetic oblique: ``x' = x + slant * y`` on every control point
    (rounded to integer font units, like any native outline).  Affine
    images of quadratics are the quadratics through the mapped control
    points, so winding/SDF/triangulation all stay exact.  A capability
    extension (the reference renders upright outlines only)."""
    if slant == 0.0 or not glyph.contours:
        return glyph
    contours = []
    xs = []
    ys = []
    for c in glyph.contours:
        p = c.points.astype(np.float64)
        q = np.empty_like(p)
        q[:, 0] = p[:, 0] + slant * p[:, 1]
        q[:, 1] = p[:, 1]
        qi = np.round(q).astype(np.int32)
        contours.append(Contour(qi))
        xs.append(qi[:, 0])
        ys.append(qi[:, 1])
    ax = np.concatenate(xs)
    ay = np.concatenate(ys)
    box = Box(int(ax.min()), int(ay.min()), int(ax.max()), int(ay.max()))
    return Glyph(box, tuple(contours))
