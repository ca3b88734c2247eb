"""COLR/CPAL color glyph layers (capability extension).

The reference renders monochrome outlines only (its pipeline has no
color tables at all — ``src/font/ttf.zig`` parses the glyf family and
``render_glyph.zig`` emits single-channel winding/fill); fontrx adds
the OpenType color-layer subsystem: COLR v0 maps a base glyph to an
ordered stack of layer glyphs, each painted in a CPAL palette color,
composited src-over bottom-to-top.

Scope: COLR **version 0** (layer records) plus a broad **version 1**
subset: BaseGlyphList paint graphs built from PaintColrLayers /
PaintGlyph / PaintColrGlyph with Paint(Var)Solid and linear/radial
gradient fills (pad/repeat/reflect extends) and the full
transform family (PaintTransform / Translate / Scale[Uniform]
[AroundCenter] / Rotate[AroundCenter] / Skew[AroundCenter], Var
variants at base values) — transforms accumulate along the walk,
bake into the layer outline (quadratics are affine-invariant) and
inverse-map gradient fields.  PaintComposite nodes build a
render TREE (all 28 CompositeModes: Porter-Duff CLEAR..PLUS plus the
W3C separable and HSL blend modes).  A graph touching any other
paint falls back to the glyph's v0 record when present, else to the
monochrome outline — documented
degradation, never an error.  CPAL v0 and v1 are parsed (v1's
palette-type/label arrays are skipped; they only annotate).

Layer rasters ride the existing batched coverage pipeline — layers are
just more glyph tiles in the same batched launch — and compositing is a
``lax.scan`` src-over fold on device (``fontrx/cli/main.py`` mode
``color``).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from fontrx.font.ttf import CorruptedFont
from fontrx.utils.reader import BigEndianReader

# CPAL paletteIndex sentinel: use the text foreground color
FOREGROUND = 0xFFFF



_IDENTITY = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


def _compose(a, b):
    """Affine composition ``a ∘ b`` (apply ``b`` first).  Tuples are
    (xx, yx, xy, yy, dx, dy): x' = xx*x + xy*y + dx, y' = yx*x + yy*y
    + dy (the COLR Affine2x3 field order)."""
    axx, ayx, axy, ayy, adx, ady = a
    bxx, byx, bxy, byy, bdx, bdy = b
    return (
        axx * bxx + axy * byx,
        ayx * bxx + ayy * byx,
        axx * bxy + axy * byy,
        ayx * bxy + ayy * byy,
        axx * bdx + axy * bdy + adx,
        ayx * bdx + ayy * bdy + ady,
    )


def _around(mat, cx, cy):
    """T(c) ∘ mat ∘ T(-c)."""
    pre = (1.0, 0.0, 0.0, 1.0, -cx, -cy)
    post = (1.0, 0.0, 0.0, 1.0, cx, cy)
    return _compose(post, _compose(mat, pre))


@dataclass(frozen=True, slots=True)
class ColrTable:
    """COLR v0 layer records.

    ``base_gids``: sorted uint16 base glyph ids; ``first_layer`` /
    ``num_layers`` parallel arrays into the layer records
    (``layer_gids``, ``layer_palettes``).
    """

    version: int
    base_gids: np.ndarray       # uint16 [B], sorted
    first_layer: np.ndarray     # uint16 [B]
    num_layers: np.ndarray      # uint16 [B]
    layer_gids: np.ndarray      # uint16 [L]
    layer_palettes: np.ndarray  # uint16 [L] (palette entry or 0xFFFF)
    # v1: gid -> absolute paint-table offset (BaseGlyphList), the
    # LayerList's absolute paint offsets, and the raw table bytes the
    # graph walker reads from (empty for v0 tables)
    v1_paints: dict | None = None
    v1_layer_list: tuple = ()
    data: bytes = b""
    # v1 variation machinery (absolute offsets; 0 = absent)
    _var_map_off: int = 0
    _ivs_off: int = 0
    _clip_off: int = 0
    # lazily parsed (ivs, var_index_map) / clip ranges — declared
    # slots so the frozen dataclass can memoize via object.__setattr__
    _ivs_cache: tuple | None = None
    _clip_cache: tuple | None = None

    @classmethod
    def parse(cls, r: BigEndianReader) -> "ColrTable":
        base = r.pos
        version, n_base = r.unpack("HH")
        base_off, layer_off = r.unpack("II")
        (n_layers,) = r.unpack("H")
        v1_paints = None
        v1_layers: tuple = ()
        var_map_off = ivs_off = clip_off = 0
        if version >= 1:
            bgl_off, ll_off = r.unpack("II")
            (clip_off,) = r.unpack("I")
            var_map_off, ivs_off = r.unpack("II")
            if bgl_off:
                br = BigEndianReader(r.data, base + bgl_off)
                (n,) = br.unpack("I")
                if n > 0xFFFF:
                    raise CorruptedFont("COLR v1 BaseGlyphList size")
                v1_paints = {}
                for _ in range(n):
                    gid, poff = br.unpack("HI")
                    v1_paints[int(gid)] = base + bgl_off + int(poff)
            if ll_off:
                lr = BigEndianReader(r.data, base + ll_off)
                (n,) = lr.unpack("I")
                if n > 0xFFFFF:
                    raise CorruptedFont("COLR v1 LayerList size")
                offs = lr.u32_array(n)
                v1_layers = tuple(base + ll_off + int(o) for o in offs)
        if n_base:
            r.seek(base + base_off)
            rec = r.u16_array(3 * n_base).reshape(n_base, 3)
        else:
            rec = np.zeros((0, 3), np.uint16)
        if n_layers:
            r.seek(base + layer_off)
            lay = r.u16_array(2 * n_layers).reshape(n_layers, 2)
        else:
            lay = np.zeros((0, 2), np.uint16)
        first = rec[:, 1].astype(np.int64)
        count = rec[:, 2].astype(np.int64)
        if len(rec) and (first + count).max(initial=0) > n_layers:
            raise CorruptedFont("COLR layer range past layer records")
        return cls(
            int(version),
            rec[:, 0].copy(),
            rec[:, 1].copy(),
            rec[:, 2].copy(),
            lay[:, 0].copy(),
            lay[:, 1].copy(),
            v1_paints=v1_paints,
            v1_layer_list=v1_layers,
            data=r.data,
            _var_map_off=(base + var_map_off) if var_map_off else 0,
            _ivs_off=(base + ivs_off) if ivs_off else 0,
            _clip_off=(base + clip_off) if clip_off else 0,
        )

    def clip_box(self, gid: int):
        """The ClipList's authoritative render bounds for ``gid``:
        (xMin, yMin, xMax, yMax) design units, or None.  Renderers
        clip the paint graph's output to this box, per spec (format-2
        variable boxes read their base values)."""
        if not self._clip_off:
            return None
        clips = self._clip_cache
        if clips is None:
            clips = ()
            try:
                fmt, n = struct.unpack_from(">BI", self.data,
                                            self._clip_off)
                if fmt == 1 and n <= 0xFFFF:
                    rows = []
                    p = self._clip_off + 5
                    for _ in range(n):
                        first, last = struct.unpack_from(
                            ">HH", self.data, p)
                        off = int.from_bytes(
                            self.data[p + 4 : p + 7], "big")
                        bpos = self._clip_off + off
                        bfmt = self.data[bpos]
                        if bfmt in (1, 2):
                            box = struct.unpack_from(
                                ">hhhh", self.data, bpos + 1)
                            rows.append((int(first), int(last),
                                         tuple(int(v) for v in box)))
                        p += 7
                    clips = tuple(rows)
            except (struct.error, IndexError):
                clips = ()
            object.__setattr__(self, "_clip_cache", clips)
        for first, last, box in clips:
            if first <= gid <= last:
                return box
        return None

    def delta_resolver(self, coords):
        """A ``dv(var_index_base, i) -> float`` closure resolving COLR
        v1 variation deltas at normalized ``coords`` through the
        table's VarIndexMap + ItemVariationStore; returns the
        zero-resolver when the table carries no store, ``coords`` is
        None/default, or parsing fails (base values, documented)."""
        if coords is None or not self._ivs_off:
            return None
        cache = self._ivs_cache
        if cache is None:
            from fontrx.font.variations import (
                ItemVariationStore,
                _read_index_map,
            )

            try:
                ivs = ItemVariationStore.parse(self.data, self._ivs_off)
                vmap = (_read_index_map(self.data, self._var_map_off)
                        if self._var_map_off else None)
            except Exception:
                ivs = vmap = None
            cache = (ivs, vmap)
            object.__setattr__(self, "_ivs_cache", cache)
        ivs, vmap = cache
        if ivs is None:
            return None

        def dv(base: int, i: int) -> float:
            if base == 0xFFFFFFFF:
                return 0.0
            idx = base + i
            if vmap is not None:
                if idx >= len(vmap):
                    return 0.0
                outer, inner = vmap[idx]
            else:
                outer, inner = idx >> 16, idx & 0xFFFF
            try:
                return float(ivs.delta(outer, inner, coords))
            except Exception:
                return 0.0

        return dv

    def _color_line(self, pos: int, variable: bool, dv=None):
        """(extend, [(offset, palette_entry, alpha), ...]) or None.
        ``dv``: the variation resolver — VarColorStops vary their
        offset (index 0) and alpha (index 1) per stop."""
        try:
            extend, n = struct.unpack_from(">BH", self.data, pos)
        except struct.error:
            return None
        if extend > 2 or n == 0:
            return None
        stride = 10 if variable else 6
        stops = []
        p = pos + 3
        for _ in range(n):
            try:
                off_raw, entry, alpha_raw = struct.unpack_from(
                    ">hHh", self.data, p)
            except struct.error:
                return None
            off = off_raw / 16384.0
            alpha = alpha_raw / 16384.0
            if variable and dv is not None:
                try:
                    (vib,) = struct.unpack_from(">I", self.data, p + 6)
                except struct.error:
                    return None
                off += dv(vib, 0) / 16384.0
                alpha += dv(vib, 1) / 16384.0
            stops.append((
                off, int(entry), max(min(alpha, 1.0), 0.0),
            ))
            p += stride
        stops.sort(key=lambda s: s[0])
        return int(extend), stops

    def _fill(self, pos: int, dv=None):
        """Decode a supported fill paint at ``pos``:
        ``("solid", entry, alpha)`` /
        ``("linear", (x0..y2), extend, stops)`` /
        ``("radial", (x0, y0, r0, x1, y1, r1), extend, stops)`` /
        ``("sweep", (cx, cy, start_deg, end_deg), extend, stops)``;
        None = unsupported."""
        if pos + 1 > len(self.data):
            return None
        fmt = self.data[pos]
        try:
            if fmt in (2, 3):        # Paint(Var)Solid
                entry, alpha_raw = struct.unpack_from(
                    ">Hh", self.data, pos + 1)
                alpha = alpha_raw / 16384.0
                if fmt == 3 and dv is not None:
                    (vib,) = struct.unpack_from(">I", self.data,
                                                pos + 5)
                    alpha += dv(vib, 0) / 16384.0
                return ("solid", int(entry),
                        max(min(alpha, 1.0), 0.0))
            if fmt in (4, 5):        # Paint(Var)LinearGradient
                o24 = self.data[pos + 1 : pos + 4]
                cl = self._color_line(
                    pos + int.from_bytes(o24, "big"), fmt == 5, dv)
                if cl is None:
                    return None
                geom = [float(v) for v in struct.unpack_from(
                    ">6h", self.data, pos + 4)]
                if fmt == 5 and dv is not None:
                    (vib,) = struct.unpack_from(">I", self.data,
                                                pos + 16)
                    for k in range(6):
                        geom[k] += dv(vib, k)
                return ("linear", tuple(geom), *cl)
            if fmt in (6, 7):        # Paint(Var)RadialGradient
                o24 = self.data[pos + 1 : pos + 4]
                cl = self._color_line(
                    pos + int.from_bytes(o24, "big"), fmt == 7, dv)
                if cl is None:
                    return None
                geom = [float(v) for v in struct.unpack_from(
                    ">hhHhhH", self.data, pos + 4)]
                if fmt == 7 and dv is not None:
                    (vib,) = struct.unpack_from(">I", self.data,
                                                pos + 16)
                    for k in range(6):
                        geom[k] += dv(vib, k)
                    geom[2] = max(geom[2], 0.0)
                    geom[5] = max(geom[5], 0.0)
                return ("radial", tuple(geom), *cl)
            if fmt in (8, 9):        # Paint(Var)SweepGradient
                o24 = self.data[pos + 1 : pos + 4]
                cl = self._color_line(
                    pos + int.from_bytes(o24, "big"), fmt == 9, dv)
                if cl is None:
                    return None
                cx, cy, a0, a1 = struct.unpack_from(
                    ">hhhh", self.data, pos + 4)
                cx, cy = float(cx), float(cy)
                # angles are BIASED F2Dot14: stored = angle/180 - 1
                # (OpenType COLR sweep angle representation); deltas
                # are unbiased F2Dot14 fractions of 180 degrees
                s0 = (a0 / 16384.0 + 1.0) * 180.0
                s1 = (a1 / 16384.0 + 1.0) * 180.0
                if fmt == 9 and dv is not None:
                    (vib,) = struct.unpack_from(">I", self.data,
                                                pos + 12)
                    cx += dv(vib, 0)
                    cy += dv(vib, 1)
                    s0 += dv(vib, 2) / 16384.0 * 180.0
                    s1 += dv(vib, 3) / 16384.0 * 180.0
                return ("sweep", (cx, cy, s0, s1), *cl)
        except (struct.error, IndexError):
            return None
        return None

    def _transform_matrix(self, pos: int, fmt: int, dv=None):
        """(affine, child_paint_offset) for the transform paint family
        (formats 12-31), or None when malformed.  ``dv`` resolves Var
        variants' deltas (varIndexBase follows the base fields; field
        order matches the wire order)."""
        import math

        d = self.data

        def deltas(base_pos, n):
            """n per-field deltas for a Var paint (zeros without dv)."""
            if dv is None:
                return [0.0] * n
            (vib,) = struct.unpack_from(">I", d, base_pos)
            return [dv(vib, k) for k in range(n)]

        try:
            o24 = d[pos + 1 : pos + 4]
            child = pos + int.from_bytes(o24, "big")
            a = pos + 4
            if fmt in (12, 13):       # PaintTransform: Affine2x3 table
                t24 = d[pos + 4 : pos + 7]
                tpos = pos + int.from_bytes(t24, "big")
                vals = struct.unpack_from(">6i", d, tpos)
                mat = [v / 65536.0 for v in vals]     # Fixed 16.16
                if fmt == 13:
                    dl = deltas(tpos + 24, 6)
                    mat = [m + dk / 65536.0 for m, dk in zip(mat, dl)]
                return tuple(mat), child
            if fmt in (14, 15):       # PaintTranslate
                dx, dy = struct.unpack_from(">hh", d, a)
                dl = deltas(a + 4, 2) if fmt == 15 else [0.0, 0.0]
                return (1.0, 0.0, 0.0, 1.0,
                        dx + dl[0], dy + dl[1]), child
            if fmt in (16, 17):       # PaintScale
                sx, sy = struct.unpack_from(">hh", d, a)
                dl = deltas(a + 4, 2) if fmt == 17 else [0.0, 0.0]
                return ((sx + dl[0]) / 16384.0, 0.0, 0.0,
                        (sy + dl[1]) / 16384.0, 0.0, 0.0), child
            if fmt in (18, 19):       # PaintScaleAroundCenter
                sx, sy, cx, cy = struct.unpack_from(">hhhh", d, a)
                dl = deltas(a + 8, 4) if fmt == 19 else [0.0] * 4
                return _around(
                    ((sx + dl[0]) / 16384.0, 0.0, 0.0,
                     (sy + dl[1]) / 16384.0, 0.0, 0.0),
                    cx + dl[2], cy + dl[3]), child
            if fmt in (20, 21):       # PaintScaleUniform
                (sc,) = struct.unpack_from(">h", d, a)
                dl = deltas(a + 2, 1) if fmt == 21 else [0.0]
                u = (sc + dl[0]) / 16384.0
                return (u, 0.0, 0.0, u, 0.0, 0.0), child
            if fmt in (22, 23):       # PaintScaleUniformAroundCenter
                sc, cx, cy = struct.unpack_from(">hhh", d, a)
                dl = deltas(a + 6, 3) if fmt == 23 else [0.0] * 3
                u = (sc + dl[0]) / 16384.0
                return _around((u, 0.0, 0.0, u, 0.0, 0.0),
                               cx + dl[1], cy + dl[2]), child
            if fmt in (24, 25):       # PaintRotate
                (ang,) = struct.unpack_from(">h", d, a)
                dl = deltas(a + 2, 1) if fmt == 25 else [0.0]
                t = math.radians((ang + dl[0]) / 16384.0 * 180.0)
                c_, s_ = math.cos(t), math.sin(t)
                return (c_, s_, -s_, c_, 0.0, 0.0), child
            if fmt in (26, 27):       # PaintRotateAroundCenter
                ang, cx, cy = struct.unpack_from(">hhh", d, a)
                dl = deltas(a + 6, 3) if fmt == 27 else [0.0] * 3
                t = math.radians((ang + dl[0]) / 16384.0 * 180.0)
                c_, s_ = math.cos(t), math.sin(t)
                return _around((c_, s_, -s_, c_, 0.0, 0.0),
                               cx + dl[1], cy + dl[2]), child
            if fmt in (28, 29):       # PaintSkew
                xa, ya = struct.unpack_from(">hh", d, a)
                dl = deltas(a + 4, 2) if fmt == 29 else [0.0, 0.0]
                tx = math.tan(math.radians(
                    (xa + dl[0]) / 16384.0 * 180.0))
                ty = math.tan(math.radians(
                    (ya + dl[1]) / 16384.0 * 180.0))
                return (1.0, ty, -tx, 1.0, 0.0, 0.0), child
            if fmt in (30, 31):       # PaintSkewAroundCenter
                xa, ya, cx, cy = struct.unpack_from(">hhhh", d, a)
                dl = deltas(a + 8, 4) if fmt == 31 else [0.0] * 4
                tx = math.tan(math.radians(
                    (xa + dl[0]) / 16384.0 * 180.0))
                ty = math.tan(math.radians(
                    (ya + dl[1]) / 16384.0 * 180.0))
                return _around((1.0, ty, -tx, 1.0, 0.0, 0.0),
                               cx + dl[2], cy + dl[3]), child
        except (struct.error, IndexError):
            return None
        return None

    def paint_tree(self, gid: int, coords=None):
        """Build ``gid``'s v1 paint graph as a render tree:

        - ``("glyph", layer_gid, fill, affine_or_None)``
        - ``("layers", [child, ...])`` — src-over bottom-to-top
        - ``("composite", mode, source, backdrop)`` — all 28
          CompositeModes (Porter-Duff 0-12, separable 13-23, HSL
          24-27)

        ``None`` when the glyph has no v1 record or the graph uses an
        unsupported paint.  Transform affines accumulate along the
        walk and attach to the glyph leaves (composite operands keep
        their own subtree affines).  ``coords`` (normalized design
        location) resolves Var paints' deltas through the table's
        VarIndexMap + ItemVariationStore; None/default renders base
        values."""
        if not self.v1_paints or gid not in self.v1_paints:
            return None
        dv = self.delta_resolver(coords)
        seen: set[int] = set()

        def walk(pos: int, depth: int, xf):
            """Subtree or None (unsupported)."""
            if depth > 16 or pos in seen or pos + 1 > len(self.data):
                return None
            seen.add(pos)
            try:
                fmt = self.data[pos]
                if fmt == 1:          # PaintColrLayers
                    n, first = struct.unpack_from(">BI", self.data,
                                                  pos + 1)
                    if first + n > len(self.v1_layer_list):
                        return None
                    kids = []
                    for k in range(n):
                        sub = walk(self.v1_layer_list[first + k],
                                   depth + 1, xf)
                        if sub is None:
                            return None
                        kids.append(sub)
                    return ("layers", kids)
                if fmt == 10:         # PaintGlyph
                    o24 = self.data[pos + 1 : pos + 4]
                    child = pos + int.from_bytes(o24, "big")
                    (glyph_id,) = struct.unpack_from(">H", self.data,
                                                     pos + 4)
                    fill = self._fill(child, dv)
                    if fill is None:
                        return None
                    return ("glyph", int(glyph_id), fill,
                            None if xf == _IDENTITY else xf)
                if fmt == 11:         # PaintColrGlyph
                    (ref,) = struct.unpack_from(">H", self.data, pos + 1)
                    tgt = self.v1_paints.get(int(ref))
                    return None if tgt is None else walk(
                        tgt, depth + 1, xf)
                if 12 <= fmt <= 31:   # transform family
                    mc = self._transform_matrix(pos, fmt, dv)
                    if mc is None:
                        return None
                    mat, child = mc
                    return walk(child, depth + 1, _compose(xf, mat))
                if fmt == 32:         # PaintComposite
                    s24 = self.data[pos + 1 : pos + 4]
                    src = pos + int.from_bytes(s24, "big")
                    (mode,) = struct.unpack_from(">B", self.data,
                                                 pos + 4)
                    b24 = self.data[pos + 5 : pos + 8]
                    bdp = pos + int.from_bytes(b24, "big")
                    if mode > 27:     # reserved modes
                        return None
                    sn = walk(src, depth + 1, xf)
                    if sn is None:
                        return None
                    bn = walk(bdp, depth + 1, xf)
                    if bn is None:
                        return None
                    return ("composite", int(mode), sn, bn)
                return None           # any other paint: unsupported
            except (struct.error, IndexError):
                return None
            finally:
                seen.discard(pos)

        return walk(self.v1_paints[gid], 0, _IDENTITY)

    def layers_v1(
        self, gid: int, coords=None,
    ) -> list[tuple[int, tuple, tuple | None]] | None:
        """Flatten ``gid``'s v1 paint graph to ordered
        ``[(layer_gid, fill, affine_or_None), ...]`` (bottom-to-top)
        when the graph is a pure src-over stack; ``None`` when absent,
        unsupported, or when it needs composite semantics (use
        :meth:`paint_tree`)."""
        tree = self.paint_tree(gid, coords)
        if tree is None:
            return None
        out: list[tuple[int, tuple, tuple | None]] = []

        def flat(node) -> bool:
            if node[0] == "glyph":
                out.append((node[1], node[2], node[3]))
                return True
            if node[0] == "layers":
                return all(flat(k) for k in node[1])
            return False              # composite: not a flat stack

        if not flat(tree):
            return None
        return out

    def layers(self, gid: int) -> list[tuple[int, int]] | None:
        """Ordered ``[(layer_gid, palette_index), ...]`` painting
        bottom-to-top, or ``None`` when ``gid`` has no color layers
        (including v1-only base glyphs — callers fall back to the
        monochrome outline)."""
        i = int(np.searchsorted(self.base_gids, gid))
        if i >= len(self.base_gids) or int(self.base_gids[i]) != gid:
            return None
        lo = int(self.first_layer[i])
        n = int(self.num_layers[i])
        return [
            (int(self.layer_gids[j]), int(self.layer_palettes[j]))
            for j in range(lo, lo + n)
        ]


@dataclass(frozen=True, slots=True)
class CpalTable:
    """CPAL color palettes: ``colors[p, e]`` = RGBA uint8."""

    version: int
    colors: np.ndarray  # uint8 [numPalettes, numPaletteEntries, 4] RGBA
    # CPAL v1 paletteTypes bits per palette (0 when absent):
    # bit 0 = usable with light background, bit 1 = with dark
    palette_types: tuple = ()

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CpalTable":
        base = r.pos
        version, n_entries, n_palettes, n_records = r.unpack("HHHH")
        (records_off,) = r.unpack("I")
        if n_entries == 0 or n_palettes == 0:
            raise CorruptedFont("CPAL with no palettes")
        starts = r.u16_array(n_palettes).astype(np.int64)
        types = (0,) * n_palettes
        if version >= 1:
            # paletteTypes array (labels are name-table annotations
            # and stay skipped)
            try:
                (types_off,) = r.unpack("I")
                if types_off:
                    tr = BigEndianReader(r.data, base + types_off)
                    types = tuple(
                        int(v) for v in tr.u32_array(n_palettes))
            except Exception:
                types = (0,) * n_palettes
        if (starts + n_entries).max() > n_records:
            raise CorruptedFont("CPAL palette start past color records")
        r.seek(base + records_off)
        bgra = np.frombuffer(
            r.bytes(4 * n_records), np.uint8
        ).reshape(n_records, 4)
        rgba = bgra[:, [2, 1, 0, 3]]
        colors = np.stack(
            [rgba[s : s + n_entries] for s in starts]
        )
        return cls(int(version), colors.copy(), types)

    @property
    def num_palettes(self) -> int:
        return self.colors.shape[0]

    @property
    def num_entries(self) -> int:
        return self.colors.shape[1]

    def color(
        self, palette: int, entry: int,
        foreground: tuple[int, int, int, int] = (0, 0, 0, 255),
    ) -> tuple[int, int, int, int]:
        """RGBA for ``entry`` of ``palette``; the 0xFFFF sentinel is
        the text foreground color, per spec."""
        if entry == FOREGROUND:
            return foreground
        if not (0 <= palette < self.num_palettes):
            raise IndexError(f"palette {palette} of {self.num_palettes}")
        if not (0 <= entry < self.num_entries):
            raise CorruptedFont(
                f"palette entry {entry} of {self.num_entries}")
        return tuple(int(v) for v in self.colors[palette, entry])

    def select(self, which) -> int:
        """Resolve a palette selector to an index: an int passes
        through; ``"light"``/``"dark"`` pick the first palette whose
        CPAL v1 paletteTypes flag claims usability with that
        background (bit 0 light / bit 1 dark), falling back to
        palette 0 when no palette is flagged."""
        if isinstance(which, int):
            return which
        bit = {"light": 1, "dark": 2}.get(str(which).lower())
        if bit is None:
            raise ValueError(f"palette selector {which!r}")
        for i, t in enumerate(self.palette_types):
            if t & bit:
                return i
        return 0
