"""Color glyph (COLR/CPAL) rendering — layered coverage composite.

Capability extension: the reference is monochrome end to end (its
kernels emit single-channel winding/fill, ``render_glyph.zig:20-33``).
fontrx renders COLR v0 color glyphs by rastering every layer of every
glyph in ONE batched coverage launch (layers are just extra rows in
the segment tensor — the accelerator-friendly shape) and folding the layer
stack src-over on device.

Per base glyph all layers share one grid (anchored at the union of the
layer boxes) so the stack composites in register; glyphs without COLR
layers degrade to a single foreground-colored layer of their own
outline, which makes mixed color/monochrome text uniform.

COLR v1 gradient fills (linear / radial with pad/repeat/reflect
extends) evaluate as per-pixel RGBA fields over the tile's em-space
lattice — the same src-over fold applies with the field in place of
the constant color, so gradients ride the identical compositing path.

Two surfaces:

- :func:`color_glyph_tiles` — premultiplied RGBA tiles + their grids
  (the atlas form: page compositing needs the alpha and the anchor).
- :func:`color_tiles` — the same tiles flattened over an opaque
  background (the simple per-glyph strip form).
- :func:`composite_color_page` — src-over placement of RGBA tiles at
  layout pen positions (the color analog of the monochrome composite
  pass, ``scene/page.py::composite_tiles``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fontrx.font.font import Font
from fontrx.kernels.exactmath import div_cr, sqrt_cr
from fontrx.kernels.grid import RasterGrid
from fontrx.pack.segments import pack_glyphs

# XLA's f32 division and sqrt on the GPU are not IEEE-correct
# (fontrx/kernels/exactmath.py), and an on-device constant divide can
# make 255/255 != 1.0.  The color path therefore (a) folds all CONSTANT
# color-space divisions on the host (numpy is IEEE), and (b) routes
# per-pixel divides/sqrts through the correctly-rounded emulation,
# which is bit-identical to the plain ops on the CPU.  Remaining
# documented inexactness on the device: transcendentals (arctan2 in
# sweep gradients, jax.image.resize weights, jnp.interp's internal
# divide) follow the device's math library.


def _interp_stops(t, stops):
    """Piecewise-linear color-line lookup: ``t`` (T, T) -> straight
    RGBA (T, T, 4) in [0, 1].  ``stops``: [(offset, (r, g, b, a))],
    sorted by offset."""
    xs = jnp.asarray([o for o, _ in stops], jnp.float32)
    cols = jnp.asarray(
        np.asarray([c for _, c in stops], np.float32) / np.float32(255.0))
    flat = t.reshape(-1)
    out = jnp.stack(
        [jnp.interp(flat, xs, cols[:, k]) for k in range(4)], axis=-1)
    return out.reshape(t.shape + (4,))


def _apply_extend(t, s0, s1, extend):
    """Map ``t`` into the color line's defined span per the extend
    mode: 0 pad (clamp), 1 repeat, 2 reflect."""
    span = s1 - s0
    if span <= 0:
        return jnp.full_like(t, s0)
    if extend == 1:
        return s0 + jnp.mod(t - s0, span)
    if extend == 2:
        m = jnp.mod(t - s0, 2.0 * span)
        return s0 + jnp.where(m > span, 2.0 * span - m, m)
    return jnp.clip(t, s0, s1)


def _gradient_field(paint, grid, tile: int, xf=None):
    """Evaluate a ("linear"|"radial", geom, extend, stops) paint over
    the tile's pixel-center lattice: straight-alpha RGBA float32
    ``[tile, tile, 4]`` in [0, 1].  ``xf`` (a COLR paint affine,
    layer-local -> glyph space) inverse-maps the lattice so the
    gradient evaluates in its own local coordinates — exactly how a
    transformed gradient paints.  Degenerate geometry (coincident
    gradient points / circles, singular transforms) renders
    transparent, per spec."""
    kind, geom, extend, stops = paint
    c = jnp.arange(tile, dtype=jnp.float32)
    r = jnp.arange(tile, dtype=jnp.float32)
    ex = div_cr(grid.min_x + c[None, :], grid.scale)  # em x per column
    ey = div_cr(grid.max_y - r[:, None], grid.scale)  # em y per row
    ex = jnp.broadcast_to(ex, (tile, tile))
    ey = jnp.broadcast_to(ey, (tile, tile))
    if xf is not None:
        xx, yx, xy, yy, dx, dy = (float(v) for v in xf)
        det = xx * yy - xy * yx
        if abs(det) < 1e-12:
            return jnp.zeros((tile, tile, 4), jnp.float32)
        ux, uy = ex - dx, ey - dy
        ex = div_cr(yy * ux - xy * uy, det)
        ey = div_cr(-yx * ux + xx * uy, det)

    if kind == "sweep":
        cx, cy, a0, a1 = (float(v) for v in geom)
        if a1 == a0:
            return jnp.zeros((tile, tile, 4), jnp.float32)
        theta = jnp.degrees(jnp.arctan2(ey - cy, ex - cx))
        t = div_cr(theta - a0, a1 - a0)
        valid = (ex != cx) | (ey != cy)
    elif kind == "linear":
        x0, y0, x1, y1, x2, y2 = (float(v) for v in geom)
        dx, dy = x1 - x0, y1 - y0
        rx, ry = x2 - x0, y2 - y0
        rr = rx * rx + ry * ry
        if rr > 0.0:
            # project out the rotation direction: color lines run
            # parallel to p0->p2 (COLR v1 spec / Skia semantics)
            k = (dx * rx + dy * ry) / rr
            dx, dy = dx - k * rx, dy - k * ry
        dd = dx * dx + dy * dy
        if dd <= 0.0:
            return jnp.zeros((tile, tile, 4), jnp.float32)
        t = div_cr((ex - x0) * dx + (ey - y0) * dy, dd)
        valid = jnp.ones((tile, tile), bool)
    else:
        x0, y0, r0, x1, y1, r1 = (float(v) for v in geom)
        cdx, cdy = x1 - x0, y1 - y0
        dr = r1 - r0
        pdx, pdy = ex - x0, ey - y0
        a = cdx * cdx + cdy * cdy - dr * dr
        b = pdx * cdx + pdy * cdy + r0 * dr
        cc = pdx * pdx + pdy * pdy - r0 * r0
        if abs(a) < 1e-9:
            safe_b = jnp.where(b == 0, 1.0, b)
            t = div_cr(cc, 2.0 * safe_b)
            valid = (b != 0) & (r0 + t * dr >= 0)
        else:
            disc = b * b - a * cc
            sq = sqrt_cr(jnp.maximum(disc, 0.0))
            t1 = div_cr(b + sq, a)
            t2 = div_cr(b - sq, a)
            # the greater root with a nonnegative interpolated radius
            hi = jnp.maximum(t1, t2)
            lo = jnp.minimum(t1, t2)
            use_hi = r0 + hi * dr >= 0
            t = jnp.where(use_hi, hi, lo)
            valid = (disc >= 0) & (r0 + t * dr >= 0)

    s0 = float(stops[0][0])
    s1 = float(stops[-1][0])
    rgba = _interp_stops(_apply_extend(t, s0, s1, extend), stops)
    return jnp.where(valid[..., None], rgba, 0.0)



# Porter-Duff source/backdrop factors per CompositeMode 0-12, as
# functions of the (premultiplied) alphas
_PORTER_DUFF = {
    0: lambda sa, ba: (0.0, 0.0),          # CLEAR
    1: lambda sa, ba: (1.0, 0.0),          # SRC
    2: lambda sa, ba: (0.0, 1.0),          # DEST
    3: lambda sa, ba: (1.0, 1.0 - sa),     # SRC_OVER
    4: lambda sa, ba: (1.0 - ba, 1.0),     # DEST_OVER
    5: lambda sa, ba: (ba, 0.0),           # SRC_IN
    6: lambda sa, ba: (0.0, sa),           # DEST_IN
    7: lambda sa, ba: (1.0 - ba, 0.0),     # SRC_OUT
    8: lambda sa, ba: (0.0, 1.0 - sa),     # DEST_OUT
    9: lambda sa, ba: (ba, 1.0 - sa),      # SRC_ATOP
    10: lambda sa, ba: (1.0 - ba, sa),     # DEST_ATOP
    11: lambda sa, ba: (1.0 - ba, 1.0 - sa),  # XOR
    12: lambda sa, ba: (1.0, 1.0),         # PLUS (clamped)
}


def _eval_node(node, cov, grid, tile: int):
    """Evaluate a row-annotated COLR render tree to a premultiplied
    RGBA tile (float32 [tile, tile, 4])."""
    if node[0] == "glyph":
        _, row, paint, xf = node
        if paint[0] == "solid":
            r, g_, b, a = paint[1]
            # constant color-space divisions fold on the HOST (IEEE):
            # an on-device divide need not be correctly rounded and
            # can turn 255/255 into 0.99999994
            av = cov[row][..., None] * np.float32(a / 255.0)
            rgb = jnp.asarray(
                np.asarray((r, g_, b), np.float32) / np.float32(255.0)
            )[None, None]
        else:
            field = _gradient_field(paint, grid, tile, xf)
            av = cov[row][..., None] * field[..., 3:]
            rgb = field[..., :3]
        return jnp.concatenate([rgb * av, av], axis=-1)
    if node[0] == "bitmap":
        return node[1]
    if node[0] == "alpha":
        # exact group opacity (SVG `opacity` on a composited subtree):
        # premultiplied RGBA scales linearly
        return _eval_node(node[2], cov, grid, tile) * node[1]
    if node[0] == "mask":
        # SVG luminance masking: the content scales by the mask
        # render's luminance x alpha (CSS masking / Rec.709
        # coefficients on the unpremultiplied color)
        src = _eval_node(node[1], cov, grid, tile)
        m = _eval_node(node[2], cov, grid, tile)
        ma = m[..., 3:]
        rgb = div_cr(m[..., :3], jnp.where(ma == 0, 1.0, ma))
        lum = (0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2]
               + 0.0722 * rgb[..., 2:3])
        return src * (lum * ma)
    if node[0] == "layers":
        acc = jnp.zeros((tile, tile, 4), jnp.float32)
        for k in node[1]:
            src = _eval_node(k, cov, grid, tile)
            acc = acc * (1.0 - src[..., 3:]) + src
        return acc
    if node[0] == "filter":
        return _eval_filter(node, cov, grid, tile)
    _, mode, sn, bn = node
    src = _eval_node(sn, cov, grid, tile)
    bdp = _eval_node(bn, cov, grid, tile)
    if mode <= 12:
        fa, fb = _PORTER_DUFF[mode](src[..., 3:], bdp[..., 3:])
        return jnp.clip(src * fa + bdp * fb, 0.0, 1.0)
    return _blend(mode, src, bdp)


# -- SVG filter primitives (fontrx.font.svgdoc lowers <filter> to
# ("filter", region_em, prims, node); evaluation is raster-space on
# the premultiplied tile) --------------------------------------------


def _blur_kernel(sigma_px: float):
    """SVG 1.1 feGaussianBlur: the composite 1-D kernel of the spec's
    THREE successive box blurs (the deterministic approximation the
    spec itself prescribes), as (taps, index-of-zero-offset).  None =
    identity."""
    if not (sigma_px > 0.0):
        return None
    d = int(np.floor(sigma_px * 3.0 * np.sqrt(2.0 * np.pi) / 4.0 + 0.5))
    if d < 1:
        return None
    if d % 2 == 1:
        boxes = [(d, d // 2)] * 3
    else:
        # two size-d boxes centered on the pixel boundaries to the
        # left and right, one size-(d+1) box centered
        boxes = [(d, d // 2), (d, d // 2 - 1), (d + 1, d // 2)]
    kern = np.array([1.0])
    center = 0
    for size, c in boxes:
        kern = np.convolve(kern, np.full(size, 1.0 / size))
        center += c
    return kern.astype(np.float32), center


def _conv1d(img, kern, center: int, axis: int):
    """out[i] = sum_j kern[j] * img[i + j - center], zero outside (the
    spec's transparent-black edge rule)."""
    n = img.shape[axis]
    pad = [(0, 0)] * img.ndim
    pad[axis] = (center, len(kern) - 1 - center)
    p = jnp.pad(img, pad)
    out = jnp.zeros_like(img)
    for j, w in enumerate(kern):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(j, j + n)
        out = out + jnp.float32(w) * p[tuple(sl)]
    return out


def _gaussian_blur(img, sx_px: float, sy_px: float):
    kx = _blur_kernel(sx_px)
    ky = _blur_kernel(sy_px)
    if kx is not None:
        img = _conv1d(img, *kx, axis=1)
    if ky is not None:
        img = _conv1d(img, *ky, axis=0)
    return img


def _offset_px(img, dx: int, dy: int):
    """Integer pixel shift with transparent-black fill (dy in ROW
    direction, already y-flipped by the caller)."""
    if dx == 0 and dy == 0:
        return img
    out = jnp.roll(img, (dy, dx), axis=(0, 1))
    t = img.shape[0]
    rows = jnp.arange(t)
    if dy > 0:
        out = jnp.where((rows < dy)[:, None, None], 0.0, out)
    elif dy < 0:
        out = jnp.where((rows >= t + dy)[:, None, None], 0.0, out)
    if dx > 0:
        out = jnp.where((rows < dx)[None, :, None], 0.0, out)
    elif dx < 0:
        out = jnp.where((rows >= t + dx)[None, :, None], 0.0, out)
    return out


def _morphology(img, op: str, rx_px: int, ry_px: int):
    """feMorphology on the premultiplied tile: min (erode) / max
    (dilate) over the ``(2*ry+1, 2*rx+1)`` pixel window, separably
    (rect structuring elements decompose exactly).  Transparent-black
    outside, per the filter edge rule.  Radii FLOOR to whole pixels
    (the common renderer convention for this deprecated-units-free
    primitive)."""
    if rx_px <= 0 and ry_px <= 0:
        return img
    fold = jnp.maximum if op == "dilate" else jnp.minimum
    pad_val = 0.0

    def run(a, r, axis):
        if r <= 0:
            return a
        n = a.shape[axis]
        pad = [(0, 0)] * a.ndim
        pad[axis] = (r, r)
        p = jnp.pad(a, pad, constant_values=pad_val)
        out = None
        for j in range(2 * r + 1):
            sl = [slice(None)] * a.ndim
            sl[axis] = slice(j, j + n)
            s = p[tuple(sl)]
            out = s if out is None else fold(out, s)
        return out

    return run(run(img, rx_px, 1), ry_px, 0)


def _convolve_matrix(img, order, kern, divisor, bias, target, edge,
                     preserve_alpha: bool):
    """feConvolveMatrix per SVG 1.1: result(x, y) = sum over (i, j)
    of source(x - targetX + j, y - targetY + i) *
    kernelMatrix[orderX - j - 1, orderY - i - 1] / divisor + bias.
    ``preserveAlpha=false`` convolves the premultiplied RGBA (our
    tile's native form); ``true`` convolves straight RGB and passes
    the source alpha through.  ``edgeMode``: duplicate | wrap | none."""
    ox, oy = order
    tx, ty = target
    k = np.asarray(kern, np.float32).reshape(oy, ox)

    a = img[..., 3:]
    if preserve_alpha:
        src = div_cr(img[..., :3], jnp.where(a == 0, 1.0, a))
    else:
        src = img

    h, w = src.shape[0], src.shape[1]
    pl_, pr = tx, ox - 1 - tx
    pt, pb = ty, oy - 1 - ty
    pad = [(pt, pb), (pl_, pr), (0, 0)]
    if edge == "duplicate":
        p = jnp.pad(src, pad, mode="edge")
    elif edge == "wrap":
        p = jnp.pad(src, pad, mode="wrap")
    else:
        p = jnp.pad(src, pad)
    out = jnp.zeros_like(src)
    for i in range(oy):
        for j in range(ox):
            wgt = float(k[oy - i - 1, ox - j - 1])
            if wgt == 0.0:
                continue
            out = out + jnp.float32(wgt) * p[i : i + h, j : j + w]
    out = div_cr(out, jnp.float32(divisor)) + jnp.float32(bias)
    if preserve_alpha:
        out = jnp.clip(out, 0.0, 1.0) * a
        return jnp.concatenate([out, a], axis=-1)
    out = jnp.clip(out, 0.0, 1.0)
    # premultiplied invariant: color channels cannot exceed alpha
    return jnp.concatenate(
        [jnp.minimum(out[..., :3], out[..., 3:]), out[..., 3:]],
        axis=-1)


def _fe_tile(img, grid, sub_em):
    """feTile: replicate the input's subregion across the tile.  The
    subregion (EM units) snaps to the pixel lattice by rounding its
    edges; a missing/degenerate subregion is the identity (the input
    already spans the filter region)."""
    if sub_em is None:
        return img
    t = img.shape[0]
    x0, y0, x1, y1 = sub_em
    scale = float(grid.scale)
    # half-open pixel boxes: em x in [x0, x1) covers columns
    # [x0*s - min_x, x1*s - min_x); em y in [y0, y1) covers rows
    # [max_y - y1*s + 1, max_y - y0*s + 1) on the y-down raster
    c0 = int(round(x0 * scale - grid.min_x))
    c1 = int(round(x1 * scale - grid.min_x))
    r0 = int(round(grid.max_y - y1 * scale + 1))
    r1 = int(round(grid.max_y - y0 * scale + 1))
    c0, c1 = max(c0, 0), min(c1, t)
    r0, r1 = max(r0, 0), min(r1, t)
    if c1 - c0 <= 0 or r1 - r0 <= 0:
        return img
    rows = r0 + (jnp.arange(t) - r0) % (r1 - r0)
    cols = c0 + (jnp.arange(t) - c0) % (c1 - c0)
    return img[rows[:, None], cols[None, :]]


_COLORMATRIX_LUM = (0.2125, 0.7154, 0.0721)


def _colormatrix(img, kind: str, values):
    """feColorMatrix on STRAIGHT (unpremultiplied) RGBA, per spec."""
    a = img[..., 3:]
    straight = div_cr(img[..., :3], jnp.where(a == 0, 1.0, a))
    if kind == "saturate":
        s = float(values[0]) if values else 1.0
        m = np.array([
            [0.213 + 0.787 * s, 0.715 - 0.715 * s, 0.072 - 0.072 * s, 0, 0],
            [0.213 - 0.213 * s, 0.715 + 0.285 * s, 0.072 - 0.072 * s, 0, 0],
            [0.213 - 0.213 * s, 0.715 - 0.715 * s, 0.072 + 0.928 * s, 0, 0],
            [0, 0, 0, 1, 0]])
    elif kind == "hueRotate":
        t = np.radians(float(values[0]) if values else 0.0)
        c, s = np.cos(t), np.sin(t)
        m = (np.array([
            [0.213, 0.715, 0.072, 0, 0],
            [0.213, 0.715, 0.072, 0, 0],
            [0.213, 0.715, 0.072, 0, 0],
            [0, 0, 0, 1, 0]])
            + c * np.array([
                [0.787, -0.715, -0.072, 0, 0],
                [-0.213, 0.285, -0.072, 0, 0],
                [-0.213, -0.715, 0.928, 0, 0],
                [0, 0, 0, 0, 0]])
            + s * np.array([
                [-0.213, -0.715, 0.928, 0, 0],
                [0.143, 0.140, -0.283, 0, 0],
                [-0.787, 0.715, 0.072, 0, 0],
                [0, 0, 0, 0, 0]]))
    elif kind == "luminanceToAlpha":
        lr, lg, lb = _COLORMATRIX_LUM
        m = np.array([
            [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
            [lr, lg, lb, 0, 0]])
    else:  # "matrix": 20 values, rows of [r g b a 1] weights
        m = np.asarray(values, np.float64).reshape(4, 5)
    vec = jnp.concatenate(
        [straight, a, jnp.ones_like(a)], axis=-1)  # [T, T, 5]
    out = jnp.clip(
        jnp.einsum("ijk,lk->ijl", vec, jnp.asarray(m, jnp.float32),
                   precision=jax.lax.Precision.HIGHEST),
        0.0, 1.0)
    oa = out[..., 3:]
    return jnp.concatenate([out[..., :3] * oa, oa], axis=-1)


_FE_BLEND = {"normal": None, "screen": 13, "darken": 15,
             "lighten": 16, "multiply": 23}


def _fe_composite(src, bdp, op: str, k):
    sa, ba = src[..., 3:], bdp[..., 3:]
    if op == "in":
        return src * ba
    if op == "out":
        return src * (1.0 - ba)
    if op == "atop":
        return src * ba + bdp * (1.0 - sa)
    if op == "xor":
        return src * (1.0 - ba) + bdp * (1.0 - sa)
    if op == "arithmetic":
        k1, k2, k3, k4 = (float(v) for v in k)
        return jnp.clip(
            k1 * src * bdp + k2 * src + k3 * bdp + k4, 0.0, 1.0)
    return src + bdp * (1.0 - sa)  # over


def _eval_filter(node, cov, grid, tile: int):
    """Evaluate a ("filter", region_em, prims, child) node: raster the
    child, then run the primitive pipeline over the premultiplied
    tile.  Lengths in the prims are EM units (the document lowering
    already applied the element transform); they scale to pixels by
    ``grid.scale`` here so zoom changes re-raster correctly.  Each
    primitive's output crops to the filter region (the spec's hard
    clip; per-primitive subregions are not supported — documented in
    fontrx.font.svgdoc)."""
    _, region, prims, child = node
    src = _eval_node(child, cov, grid, tile)

    mask = None
    if region is not None:
        x0, y0, x1, y1 = region
        c = jnp.arange(tile, dtype=jnp.float32)
        r = jnp.arange(tile, dtype=jnp.float32)
        ex = div_cr(grid.min_x + c[None, :], grid.scale)
        ey = div_cr(grid.max_y - r[:, None], grid.scale)
        mask = ((ex >= x0) & (ex <= x1) & (ey >= y0)
                & (ey <= y1)).astype(jnp.float32)[..., None]

    def crop(img):
        return img if mask is None else img * mask

    results = {"SourceGraphic": crop(src)}
    results["SourceAlpha"] = crop(jnp.concatenate(
        [jnp.zeros_like(src[..., :3]), src[..., 3:]], axis=-1))
    last = results["SourceGraphic"]

    def get(ref):
        if ref and ref in results:
            return results[ref]
        return last

    scale = float(grid.scale)
    for p in prims:
        kind = p[0]
        if kind == "blur":
            out = _gaussian_blur(get(p[1]), p[2] * scale, p[3] * scale)
        elif kind == "offset":
            out = _offset_px(get(p[1]),
                             int(round(p[2] * scale)),
                             int(round(-p[3] * scale)))
        elif kind == "flood":
            r_, g_, b_, a_ = p[1]
            out = jnp.broadcast_to(
                jnp.asarray((r_ * a_, g_ * a_, b_ * a_, a_),
                            jnp.float32), (tile, tile, 4))
        elif kind == "merge":
            out = jnp.zeros((tile, tile, 4), jnp.float32)
            for ref in p[1]:
                s = get(ref)
                out = out * (1.0 - s[..., 3:]) + s
        elif kind == "composite":
            out = _fe_composite(get(p[1]), get(p[2]), p[3], p[4])
        elif kind == "blend":
            mode = _FE_BLEND.get(p[3])
            s, b = get(p[1]), get(p[2])
            out = (s + b * (1.0 - s[..., 3:]) if mode is None
                   else _blend(mode, s, b))
        elif kind == "colormatrix":
            out = _colormatrix(get(p[1]), p[2], p[3])
        elif kind == "morph":
            out = _morphology(get(p[1]), p[2],
                              int(np.floor(p[3] * scale)),
                              int(np.floor(p[4] * scale)))
        elif kind == "convolve":
            out = _convolve_matrix(get(p[1]), p[2], p[3], p[4], p[5],
                                   p[6], p[7], p[8])
        elif kind == "tile":
            out = _fe_tile(get(p[1]), grid, p[2])
        else:  # pragma: no cover - the lowering rejects unknown prims
            continue
        out = crop(out)
        if p[-1]:
            results[p[-1]] = out
        last = out
    return last


def _lum(c):
    return (0.3 * c[..., 0:1] + 0.59 * c[..., 1:2]
            + 0.11 * c[..., 2:3])


def _clip_color(c):
    lum = _lum(c)
    cmin = jnp.min(c, axis=-1, keepdims=True)
    cmax = jnp.max(c, axis=-1, keepdims=True)
    low = lum + div_cr((c - lum) * lum, jnp.where(
        lum - cmin == 0, 1.0, lum - cmin))
    high = lum + div_cr((c - lum) * (1.0 - lum), jnp.where(
        cmax - lum == 0, 1.0, cmax - lum))
    c = jnp.where(cmin < 0.0, low, c)
    return jnp.where(cmax > 1.0, high, c)


def _set_lum(c, lum):
    return _clip_color(c + (lum - _lum(c)))


def _sat(c):
    return (jnp.max(c, axis=-1, keepdims=True)
            - jnp.min(c, axis=-1, keepdims=True))


def _set_sat(c, sat):
    cmin = jnp.min(c, axis=-1, keepdims=True)
    cmax = jnp.max(c, axis=-1, keepdims=True)
    span = jnp.where(cmax - cmin == 0, 1.0, cmax - cmin)
    scaled = div_cr((c - cmin) * sat, span)
    return jnp.where(cmax > cmin, scaled, jnp.zeros_like(c))


def _blend(mode: int, src, bdp):
    """W3C separable/HSL blend modes (COLR CompositeMode 13-27) on
    premultiplied tiles: un-premultiply, blend per the spec's B(cb,
    cs), mix by the backdrop alpha, then composite src-over."""
    sa = src[..., 3:]
    ba = bdp[..., 3:]
    cs = div_cr(src[..., :3], jnp.where(sa == 0, 1.0, sa))
    cb = div_cr(bdp[..., :3], jnp.where(ba == 0, 1.0, ba))

    def screen(b, s):
        return b + s - b * s

    def hard_light(b, s):
        return jnp.where(s <= 0.5, 2.0 * b * s,
                         screen(b, 2.0 * s - 1.0))

    if mode == 13:
        bl = screen(cb, cs)
    elif mode == 14:                       # overlay
        bl = hard_light(cs, cb)
    elif mode == 15:
        bl = jnp.minimum(cb, cs)
    elif mode == 16:
        bl = jnp.maximum(cb, cs)
    elif mode == 17:                       # color-dodge
        bl = jnp.where(cb == 0.0, 0.0,
                       jnp.where(cs == 1.0, 1.0,
                                 jnp.minimum(1.0, div_cr(cb, jnp.where(
                                     cs == 1.0, 1.0, 1.0 - cs)))))
    elif mode == 18:                       # color-burn
        bl = jnp.where(cb == 1.0, 1.0,
                       jnp.where(cs == 0.0, 0.0,
                                 1.0 - jnp.minimum(
                                     1.0, div_cr(1.0 - cb, jnp.where(
                                         cs == 0.0, 1.0, cs)))))
    elif mode == 19:
        bl = hard_light(cb, cs)
    elif mode == 20:                       # soft-light (W3C D())
        d = jnp.where(cb <= 0.25,
                      ((16.0 * cb - 12.0) * cb + 4.0) * cb,
                      jnp.sqrt(jnp.maximum(cb, 0.0)))
        bl = jnp.where(
            cs <= 0.5,
            cb - (1.0 - 2.0 * cs) * cb * (1.0 - cb),
            cb + (2.0 * cs - 1.0) * (d - cb))
    elif mode == 21:
        bl = jnp.abs(cb - cs)
    elif mode == 22:                       # exclusion
        bl = cb + cs - 2.0 * cb * cs
    elif mode == 23:
        bl = cb * cs
    elif mode == 24:                       # hue
        bl = _set_lum(_set_sat(cs, _sat(cb)), _lum(cb))
    elif mode == 25:                       # saturation
        bl = _set_lum(_set_sat(cb, _sat(cs)), _lum(cb))
    elif mode == 26:                       # color
        bl = _set_lum(cs, _lum(cb))
    else:                                  # 27 luminosity
        bl = _set_lum(cb, _lum(cs))

    mixed = (1.0 - ba) * cs + ba * bl      # straight source color
    out_a = sa + ba * (1.0 - sa)
    out_rgb = mixed * sa + bdp[..., :3] * (1.0 - sa)
    return jnp.clip(
        jnp.concatenate([out_rgb, out_a], axis=-1), 0.0, 1.0)

def color_glyph_tiles(
    font: Font,
    gids: list[int],
    size: float,
    engine,
    *,
    palette: int = 0,
    samples: int = 2,
    foreground: tuple[int, int, int, int] = (0, 0, 0, 255),
    tile: int | None = None,
) -> tuple[jnp.ndarray, list[RasterGrid]]:
    """Premultiplied-RGBA color tiles: float32 ``[len(gids), tile,
    tile, 4]`` in [0, 1] (rgb premultiplied by alpha), plus the
    per-glyph :class:`RasterGrid` anchoring each tile.

    ``size`` is the em size in pixels (may be fractional — the page
    path rasters at the view's zoom); ``tile`` the square raster
    dimension (defaults to ``round(size)``).

    One coverage launch covers all (glyph, layer) rows; the src-over
    fold runs bottom-to-top per glyph, matching COLR v0 paint order:
    with premultiplied ``src = (rgb*a, a)``, the fold is
    ``dst = dst*(1-a) + src`` on all four channels.
    """
    if tile is None:
        tile = max(int(round(size)), 1)
    upem = font.info.units_per_em
    glyphs = []
    cells: list[list[tuple[int, tuple]]] = []
    row_grid: list[RasterGrid] = []
    cell_grids: list[RasterGrid] = []
    from fontrx.font.glyph import transform_glyph

    for gid in gids:
        tree = font.color_paint_tree(gid, palette, foreground)
        if tree is None:
            # bitmap strikes (sbix / CBDT): pre-rendered PNG scaled
            # from the best strike; positioned by the strike-pixel
            # bottom-left origin
            bm = font.color_bitmap(gid, size)
            if bm is not None:
                img, ox, oy, strike_ppem = bm
                k = size / max(strike_ppem, 1)
                th = max(1, min(tile, int(round(img.shape[0] * k))))
                tw = max(1, min(tile, int(round(img.shape[1] * k))))
                f = jnp.asarray(
                    np.asarray(img, np.float32) / np.float32(255.0))
                f = jax.image.resize(f, (th, tw, 4), method="linear")
                prem = jnp.concatenate(
                    [f[..., :3] * f[..., 3:], f[..., 3:]], axis=-1)
                buf = jnp.zeros((tile, tile, 4), jnp.float32)
                buf = buf.at[:th, :tw].set(prem)
                left_px = int(round(ox * k))
                top_px = int(round(oy * k)) + th - 1
                cells.append(("bitmap", buf))
                cell_grids.append(RasterGrid(
                    width=tile, height=tile, min_x=left_px,
                    max_y=top_px, scale=np.float32(size / upem)))
                continue
            tree = ("layers",
                    [("glyph", gid, ("solid", foreground), None)])
        # annotate glyph leaves with their batch row and collect the
        # (transformed) outlines; one shared grid per cell so every
        # leaf samples identical pixel centers
        loaded = []

        def collect(node):
            if node[0] == "glyph":
                _, lg, paint, xf = node
                g = font.load_glyph_safe(lg)
                if xf is not None:
                    # bake the paint transform into the outline
                    # (quadratics are affine-invariant); gradient
                    # fields inverse-map instead
                    g = transform_glyph(g, xf)
                row = len(glyphs)
                glyphs.append(g)
                loaded.append(g)
                return ("glyph", row, paint, xf)
            if node[0] == "outline":
                # OT-SVG leaf (fontrx.font.svgdoc): the outline is
                # ALREADY in font units; xf belongs to the gradient
                # field only (its own space -> glyph space)
                _, g, paint, xf = node
                row = len(glyphs)
                glyphs.append(g)
                loaded.append(g)
                return ("glyph", row, paint, xf)
            if node[0] == "layers":
                return ("layers", [collect(k) for k in node[1]])
            if node[0] == "alpha":
                return ("alpha", node[1], collect(node[2]))
            if node[0] == "mask":
                return ("mask", collect(node[1]), collect(node[2]))
            if node[0] == "filter":
                return ("filter", node[1], node[2], collect(node[3]))
            return ("composite", node[1], collect(node[2]),
                    collect(node[3]))

        n_before = len(glyphs)
        rowtree = collect(tree)
        # the ClipList's box is the authoritative render bounds when
        # present (the tile crops to it, which IS the clip); otherwise
        # the union of the (transformed) layer boxes
        clip = None
        colr = getattr(font, "colr", None)
        if colr is not None and hasattr(colr, "clip_box"):
            clip = colr.clip_box(gid)
        boxes = [g.box for g in loaded]
        # filter regions are render bounds too (a drop shadow spills
        # past the outline union; the region is the spec's hard clip)
        regions: list[tuple] = []

        def scan_regions(n):
            if n[0] == "filter" and n[1] is not None:
                regions.append(n[1])
                scan_regions(n[3])
            elif n[0] == "layers":
                for k in n[1]:
                    scan_regions(k)
            elif n[0] == "alpha":
                scan_regions(n[2])
            elif n[0] in ("mask", "composite"):
                scan_regions(n[-2])
                scan_regions(n[-1])

        scan_regions(rowtree)
        if clip is not None:
            union = clip
        elif boxes or regions:
            union = (
                min([b.x_min for b in boxes]
                    + [r[0] for r in regions]),
                min([b.y_min for b in boxes]
                    + [r[1] for r in regions]),
                max([b.x_max for b in boxes]
                    + [r[2] for r in regions]),
                max([b.y_max for b in boxes]
                    + [r[3] for r in regions]),
            )
        else:
            union = (0, 0, 1, 1)
        grid = RasterGrid.fixed_tile(union, size, upem, tile)
        row_grid.extend([grid] * (len(glyphs) - n_before))
        cells.append(rowtree)
        cell_grids.append(grid)

    batch = pack_glyphs(glyphs)
    cov = engine.coverage_batch(
        batch.segments,
        np.array([g.min_x for g in row_grid], np.int32),
        np.array([g.max_y for g in row_grid], np.int32),
        row_grid[0].scale if row_grid else np.float32(size / upem),
        height=tile,
        width=tile,
        samples=max(samples, 2),
    )

    tiles = []
    for cell_i, rowtree in enumerate(cells):
        tiles.append(
            _eval_node(rowtree, cov, cell_grids[cell_i], tile))
    stacked = (jnp.stack(tiles) if tiles
               else jnp.zeros((0, tile, tile, 4), jnp.float32))
    return stacked, cell_grids


def color_tiles(
    font: Font,
    gids: list[int],
    size: int,
    engine,
    *,
    palette: int = 0,
    samples: int = 2,
    foreground: tuple[int, int, int, int] = (0, 0, 0, 255),
    background: tuple[int, int, int] = (255, 255, 255),
) -> np.ndarray:
    """``size x size`` RGB tiles over an opaque background: uint8
    ``[len(gids), size, size, 3]`` (the strip form)."""
    rgba, _ = color_glyph_tiles(
        font, gids, size, engine, palette=palette, samples=samples,
        foreground=foreground)
    bg = jnp.asarray(np.asarray(background, np.float32) / np.float32(255.0))
    rgb = bg * (1.0 - rgba[..., 3:]) + rgba[..., :3]
    return np.asarray(
        jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8))


def composite_color_page(
    tiles_rgba: jnp.ndarray,
    grids: list[RasterGrid],
    slots: np.ndarray,
    pen_px: np.ndarray,
    *,
    page_h: int,
    page_w: int,
    background: tuple[int, int, int] = (255, 255, 255),
) -> np.ndarray:
    """Src-over placement of premultiplied RGBA tiles onto an opaque
    page: uint8 ``[page_h, page_w, 3]``.

    ``slots``: int ``[N]`` tile index per instance; ``pen_px``: float
    ``[N, 2]`` page-pixel pen positions (x right, y DOWN — the page's
    raster convention).  Tile origin per instance mirrors the
    monochrome composite pass: ``round(pen) + (grid.min_x,
    -grid.max_y)``.  The page is padded by one tile on every side so
    edge glyphs clip instead of smearing, then cropped.
    """
    tile = int(tiles_rgba.shape[1])
    n = len(slots)
    if n == 0:
        out = np.zeros((page_h, page_w, 3), np.uint8)
        out[:] = background
        return out
    g_minx = np.array([g.min_x for g in grids], np.int64)[slots]
    g_maxy = np.array([g.max_y for g in grids], np.int64)[slots]
    xs = (np.round(pen_px[:, 0]).astype(np.int64) + g_minx).astype(np.int32)
    ys = (np.round(pen_px[:, 1]).astype(np.int64) - g_maxy).astype(np.int32)

    import jax

    # unique tiles stay resident; each scan step gathers its instance's
    # tile in the body — an [N, T, T, 4] up-front gather OOM'd page-
    # scale scenes (the monochrome twin measured it first, round 5)
    uniq = jnp.asarray(tiles_rgba)
    padded = jnp.zeros((page_h + 2 * tile, page_w + 2 * tile, 4),
                       jnp.float32)

    def body(page, args):
        s, x0, y0 = args
        t = uniq[s]
        x0 = jnp.clip(x0 + tile, 0, page_w + tile)
        y0 = jnp.clip(y0 + tile, 0, page_h + tile)
        cur = jax.lax.dynamic_slice(
            page, (y0, x0, 0), (tile, tile, 4))
        blended = cur * (1.0 - t[..., 3:]) + t
        return (
            jax.lax.dynamic_update_slice(page, blended, (y0, x0, 0)),
            None,
        )

    padded, _ = jax.lax.scan(
        body, padded,
        (jnp.asarray(np.asarray(slots, np.int32)), jnp.asarray(xs),
         jnp.asarray(ys)))
    rgba = padded[tile : tile + page_h, tile : tile + page_w]
    bg = jnp.asarray(np.asarray(background, np.float32) / np.float32(255.0))
    rgb = bg * (1.0 - rgba[..., 3:]) + rgba[..., :3]
    return np.asarray(
        jnp.clip(jnp.round(rgb * 255.0), 0, 255).astype(jnp.uint8))
