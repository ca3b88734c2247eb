"""Triangulation-equivalent fill: rasterize classified triangles with
the implicit-quadratic sign test (BASELINE config 3).

The JAX re-expression of the reference's three graphics pipelines
(``src/Appli.zig:145-217``) and fragment kernels
(``src/shaders/shader.slang:32-51``): per pixel, a triangle covers it
when the pixel is inside the triangle AND the class test passes on the
barycentric-interpolated texcoord ``(u, v)``:

- concave: keep where ``(1+u-v)^2 >= 4u``  (discard ``< 4u``)
- convex:  keep where ``(1+u-v)^2 <= 4u``  (discard ``> 4u``)
- solid:   keep unconditionally

Coverage is the OR over triangles (alpha blending of identical opaque
color == union).  Inside-triangle uses orientation-normalized edge
functions with top-left-free >= 0 semantics — boundary conventions
therefore differ from the GPU rasterizer at shared-edge pixels, which
only affects tie pixels (tested with an edge-tolerant comparison).

Also provides ``debug_render`` — the analog of ``debug.slang``: the
three classes composited in translucent red/green/blue over both sides
of each curve test, for visual triangulation debugging (Ctrl+D in the
reference).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

TRI_CHUNK = 16


def _pack_triangle_arrays(tri_glyph):
    """TriangulatedGlyph -> per-triangle vertex/texcoord arrays:
    float32 [M, 3(corner), 4(x y u v)]."""
    v = tri_glyph.vertices.astype(np.float32)
    t = tri_glyph.texcoords.astype(np.float32)
    vt = np.concatenate([v, t], axis=1)  # [N, 4]
    return vt[tri_glyph.triangles]  # [M, 3, 4]


def pad_triangles(tris: np.ndarray, classes: np.ndarray, capacity: int):
    """Zero-pad triangle arrays to ``capacity`` (degenerate zero-area
    triangles never cover any pixel, so padding is inert)."""
    m = len(tris)
    out = np.zeros((capacity, 3, 4), np.float32)
    out[:m] = tris
    cls = np.full(capacity, 3, np.int32)  # class 3 = padding (never draws)
    cls[:m] = classes
    return out, cls


@functools.partial(jax.jit, static_argnames=("height", "width"))
def loopblinn_batch(
    tris, classes, min_x, max_y, scale, *, height, width,
    sample_offset=(0.0, 0.0),
):
    """Batched triangle-mesh fill.

    - ``tris``: float32 ``[B, M, 3, 4]`` (x y u v per corner)
    - ``classes``: int32 ``[B, M]`` (0 concave / 1 convex / 2 solid / 3 pad)
    - grid params as in the winding kernels
    -> bool ``[B, height, width]`` coverage.
    """
    scale = jnp.asarray(scale, jnp.float32)
    ox = jnp.asarray(sample_offset[0], jnp.float32)
    oy = jnp.asarray(sample_offset[1], jnp.float32)

    def one(tri, cls, mx, my):
        xi = (mx + jnp.arange(width, dtype=jnp.int32)).astype(jnp.float32)
        yi = (my - jnp.arange(height, dtype=jnp.int32)).astype(jnp.float32)
        xs = (xi + ox) / scale
        ys = (yi + oy) / scale
        px = xs[None, :]  # [1, W]
        py = ys[:, None]  # [H, 1]

        m = tri.shape[0]
        n_chunks = (m + TRI_CHUNK - 1) // TRI_CHUNK
        pad = n_chunks * TRI_CHUNK - m
        tri = jnp.pad(tri, ((0, pad), (0, 0), (0, 0)))
        cls = jnp.pad(cls, (0, pad), constant_values=3)
        tri = tri.reshape(n_chunks, TRI_CHUNK, 3, 4)
        cls = cls.reshape(n_chunks, TRI_CHUNK)

        def body(i, covered):
            t = tri[i][:, :, :, None, None]  # [C, 3, 4, 1, 1]
            c = cls[i][:, None, None]        # [C, 1, 1]
            ax, ay = t[:, 0, 0], t[:, 0, 1]
            bx, by = t[:, 1, 0], t[:, 1, 1]
            cx, cy = t[:, 2, 0], t[:, 2, 1]
            # edge functions vs pixel (w0 at corner a, etc.)
            e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
            e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
            e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
            area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
            sgn = jnp.sign(area)
            inside = (
                (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0)
                & (area != 0)
            )
            # barycentric weights: lambda_a = e1/area etc.
            inv = jnp.where(area != 0, 1.0 / jnp.where(area == 0, 1.0, area), 0.0)
            la = e1 * inv
            lb = e2 * inv
            lc = 1.0 - la - lb
            u = la * t[:, 0, 2] + lb * t[:, 1, 2] + lc * t[:, 2, 2]
            v = la * t[:, 0, 3] + lb * t[:, 1, 3] + lc * t[:, 2, 3]
            f = (1 + u - v) * (1 + u - v)
            keep = jnp.where(
                c == 0, f >= 4 * u,
                jnp.where(c == 1, f <= 4 * u, c == 2),
            )
            return covered | jnp.any(inside & keep, axis=0)

        return jax.lax.fori_loop(
            0, n_chunks, body, jnp.zeros((height, width), bool)
        )

    return jax.vmap(one)(tris, classes, min_x, max_y)


def loopblinn_fill(tri_glyph, grid) -> np.ndarray:
    """Single-glyph convenience: uint8 ``[H, W]`` 0/255 fill over the
    exact grid."""
    tris = _pack_triangle_arrays(tri_glyph)
    classes = tri_glyph.classes
    padded, cls = pad_triangles(tris, classes, max(len(tris), 1))
    out = loopblinn_batch(
        jnp.asarray(padded)[None],
        jnp.asarray(cls)[None],
        jnp.array([grid.min_x], jnp.int32),
        jnp.array([grid.max_y], jnp.int32),
        jnp.float32(grid.scale),
        height=grid.height, width=grid.width,
    )
    return np.where(np.asarray(out[0]), 255, 0).astype(np.uint8)


def debug_render(tri_glyph, grid) -> np.ndarray:
    """Debug visualization (``debug.slang:32-51`` semantics): concave
    red, convex green, solid blue; the kept side of each curve test at
    alpha 0.5, the discarded side at 0.2; alpha-composited in triangle
    order over black.  uint8 ``[H, W, 3]``."""
    tris = _pack_triangle_arrays(tri_glyph)
    classes = tri_glyph.classes
    xs, ys = grid.sample_coords()
    px = xs[None, :]
    py = ys[:, None]
    img = np.zeros((grid.height, grid.width, 3), np.float32)
    colors = {0: (1.0, 0, 0), 1: (0, 1.0, 0), 2: (0, 0, 1.0)}
    for tri, c in zip(tris, classes):
        (ax, ay, au, av), (bx, by, bu, bv), (cx, cy, cu, cv) = tri
        e0 = (bx - ax) * (py - ay) - (by - ay) * (px - ax)
        e1 = (cx - bx) * (py - by) - (cy - by) * (px - bx)
        e2 = (ax - cx) * (py - cy) - (ay - cy) * (px - cx)
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if area == 0:
            continue
        sgn = np.sign(area)
        inside = (e0 * sgn >= 0) & (e1 * sgn >= 0) & (e2 * sgn >= 0)
        la, lb = e1 / area, e2 / area
        lc = 1.0 - la - lb
        u = la * au + lb * bu + lc * cu
        v = la * av + lb * bv + lc * cv
        f = (1 + u - v) ** 2
        if c == 0:
            kept = f >= 4 * u
        elif c == 1:
            kept = f <= 4 * u
        else:
            kept = np.ones_like(f, bool)
        alpha = np.where(inside, np.where(kept, 0.5, 0.2), 0.0)[..., None]
        img = img * (1 - alpha) + np.array(colors[int(c)]) * alpha
    return np.clip(img * 255, 0, 255).astype(np.uint8)
