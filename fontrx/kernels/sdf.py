"""Signed-distance-field output mode (BASELINE config 4).

Not present in the reference (its fill is binary); this is the
extension the project adds: per-pixel signed distance to
the glyph outline, for scalable text rendering from small atlases.

Math: distance from a sample to each quadratic ``B(t) = (1-t)^2 p0 +
2t(1-t) p1 + t^2 p2`` minimizes ``|B(t) - p|^2`` whose stationary
condition is a cubic in ``t``.  Rather than branchy Cardano roots, the
kernel runs vectorized Newton iterations from a fixed lattice of
starting points (plus the endpoints), clamps to ``[0, 1]``, and takes
the min — branch-free, vector-friendly, accurate to well under the SDF
quantization step.  Sign comes from the same nonzero-winding rule as
the fill kernels (positive = inside, the usual font-SDF convention).

The segment axis streams in chunks of ``SEG_CHUNK`` under
``lax.fori_loop`` with a running minimum, so live intermediates stay
``[B, H, W, SEG_CHUNK]`` whatever the glyph's complexity; ``min``
commutes, so the chunking changes no bit of the result.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fontrx.kernels.winding import winding_batch

NEWTON_STARTS = 8
NEWTON_ITERS = 4
SEG_CHUNK = 16


def _min_dist_sq_single(segments, px, py):
    """Min squared distance from sample points to any segment:
    ``segments [S, 3, 2]`` streamed in ``SEG_CHUNK`` chunks,
    ``px``/``py`` ``[H, W]``."""
    s = segments.shape[0]
    n_chunks = -(-s // SEG_CHUNK)
    seg = jnp.pad(segments, ((0, n_chunks * SEG_CHUNK - s), (0, 0), (0, 0)))
    seg = seg.reshape(n_chunks, SEG_CHUNK, 3, 2)

    def body(i, best):
        return jnp.minimum(best, _chunk_min_dist_sq(seg[i], px, py))

    return jax.lax.fori_loop(
        0, n_chunks, body, jnp.full(px.shape, jnp.inf, jnp.float32))


def _chunk_min_dist_sq(segments, px, py):
    """Min squared distance from sample points to a segment chunk.

    ``segments``: ``[C, 3, 2]``; ``px``/``py``: ``[H, W]``.
    Padded all-zero segments are excluded via an explicit mask (unlike
    winding, a degenerate point-segment at the origin WOULD perturb
    distances).
    """
    p0 = segments[:, 0]  # [S, 2]
    p1 = segments[:, 1]
    p2 = segments[:, 2]
    live = jnp.any(segments.reshape(segments.shape[0], -1) != 0, axis=-1)  # [S]

    a = p1 - p0          # [S, 2]
    b = p0 - 2 * p1 + p2

    # cubic coefficients of d/dt |B(t)-p|^2 / 2:
    #   k3 t^3 + k2 t^2 + (k1 + q.b) t + q.a
    k3 = jnp.sum(b * b, axis=-1)            # [S]
    k2 = 3 * jnp.sum(a * b, axis=-1)
    k1 = 2 * jnp.sum(a * a, axis=-1)

    px = px[..., None]  # [H, W, 1] vs segment axis
    py = py[..., None]
    qx = p0[:, 0] - px  # [H, W, S]
    qy = p0[:, 1] - py
    qa = qx * a[:, 0] + qy * a[:, 1]
    qb = qx * b[:, 0] + qy * b[:, 1]

    def dist_sq_at(t):
        bxt = p0[:, 0] + 2 * t * a[:, 0] + t * t * b[:, 0] - px
        byt = p0[:, 1] + 2 * t * a[:, 1] + t * t * b[:, 1] - py
        return bxt * bxt + byt * byt

    def newton(_, t):
        f = ((k3 * t + k2) * t + (k1 + qb)) * t + qa
        df = (3 * k3 * t + 2 * k2) * t + (k1 + qb)
        step = jnp.where(df != 0, f / jnp.where(df == 0, 1.0, df), 0.0)
        return jnp.clip(t - step, 0.0, 1.0)

    def start(i, best):
        t0 = jnp.full_like(qx, (i.astype(jnp.float32) + 0.5) / NEWTON_STARTS)
        t = jax.lax.fori_loop(0, NEWTON_ITERS, newton, t0)
        return jnp.minimum(best, dist_sq_at(t))

    # loops, not Python unrolling: one fused reduction over the whole
    # unrolled solve took XLA:GPU minutes to compile
    best = jax.lax.fori_loop(
        0, NEWTON_STARTS, start, jnp.full(qx.shape, jnp.inf, jnp.float32))
    best = jnp.minimum(best, dist_sq_at(jnp.zeros_like(qx)))
    best = jnp.minimum(best, dist_sq_at(jnp.ones_like(qx)))

    best = jnp.where(live, best, jnp.inf)
    return jnp.min(best, axis=-1)  # [H, W]


@functools.partial(jax.jit, static_argnames=("height", "width"))
def sdf_batch(segments, min_x, max_y, scale, *, height, width):
    """Batched signed distance fields.

    Same grid conventions as the winding kernels.  Returns float32
    ``[B, height, width]`` distances in *pixel* units, positive inside.
    """
    scale = jnp.asarray(scale, jnp.float32)

    def one(seg, mx, my):
        xs = (mx + jnp.arange(width, dtype=jnp.int32)).astype(jnp.float32) / scale
        ys = (my - jnp.arange(height, dtype=jnp.int32)).astype(jnp.float32) / scale
        px = jnp.broadcast_to(xs[None, :], (height, width))
        py = jnp.broadcast_to(ys[:, None], (height, width))
        d_em = jnp.sqrt(_min_dist_sq_single(seg, px, py))
        return d_em * scale  # pixel units

    dist = jax.vmap(one)(segments, min_x, max_y)
    w = winding_batch(segments, min_x, max_y, scale, height=height, width=width)
    sign = jnp.where(w != 0, 1.0, -1.0)
    return sign * dist


def sdf_to_u8(sdf, spread: float = 8.0) -> jnp.ndarray:
    """Quantize an SDF to the standard 8-bit atlas encoding:
    128 at the outline, +-``spread`` pixels mapped to the full range."""
    return jnp.clip(
        jnp.round(128.0 + sdf * (127.0 / spread)), 0, 255
    ).astype(jnp.uint8)
