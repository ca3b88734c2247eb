"""Supersampled coverage — the MSAA analog.

The reference's MSAA is a Vulkan multisample color target resolved by
averaging (``src/VulkanContext.zig:303-371``, resolve mode ``average``
``:243-247``).  Here winding is evaluated at a k x k sub-pixel sample
lattice and coverage is the fraction of covered samples.

Sample positions: a centered uniform lattice,
``offset_i = (i + 0.5)/k - 0.5`` for ``i in 0..k-1`` (pixel units)
around the reference sample point — the regular-grid analog of the
GPU's standard sample patterns.  At ``k=1`` the single offset is 0.0,
which reproduces the 1x oracle raster bit-for-bit.

The engine's ``RasterEngine.coverage_batch`` runs the k^2 passes on its
winding route over one binning; :func:`coverage_batch` here is the
traceable plain-XLA form (sharded atlases, tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fontrx.kernels.winding import winding_batch as _winding_batch


def sample_offsets(k: int) -> np.ndarray:
    """Centered k x k sub-pixel lattice, float32 ``[k*k, 2]`` (ox, oy)."""
    o = (np.arange(k, dtype=np.float32) + 0.5) / k - 0.5
    ox, oy = np.meshgrid(o, o)
    return np.stack([ox.ravel(), oy.ravel()], axis=1)


@functools.partial(jax.jit, static_argnames=("height", "width", "samples"))
def coverage_batch(segments, min_x, max_y, scale, *, height, width,
                   samples: int = 4):
    """Batched k x k supersampled coverage.

    ``samples`` is k (so 4 => 16 subsamples, the "4x MSAA" analog of
    BASELINE config 2 uses k=2 => 4 subsamples; pick per config).
    Returns float32 ``[B, height, width]`` in [0, 1].
    """
    offs = jnp.asarray(sample_offsets(samples))

    def one(off):
        w = _winding_batch(
            segments, min_x, max_y, scale, height=height, width=width,
            sample_offset=off,
        )
        return (w != 0).astype(jnp.float32)

    cov = jax.lax.map(one, offs)  # [k*k, B, H, W]
    return cov.mean(axis=0)


def coverage_to_gray(coverage) -> jnp.ndarray:
    """Antialiased 8-bit alpha from coverage."""
    return jnp.clip(jnp.round(coverage * 255.0), 0, 255).astype(jnp.uint8)
