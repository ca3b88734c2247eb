"""Correctly-rounded f32 division and sqrt where XLA's are not.

XLA's f32 division and sqrt on the GPU are approximate: on an H100,
~30% of random quotients and ~17% of square roots differ from the
correctly rounded result (``PERF.md``).  The winding routes' tie
decisions — a root landing exactly on ``t = 0``/``t = 1`` or a crossing
exactly on a pixel column, which real fonts hit constantly because
glyph coordinates are integers aligned to the pixel grid — flip on that
last ulp, breaking bit-parity with the (IEEE-correct) CPU oracle.

These helpers recover correct rounding with classic extended-precision
tricks that need neither FMA nor float64:

- ``two_prod(a, b)``: Dekker/Veltkamp split exact product
  ``a*b = p + e`` with ``p = fl(a*b)``.
- ``div_cr(a, b)``: two Newton corrections with *exact* residuals
  ``r = a - q*b`` (Sterbenz-exact leading subtraction), each correction
  a hardware divide ``r / b``.  After the second step the correction's
  absolute error is ~2^-46 ulp, far inside the 2^-25-ulp exclusion zone
  of f32 quotients of f32 inputs, and exact-halfway ties resolve
  through the final correctly-rounded IEEE addition — so the result
  equals the IEEE quotient.
- ``sqrt_cr(d)``: same scheme on ``r = d - s*s`` with correction
  ``r / (2 s)``; f32 square roots are never exactly halfway, with the
  same exclusion-zone argument.

The Veltkamp split relies on the products not being fused into FMAs;
XLA on the GPU does not contract them.  Cost: ~30 ops per call instead
of 1 — used only in the winding routes' per-row phase (O(rows x
segments), not O(pixels)) and the colour path.  Verified against NumPy
IEEE results on random/adversarial values (tests, and on the GPU by
``chip_smoke.py``'s route-vs-oracle checks).
"""

from __future__ import annotations

import jax.numpy as jnp

# 2**12 + 1 (Veltkamp constant for f32); a Python literal so kernels
# don't capture a traced constant
_SPLIT = 4097.0


def _split(x):
    t = x * _SPLIT
    hi = t - (t - x)
    lo = x - hi
    return hi, lo


def two_prod(a, b):
    """Exact product: returns (p, e) with a*b == p + e, p = fl(a*b)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _residual_div(a, b, q):
    """Exact-ish residual a - q*b (leading subtraction is Sterbenz-exact
    because q*b is within a factor 2 of a)."""
    p, e = two_prod(q, b)
    return (a - p) - e


def div_cr(a, b):
    """Correctly rounded a / b for finite f32 (sign/inf/nan follow the
    hardware op)."""
    a = jnp.asarray(a, jnp.float32)
    b = jnp.asarray(b, jnp.float32)
    q0 = a / b
    q1 = q0 + _residual_div(a, b, q0) / b
    q2 = q1 + _residual_div(a, b, q1) / b
    # non-finite intermediate (a/b inf or nan) -> keep hardware result
    return jnp.where(jnp.isfinite(q0), q2, q0)


def sqrt_cr(d):
    """Correctly rounded sqrt(d) for finite nonnegative f32."""
    d = jnp.asarray(d, jnp.float32)
    s0 = jnp.sqrt(d)
    fin = jnp.isfinite(s0) & (s0 > 0)
    s0s = jnp.where(fin, s0, jnp.float32(1.0))  # guard 0/inf/nan lanes
    s1 = s0s + _residual_div(d, s0s, s0s) / (2.0 * s0s)
    s2 = s1 + _residual_div(d, s1, s1) / (2.0 * s1)
    return jnp.where(fin, s2, s0)
