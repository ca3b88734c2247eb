"""Kernel debugging / validation helpers.

SURVEY §5.2: the reference's GPU-correctness harness is Vulkan
validation layers + debug messenger (``src/VulkanContext.zig:506-562``);
the equivalents collected here:

- ``checked(fn)``            — wrap a jitted function with
  ``jax.experimental.checkify`` NaN/div/OOB checks.
- ``assert_finite(x, name)`` — host-side guard for raster outputs.
- golden-image diffing       — the determinism-based race detector
  (``diff_report``): the raster routes are deterministic (integer
  winding sums commute), so any two runs of the same program must
  match bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from fontrx.utils.log import get_logger

log = get_logger("Debug")


def checked(fn):
    """Wrap ``fn`` with checkify error tracking (NaN / OOB / div).
    Returns a callable raising on the first checked error."""
    import jax
    from jax.experimental import checkify

    checked_fn = checkify.checkify(
        fn, errors=checkify.float_checks | checkify.index_checks
    )

    def run(*args, **kwargs):
        err, out = checked_fn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return run


def assert_finite(x, name: str = "array") -> None:
    a = np.asarray(x)
    if not np.isfinite(a).all():
        bad = int((~np.isfinite(a)).sum())
        raise FloatingPointError(f"{name}: {bad} non-finite values")


def diff_report(a, b, name: str = "images") -> dict:
    """Pixel-difference report between two rasters (golden-image
    diffing; determinism check when a == rerun of b)."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        return {"name": name, "shape_mismatch": (a.shape, b.shape)}
    diff = a != b
    n = int(diff.sum())
    report = {"name": name, "mismatched": n, "total": int(diff.size)}
    if n:
        ys, xs = np.nonzero(diff.reshape(a.shape[0], -1))
        report["first"] = (int(ys[0]), int(xs[0]))
        log.warning("%s differ at %d/%d pixels", name, n, diff.size)
    return report
