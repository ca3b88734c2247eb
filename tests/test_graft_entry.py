"""The entry points must stay green.

``dryrun_multichip`` is the multi-device validation: it must provision
(or reuse) an 8-device mesh and run every sharded raster family under
``shard_map`` on the engine's route, cross-checked against the plain
XLA route.  Here the conftest's virtual 8-device CPU mesh is already
initialized, so the dry run exercises the reuse path; the
self-provisioning path is what a fresh process runs.
"""

import jax
import numpy as np
import pytest

import __graft_entry__ as graft


def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    out.block_until_ready()
    assert out.shape == (8, 128, 640)
    # the diamonds cover a nontrivial area
    assert 1000 < float(np.asarray(out).sum()) < out.size


def test_entry_matches_oracle():
    """The flagship entry path agrees with the CPU oracle."""
    from fontrx.kernels import oracle

    fn, args = graft.entry()
    out = np.asarray(jax.jit(fn)(*args))
    segments, min_x, max_y, scale = args
    for b in range(segments.shape[0]):
        xs = (min_x[b] + np.arange(out.shape[2], dtype=np.int32)).astype(
            np.float32
        ) / scale
        ys = (max_y[b] - np.arange(out.shape[1], dtype=np.int32)).astype(
            np.float32
        ) / scale
        w = oracle.winding_at(segments[b], xs[None, :], ys[:, None])
        np.testing.assert_array_equal(out[b], (w != 0).astype(np.float32))


def test_dryrun_multichip_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest 8-device CPU mesh")
    graft.dryrun_multichip(8)


def test_provision_raises_when_initialized_and_short():
    # backend is initialized with 8 devices; asking for more must fail
    # loudly rather than silently mis-shard
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft._provision_mesh_devices(16)
