"""The raster route compiled for the GPU against the oracle in its
strict (no FMA contraction) mode, which the GPU matches.  Skips without
a GPU (see the ``gpu`` fixture in ``conftest.py``)."""

import numpy as np
import pytest

from fontrx.kernels import oracle


@pytest.mark.gpu
@pytest.mark.parametrize("size", [64, 256])
def test_route_matches_oracle(gpu, dejavu, size):
    import jax

    from fontrx.engine.raster import RasterEngine
    from fontrx.kernels.grid import RasterGrid
    from fontrx.pack.segments import pack_glyphs

    glyphs = [dejavu.get_glyph(c)[0] for c in "AgQ@&W8"]
    batch = pack_glyphs(glyphs)
    grids = [RasterGrid.fixed_tile(tuple(b), size, 2048, size)
             for b in batch.boxes]
    args = (batch.segments, np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32), grids[0].scale)
    with jax.default_device(gpu):
        out = np.asarray(RasterEngine().winding_batch(
            *args, height=size, width=size))
    for i, g in enumerate(grids):
        xs, ys = g.sample_coords()
        np.testing.assert_array_equal(out[i], oracle.winding_at(
            batch.segments[i], xs[None, :], ys[:, None], contract=False))
