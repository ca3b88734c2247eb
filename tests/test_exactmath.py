"""Correctly-rounded math emulation + exact routes + direct-page tests."""

import numpy as np
import pytest


class TestExactMath:
    def test_two_prod_exact(self, rng):
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import two_prod

        a = (rng.random(50000).astype(np.float32) * 4000 - 2000)
        b = (rng.random(50000).astype(np.float32) * 4000 - 2000)
        p, e = jax.jit(two_prod)(jnp.array(a), jnp.array(b))
        exact = np.float64(a) * np.float64(b)
        assert (np.float64(np.asarray(p)) + np.float64(np.asarray(e)) == exact).all()

    def test_div_cr_matches_ieee(self, rng):
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import div_cr

        a = (rng.random(50000).astype(np.float32) * 4000 - 2000)
        b = (rng.random(50000).astype(np.float32) * 4000 - 2000)
        b = np.where(np.abs(b) < 0.5, 1.0, b).astype(np.float32)
        q = np.asarray(jax.jit(div_cr)(jnp.array(a), jnp.array(b)))
        np.testing.assert_array_equal(q, a / b)

    def test_div_cr_int_inputs(self, rng):
        """The winding case: integer-valued operands."""
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import div_cr

        a = rng.integers(-16384, 16384, 50000).astype(np.float32)
        b = rng.integers(1, 16384, 50000).astype(np.float32)
        q = np.asarray(jax.jit(div_cr)(jnp.array(a), jnp.array(b)))
        np.testing.assert_array_equal(q, a / b)

    def test_div_cr_nonfinite_passthrough(self):
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import div_cr

        a = jnp.array([1.0, 0.0, -1.0], jnp.float32)
        b = jnp.array([0.0, 0.0, 0.0], jnp.float32)
        q = np.asarray(jax.jit(div_cr)(a, b))
        assert np.isposinf(q[0]) and np.isnan(q[1]) and np.isneginf(q[2])

    def test_sqrt_cr_matches_ieee(self, rng):
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import sqrt_cr

        d = rng.random(50000).astype(np.float32) * 4e6
        s = np.asarray(jax.jit(sqrt_cr)(jnp.array(d)))
        np.testing.assert_array_equal(s, np.sqrt(d))

    def test_sqrt_cr_edge_values(self):
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import sqrt_cr

        d = jnp.array([0.0, 1.0, 4.0, 2.0], jnp.float32)
        s = np.asarray(jax.jit(sqrt_cr)(d))
        np.testing.assert_array_equal(s, np.sqrt(np.asarray(d)))

    @pytest.mark.parametrize("scale", [64 / 2048, 48 / 2048, 1.0])
    def test_sample_coords_match_grid(self, scale):
        """The routes' row/column sample program (int add, f32 add of
        the offset, ``div_cr`` by the scale) equals RasterGrid's IEEE
        sample coordinates."""
        import jax
        import jax.numpy as jnp

        from fontrx.kernels.exactmath import div_cr
        from fontrx.kernels.grid import RasterGrid

        grid = RasterGrid(300, 300, -37, 241, float(np.float32(scale)))
        xs, ys = grid.sample_coords()
        cx = np.asarray(jax.jit(lambda: div_cr(
            (grid.min_x + jnp.arange(300)).astype(jnp.float32) + 0.0,
            jnp.float32(grid.scale)))())
        cy = np.asarray(jax.jit(lambda: div_cr(
            (grid.max_y - jnp.arange(300)).astype(jnp.float32) + 0.0,
            jnp.float32(grid.scale)))())
        np.testing.assert_array_equal(cx, xs)
        np.testing.assert_array_equal(cy, ys)


class TestRouteExactMode:
    @pytest.mark.parametrize("ch,size", [("g", 128), ("Q", 72)])
    def test_route_bitexact(self, dejavu, ch, size):
        """The XLA route — correctly rounded division and sqrt in the
        root solve — equals the IEEE oracle."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels import oracle
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph(ch)
        seg = glyph_segments(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), size, 2048
        ).padded(128, 128)
        out = RasterEngine().winding_glyph(seg, grid)
        np.testing.assert_array_equal(
            np.asarray(out), oracle.winding_map(seg, grid)
        )


class TestDirectPage:
    def test_direct_matches_oracle_page(self, dejavu):
        """Direct page raster equals an oracle raster of the transformed
        segments over the same page grid."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels import oracle
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer
        from fontrx.scene.transform import ViewTransform

        layout = layout_text(dejavu, "ox")
        w, h = 256, 128
        pr = PageRenderer(dejavu, layout, w, h, RasterEngine())
        view = ViewTransform.init(dejavu.info.units_per_em, w, h)
        page = pr.render_direct(view)
        assert page.shape == (h, w)
        assert page.any()

        # oracle check: build page-space segments the same way
        slots, offs = layout.instance_arrays()
        s_px = np.float32(view.scale[0] * (w / 2.0))
        segs = []
        for slot, (ex, ey) in zip(slots, offs):
            ndc = view.apply(float(ex), float(ey))
            off = np.array(
                [(ndc[0] + 1) / 2 * w, (ndc[1] + 1) / 2 * h], np.float32
            )
            n = layout.batch.seg_counts[slot]
            segs.append(layout.batch.segments[slot][:n] * s_px + off)
        allsegs = np.concatenate(segs).astype(np.float32)
        xs = np.arange(w, dtype=np.float32)
        ys = (h - 1 - np.arange(h)).astype(np.float32)
        wmap = oracle.winding_at(allsegs, xs[None, :], ys[:, None])
        np.testing.assert_array_equal(page != 0, wmap != 0)

    def test_interactive_direct_mode(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "Hi", 256, 128, RasterEngine(), mode="direct"
        )
        f0 = sess.frame()
        assert f0.any()
        sess.scroll(1.0, (0.0, 0.0))
        f1 = sess.frame()
        assert not np.array_equal(f0, f1)


class TestKernelCoverage:
    def test_matches_multipass(self, dejavu):
        """The engine's binned coverage equals the traceable unculled
        multipass reference on a tall non-square grid."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.coverage import coverage_batch
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph("B")
        seg = glyph_segments(g)[None]
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 96, 2048
        ).padded(16, 16)
        mx = np.array([grid.min_x], np.int32)
        my = np.array([grid.max_y], np.int32)
        ref = np.asarray(coverage_batch(
            jnp.asarray(seg), jnp.asarray(mx), jnp.asarray(my),
            jnp.float32(grid.scale), height=grid.height, width=grid.width,
            samples=2))
        out = np.asarray(RasterEngine().coverage_batch(
            seg, mx, my, grid.scale, height=grid.height, width=grid.width,
            samples=2))
        np.testing.assert_array_equal(ref, out)

    def test_engine_coverage_dispatch(self, dejavu):
        """Concrete inputs bin on the host, traced ones read every
        segment in every band: the coverage is the same."""
        import jax
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph("o")
        seg = glyph_segments(g)[None]
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 48, 2048
        )
        args = (
            jnp.asarray(seg),
            jnp.array([grid.min_x], jnp.int32),
            jnp.array([grid.max_y], jnp.int32),
            grid.scale,
        )
        eng = RasterEngine()
        a = np.asarray(
            eng.coverage_batch(
                *args, height=grid.height, width=grid.width, samples=2
            )
        )
        b = np.asarray(jax.jit(
            lambda s, x, y: eng.coverage_batch(
                s, x, y, grid.scale, height=grid.height, width=grid.width,
                samples=2)
        )(*args[:3]))
        np.testing.assert_array_equal(a, b)
