"""Kernel conformance: the row-binned XLA route vs the NumPy oracle,
bit-exact (SURVEY §4 items 2/4)."""

import numpy as np
import pytest

from fontrx.kernels import oracle
from fontrx.kernels.grid import RasterGrid
from fontrx.pack.segments import glyph_segments, pack_glyphs


def glyph_case(font, ch, size):
    g, _ = font.get_glyph(ch)
    segs = glyph_segments(g)
    grid = RasterGrid.for_glyph_box(
        (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
        size, font.info.units_per_em,
    )
    return segs, grid


class TestJnpKernel:
    @pytest.mark.parametrize("ch", list("AQg@j&"))
    def test_bitexact_vs_oracle(self, dejavu, ch):
        from fontrx.kernels.winding import winding_grid

        segs, grid = glyph_case(dejavu, ch, 96)
        wo = oracle.winding_map(segs, grid)
        wj = np.asarray(winding_grid(segs, grid))
        np.testing.assert_array_equal(wo, wj)

    def test_batch_matches_singles(self, dejavu):
        from fontrx.kernels.winding import winding_batch

        import jax.numpy as jnp

        glyphs = [dejavu.get_glyph(c)[0] for c in "ABC"]
        batch = pack_glyphs(glyphs)
        grids = [
            RasterGrid.fixed_tile(tuple(b), 64, 2048, 64) for b in batch.boxes
        ]
        out = np.asarray(
            winding_batch(
                jnp.asarray(batch.segments),
                jnp.array([g.min_x for g in grids], jnp.int32),
                jnp.array([g.max_y for g in grids], jnp.int32),
                jnp.float32(grids[0].scale),
                height=64,
                width=64,
            )
        )
        for i, g in enumerate(grids):
            xs, ys = g.sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None])
            np.testing.assert_array_equal(out[i], wo)


class TestBinnedRoute:
    @pytest.mark.parametrize("ch", list("AQg"))
    def test_bitexact_vs_oracle(self, dejavu, ch):
        from fontrx.engine.raster import RasterEngine

        segs, grid = glyph_case(dejavu, ch, 64)
        wo = oracle.winding_map(segs, grid)
        wp = np.asarray(RasterEngine().winding_glyph(segs, grid))
        np.testing.assert_array_equal(wo, wp)

    def test_random_segment_soup(self, rng):
        """Host-binned vs unculled bins on random quadratic soups
        (SURVEY §4 item 4): culling changes no pixel."""
        import jax.numpy as jnp

        from fontrx.kernels.winding import (
            bin_glyph_rows,
            full_rows,
            winding_bins_xla,
        )

        b, s = 3, 16
        segs = rng.integers(-100, 100, (b, s, 3, 2)).astype(np.float32)
        min_x = rng.integers(-10, 10, b).astype(np.int32)
        max_y = rng.integers(50, 80, b).astype(np.int32)
        anchors = (jnp.asarray(min_x), jnp.asarray(max_y), jnp.float32(0.7),
                   jnp.zeros(2, jnp.float32))
        out = []
        for bins in (bin_glyph_rows(segs, max_y, 0.7, 64),
                     full_rows(jnp.asarray(segs), 64)):
            out.append(np.asarray(winding_bins_xla(
                bins.soa, bins.start, bins.count, *anchors,
                n_bands=bins.n_bands, cap=bins.cap, width=128)))
        np.testing.assert_array_equal(out[0], out[1])
        assert (out[0] != 0).any()


class TestEngine:
    def test_engine_dispatch_and_crop(self, dejavu):
        from fontrx.engine.raster import RasterEngine

        segs, grid = glyph_case(dejavu, "A", 48)
        eng = RasterEngine()
        w = np.asarray(eng.winding_glyph(segs, grid))
        assert w.shape == (grid.height, grid.width)
        np.testing.assert_array_equal(w, oracle.winding_map(segs, grid))

    def test_fill_and_gray(self, dejavu):
        from fontrx.engine.raster import RasterEngine

        segs, grid = glyph_case(dejavu, "A", 48)
        eng = RasterEngine()
        w = eng.winding_glyph(segs, grid)
        np.testing.assert_array_equal(
            np.asarray(eng.fill(w)), oracle.render_fill(segs, grid)
        )
        np.testing.assert_array_equal(
            np.asarray(eng.gray(w)), oracle.render_gray(segs, grid)
        )


class TestAtlas:
    def test_ascii_atlas(self, dejavu):
        from fontrx.engine.atlas import render_atlas
        from fontrx.engine.raster import RasterEngine

        sheet, layout = render_atlas(
            dejavu, "ABCDEFGHIJKLMNOP", 64, 64, RasterEngine()
        )
        assert sheet.shape == (layout.height, layout.width)
        assert layout.cols * layout.rows >= 16
        # every glyph tile has ink
        for i in range(16):
            x0, y0 = layout.tile_origin(i)
            assert sheet[y0 : y0 + 64, x0 : x0 + 64].any(), chr(layout.chars[i])


class TestSharding:
    @pytest.mark.parametrize("replicate_out", [False, True])
    def test_virtual_8_device_mesh(self, dejavu, replicate_out):
        """shard_map over the route must produce oracle-exact shards,
        glyph-sharded or gathered onto every device."""
        import jax
        import jax.numpy as jnp

        from fontrx.engine.atlas import pack_charset
        from fontrx.engine.sharding import make_mesh, shard_batch, winding_sharded

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        batch = pack_charset(dejavu, "ABCDEFGH", pad_batch_to=8)
        grids = [
            RasterGrid.fixed_tile(tuple(b), 64, 2048, 64) for b in batch.boxes
        ]
        mesh = make_mesh()
        seg, mx, my = shard_batch(
            mesh,
            jnp.asarray(batch.segments),
            jnp.array([g.min_x for g in grids], jnp.int32),
            jnp.array([g.max_y for g in grids], jnp.int32),
        )
        out = winding_sharded(
            seg, mx, my, jnp.float32(grids[0].scale),
            height=64, width=128, mesh=mesh, replicate_out=replicate_out,
        )
        assert len(out.sharding.device_set) == 8
        assert out.sharding.is_fully_replicated == replicate_out
        out = np.asarray(out)
        for i, g in enumerate(grids):
            gg = RasterGrid(128, 64, g.min_x, g.max_y, g.scale)
            xs, ys = gg.sample_coords()
            wo = oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None])
            np.testing.assert_array_equal(out[i], wo)


class TestGraftEntry:
    def test_entry_compiles(self):
        import jax
        import sys

        sys.path.insert(0, "/root/repo")
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert out.shape[0] == args[0].shape[0]

    def test_dryrun_multichip(self):
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestSharding2D:
    @pytest.mark.parametrize("transposed", [False, True])
    def test_glyph_by_row_mesh(self, dejavu, transposed):
        import jax
        import jax.numpy as jnp

        from fontrx.engine.atlas import pack_charset
        from fontrx.engine.sharding import make_mesh_2d, winding_sharded_2d
        from fontrx.kernels import oracle

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        batch = pack_charset(dejavu, "ABCD")
        grids = [
            RasterGrid.fixed_tile(tuple(b), 128, 2048, 128) for b in batch.boxes
        ]
        mesh = make_mesh_2d(*((4, 2) if transposed else (2, 4)))
        out = winding_sharded_2d(
            jnp.asarray(batch.segments),
            jnp.array([g.min_x for g in grids], jnp.int32),
            jnp.array([g.max_y for g in grids], jnp.int32),
            jnp.float32(grids[0].scale),
            height=128, width=128, mesh=mesh,
        )
        assert len(out.sharding.device_set) == 8
        for i, g in enumerate(grids):
            xs, ys = g.sample_coords()
            np.testing.assert_array_equal(
                np.asarray(out[i]),
                oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None]),
            )

    def test_page_raster_row_band_mesh(self, dejavu):
        """Config-5 scale-out shape: one page sharded over row bands."""
        import jax
        import jax.numpy as jnp

        from fontrx.engine.sharding import make_mesh_2d, winding_sharded_2d
        from fontrx.scene.layout import layout_text
        from fontrx.scene.transform import ViewTransform

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        layout = layout_text(dejavu, "ab")
        w, h = 256, 64
        view = ViewTransform.init(2048, w, h)
        slots, offs = layout.instance_arrays()
        s_px = np.float32(view.scale[0] * (w / 2.0))
        chunks = []
        for slot, (ex, ey) in zip(slots, offs):
            ndc = view.apply(float(ex), float(ey))
            off = np.array(
                [(ndc[0] + 1) / 2 * w, (ndc[1] + 1) / 2 * h], np.float32
            )
            n = layout.batch.seg_counts[slot]
            chunks.append(layout.batch.segments[slot][:n] * s_px + off)
        allsegs = np.concatenate(chunks).astype(np.float32)[None]
        mesh = make_mesh_2d(1, 8)
        out = winding_sharded_2d(
            jnp.asarray(allsegs), jnp.zeros(1, jnp.int32),
            jnp.full(1, h - 1, jnp.int32), jnp.float32(1.0),
            height=h, width=w, mesh=mesh,
        )
        assert len(out.sharding.device_set) == 8
        xs = np.arange(w, dtype=np.float32)
        ys = (h - 1 - np.arange(h)).astype(np.float32)
        wp = oracle.winding_at(allsegs[0], xs[None, :], ys[:, None])
        np.testing.assert_array_equal(np.asarray(out[0]), wp)


def _oracle_tiles(segs, min_x, max_y, scale, size, offset=(0.0, 0.0)):
    """Oracle winding of each glyph over its ``size`` grid, sample
    offset included (the routes' ``(f32(i) + o) / scale`` program)."""
    out = []
    for i in range(len(segs)):
        xs = ((min_x[i] + np.arange(size)).astype(np.float32)
              + np.float32(offset[0])) / np.float32(scale)
        ys = ((max_y[i] - np.arange(size)).astype(np.float32)
              + np.float32(offset[1])) / np.float32(scale)
        out.append(oracle.winding_at(segs[i], xs[None, :], ys[:, None]))
    return np.stack(out)


class TestBigBatchChunking:
    def test_batch_over_kernel_cap_matches(self, dejavu):
        """A batch of many jobs (7 glyphs x 3 bands) rasters
        oracle-exact glyph by glyph."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import pack_glyphs

        glyphs = [dejavu.get_glyph(c)[0] for c in "ABCDEFG"]
        batch = pack_glyphs(glyphs)
        eng = RasterEngine()
        w, grids = eng.winding_packed(batch, 48, 2048, 48)
        w = np.asarray(w)
        for i, g in enumerate(grids):
            xs, ys = g.sample_coords()
            np.testing.assert_array_equal(
                w[i],
                oracle.winding_at(batch.segments[i], xs[None, :], ys[:, None]),
            )


class TestBinning:
    """Host row binning (``kernels/winding.py:bin_glyph_rows``): every
    job lists exactly the glyph's live segments whose control hull can
    reach its band, capacities bucket to powers of two, and bands are
    anchored at multiples of BAND_ROWS from each glyph's top row."""

    def _bins(self, size=64, n=3, segn=120, seed=21):
        from benchmarks.cjk import UPEM, synthetic_strokes
        from fontrx.kernels.winding import bin_glyph_rows

        rng = np.random.default_rng(seed)
        segs = np.stack([synthetic_strokes(rng, segn) for _ in range(n)])
        segs[:, -7:] = 0.0  # padding rows
        scale = np.float32(size / UPEM)
        max_y = np.full(n, size - 1, np.int32)
        return segs, scale, max_y, bin_glyph_rows(segs, max_y, scale, size)

    @pytest.mark.parametrize("size", [16, 40, 64, 100])
    def test_jobs_and_capacity_buckets(self, size):
        from fontrx.kernels.winding import BAND_ROWS

        segs, scale, max_y, bins = self._bins(size=size)
        count = np.asarray(bins.count)
        start = np.asarray(bins.start)
        assert bins.n_bands == -(-size // BAND_ROWS)
        assert len(count) == len(segs) * bins.n_bands
        assert bins.cap >= count.max() and bins.cap & (bins.cap - 1) == 0
        assert bins.cap < 2 * max(count.max(), 8)
        # ranges tile the stream without gaps; padding rows never listed
        np.testing.assert_array_equal(start[1:], np.cumsum(count)[:-1])
        soa = np.asarray(bins.soa)
        assert soa.shape[1] >= count.sum()
        live = soa[:, : count.sum()]
        assert (np.abs(live).sum(axis=0) > 0).all()

    @pytest.mark.parametrize("band", [0, 1, 3])
    def test_band_lists_exactly_the_reaching_segments(self, band):
        from fontrx.kernels.winding import (
            BAND_ROWS,
            HULL_GUARD,
            SAMPLE_MARGIN_PX,
        )

        segs, scale, max_y, bins = self._bins(size=64)
        soa = np.asarray(bins.soa)
        start = np.asarray(bins.start)
        count = np.asarray(bins.count)
        for b in range(len(segs)):
            j = b * bins.n_bands + band
            got = soa[:, start[j] : start[j] + count[j]].T.reshape(-1, 3, 2)
            hi = (max_y[b] - band * BAND_ROWS + SAMPLE_MARGIN_PX) / scale
            lo = (max_y[b] - band * BAND_ROWS - BAND_ROWS + 1
                  - SAMPLE_MARGIN_PX) / scale
            live = np.abs(segs[b]).reshape(len(segs[b]), -1).sum(1) > 0
            ys = segs[b][..., 1]
            want = segs[b][live & (ys.max(1) >= lo - HULL_GUARD)
                           & (ys.min(1) <= hi + HULL_GUARD)]
            key = lambda a: sorted(map(tuple, a.reshape(len(a), -1)))
            assert key(got) == key(want)

    def test_empty_batch(self):
        """A batch with no glyphs (a colour font whose run has only
        bitmap glyphs) rasters to an empty array."""
        from fontrx.engine.raster import RasterEngine

        out = RasterEngine().winding_batch(
            np.zeros((0, 8, 3, 2), np.float32), np.zeros(0, np.int32),
            np.zeros(0, np.int32), 0.5, height=24, width=20)
        assert out.shape == (0, 24, 20)

    def test_traced_inputs_bin_unculled(self):
        """Inside jit the engine cannot bin on the host: every band
        reads all of its glyph's segments, and the result is the same."""
        import jax
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine

        segs, scale, max_y, _ = self._bins(size=32, n=2)
        eng = RasterEngine()
        mx = np.zeros(2, np.int32)
        host = np.asarray(eng.winding_batch(segs, mx, max_y, scale,
                                            height=32, width=32))
        traced = np.asarray(jax.jit(
            lambda s, x, y: eng.winding_batch(s, x, y, scale, height=32,
                                              width=32))(
            jnp.asarray(segs), jnp.asarray(mx), jnp.asarray(max_y)))
        np.testing.assert_array_equal(host, traced)
        np.testing.assert_array_equal(
            host, _oracle_tiles(segs, mx, max_y, scale, 32))


class TestPlatformCheck:
    """One dispatch decision (``engine/raster.py``): the GPU and the
    CPU run the XLA route; any other platform is an error, never a
    silent fallback."""

    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_supported_platforms(self, monkeypatch, platform):
        import jax

        from fontrx.engine import raster

        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert raster.check_platform() == platform
        assert raster.RasterEngine().platform == platform

    @pytest.mark.parametrize("platform", ["rocm", "metal"])
    def test_unknown_platform_is_an_error(self, monkeypatch, platform):
        import jax

        from fontrx.engine import raster

        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        with pytest.raises(RuntimeError, match="no raster route"):
            raster.RasterEngine()


class TestOtherFontsParity:
    @pytest.mark.parametrize("fixture", ["dejavu_serif"])
    def test_serif_kernel_parity(self, fixture, request):
        """Route == oracle on serif curves (heavier use of quadratics
        and hairline features than the sans)."""
        self._parity(request.getfixturevalue(fixture), 96)

    def test_serif_kernel_parity_small(self, dejavu_serif):
        """The same at 40 px, where one band holds most of a glyph."""
        self._parity(dejavu_serif, 40)

    @staticmethod
    def _parity(dejavu_serif, size):
        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import glyph_segments

        eng = RasterEngine()
        for ch in "SgQ&":
            g, _ = dejavu_serif.get_glyph(ch)
            segs = glyph_segments(g)
            grid = RasterGrid.for_glyph_box(
                (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                size, dejavu_serif.info.units_per_em,
            ).padded(128, 128)
            out = eng.winding_glyph(segs, grid)
            xs, ys = grid.sample_coords()
            np.testing.assert_array_equal(
                np.asarray(out),
                oracle.winding_at(segs, xs[None, :], ys[:, None]),
                err_msg=ch,
            )


class TestHighSegmentCounts:
    """CJK-regime correctness: row binning, chunk streaming and hull
    culls must stay bit-exact at 200+ segments/glyph."""

    @pytest.mark.parametrize("shuffled", [False, True])
    def test_synthetic_300seg_bitexact(self, shuffled):
        from benchmarks.cjk import UPEM, synthetic_strokes
        from fontrx.engine.raster import RasterEngine

        rng = np.random.default_rng(5)
        segs = np.stack([synthetic_strokes(rng, 300) for _ in range(2)])
        if shuffled:  # every band's range spans the whole glyph
            segs = segs[:, rng.permutation(300)]
        size = 128
        scale = np.float32(size / UPEM)
        mx = np.zeros(2, np.int32)
        max_y = np.full(2, size - 1, np.int32)
        out = np.asarray(RasterEngine().winding_batch(
            segs, mx, max_y, scale, height=size, width=size))
        np.testing.assert_array_equal(
            out, _oracle_tiles(segs, mx, max_y, scale, size))

    @pytest.mark.parametrize("size,offset", [
        (64, (0.0, 0.0)), (64, (0.25, -0.25)), (32, (-0.5, 0.5)),
        (32, (0.0, -1.0)),
    ])
    def test_kernel_matches_oracle_at_offsets(self, size, offset):
        """The route at sample offsets inside the binning margin (one
        binning serves every MSAA/LCD offset)."""
        import jax.numpy as jnp

        from benchmarks.cjk import UPEM, synthetic_strokes
        from fontrx.kernels.winding import bin_glyph_rows, winding_bins_xla
        from fontrx.pack.segments import xsort_segments

        rng = np.random.default_rng(7)
        segs = np.stack(
            [xsort_segments(synthetic_strokes(rng, 280)) for _ in range(3)])
        scale = np.float32(size / UPEM)
        mx = np.zeros(3, np.int32)
        max_y = np.full(3, size - 1, np.int32)
        bins = bin_glyph_rows(segs, max_y, scale, size)
        out = np.asarray(winding_bins_xla(
            bins.soa, bins.start, bins.count, jnp.asarray(mx),
            jnp.asarray(max_y), jnp.float32(scale),
            jnp.asarray(offset, jnp.float32), n_bands=bins.n_bands,
            cap=bins.cap, width=size))[:, :size]
        np.testing.assert_array_equal(
            out, _oracle_tiles(segs, mx, max_y, scale, size, offset))

    def test_winding_invariant_under_segment_order(self):
        """Winding is a sum of per-segment contributions — shuffling the
        segment stream (which changes every job's chunk coherence and
        which chunks the hull culls skip) must not change a pixel."""
        from benchmarks.cjk import UPEM, synthetic_strokes
        from fontrx.engine.raster import RasterEngine

        rng = np.random.default_rng(6)
        sorted_segs = synthetic_strokes(rng, 256, y_sorted=True)
        shuffled = sorted_segs[rng.permutation(len(sorted_segs))]
        size = 256
        scale = np.float32(size / UPEM)
        eng = RasterEngine()

        def run(s):
            return np.asarray(eng.winding_batch(
                s[None], np.zeros(1, np.int32),
                np.full(1, size - 1, np.int32), scale,
                height=size, width=size))[0]

        np.testing.assert_array_equal(run(sorted_segs), run(shuffled))


class TestPackOrder:
    """Pack-time segment order is free: x-sorted and y-sorted packs of
    the same glyphs raster identically."""

    @pytest.mark.parametrize("tile,chars", [(64, "AgWo8@e!"), (32, "Hi,fj")])
    def test_matches_per_glyph(self, dejavu, tile, chars):
        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import pack_glyphs

        glyphs = [dejavu.get_glyph(c)[0] for c in chars]
        eng = RasterEngine()
        ref, ref_grids = eng.winding_packed(
            pack_glyphs(glyphs), tile, 2048, tile
        )
        xs, grids = eng.winding_packed(
            pack_glyphs(glyphs, sort="x"), tile, 2048, tile)
        assert xs.shape == (len(glyphs), tile, tile)
        for i in range(len(glyphs)):
            assert (grids[i].min_x, grids[i].max_y) == (
                ref_grids[i].min_x, ref_grids[i].max_y)
            np.testing.assert_array_equal(
                np.asarray(xs[i]), np.asarray(ref[i]),
                err_msg=f"glyph {chars[i]}",
            )

    def test_xsorted_pack_matches_default(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import pack_glyphs

        glyphs = [dejavu.get_glyph(c)[0] for c in "AB"]
        eng = RasterEngine()
        a, _ = eng.winding_packed(pack_glyphs(glyphs, sort="x"), 64, 2048, 64)
        b, _ = eng.winding_packed(pack_glyphs(glyphs), 64, 2048, 64)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestShardedSdfLoopBlinn:
    """Glyph-axis sharding for the SDF and triangle-fill atlases
    (`engine/sharding.py::sdf_sharded/loopblinn_sharded`) — each shard
    must equal the unsharded computation's slice on the virtual
    8-device mesh."""

    @pytest.mark.parametrize("wide", [False, True])
    def test_sdf_sharded_matches_unsharded(self, dejavu, wide):
        import jax
        import jax.numpy as jnp

        from fontrx.engine.atlas import pack_charset
        from fontrx.engine.sharding import (
            make_mesh, sdf_sharded, shard_batch,
        )
        from fontrx.kernels.sdf import sdf_batch

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        size = 48 if wide else 32
        batch = pack_charset(dejavu, "ABCDEFGH", pad_batch_to=8)
        grids = [
            RasterGrid.fixed_tile(tuple(b), size, 2048, size)
            for b in batch.boxes
        ]
        mesh = make_mesh()
        args = (
            jnp.asarray(batch.segments),
            jnp.array([g.min_x for g in grids], jnp.int32),
            jnp.array([g.max_y for g in grids], jnp.int32),
        )
        seg, mx, my = shard_batch(mesh, *args)
        out = sdf_sharded(
            seg, mx, my, jnp.float32(grids[0].scale),
            height=size, width=size, mesh=mesh,
        )
        assert len(out.sharding.device_set) == 8
        ref = np.asarray(sdf_batch(
            *args, jnp.float32(grids[0].scale), height=size, width=size
        ))
        np.testing.assert_array_equal(np.asarray(out), ref)

    @pytest.mark.parametrize("curvy", [False, True])
    def test_loopblinn_sharded_matches_unsharded(self, dejavu, curvy):
        import jax
        import jax.numpy as jnp

        from fontrx.engine.sharding import loopblinn_sharded, make_mesh
        from fontrx.geometry import TriangulatedGlyph
        from fontrx.kernels.loopblinn import (
            _pack_triangle_arrays,
            loopblinn_batch,
            pad_triangles,
        )

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        chars = "gjQ@&%os" if curvy else "ABCDEFGH"
        tgs = [
            TriangulatedGlyph.from_glyph(dejavu.get_glyph(c)[0])
            for c in chars
        ]
        cap = max(len(t.triangles) for t in tgs)
        tris = np.zeros((len(tgs), cap, 3, 4), np.float32)
        cls = np.full((len(tgs), cap), 3, np.int32)
        boxes = []
        for i, (c, tg) in enumerate(zip(chars, tgs)):
            p, pc = pad_triangles(
                _pack_triangle_arrays(tg), tg.classes, cap
            )
            tris[i] = p
            cls[i] = pc
            g, _ = dejavu.get_glyph(c)
            boxes.append(
                (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max)
            )
        grids = [
            RasterGrid.fixed_tile(b, 128, 2048, 128) for b in boxes
        ]
        mesh = make_mesh()
        args = (
            jnp.asarray(tris), jnp.asarray(cls),
            jnp.array([g.min_x for g in grids], jnp.int32),
            jnp.array([g.max_y for g in grids], jnp.int32),
        )
        out = loopblinn_sharded(
            *args, jnp.float32(grids[0].scale),
            height=128, width=128, mesh=mesh,
        )
        assert len(out.sharding.device_set) == 8
        ref = np.asarray(loopblinn_batch(
            *args, jnp.float32(grids[0].scale), height=128, width=128
        ))
        np.testing.assert_array_equal(np.asarray(out), ref)


def _soup_page(rng, n=300, width=2048, height=128):
    """Random page-space quadratics over a wide strip (pixel units)."""
    p0 = rng.uniform(0, [width, height], (n, 2))
    p1 = p0 + rng.uniform(-60, 60, (n, 2))
    p2 = p0 + rng.uniform(-60, 60, (n, 2))
    return np.stack([p0, p1, p2], 1).astype(np.float32)[None]


class TestWidePage:
    """Pages wider and taller than one band: the page binning (instance
    runs per band) and the route reproduce the unculled raster."""

    @pytest.mark.parametrize("offset", [(0.0, 0.0), (0.25, -0.25)])
    def test_binned_matches_unculled_wide_page(self, rng, offset):
        import jax.numpy as jnp

        from fontrx.kernels.winding import (
            bin_glyph_rows,
            full_rows,
            winding_bins_xla,
        )

        seg = _soup_page(rng)
        anchors = (jnp.zeros(1, jnp.int32), jnp.full(1, 127, jnp.int32),
                   jnp.float32(1.0), jnp.asarray(offset, jnp.float32))
        out = []
        for bins in (bin_glyph_rows(seg, np.array([127]), 1.0, 128),
                     full_rows(jnp.asarray(seg), 128)):
            out.append(np.asarray(winding_bins_xla(
                bins.soa, bins.start, bins.count, *anchors,
                n_bands=bins.n_bands, cap=bins.cap, width=2048)))
        np.testing.assert_array_equal(out[0], out[1])
        assert int((out[0] != 0).sum()) > 1000

    def test_render_direct_wide_page(self, dejavu):
        """A 2048-px page renders with ink, equal to the unculled
        raster of the same page-space segments."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.winding import bucket
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer, _direct_page_step
        from fontrx.scene.transform import ViewTransform

        layout = layout_text(dejavu, "Wide page check")
        view = ViewTransform.init(dejavu.info.units_per_em, 2048, 128)
        pr = PageRenderer(dejavu, layout, 2048, 128, RasterEngine())
        page = np.asarray(pr.render_direct(view))
        assert page.shape == (128, 2048)
        assert int((page != 0).sum()) > 100
        stream, idx, xs, s_px, _, iss, _ = pr._frame(view)
        n = int(iss[-1])
        full = np.asarray(_direct_page_step(
            stream, idx, jnp.asarray(xs), s_px, jnp.zeros(8, jnp.int32),
            jnp.full(8, n, jnp.int32), np.int32(127),
            jnp.zeros((1, 2), jnp.float32), n_bands=8,
            cap=bucket(n, 256), page_w=2048, out_h=128))
        np.testing.assert_array_equal(page, full)

    def test_page_segments_feed_the_oracle(self, dejavu):
        """``PageRenderer.page_segments`` are the segments the page
        rasters: the oracle over them reproduces the page."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer
        from fontrx.scene.transform import ViewTransform

        layout = layout_text(dejavu, "Oracle page\nsecond line")
        w, h = 320, 160
        pr = PageRenderer(dejavu, layout, w, h, RasterEngine())
        view = ViewTransform.init(dejavu.info.units_per_em, w, h).zoomed(
            -4.0, (-1.0, 1.0))
        page = np.asarray(pr.render_direct(view))
        segs = pr.page_segments(view)
        xs = np.arange(w, dtype=np.float32)
        ys = (h - 1 - np.arange(h)).astype(np.float32)
        wo = oracle.winding_at(segs, xs[None, :], ys[:, None])
        np.testing.assert_array_equal(page != 0, wo != 0)
        assert page.any()

    def test_render_direct_msaa_equals_four_pass(self, dejavu):
        """MSAA pages sum four single-offset fills exactly."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.coverage import sample_offsets
        from fontrx.kernels.winding import bucket
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer, _direct_page_step
        from fontrx.scene.transform import ViewTransform

        layout = layout_text(dejavu, "MSAA page pair")
        pr = PageRenderer(dejavu, layout, 1024, 128, RasterEngine())
        view = ViewTransform.init(dejavu.info.units_per_em, 1024, 128)
        page = np.asarray(pr.render_direct(view, msaa=True))
        assert page.shape == (128, 1024)
        assert len(np.unique(page)) > 2  # actually antialiased

        stream, idx, xs, s_px, base, iss, ext = pr._frame(view)
        start, count = pr._band_ranges(base, iss, ext, float(s_px), 127, 8)
        acc = None
        for off in sample_offsets(2):
            f = np.asarray(_direct_page_step(
                stream, idx, jnp.asarray(xs), s_px, jnp.asarray(start),
                jnp.asarray(count), np.int32(127), jnp.asarray(off[None]),
                n_bands=8, cap=bucket(int(count.max()), 256), page_w=1024,
                out_h=128,
            )).astype(np.uint16)
            acc = f if acc is None else acc + f
        np.testing.assert_array_equal(page, (acc // 4).astype(np.uint8))
