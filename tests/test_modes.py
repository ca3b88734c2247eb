"""Coverage (MSAA), SDF, scene, interactive-session, and CLI tests."""

import numpy as np
import pytest


class TestCoverage:
    def square(self, size=64.0):
        corners = [(0, 0), (size, 0), (size, size), (0, size)]
        segs = np.zeros((1, 8, 3, 2), np.float32)
        for i in range(4):
            p0 = np.array(corners[i], np.float32)
            p2 = np.array(corners[(i + 1) % 4], np.float32)
            segs[0, i] = [p0, (p0 + p2) / 2, p2]
        return segs

    def test_k1_equals_winding(self, dejavu):
        import jax.numpy as jnp

        from fontrx.kernels.coverage import coverage_batch
        from fontrx.kernels.winding import winding_batch
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph("A")
        seg = glyph_segments(g)[None]
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 48, 2048
        )
        args = (
            jnp.asarray(seg),
            jnp.array([grid.min_x], jnp.int32),
            jnp.array([grid.max_y], jnp.int32),
            jnp.float32(grid.scale),
        )
        cov = np.asarray(
            coverage_batch(*args, height=grid.height, width=grid.width, samples=1)
        )
        w = np.asarray(
            winding_batch(*args, height=grid.height, width=grid.width)
        )
        np.testing.assert_array_equal(cov, (w != 0).astype(np.float32))

    def test_supersampled_square_edges(self):
        import jax.numpy as jnp

        from fontrx.kernels.coverage import coverage_batch

        segs = self.square(64.0)
        cov = np.asarray(
            coverage_batch(
                jnp.asarray(segs),
                jnp.array([-8], jnp.int32),
                jnp.array([71], jnp.int32),
                jnp.float32(1.0),
                height=80, width=80, samples=4,
            )
        )[0]
        assert cov[40, 40] == 1.0   # interior fully covered
        assert cov[0, 0] == 0.0     # exterior uncovered
        # corner pixel: exactly quarter-covered by the axis-aligned square
        assert cov[71, 8] == pytest.approx(0.25)
        # values are k^2-quantized fractions
        assert np.all((cov * 16) == np.round(cov * 16))

    @pytest.mark.parametrize("samples", [2, 3])
    def test_engine_multipass_matches_reference(self, dejavu, samples):
        """RasterEngine.coverage_batch — k^2 traced-offset passes of the
        binned winding route over one binning (config 2's strategy) — is
        bit-identical to the traceable unculled multipass reference."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.coverage import coverage_batch
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import pack_glyphs

        glyphs = [dejavu.get_glyph(c)[0] for c in "HeloWrd!,"]
        batch = pack_glyphs(glyphs)
        grids = [RasterGrid.fixed_tile(tuple(b), 64, 2048, 64)
                 for b in batch.boxes]
        mx = np.array([g.min_x for g in grids], np.int32)
        my = np.array([g.max_y for g in grids], np.int32)
        ref = np.asarray(coverage_batch(
            jnp.asarray(batch.segments), jnp.asarray(mx), jnp.asarray(my),
            jnp.float32(grids[0].scale), height=64, width=64,
            samples=samples))
        out = np.asarray(RasterEngine().coverage_batch(
            batch.segments, mx, my, grids[0].scale, height=64, width=64,
            samples=samples))
        np.testing.assert_array_equal(ref, out)

    def test_engine_coverage_interpret_matches_jnp(self, dejavu):
        """Binned and unculled coverage agree on a non-square,
        non-power-of-two grid (row-band padding cropped)."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.coverage import coverage_batch
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph("e")
        seg = glyph_segments(g)[None]
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 72, 2048
        )
        args = (seg, np.array([grid.min_x], np.int32),
                np.array([grid.max_y], np.int32), grid.scale)
        kw = dict(height=grid.height, width=grid.width, samples=2)
        ref = np.asarray(coverage_batch(
            *[jnp.asarray(a) for a in args[:3]], jnp.float32(args[3]), **kw))
        out = np.asarray(RasterEngine().coverage_batch(*args, **kw))
        assert out.shape == (1, grid.height, grid.width)
        np.testing.assert_array_equal(ref, out)

    def test_coverage_monotone_in_k(self, dejavu):
        """More samples -> coverage converges; mean stays stable."""
        import jax.numpy as jnp

        from fontrx.kernels.coverage import coverage_batch
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph("o")
        seg = glyph_segments(g)[None]
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 32, 2048
        )
        args = (
            jnp.asarray(seg),
            jnp.array([grid.min_x], jnp.int32),
            jnp.array([grid.max_y], jnp.int32),
            jnp.float32(grid.scale),
        )
        means = [
            float(
                np.asarray(
                    coverage_batch(
                        *args, height=grid.height, width=grid.width, samples=k
                    )
                ).mean()
            )
            for k in (2, 4)
        ]
        assert abs(means[0] - means[1]) < 0.01


class TestSDF:
    def test_square_distances(self):
        import jax.numpy as jnp

        from fontrx.kernels.sdf import sdf_batch

        corners = [(0, 0), (64, 0), (64, 64), (0, 64)]
        segs = np.zeros((1, 8, 3, 2), np.float32)
        for i in range(4):
            p0 = np.array(corners[i], np.float32)
            p2 = np.array(corners[(i + 1) % 4], np.float32)
            segs[0, i] = [p0, (p0 + p2) / 2, p2]
        sdf = np.asarray(
            sdf_batch(
                jnp.asarray(segs),
                jnp.array([-8], jnp.int32),
                jnp.array([71], jnp.int32),
                jnp.float32(1.0),
                height=80, width=80,
            )
        )[0]
        assert sdf[40, 40] == pytest.approx(31.0, abs=1e-3)   # inside
        assert sdf[0, 0] == pytest.approx(-np.hypot(8, 7), abs=1e-3)  # outside
        assert abs(sdf[71, 8]) < 1e-3                          # on edge

    def test_sdf_quantization(self):
        from fontrx.kernels.sdf import sdf_to_u8
        import jax.numpy as jnp

        sdf = jnp.array([[-100.0, -8.0, 0.0, 8.0, 100.0]])
        u8 = np.asarray(sdf_to_u8(sdf, spread=8.0))
        assert list(u8[0]) == [0, 1, 128, 255, 255]

    def test_glyph_sdf_sign_matches_fill(self, dejavu):
        import jax.numpy as jnp

        from fontrx.kernels.grid import RasterGrid
        from fontrx.kernels.sdf import sdf_batch
        from fontrx.kernels import oracle
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph("H")
        seg = glyph_segments(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 32, 2048
        )
        sdf = np.asarray(
            sdf_batch(
                jnp.asarray(seg)[None],
                jnp.array([grid.min_x], jnp.int32),
                jnp.array([grid.max_y], jnp.int32),
                jnp.float32(grid.scale),
                height=grid.height, width=grid.width,
            )
        )[0]
        fill = oracle.winding_map(seg, grid) != 0
        # on-outline pixels have distance exactly 0; the inside/outside
        # sign survives in the float sign bit (+0.0 vs -0.0)
        np.testing.assert_array_equal(~np.signbit(sdf), fill)


class TestViewTransform:
    def test_apply_invert_roundtrip(self):
        from fontrx.scene.transform import ViewTransform

        v = ViewTransform.init(2048, 800, 600)
        x, y = v.apply(1000.0, 500.0)
        bx, by = v.invert(x, y)
        assert bx == pytest.approx(1000.0, rel=1e-5)
        assert by == pytest.approx(500.0, rel=1e-5)

    def test_zoom_preserves_cursor_point(self):
        from fontrx.scene.transform import ViewTransform

        v = ViewTransform.init(2048, 800, 600)
        cursor = (0.3, -0.2)
        em = v.invert(*cursor)
        v2 = v.zoomed(3.0, cursor)
        em2 = v2.invert(*cursor)
        assert em[0] == pytest.approx(em2[0], rel=1e-4)
        assert em[1] == pytest.approx(em2[1], rel=1e-4)

    def test_zoom_factor(self):
        from fontrx.scene.transform import ViewTransform, ZOOM_FACTOR

        v = ViewTransform.init(2048, 800, 600)
        v2 = v.zoomed(1.0, (0.0, 0.0))
        assert v2.scale[0] == pytest.approx(v.scale[0] * ZOOM_FACTOR)

    def test_drag_moves_offset(self):
        from fontrx.scene.transform import ViewTransform

        v = ViewTransform.init(2048, 800, 600)
        v2 = v.dragged(0.1, 0.2)
        assert v2.offset[0] == pytest.approx(v.offset[0] + 0.1)
        # y drag divides by aspect (Appli.zig:399)
        assert v2.offset[1] == pytest.approx(v.offset[1] + 0.2 / v.aspect_ratio)


class TestLayout:
    def test_random_text_invariants(self, dejavu, rng):
        """Property sweep over random text in all four shaping modes:
        pen x is monotone within a line, every instance's slot is in
        range, width is the max pen extent, dedup never exceeds the
        stream length."""
        import itertools

        from fontrx.scene.layout import layout_text

        alphabet = "afilfTVAWo .\n"
        for trial in range(8):
            n = int(rng.integers(1, 40))
            text = "".join(alphabet[i] for i in rng.integers(0, len(alphabet), n))
            for kern, liga in itertools.product((False, True), repeat=2):
                lt = layout_text(dejavu, text, kern=kern, ligatures=liga)
                n_glyphs = len(text) - text.count("\n")
                assert len(lt.instances) <= n_glyphs
                if not liga:
                    assert len(lt.instances) == n_glyphs
                assert len(lt.batch) <= max(len(lt.instances), 1)
                max_seen = 0.0
                for a, b in zip(lt.instances, lt.instances[1:]):
                    if a.y == b.y:  # same line: pen never goes left
                        assert b.x >= a.x
                for inst in lt.instances:
                    assert 0 <= inst.glyph_slot < max(len(lt.batch), 1)
                    w = lt.batch.advance_widths[inst.glyph_slot]
                    max_seen = max(max_seen, inst.x + float(w))
                if lt.instances:
                    assert lt.width == max_seen

    def test_dedup_and_advance(self, dejavu):
        from fontrx.scene.layout import layout_text

        lt = layout_text(dejavu, "AAB")
        assert len(lt.batch) == 2           # A and B dedup
        assert len(lt.instances) == 3
        aw_a = int(dejavu.advance_widths[dejavu.glyph_index("A")])
        assert lt.instances[1].x == aw_a
        assert lt.instances[2].x == 2 * aw_a

    def test_newline(self, dejavu):
        from fontrx.scene.layout import layout_text

        lt = layout_text(dejavu, "A\nB")
        assert lt.instances[1].x == 0
        assert lt.instances[1].y < 0


class TestInteractive:
    def test_session_frames_and_events(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "Hi", 256, 192, RasterEngine()
        )
        f0 = sess.frame()
        assert f0.shape == (192, 256)
        assert f0.any()
        sess.scroll(2.0, (0.0, 0.0))
        f1 = sess.frame()
        assert not np.array_equal(f0, f1)   # zoom changed the page
        sess.drag(0.5, 0.0)
        f2 = sess.frame()
        assert not np.array_equal(f1, f2)
        sess.key("m")
        sess.frame()
        assert sess.msaa
        stats = sess.stats()
        assert stats["frames"] == 4
        assert stats["mean_ms"] > 0


class TestTileCache:
    """Composite-path glyph-tile LRU (`scene/page.py::GlyphTileCache`):
    zoom-return and text edits must re-raster nothing already seen, the
    cached pages must be byte-identical to uncached rendering, and
    eviction must respect the byte budget."""

    def _session(self, dejavu, **kw):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        return InteractiveSession(
            dejavu, "Hello", 256, 192, RasterEngine(),
            mode="composite", **kw,
        )

    def test_zoom_return_hits(self, dejavu):
        s = self._session(dejavu)
        f1 = s.frame()
        s.scroll(1.0)
        s.frame()
        m1 = s.tile_cache.stats()
        s.scroll(-1.0)
        f3 = s.frame()
        m2 = s.tile_cache.stats()
        assert m2["misses"] == m1["misses"]  # revisited zoom: no raster
        assert m2["hits"] > m1["hits"]
        np.testing.assert_array_equal(f1, f3)

    def test_char_input_reuses_seen_glyphs(self, dejavu):
        s = self._session(dejavu)
        s.frame()
        m0 = s.tile_cache.stats()
        s.char_input(" olleH")  # same glyph set + space (empty glyph)
        s.frame()
        m1 = s.tile_cache.stats()
        # only the space is new (and it has an empty tile slot)
        assert m1["misses"] <= m0["misses"] + 1

    def test_cached_page_matches_uncached(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import GlyphTileCache, PageRenderer
        from fontrx.scene.transform import ViewTransform

        eng = RasterEngine()
        layout = layout_text(dejavu, "Wavy")
        view = ViewTransform.init(dejavu.info.units_per_em, 256, 192)
        plain = PageRenderer(dejavu, layout, 256, 192, eng)
        cached = PageRenderer(
            dejavu, layout, 256, 192, eng, tile_cache=GlyphTileCache()
        )
        np.testing.assert_array_equal(
            plain.render(view), cached.render(view)
        )
        # second renderer sharing the warm cache: full hit, same bytes
        warm = PageRenderer(
            dejavu, layout, 256, 192, eng, tile_cache=cached.tile_cache
        )
        misses_before = cached.tile_cache.misses
        np.testing.assert_array_equal(plain.render(view), warm.render(view))
        assert cached.tile_cache.misses == misses_before

    def test_eviction_respects_budget(self, dejavu):
        from fontrx.scene.page import GlyphTileCache

        import jax.numpy as jnp

        c = GlyphTileCache(capacity_bytes=3 * 64 * 64)
        for i in range(5):
            c.put((i, 1.0, "fill", 64), jnp.zeros((64, 64), jnp.uint8))
        assert c.nbytes <= 3 * 64 * 64
        assert len(c) == 3
        assert c.get((0, 1.0, "fill", 64)) is None   # evicted (LRU)
        assert c.get((4, 1.0, "fill", 64)) is not None


class TestToggles:
    """The m/d/t keybinds must have *observable* frame effects in both
    render modes (reference behavior: Ctrl+M/T/D,
    ``CallbackContext.zig:67-78`` + ``VulkanContext.zig:114-141,891``)."""

    @pytest.mark.parametrize("mode", ["direct", "composite"])
    def test_msaa_and_debug_change_frames(self, dejavu, mode):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "Hi", 256, 192, RasterEngine(), mode=mode
        )
        base = sess.frame()
        sess.key("m")
        f_msaa = sess.frame()
        assert sess.msaa
        assert not np.array_equal(base, f_msaa)  # antialiased edges
        # msaa frames contain partial coverage, not just 0/255
        assert len(np.unique(f_msaa)) > 2
        sess.key("m")
        sess.key("d")
        f_debug = sess.frame()
        assert sess.debug
        assert not np.array_equal(base, f_debug)  # winding visualization
        # debug background is the reference's winding-vis gray (100)
        assert (f_debug == 100).any()

    @pytest.mark.parametrize("mode", ["direct", "composite"])
    def test_transparent_changes_display_alpha(self, dejavu, mode):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "Hi", 256, 192, RasterEngine(), mode=mode
        )
        opaque = sess.display_frame()
        assert opaque.shape == (192, 256, 4)
        assert (opaque[..., 3] == 255).all()
        sess.key("t")
        transp = sess.display_frame()
        assert sess.transparent
        assert not (transp[..., 3] == 255).all()  # background alpha 0
        np.testing.assert_array_equal(transp[..., 3], transp[..., 0])


class TestCLI:
    FONT = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"

    def test_missing_required(self, capsys):
        from fontrx.cli.main import main

        assert main([]) == 2
        err = capsys.readouterr().err
        assert "font_file" in err

    def test_error_accumulation(self, capsys):
        from fontrx.cli.main import main

        assert main(["--nope", "-t"]) == 2
        err = capsys.readouterr().err
        assert "unknown option" in err and "requires a value" in err

    def test_duplicate_flag(self):
        from fontrx.cli.config import ConfigError, parse_args

        with pytest.raises(ConfigError, match="duplicate"):
            parse_args(["-f", "x", "-f", "y"])

    def test_triangulation_mode(self, capsys, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "b.qoi"
        rc = main(["-f", self.FONT, "-t", "B", "-m", "triangulation",
                   "-s", "32", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        assert img.any()

    def test_kern_flag_narrows_page(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        plain, kerned = tmp_path / "p.qoi", tmp_path / "k.qoi"
        assert main(["-f", self.FONT, "-t", "AV", "-m", "fill",
                     "-s", "48", "-o", str(plain)]) == 0
        assert main(["-f", self.FONT, "-t", "AV", "-m", "fill",
                     "-s", "48", "-o", str(kerned), "-k"]) == 0
        wp = decode(plain.read_bytes()).shape[1]
        wk = decode(kerned.read_bytes()).shape[1]
        assert wk < wp  # AV kerns negative in DejaVu

    def test_sdf_mode(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "s.qoi"
        rc = main(["-f", self.FONT, "-t", "A", "-m", "sdf", "-s", "32",
                   "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        assert img.shape == (32, 32, 3)

    def test_hinting_flag(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "h.qoi"
        rc = main(["-f", self.FONT, "-t", "Hi", "-m", "fill", "-s", "16",
                   "-k", "--hinting", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        assert img.any()
        # grid-fitted fill is hard-edged: every pixel fully on or off
        assert set(np.unique(img)) <= {0, 255}
        # the H stem lands on whole pixels: each inked column of the
        # page is solid through the glyph's vertical extent or empty
        ink = img[..., 0] == 255
        cols = ink.any(axis=0)
        assert cols.sum() > 4

    def test_hinting_warns_unsupported_mode(self, tmp_path, caplog):
        from fontrx.cli.main import main

        out = tmp_path / "s.qoi"
        rc = main(["-f", self.FONT, "-t", "A", "-m", "sdf", "-s", "32",
                   "--hinting", "-o", str(out)])
        assert rc == 0  # falls back to the unhinted sdf path


class TestCompilationCache:
    def test_enable_and_stats(self, tmp_path):
        from fontrx.engine.cache import cache_stats, enable_compilation_cache

        d = enable_compilation_cache(str(tmp_path / "xla"))
        stats = cache_stats(str(tmp_path / "xla"))
        assert stats["dir"] == d
        # render something tiny to produce a cache entry
        import jax
        import jax.numpy as jnp

        jax.jit(lambda x: x * 2 + 1)(jnp.ones((8, 8))).block_until_ready()
        stats = cache_stats(str(tmp_path / "xla"))
        assert stats["entries"] >= 1


class TestSDFChunking:
    """The SDF streams segments in chunks under ``fori_loop`` with a
    running minimum: min commutes, so the chunk size changes no bit."""

    @pytest.mark.parametrize("chars,size", [("Ag", 32), ("W&o", 64)])
    def test_chunk_size_is_bit_neutral(self, dejavu, monkeypatch, chars,
                                       size):
        import jax.numpy as jnp

        from fontrx.kernels import sdf
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import pack_glyphs

        batch = pack_glyphs([dejavu.get_glyph(c)[0] for c in chars])
        grids = [RasterGrid.fixed_tile(tuple(b), size, 2048, size)
                 for b in batch.boxes]
        args = (
            jnp.asarray(batch.segments),
            jnp.array([g.min_x for g in grids], jnp.int32),
            jnp.array([g.max_y for g in grids], jnp.int32),
            jnp.float32(grids[0].scale),
        )
        ref = np.asarray(sdf.sdf_batch(*args, height=size, width=size))
        monkeypatch.setattr(sdf, "SEG_CHUNK", 5)
        sdf.sdf_batch.clear_cache()
        out = np.asarray(sdf.sdf_batch(*args, height=size, width=size))
        sdf.sdf_batch.clear_cache()
        np.testing.assert_array_equal(ref, out)
        assert np.isfinite(out).all()

    def test_engine_sdf_is_plain_sdf(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.grid import RasterGrid
        from fontrx.kernels.sdf import sdf_batch
        from fontrx.pack.segments import pack_glyphs

        import jax.numpy as jnp

        batch = pack_glyphs([dejavu.get_glyph(c)[0] for c in "Qx"])
        grids = [RasterGrid.fixed_tile(tuple(b), 32, 2048, 32)
                 for b in batch.boxes]
        mx = np.array([g.min_x for g in grids], np.int32)
        my = np.array([g.max_y for g in grids], np.int32)
        out = RasterEngine().sdf_batch(
            batch.segments, mx, my, grids[0].scale, height=32, width=32)
        ref = sdf_batch(jnp.asarray(batch.segments), jnp.asarray(mx),
                        jnp.asarray(my), jnp.float32(grids[0].scale),
                        height=32, width=32)
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


class TestCLIHelp:
    def test_help_exits_zero_and_lists_flags(self, capsys):
        from fontrx.cli.main import main

        assert main(["-h"]) == 0
        out = capsys.readouterr().out
        for flag in ("--font_file", "--mode", "--interactive", "(required)"):
            assert flag in out


class TestKerning:
    def test_kern_pair_lookup(self, dejavu):
        assert dejavu.kerning is not None
        av = int(dejavu.kerning.lookup(
            dejavu.glyph_index("A"), dejavu.glyph_index("V")))
        assert av < 0  # AV is famously negative
        # unkerned pair returns 0
        assert int(dejavu.kerning.lookup(
            dejavu.glyph_index("H"), dejavu.glyph_index("H"))) == 0

    def test_layout_kern_optin(self, dejavu):
        from fontrx.scene.layout import layout_text

        plain = layout_text(dejavu, "AV")
        kerned = layout_text(dejavu, "AV", kern=True)
        av = int(dejavu.kerning.lookup(
            dejavu.glyph_index("A"), dejavu.glyph_index("V")))
        assert kerned.instances[1].x == plain.instances[1].x + av
        # default layout stays reference-exact (advance widths only)
        aw = int(dejavu.advance_widths[dejavu.glyph_index("A")])
        assert plain.instances[1].x == aw

    def test_kern_resets_across_newline(self, dejavu):
        from fontrx.scene.layout import layout_text

        kerned = layout_text(dejavu, "A\nV", kern=True)
        assert kerned.instances[1].x == 0  # new line: no kern carryover


class TestWordWrap:
    """Greedy word wrap (`layout_text(wrap_width=...)`), a layout
    capability beyond the reference (whose pen never breaks lines,
    `Appli.zig:343-351`)."""

    def test_wraps_at_spaces_within_budget(self, dejavu):
        from fontrx.scene.layout import layout_text

        text = "the quick brown fox jumps over the lazy dog"
        lt = layout_text(dejavu, text, wrap_width=12000)
        rows = {}
        for i in lt.instances:
            rows.setdefault(i.y, []).append(i.x)
        assert len(rows) > 1
        space_w = int(dejavu.advance_widths[dejavu.glyph_index(" ")])
        # every line's glyph-start extent stays within budget (starts
        # are < budget by construction; only an over-budget single
        # word may overflow, and this text has none)
        for xs in rows.values():
            assert max(xs) < 12000

    def test_over_budget_word_gets_own_line(self, dejavu):
        from fontrx.scene.layout import layout_text

        lt = layout_text(
            dejavu, "hi supercalifragilistic yes", wrap_width=3000
        )
        assert len({i.y for i in lt.instances}) == 3

    def test_no_wrap_is_single_line(self, dejavu):
        from fontrx.scene.layout import layout_text

        lt = layout_text(dejavu, "abc def ghi")
        assert len({i.y for i in lt.instances}) == 1

    def test_wrap_composes_with_newlines_and_shaping(self, dejavu):
        from fontrx.scene.layout import layout_text

        lt = layout_text(
            dejavu, "waffle fish\nsecond line here",
            wrap_width=6000, ligatures=True, kern=True,
        )
        assert len({i.y for i in lt.instances}) >= 3

    def test_wrapped_equals_manual_breaks(self, dejavu):
        """Wrapping must place glyphs exactly like the same text with
        newlines inserted at the breaks wrapping chose."""
        from fontrx.scene.layout import layout_text

        text = "one two three four"
        a = layout_text(dejavu, text, wrap_width=6000)
        # reconstruct the chosen breaks: glyphs per line, then re-split
        # the word stream manually at those counts
        lines_a = {}
        for inst in a.instances:
            lines_a.setdefault(round(inst.y), []).append(inst)
        counts = [
            len(v) for _, v in sorted(lines_a.items(), reverse=True)
        ]
        words = text.split(" ")
        manual, k = [], 0
        for n in counts:
            taken, consumed = [], 0
            while k < len(words) and consumed + len(words[k]) <= n:
                consumed += len(words[k]) + 1  # word + inner space
                taken.append(words[k])
                k += 1
                if consumed - 1 == n:
                    break
            manual.append(" ".join(taken))
        b = layout_text(dejavu, "\n".join(manual))
        pa = sorted((round(i.y), round(i.x)) for i in a.instances)
        pb = sorted((round(i.y), round(i.x)) for i in b.instances)
        assert pa == pb


class TestLoopBlinnFill:
    """``loopblinn_fill`` (the CLI's triangulation mode) is the batch
    kernel's single-glyph view — same float program per (triangle,
    pixel) pair."""

    @pytest.mark.parametrize("ch", list("ABgo&@"))
    def test_matches_batch_coverage(self, dejavu, ch):
        import jax.numpy as jnp

        from fontrx.geometry import TriangulatedGlyph
        from fontrx.kernels.grid import RasterGrid
        from fontrx.kernels.loopblinn import (
            _pack_triangle_arrays,
            loopblinn_batch,
            loopblinn_fill,
            pad_triangles,
        )

        g, _ = dejavu.get_glyph(ch)
        tg = TriangulatedGlyph.from_glyph(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 96, 2048)
        tris, cls = pad_triangles(
            _pack_triangle_arrays(tg), tg.classes, len(tg.triangles) + 3)
        a = np.asarray(loopblinn_batch(
            jnp.asarray(tris)[None], jnp.asarray(cls)[None],
            jnp.array([grid.min_x], jnp.int32),
            jnp.array([grid.max_y], jnp.int32), jnp.float32(grid.scale),
            height=grid.height, width=grid.width))[0]
        fill = loopblinn_fill(tg, grid)
        np.testing.assert_array_equal(np.where(a, 255, 0), fill)
        assert fill.any()


class TestTextEditing:
    """char_input + backspace: the edit half of user text input (the
    reference stubs the char callback, `CallbackContext.zig:80-88`)."""

    def test_backspace_restores_frame(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        s = InteractiveSession(
            dejavu, "Hi", 128, 96, RasterEngine()
        )
        f0 = s.frame()
        s.char_input("!")
        f1 = s.frame()
        assert not np.array_equal(f0, f1)
        s.backspace()
        np.testing.assert_array_equal(s.frame(), f0)
        s.backspace(99)  # over-deleting empties, never raises
        assert s.text == ""
        s.frame()

    def test_stdin_protocol_back(self, dejavu, tmp_path):
        from fontrx.cli.config import parse_args
        from fontrx.cli.main import _dispatch
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        cfg = parse_args([
            "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        ])
        s = InteractiveSession(
            dejavu, "ab", 128, 96, RasterEngine()
        )
        n = _dispatch(s, cfg, "type", ["cd"], 0)
        assert s.text == "abcd"
        n = _dispatch(s, cfg, "back", ["2"], n)
        assert s.text == "ab"
        _dispatch(s, cfg, "back", [], n)
        assert s.text == "a"


class TestOutlineMode:
    """Stroked outlines from the distance field (`-m outline`): ink
    hugs the contour, glyph interiors stay empty."""

    def test_ring_not_fill(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "o.qoi"
        rc = main([
            "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            "-t", "O", "-m", "outline", "-s", "64", "--stroke", "3",
            "-o", str(out),
        ])
        assert rc == 0
        img = np.asarray(decode(out.read_bytes()))[:, :, 0]
        assert (img > 128).sum() > 100          # the stroke has ink
        # the counter (center of O) is empty, unlike fill mode
        h, w = img.shape
        assert img[h // 2 - 4 : h // 2 + 4, w // 2 - 2 : w // 2 + 2].max() == 0

    def test_wider_stroke_more_ink(self, dejavu, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        inks = []
        for sw in ("2", "6"):
            out = tmp_path / f"s{sw}.qoi"
            main([
                "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                "-t", "X", "-m", "outline", "-s", "64", "--stroke", sw,
                "-o", str(out),
            ])
            inks.append(
                (np.asarray(decode(out.read_bytes()))[:, :, 0] > 128).sum()
            )
        assert inks[1] > inks[0] * 1.5


class TestLCDMode:
    """LCD subpixel coverage (3x1 RGB stripes): channels are coverage
    at shifted sample lattices, so the G channel must equal the plain
    coverage kernel and R/B must differ at vertical stems."""

    def test_channel_semantics(self, dejavu):
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.coverage import coverage_batch
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import pack_glyphs

        g, _ = dejavu.get_glyph("H")
        batch = pack_glyphs([g])
        grid = RasterGrid.fixed_tile(
            tuple(batch.boxes[0]), 48, 2048, 48
        )
        args = (
            jnp.asarray(batch.segments),
            jnp.array([grid.min_x], jnp.int32),
            jnp.array([grid.max_y], jnp.int32),
            jnp.float32(grid.scale),
        )
        lcd = np.asarray(RasterEngine().lcd_coverage_batch(
            batch.segments, np.array([grid.min_x], np.int32),
            np.array([grid.max_y], np.int32), grid.scale,
            height=48, width=48, samples=2,
        ))[0]
        plain = np.asarray(coverage_batch(
            *args, height=48, width=48, samples=2
        ))[0]
        np.testing.assert_array_equal(lcd[:, :, 1], plain)
        assert not np.array_equal(lcd[:, :, 0], lcd[:, :, 2])
        # channel means are near-identical (same ink, shifted 1/3 px)
        assert abs(lcd[:, :, 0].mean() - lcd[:, :, 2].mean()) < 0.01

    def test_cli_lcd_page(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "lcd.qoi"
        rc = main([
            "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            "-t", "Hi", "-m", "lcd", "-s", "32", "-o", str(out),
        ])
        assert rc == 0
        img = np.asarray(decode(out.read_bytes()))
        assert img.shape == (32, 64, 3)
        # subpixel fringes: R and B differ somewhere
        assert (img[:, :, 0] != img[:, :, 2]).any()


class TestOblique:
    """Synthetic italic (`layout_text(oblique=)` / `--oblique`)."""

    def test_shear_preserves_segments_and_y(self, dejavu):
        from fontrx.font.glyph import shear_glyph

        g, _ = dejavu.get_glyph("H")
        s = shear_glyph(g, 0.25)
        assert s.num_segments == g.num_segments
        assert (s.box.y_min, s.box.y_max) == (g.box.y_min, g.box.y_max)
        assert s.box.x_max > g.box.x_max  # top leans right

    def test_layout_oblique_changes_ink_not_advances(self, dejavu):
        from fontrx.scene.layout import layout_text

        a = layout_text(dejavu, "Hi", kern=True)
        b = layout_text(dejavu, "Hi", kern=True, oblique=0.21)
        assert [(i.x, i.y) for i in a.instances] == \
               [(i.x, i.y) for i in b.instances]  # advances unchanged
        assert not np.array_equal(
            a.batch.segments, b.batch.segments
        )

    def test_zero_slant_is_identity(self, dejavu):
        from fontrx.font.glyph import shear_glyph

        g, _ = dejavu.get_glyph("x")
        assert shear_glyph(g, 0.0) is g


class TestSmoothMode:
    """Antialiased SDF fill (`-m smooth`) with synthetic embolden."""

    def test_smooth_matches_fill_shape(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        outs = {}
        for mode in ("fill", "smooth"):
            p = tmp_path / f"{mode}.qoi"
            main([
                "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                "-t", "G", "-m", mode, "-s", "64", "-o", str(p),
            ])
            outs[mode] = np.asarray(decode(p.read_bytes()))[:, :, 0]
        # hard thresholds agree away from the 1px soft edge: compare
        # confidently-inside pixels
        smooth_in = outs["smooth"] > 250
        # fill page has margins; smooth is a raw tile sheet — just check
        # the smooth render has interior ink and graded edges
        assert smooth_in.sum() > 200
        edge = (outs["smooth"] > 20) & (outs["smooth"] < 235)
        assert edge.sum() > 50  # antialiased rim exists

    def test_embolden_grows_ink(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        inks = []
        for e in ("0", "2"):
            p = tmp_path / f"e{e}.qoi"
            main([
                "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                "-t", "l", "-m", "smooth", "-s", "64",
                "--embolden", e, "-o", str(p),
            ])
            inks.append(
                (np.asarray(decode(p.read_bytes()))[:, :, 0] > 128).sum()
            )
        assert inks[1] > inks[0] * 1.3


class TestRTL:
    """Right-to-left layout (`rtl=True`): logical-to-visual reversal
    after shaping/wrapping (pure-RTL runs; Hebrew in DejaVu)."""

    def test_reversal_mirrors_pen_order(self, dejavu):
        from fontrx.scene.layout import layout_text

        heb = "שלום"  # shalom, 4 distinct glyphs
        ltr = layout_text(dejavu, heb)
        rtl = layout_text(dejavu, heb, rtl=True)
        # same glyph set; instances stay in LOGICAL order (positioning
        # ran on the logical stream) but the first logical glyph (shin)
        # lands at the rightmost advance box
        gids_l = [ltr.slot_gids[i.glyph_slot] for i in ltr.instances]
        gids_r = [rtl.slot_gids[i.glyph_slot] for i in rtl.instances]
        assert gids_l == gids_r
        xs = {rtl.slot_gids[i.glyph_slot]: i.x for i in rtl.instances}
        assert xs[gids_l[0]] == max(xs.values())
        # the visual x order is exactly reversed vs the LTR layout
        order_ltr = sorted(range(len(gids_l)),
                           key=lambda k: ltr.instances[k].x)
        order_rtl = sorted(range(len(gids_l)),
                           key=lambda k: rtl.instances[k].x)
        assert order_rtl == list(reversed(order_ltr))

    def test_kern_pairs_stay_logical(self, dejavu):
        """Directional kern pairs must be looked up in LOGICAL order:
        the gap between two glyphs is identical in LTR and RTL layouts
        of the same text."""
        from fontrx.scene.layout import layout_text

        text = "AV"  # kerned pair in DejaVu
        ltr = layout_text(dejavu, text, kern=True)
        rtl = layout_text(dejavu, text, kern=True, rtl=True)
        a_w = int(dejavu.advance_widths[dejavu.glyph_index("A")])
        # LTR: gap = V.x - (A.x + A.advance)
        gap_ltr = ltr.instances[1].x - (ltr.instances[0].x + a_w)
        # RTL: A sits right of V; gap = A.x - (V.x + V.advance)
        v_w = int(dejavu.advance_widths[dejavu.glyph_index("V")])
        gap_rtl = rtl.instances[0].x - (rtl.instances[1].x + v_w)
        assert gap_ltr == gap_rtl != 0

    def test_rtl_composes_with_wrap(self, dejavu):
        from fontrx.scene.layout import layout_text

        heb = "שלום שלום"
        lt = layout_text(dejavu, heb, rtl=True, wrap_width=4000)
        assert len({i.y for i in lt.instances}) == 2
