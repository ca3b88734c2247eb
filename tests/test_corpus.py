"""Cross-font corpus: parse + raster + layout over a set of real
hinted/compound-heavy fonts (ROADMAP testing item: golden-corpus
expansion beyond DejaVuSans).

Every font in the corpus must (a) parse, (b) raster a sample of glyphs
BIT-identically to the float oracle on the jnp backend, (c) survive
layout with every shaping extension enabled, and (d) degrade GSUB/GPOS
/GDEF to None rather than raise when absent or unusable.
"""

import os

import numpy as np
import pytest

from fontrx.font.font import Font

DEJAVU_DIR = "/usr/share/fonts/truetype/dejavu"


def _corpus() -> list[str]:
    paths = [
        os.path.join(DEJAVU_DIR, f)
        for f in (
            "DejaVuSerif.ttf",
            "DejaVuSansMono.ttf",
            "DejaVuSans-Bold.ttf",
            "DejaVuSerif-Bold.ttf",
        )
        if os.path.exists(os.path.join(DEJAVU_DIR, f))
    ]
    try:
        import matplotlib

        ttf_dir = os.path.join(matplotlib.get_data_path(), "fonts", "ttf")
        for f in (
            "STIXGeneral.ttf",        # compound-heavy math font
            "STIXGeneralItalic.ttf",
            "STIXNonUni.ttf",         # non-BMP cmap coverage
            "cmr10.ttf",              # Computer Modern (legacy encodings)
            "cmtt10.ttf",
        ):
            p = os.path.join(ttf_dir, f)
            if os.path.exists(p):
                paths.append(p)
    except ImportError:
        pass
    # OpenType-CFF fixtures (the CFF frontend rides the same corpus
    # checks: parse, oracle-exact raster, layout, degradation)
    pygame_fix = (
        "/opt/venv/lib/python3.12/site-packages/pygame/tests/fixtures/fonts"
    )
    for f in ("test_fixed.otf", "PyGameMono.otf"):
        p = os.path.join(pygame_fix, f)
        if os.path.exists(p):
            paths.append(p)
    # synthetic variable-font fixtures (fvar/gvar path)
    here = os.path.dirname(__file__)
    for f in ("vartest.ttf", "vartest2.ttf", "cjktest.ttf",
              "arabictest.ttf"):
        p = os.path.join(here, "data", f)
        if os.path.exists(p):
            paths.append(p)
    return paths


CORPUS = _corpus()


@pytest.fixture(scope="module", params=CORPUS, ids=[os.path.basename(p) for p in CORPUS])
def corpus_font(request):
    return Font.open(request.param)


class TestCorpus:
    def test_parses_and_maps(self, corpus_font):
        f = corpus_font
        assert f.num_glyphs > 0
        # at least one mapped character resolves to a real glyph
        # (STIXNonUni maps only non-BMP supplements, no ASCII)
        dump = f.dump_charmap(limit=4)
        assert dump  # charmap has ranges

    def test_raster_bit_exact_vs_oracle(self, corpus_font):
        """jnp-backend winding maps must equal the float oracle pixel
        for pixel on a glyph sample (every 97th glyph + ASCII 'A g @')."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels import oracle
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import pack_glyph

        f = corpus_font
        eng = RasterEngine()
        step = max(1, f.num_glyphs // 16)
        gids = list(range(1, f.num_glyphs, step))
        gids += [f.glyph_index(c) for c in "Ag@"]
        checked = 0
        for gid in gids:
            g = f.load_glyph_safe(gid)
            p = pack_glyph(g)
            if p.seg_count == 0:
                continue
            grid = RasterGrid.for_glyph_box(p.box, 48, f.info.units_per_em)
            w = np.asarray(eng.winding_glyph(p.segments, grid))
            ys = grid.max_y - np.arange(grid.height, dtype=np.float64)
            xs = grid.min_x + np.arange(grid.width, dtype=np.float64)
            wo = oracle.winding_at(
                p.segments,
                (xs / grid.scale)[None, :].astype(np.float32),
                (ys / grid.scale)[:, None].astype(np.float32),
            )
            np.testing.assert_array_equal(w, wo, err_msg=f"gid {gid}")
            checked += 1
        assert checked >= 4

    def test_layout_all_extensions(self, corpus_font):
        from fontrx.scene.layout import layout_text

        lt = layout_text(
            corpus_font, "Tiffany flies off!\nVA fjord",
            kern=True, ligatures=True, marks=True,
        )
        assert len(lt.instances) >= 20
        assert lt.width > 0 and lt.height > 0

    def test_layout_features_and_vertical(self, corpus_font):
        from fontrx.scene.layout import layout_text

        lt = layout_text(
            corpus_font, "AB", features=(b"ccmp", b"dlig"), vertical=True
        )
        assert len(lt.instances) == 2
        # vertical: single column, instances stacked downward
        assert lt.instances[0].y > lt.instances[1].y

    def test_layout_tables_degrade_not_raise(self, corpus_font):
        f = corpus_font
        # any of these may be None; none may raise
        f.shaper((b"liga", b"rlig"))
        f.gdef
        f.kerning
        f.mark_positioning
        f.vertical_metrics

    def test_gpos_engine_matches_legacy_layout(self, corpus_font):
        """Engine-driven positioning must reproduce the legacy
        flattened kern path on every corpus font that has GPOS kern
        (both read the same PairPos lookups); fonts without one must
        fall back to identical legacy placement either way."""
        from fontrx.scene.layout import layout_text

        text = "AVATAR To.\nWavy f."
        a = layout_text(corpus_font, text, kern=True)
        b = layout_text(corpus_font, text, kern=True, positioning=())
        pa = np.array([[i.x, i.y] for i in a.instances])
        pb = np.array([[i.x, i.y] for i in b.instances])
        assert pa.shape == pb.shape
        # identical unless the font's kern table and GPOS disagree —
        # which test_gpos.py rules out for fonts carrying both
        if corpus_font.gpos_kerning is not None or \
                corpus_font.positioner((b"kern",)) is None:
            np.testing.assert_array_equal(pa, pb)

    def test_positioner_degrades_not_raise(self, corpus_font):
        sh = corpus_font.positioner((b"kern", b"mark", b"mkmk"))
        if sh is not None:
            gids = [corpus_font.glyph_index(c) for c in "AVo"]
            pos = sh.positions(gids, [100, 100, 100])
            assert len(pos.x_advance) == 3


class TestCjkCorpus:
    """The dense-regime corpus font (tests/data/cjktest.ttf): 1024
    han-style glyphs at 200-330 segments each, format-12 cmap — the
    realistic stand-in the synthetic benchmark batches approximate
    (VERDICT r2 item 7)."""

    @pytest.fixture(scope="class")
    def cjk(self):
        p = os.path.join(os.path.dirname(__file__), "data", "cjktest.ttf")
        return Font.open(p)

    def test_density_is_cjk_like(self, cjk):
        from fontrx.pack.segments import glyph_segments

        counts = []
        for i in range(1, cjk.num_glyphs, 37):
            counts.append(len(glyph_segments(cjk.load_glyph(i))))
        counts = np.array(counts)
        assert counts.min() >= 150 and counts.max() <= 400
        assert 200 <= counts.mean() <= 330

    def test_cmap12_maps_cjk_block(self, cjk):
        assert cjk.glyph_index(chr(0x4E00)) == 1
        assert cjk.glyph_index(chr(0x4E00 + 1023)) == 1024

    def test_raster_matches_fonttools_pen(self, cjk):
        """Raster differential vs fontTools' interpretation of the same
        glyphs (RecordingPen -> quadratics -> oracle): 0 differing
        pixels — the corpus bar every format meets."""
        from fontTools.pens.recordingPen import RecordingPen
        from fontTools.ttLib import TTFont

        from fontrx.kernels import oracle
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        ft = TTFont(os.path.join(
            os.path.dirname(__file__), "data", "cjktest.ttf"))
        gs = ft.getGlyphSet()
        order = ft.getGlyphOrder()
        for gid in (1, 257, 600, 1024):
            g = cjk.load_glyph(gid)
            rp = RecordingPen()
            gs[order[gid]].draw(rp)
            # rebuild segments from the pen stream (TrueType pens emit
            # qCurveTo runs with implied on-curve midpoints)
            segs = []
            cur = None
            start = None
            for op, args in rp.value:
                if op == "moveTo":
                    cur = start = np.array(args[0], np.float64)
                elif op == "lineTo":
                    p2 = np.array(args[0], np.float64)
                    segs.append([cur, (cur + p2) / 2, p2])
                    cur = p2
                elif op == "qCurveTo":
                    pts = [np.array(a, np.float64) for a in args]
                    offs = pts[:-1]
                    last = pts[-1] if pts[-1] is not None else start
                    for k, c in enumerate(offs):
                        if k + 1 < len(offs):
                            on = (c + offs[k + 1]) / 2
                        else:
                            on = last
                        segs.append([cur, c, on])
                        cur = on
                elif op == "closePath":
                    if cur is not None and not np.array_equal(cur, start):
                        p2 = start
                        segs.append([cur, (cur + p2) / 2, p2])
                    cur = start
            pen_segs = np.array(segs, np.float32)
            ours = glyph_segments(g)
            grid = RasterGrid.for_glyph_box(
                (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                96, cjk.info.units_per_em)
            xs, ys = grid.sample_coords()
            w_ours = oracle.winding_at(ours, xs[None, :], ys[:, None])
            w_pen = oracle.winding_at(pen_segs, xs[None, :], ys[:, None])
            np.testing.assert_array_equal(
                w_ours != 0, w_pen != 0), gid

    def test_dense_engine_path_matches_oracle(self, cjk):
        """The engine's row-binned route over real 200+-segment glyphs
        (x-sorted packs, the dense CJK regime)."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels import oracle
        from fontrx.pack.segments import pack_glyphs

        from fontrx.kernels.grid import RasterGrid

        glyphs = [cjk.load_glyph(i) for i in (1, 50, 333)]
        batch = pack_glyphs(glyphs, sort="x")
        assert batch.capacity > 128  # dense path engages
        eng = RasterEngine()
        size = 64
        grids = [
            RasterGrid.fixed_tile(tuple(b), float(size),
                                  cjk.info.units_per_em, size)
            for b in np.asarray(batch.boxes)
        ]
        mx = jnp.asarray(np.array([g.min_x for g in grids], np.int32))
        my = jnp.asarray(np.array([g.max_y for g in grids], np.int32))
        scale = np.float32(grids[0].scale)
        out = eng.winding_batch(
            batch.segments, mx, my, scale, height=size, width=size)
        total_ink = 0
        for i in range(len(glyphs)):
            xs, ys = grids[i].sample_coords()
            w = oracle.winding_at(
                batch.segments[i], xs[None, :], ys[:, None],
                contract=True)
            total_ink += int((w != 0).sum())
            np.testing.assert_array_equal(np.asarray(out[i]), w)
        assert total_ink > 1000  # the windows actually contain glyphs


class TestArabicCorpus:
    """The Arabic corpus font (tests/data/arabictest.ttf): genuine
    feaLib-compiled init/medi/fina + rlig + mark GSUB/GPOS registered
    under the ``arab`` script (VERDICT r2 item 7)."""

    @pytest.fixture(scope="class")
    def ar(self):
        p = os.path.join(
            os.path.dirname(__file__), "data", "arabictest.ttf")
        return Font.open(p)

    def _gid(self, ar, name):
        from fontTools.ttLib import TTFont

        ft = TTFont(os.path.join(
            os.path.dirname(__file__), "data", "arabictest.ttf"))
        return ft.getGlyphOrder().index(name)

    def test_positional_forms_via_arab_script(self, ar):
        from fontrx.scene.layout import layout_text

        # beh + meem + lam (logical): beh initial, meem medial, lam
        # final after joining
        lt = layout_text(ar, "بمل", bidi=True, rtl=True)
        gids = {lt.slot_gids[i.glyph_slot] for i in lt.instances}
        expect = {
            self._gid(ar, "beh-ar.init"),
            self._gid(ar, "meem-ar.medi"),
            self._gid(ar, "lam-ar.fina"),
        }
        assert expect <= gids, (expect, gids)

    def test_lam_alef_rlig(self, ar):
        from fontrx.scene.layout import layout_text

        lt = layout_text(
            ar, "لا", bidi=True, rtl=True, ligatures=True)
        gids = {lt.slot_gids[i.glyph_slot] for i in lt.instances}
        lig = {
            self._gid(ar, "lam_alef-ar"),
            self._gid(ar, "lam_alef-ar.fina"),
        }
        assert gids & lig, gids

    def test_mark_anchors_position_fatha(self, ar):
        from fontrx.scene.layout import layout_text

        # logical placement (no mirroring) isolates the anchor math
        lt = layout_text(ar, "بَ", marks=True, positioning=(b"mark",))
        assert len(lt.instances) == 2
        base_i, mark_i = lt.instances
        # the isolated beh's anchor is (250, 300), mark anchor (80, 45):
        # the mark sits base_x + 170, base_y + 255
        assert mark_i.x - base_i.x == pytest.approx(170.0)
        assert mark_i.y - base_i.y == pytest.approx(255.0)


class TestCjkWrap:
    """UAX#14-lite wrapping: unspaced CJK text wraps at inter-
    ideograph boundaries (class ID), with a kinsoku subset."""

    def test_ideograph_wrap(self):
        from fontrx.font.font import Font
        from fontrx.scene.layout import layout_text

        font = Font.open("tests/data/cjktest.ttf")
        text = "".join(chr(0x4E00 + i) for i in range(10))
        upem = font.info.units_per_em
        layout = layout_text(font, text, wrap_width=3.5 * upem)
        # 10 em-wide ideographs at 3.5em budget -> 3/3/3/1
        ys = sorted({round(i.y) for i in layout.instances},
                    reverse=True)
        assert len(ys) == 4
        per_line = [sum(1 for i in layout.instances
                        if round(i.y) == y) for y in ys]
        assert per_line == [3, 3, 3, 1]
        assert layout.width <= 3.5 * upem

    def test_no_wrap_without_budget_violation(self):
        from fontrx.font.font import Font
        from fontrx.scene.layout import layout_text

        font = Font.open("tests/data/cjktest.ttf")
        text = "".join(chr(0x4E00 + i) for i in range(3))
        layout = layout_text(
            font, text, wrap_width=10 * font.info.units_per_em)
        assert len({round(i.y) for i in layout.instances}) == 1

    def test_kinsoku_classes(self):
        # full UAX#14 engine (replaced the round-3 lite subset):
        # the kinsoku behaviors ride the real ID/CL/OP/NS classes
        from fontrx.font.uax14 import break_opportunities

        def ok(a, b):
            return break_opportunities([a, b])[1]

        han, han2 = ord("一"), ord("二")
        assert ok(han, han2)
        # closing punctuation can't start a line
        assert not ok(han, ord("。"))
        assert not ok(han, ord("」"))
        # opening punctuation can't end a line
        assert not ok(ord("「"), han)
        # Latin-only boundaries are not break opportunities
        assert not ok(ord("a"), ord("b"))
        # unmapped glyphs (cp -1) classify AL: no break inside a
        # ligature run, but the full rules DO allow AL ÷ ID (an
        # improvement over the round-3 lite subset, which required the
        # left side to be an ideograph)
        assert not ok(-1, -1)
        assert ok(-1, han)
        assert ok(han, -1)
