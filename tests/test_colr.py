"""COLR/CPAL color-glyph tests (capability extension — the reference
renders monochrome only, ``src/tools/render_glyph.zig:20-33``).

Fixture ``colrtest.ttf`` (tests/data/make_fixtures.py::make_colrtest,
fontTools-built): three color base glyphs over geometric layers —
'A' = red big square + blue small square, 'B' = red disc + semi-
transparent green disc (overlap blend), 'C' = yellow square + a bar
painted with the 0xFFFF foreground sentinel; two CPAL palettes.

Oracle: fontTools' table model for structure; closed-form src-over
arithmetic for rendering.
"""

import numpy as np
import pytest

from fontrx.font.font import Font

COLRTEST = "tests/data/colrtest.ttf"


@pytest.fixture(scope="module")
def cfont():
    return Font.open(COLRTEST)


class TestColrParse:
    def test_differential_vs_fonttools(self, cfont):
        from fontTools.ttLib import TTFont

        tt = TTFont(COLRTEST)
        order = tt.getGlyphOrder()
        colr = tt["COLR"]
        for ch in "ABC":
            gid = cfont.glyph_index(ch)
            ft = [(order.index(l.name), l.colorID)
                  for l in colr[order[gid]]]
            assert cfont.colr.layers(gid) == ft

    def test_cpal_differential_vs_fonttools(self, cfont):
        from fontTools.ttLib import TTFont

        cpal = TTFont(COLRTEST)["CPAL"]
        assert cfont.cpal.num_palettes == len(cpal.palettes)
        assert cfont.cpal.num_entries == cpal.numPaletteEntries
        for p, pal in enumerate(cpal.palettes):
            for e, c in enumerate(pal):
                assert cfont.cpal.color(p, e) == (
                    c.red, c.green, c.blue, c.alpha)

    def test_no_layers_returns_none(self, cfont):
        assert cfont.colr.layers(0) is None          # .notdef
        assert cfont.color_layers(0) is None
        # layer glyphs themselves are not base glyphs
        assert cfont.colr.layers(4) is None

    def test_foreground_sentinel(self, cfont):
        fg = (12, 34, 56, 255)
        layers = cfont.color_layers(
            cfont.glyph_index("C"), foreground=fg)
        assert layers[1][1] == fg

    def test_palette_selection(self, cfont):
        gid = cfont.glyph_index("A")
        p0 = cfont.color_layers(gid, palette=0)
        p1 = cfont.color_layers(gid, palette=1)
        assert [g for g, _ in p0] == [g for g, _ in p1]
        assert p0 != p1
        with pytest.raises(IndexError):
            cfont.cpal.color(9, 0)

    def test_corrupt_colr_degrades(self):
        """A COLR whose layer ranges run past the layer array is
        CorruptedFont at parse — and Font.colr degrades to None."""
        from fontrx.font.colr import ColrTable
        from fontrx.font.ttf import CorruptedFont
        from fontrx.utils.reader import BigEndianReader

        import struct
        bad = struct.pack(">HHIIH", 0, 1, 14, 20, 1) \
            + struct.pack(">HHH", 5, 0, 9) + struct.pack(">HH", 6, 0)
        with pytest.raises(CorruptedFont):
            ColrTable.parse(BigEndianReader(bad, 0))

    def test_monochrome_font_has_no_color(self, dejavu):
        assert dejavu.colr is None and dejavu.cpal is None
        assert dejavu.color_layers(dejavu.glyph_index("A")) is None


class TestColorRender:
    @pytest.fixture(scope="class")
    def tiles(self, request):
        from fontrx.engine.raster import RasterEngine
        from fontrx.engine.colorglyphs import color_tiles

        font = Font.open(COLRTEST)
        gids = [font.glyph_index(c) for c in "ABC"]
        return color_tiles(
            font, gids, 64, RasterEngine(), samples=2)

    def test_layer_stack_order(self, tiles):
        A = tiles[0]
        # small blue square paints OVER the red one
        assert tuple(A[32, 32]) == (0, 0, 255)
        # the ring between the squares stays red
        assert tuple(A[6, 6]) == (255, 0, 0)
        # outside both: background white
        assert tuple(A[62, 62]) == (255, 255, 255)

    def test_alpha_blend(self, tiles):
        B = tiles[1]
        # overlap: green a=128 over red -> (127, 102, 0)
        assert tuple(B[32, 32]) == (127, 102, 0)
        # green only (right lobe, over white): a = 128/255
        assert tuple(int(v) for v in B[19, 45]) == (127, 229, 127)
        assert tuple(B[32, 16]) == (255, 0, 0)

    def test_foreground_renders(self, tiles):
        C = tiles[2]
        assert (np.all(C == 0, axis=2)).sum() > 50     # black bar ink
        assert tuple(C[10, 32]) == (255, 230, 0)       # yellow square

    def test_monochrome_fallback_tile(self):
        """Glyphs without COLR layers render their own outline in the
        foreground color — mixed color/mono text stays uniform."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.engine.colorglyphs import color_tiles

        font = Font.open(COLRTEST)
        t = color_tiles(
            font, [0], 64, RasterEngine(),
            foreground=(10, 20, 30, 255))
        # .notdef has no outline at all -> all background
        assert (t[0] == 255).all()

    def test_palette_switch_changes_pixels(self):
        from fontrx.engine.raster import RasterEngine
        from fontrx.engine.colorglyphs import color_tiles

        font = Font.open(COLRTEST)
        gid = font.glyph_index("A")
        eng = RasterEngine()
        t0 = color_tiles(font, [gid], 64, eng, palette=0)
        t1 = color_tiles(font, [gid], 64, eng, palette=1)
        assert tuple(t1[0][32, 32]) == (255, 255, 255)  # white small sq
        assert tuple(t1[0][6, 6]) == (0, 0, 0)          # black big sq
        assert not np.array_equal(t0, t1)


class TestColorCli:
    def test_color_mode_end_to_end(self, tmp_path):
        """Laid-out color text: 'ABC' composites at pen positions
        (one em advance per glyph) — the blue-on-red square, the
        disc blend, and the foreground bar appear left to right."""
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "c.qoi"
        rc = main(["-f", COLRTEST, "-t", "ABC", "-m", "color",
                   "-s", "64", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        blue = (img[:, :, 2] == 255) & (img[:, :, 0] == 0)
        red = ((img[:, :, 0] == 255) & (img[:, :, 1] == 0)
               & (img[:, :, 2] == 0))
        blend = ((img[:, :, 0] == 127) & (img[:, :, 1] == 102)
                 & (img[:, :, 2] == 0))
        black = np.all(img == 0, axis=2)
        assert blue.sum() > 400 and red.sum() > 1000
        assert blend.sum() > 100 and black.sum() > 100
        # left-to-right pen order: A's ink, then B's, then C's
        cx = [np.nonzero(m.any(axis=0))[0].mean()
              for m in (blue, blend, black)]
        assert cx[0] < cx[1] < cx[2]

    def test_palette_flag(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "p1.qoi"
        rc = main(["-f", COLRTEST, "-t", "A", "-m", "color",
                   "-s", "64", "--palette", "1", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        # palette 1: black big square, white small square — no red
        assert np.all(img == 0, axis=2).sum() > 1000
        assert not ((img[:, :, 0] == 255) & (img[:, :, 1] == 0)
                    & (img[:, :, 2] == 0)).any()

    def test_monochrome_font_warns_and_renders(self, tmp_path, caplog):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "m.qoi"
        rc = main(["-f",
                   "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                   "-t", "Ab", "-m", "color", "-s", "48",
                   "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        # black-on-white monochrome rendering
        assert (np.all(img == 0, axis=2)).sum() > 20
        assert (np.all(img == 255, axis=2)).sum() > 20


class TestColorInteractive:
    def test_color_mode_frames_and_zoom(self):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            Font.open(COLRTEST), "AB", 256, 128,
            RasterEngine(), mode="color")
        f = sess.frame()
        assert f.shape == (128, 256, 3)
        assert (f != 255).any(axis=2).sum() > 1000
        d = sess.display_frame()
        assert d.shape == (128, 256, 4) and (d[..., 3] == 255).all()
        sess.scroll(1.0, (0.0, 0.0))
        assert not np.array_equal(f, sess.frame())

    def test_cycle_includes_color_only_for_color_fonts(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        s1 = InteractiveSession(
            Font.open(COLRTEST), "A", 128, 128,
            RasterEngine())
        seen = set()
        for _ in range(3):
            s1.cycle_mode()
            seen.add(s1.mode)
        assert seen == {"direct", "composite", "color"}

        s2 = InteractiveSession(
            dejavu, "A", 128, 128, RasterEngine())
        seen = set()
        for _ in range(2):
            s2.cycle_mode()
            seen.add(s2.mode)
        assert "color" not in seen

    def test_render_color_tile_cache(self):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer
        from fontrx.scene.transform import ViewTransform

        font = Font.open(COLRTEST)
        layout = layout_text(font, "A")
        pr = PageRenderer(font, layout, 128, 128,
                          RasterEngine())
        view = ViewTransform.init(font.info.units_per_em, 128, 128)
        a = pr.render_color(view)
        key1 = pr._color_cache[0]
        b = pr.render_color(view)
        assert pr._color_cache[0] == key1      # cache hit at same zoom
        np.testing.assert_array_equal(a, b)
        c = pr.render_color(view.zoomed(1.0, (0.0, 0.0)))
        assert pr._color_cache[0] != key1      # re-raster at new zoom
        assert not np.array_equal(a, c)


COLRV1TEST = "tests/data/colrv1test.ttf"


class TestColrV1:
    """COLR v1 solid-fill subset: PaintColrLayers / PaintGlyph /
    Paint(Var)Solid / PaintColrGlyph flatten to layer stacks; anything
    else (the fixture's gradient) falls back, documented."""

    @pytest.fixture(scope="class")
    def vfont(self):
        return Font.open(COLRV1TEST)

    def test_flattens_solid_graph(self, vfont):
        gid = vfont.glyph_index("A")
        layers = vfont.color_layers(gid)
        # big red square, then half-alpha blue square (Alpha 0.5
        # scales the palette alpha: 255 * 8192/16384 -> 128)
        assert layers == [(11, (255, 0, 0, 255)),
                          (12, (0, 0, 255, 128))]

    def test_differential_vs_fonttools_graph(self, vfont):
        """The flattened stack matches a walk of fontTools' v1 table
        model for the same glyph."""
        from fontTools.ttLib import TTFont

        tt = TTFont(COLRV1TEST)
        order = tt.getGlyphOrder()
        colr = tt["COLR"].table
        rec = next(
            r for r in colr.BaseGlyphList.BaseGlyphPaintRecord
            if r.BaseGlyph == "sq")
        ft_layers = []
        paint = rec.Paint
        assert paint.Format == 1  # PaintColrLayers
        ll = colr.LayerList.Paint
        for k in range(paint.NumLayers):
            pg = ll[paint.FirstLayerIndex + k]
            assert pg.Format == 10
            ft_layers.append(
                (order.index(pg.Glyph), pg.Paint.PaletteIndex))
        ours = vfont.colr.layers_v1(vfont.glyph_index("A"))
        assert [(g, f[1]) for g, f, _xf in ours] == ft_layers

    def test_paint_colr_glyph_reference(self, vfont):
        a = vfont.color_layers(vfont.glyph_index("A"))
        b = vfont.color_layers(vfont.glyph_index("B"))
        assert a == b

    def test_screen_blend_renders(self, vfont):
        """Separable blend modes evaluate the W3C formulas: red
        screen-blended over blue gives magenta in the overlap, plain
        red where the backdrop is empty."""
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        tree = vfont.color_paint_tree(vfont.glyph_index("J"))
        assert tree[0] == "composite" and tree[1] == 13  # SCREEN
        tiles, _ = color_glyph_tiles(
            vfont, [vfont.glyph_index("J")], 64,
            RasterEngine())
        t = np.asarray(tiles[0])
        h = t.shape[0]
        mid = t[h // 2, h // 2]
        assert mid[0] > 0.9 and mid[1] < 0.1 and mid[2] > 0.9  # magenta
        ring = t[6, 6]
        assert ring[0] > 0.9 and ring[2] < 0.1                 # red

    def test_reserved_composite_mode_falls_back(self):
        """CompositeMode values past 27 are reserved: the walker
        refuses the graph (monochrome fallback), never a wrong
        render."""
        import struct as st

        from fontrx.font.colr import ColrTable
        from fontrx.utils.reader import BigEndianReader

        # header + BaseGlyphList(1 rec: gid 5 -> composite(mode 28))
        # composite at bgl+10: fmt 32, src Offset24=8, mode, bdp=8
        paint = st.pack(">B3sB3s", 32, (8).to_bytes(3, "big"), 28,
                        (8).to_bytes(3, "big"))
        solid = st.pack(">BHh", 2, 0, 16384)
        bgl = st.pack(">I", 1) + st.pack(">HI", 5, 10) + paint + solid
        blob = st.pack(">HHIIH", 1, 0, 0, 0, 0) + st.pack(
            ">IIIII", 34, 0, 0, 0, 0) + bgl
        t = ColrTable.parse(BigEndianReader(blob, 0))
        assert t.paint_tree(5) is None

    def test_composite_tree_shape(self, vfont):
        """PaintComposite builds a render tree (src-over here); the
        flat-layer API refuses it."""
        gid = vfont.glyph_index("H")
        tree = vfont.color_paint_tree(gid)
        assert tree[0] == "composite" and tree[1] == 3
        assert tree[2][0] == "glyph" and tree[3][0] == "glyph"
        assert vfont.color_paint_layers(gid) is None

    def test_src_in_masks_gradient(self, vfont):
        """The Noto-emoji clipping idiom: a gradient src-in a shape
        paints only inside the shape, carrying the gradient colors."""
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        tiles, grids = color_glyph_tiles(
            vfont, [vfont.glyph_index("I")], 64,
            RasterEngine())
        t = np.asarray(tiles[0])
        g = grids[0]
        ink = t[..., 3] > 0.5
        cols = np.nonzero(ink.any(axis=0))[0]
        # masked to the small square: em x ~300..700, not 100..900
        em_l = (g.min_x + cols.min()) / g.scale
        em_r = (g.min_x + cols.max() + 1) / g.scale
        assert 295 <= em_l <= 320 and 685 <= em_r <= 710
        # the surviving ink carries the gradient (mid pixel ~50/50)
        rows = np.nonzero(ink.any(axis=1))[0]
        mid = t[int(rows.mean()), int(cols.mean())]
        assert 0.4 < float(mid[0]) < 0.6
        assert 0.4 < float(mid[2]) < 0.6

    def test_src_over_composite_renders(self, vfont):
        """Composite src-over equals the equivalent flat stack."""
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        eng = RasterEngine()
        tiles, _ = color_glyph_tiles(
            vfont, [vfont.glyph_index("H")], 64, eng)
        t = np.asarray(tiles[0])
        # blue small square over red big square: center blue, ring red
        h = t.shape[0]
        assert t[h // 2, h // 2, 2] > 0.9      # blue center
        assert t[6, 6, 0] > 0.9                # red ring

    def test_sweep_decodes(self, vfont):
        sw = vfont.color_paint_layers(vfont.glyph_index("G"))
        kind, geom, extend, stops = sw[0][1]
        assert kind == "sweep"
        assert geom[:2] == (500, 500)
        assert abs(geom[2] - 0.0) < 1e-6
        assert abs(geom[3] - 179.0) < 0.02  # F2Dot14 quantization

    def test_sweep_renders_angular_field(self, vfont):
        """Red at angle 0 (right of center), blue near 179 deg (left
        of center), mid color straight up."""
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        tiles, grids = color_glyph_tiles(
            vfont, [vfont.glyph_index("G")], 64,
            RasterEngine())
        t = np.asarray(tiles[0])
        g = grids[0]
        # pixel at em (800, 500): angle ~0 -> red
        col = int(round(800 * g.scale)) - g.min_x
        row = int(round(g.max_y - 500 * g.scale))
        right = t[row, col]
        assert right[0] > 0.9 and right[2] < 0.1
        # pixel at em (300, 550): angle ~166 deg -> mostly blue
        # (the exact 180-deg ray is the wrap seam: below it the angle
        # is negative and pads to the START color, per spec)
        col_l = int(round(300 * g.scale)) - g.min_x
        row_l = int(round(g.max_y - 550 * g.scale))
        left = t[row_l, col_l]
        assert left[2] > 0.8 and left[0] < 0.2
        # straight up (500, 800): angle 90 -> mid blend
        col_u = int(round(500 * g.scale)) - g.min_x
        row_u = int(round(g.max_y - 800 * g.scale))
        up = t[row_u, col_u]
        assert 0.3 < up[0] < 0.7 and 0.3 < up[2] < 0.7

    def test_translate_carries_affine(self, vfont):
        layers = vfont.color_paint_layers(vfont.glyph_index("F"))
        assert layers == [
            (12, ("solid", (255, 0, 0, 255)),
             (1.0, 0.0, 0.0, 1.0, 200.0, 0.0))]

    def test_translate_moves_ink(self, vfont):
        """The translated small square (300..700 + 200) rasters at
        500..900: compare against the untranslated layer shifted by
        200 units worth of pixels."""
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        eng = RasterEngine()
        tiles, grids = color_glyph_tiles(
            vfont, [vfont.glyph_index("F")], 64, eng)
        t = np.asarray(tiles[0])
        ink_cols = np.nonzero((t[..., 3] > 0.5).any(axis=0))[0]
        # box 500..900 at 64px/em, anchored at the union box (min_x
        # from 500) -> ink spans ~the tile's leading 400-unit band
        em_w = (ink_cols.max() - ink_cols.min() + 1) / grids[0].scale
        assert 380 <= em_w <= 420
        # absolute position: leftmost ink pixel maps to em x ~500
        left_em = (grids[0].min_x + ink_cols.min()) / grids[0].scale
        assert 490 <= left_em <= 520  # within one 15.6-unit pixel of 500

    def test_gradient_paints_decode(self, vfont):
        lin = vfont.color_paint_layers(vfont.glyph_index("C"))
        assert len(lin) == 1 and lin[0][1][0] == "linear"
        kind, geom, extend, stops = lin[0][1]
        assert geom == (100, 100, 900, 100, 100, 900)
        assert extend == 0
        assert stops == [(0.0, (255, 0, 0, 255)),
                         (1.0, (0, 0, 255, 255))]
        rad = vfont.color_paint_layers(vfont.glyph_index("D"))
        assert rad[0][1][0] == "radial"
        assert rad[0][1][1] == (500, 500, 0, 500, 500, 400)
        rep = vfont.color_paint_layers(vfont.glyph_index("E"))
        assert rep[0][1][2] == 1  # repeat extend
        # solid-only API: gradients are not representable -> None
        assert vfont.color_layers(vfont.glyph_index("C")) is None

    def test_cycle_guard(self):
        """A self-referencing PaintColrGlyph terminates as
        unsupported, not as infinite recursion."""
        import struct as st

        from fontrx.font.colr import ColrTable
        from fontrx.utils.reader import BigEndianReader

        # v1 header: no v0 records; BaseGlyphList at 34 with one
        # record (gid 7 -> paint at +10), paint = PaintColrGlyph(7)
        bgl = st.pack(">I", 1) + st.pack(">HI", 7, 10) + st.pack(
            ">BH", 11, 7)
        blob = st.pack(">HHIIH", 1, 0, 0, 0, 0) + st.pack(
            ">IIIII", 34, 0, 0, 0, 0) + bgl
        t = ColrTable.parse(BigEndianReader(blob, 0))
        assert t.layers_v1(7) is None

    def test_truncated_graph_degrades(self, vfont):
        """Chopping the paint graph mid-table yields None, never an
        exception."""
        from fontrx.font.colr import ColrTable

        data = vfont.colr.data
        gid = vfont.glyph_index("A")
        pos = vfont.colr.v1_paints[gid]
        t = ColrTable(
            1, vfont.colr.base_gids, vfont.colr.first_layer,
            vfont.colr.num_layers, vfont.colr.layer_gids,
            vfont.colr.layer_palettes,
            v1_paints={gid: pos},
            v1_layer_list=vfont.colr.v1_layer_list,
            data=data[: pos + 2],
        )
        assert t.layers_v1(gid) is None

    def test_render_v1_glyph(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "v1.qoi"
        rc = main(["-f", COLRV1TEST, "-t", "A", "-m", "color",
                   "-s", "64", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        # center: half-alpha blue over red = (127, 0, 128)
        h, w = img.shape[:2]
        assert tuple(img[h // 2, w // 2]) == (127, 0, 128)


class TestGradientRender:
    """Gradient fields against hand-computed color expectations (the
    em-space pixel mapping comes from the shared RasterGrid; the
    gradient math itself is checked independently)."""

    @pytest.fixture(scope="class")
    def setup(self):
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        font = Font.open(COLRV1TEST)
        gids = [font.glyph_index(c) for c in "CDE"]
        tiles, grids = color_glyph_tiles(
            font, gids, 64, RasterEngine())
        return np.asarray(tiles), grids

    @staticmethod
    def em(grid, row, col):
        return ((grid.min_x + col) / grid.scale,
                (grid.max_y - row) / grid.scale)

    def test_linear_gradient_values(self, setup):
        tiles, grids = setup
        lin, grid = tiles[0], grids[0]
        # 'C' is clip-boxed to em x 500..900 (TestClipList): sample
        # columns inside the clip (the tile anchors at the clip box)
        for row, col in ((30, 5), (30, 12), (30, 20)):
            x, _y = self.em(grid, row, col)
            t = (x - 100.0) / 800.0          # p0 x=100 -> p1 x=900
            exp_r = round((1 - t) * 255)
            exp_b = round(t * 255)
            got = lin[row, col]
            # premultiplied u8 roundtrip: +-1 code
            assert abs(int(got[0] * 255) - exp_r) <= 1, (row, col)
            assert abs(int(got[2] * 255) - exp_b) <= 1, (row, col)
            assert got[3] > 0.99

    def test_radial_gradient_values(self, setup):
        tiles, grids = setup
        rad, grid = tiles[1], grids[1]
        for row, col in ((32, 32), (32, 20), (16, 16)):
            x, y = self.em(grid, row, col)
            t = min(np.hypot(x - 500.0, y - 500.0) / 400.0, 1.0)
            exp_r = round((1 - t) * 255)
            got = rad[row, col]
            assert abs(int(got[0] * 255) - exp_r) <= 2, (row, col, t)
            assert got[3] > 0.99

    def test_repeat_extend_wraps(self, setup):
        tiles, grids = setup
        rep, grid = tiles[2], grids[2]
        # stops span [0, 0.25] with repeat: t and t + 0.25 give the
        # same color.  800 em units * 0.25 = 200 units = one period.
        period_px = 200.0 * grid.scale
        row = 30
        c0 = 20
        c1 = int(round(c0 + period_px))
        a = rep[row, c0]
        b = rep[row, c1]
        assert abs(float(a[0]) - float(b[0])) < 0.08
        assert abs(float(a[2]) - float(b[2])) < 0.08
        # and a half-period away the color is materially different
        c2 = int(round(c0 + period_px / 2))
        assert abs(float(a[0]) - float(rep[row, c2][0])) > 0.2


class TestVariableColr:
    """COLR v1 variation deltas (VarStore + VarIndexMap, varLib-built
    fixture): PaintVarTranslate dx 0 -> 300 and PaintVarSolid alpha
    1.0 -> 0.25 across wght 100 -> 900.  Oracle: linear interpolation
    in normalized axis space (fontTools' instancer does not yet apply
    COLR deltas, so the closed form is the independent check)."""

    VARCOLR = "tests/data/varcolrtest.ttf"

    def test_default_location_base_values(self):
        f = Font.open(self.VARCOLR)
        tree = f.color_paint_tree(f.glyph_index("A"))
        assert tree == ("glyph", 2, ("solid", (255, 0, 0, 255)), None)

    def test_max_location(self):
        f = Font.open(self.VARCOLR)
        f.set_variation({"wght": 900})
        tree = f.color_paint_tree(f.glyph_index("A"))
        _, _, paint, xf = tree
        assert paint[1][3] == round(0.25 * 255)      # alpha 0.25
        assert xf[4] == 300.0 and xf[5] == 0.0       # dx 300

    def test_intermediate_location(self):
        f = Font.open(self.VARCOLR)
        f.set_variation({"wght": 500})               # normalized 0.5
        tree = f.color_paint_tree(f.glyph_index("A"))
        _, _, paint, xf = tree
        assert paint[1][3] == round(0.625 * 255)     # lerp alpha
        assert xf[4] == 150.0                        # lerp dx

    def test_render_moves_with_location(self):
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        eng = RasterEngine()
        f = Font.open(self.VARCOLR)
        gid = f.glyph_index("A")
        t0, g0 = color_glyph_tiles(f, [gid], 64, eng)
        f.set_variation({"wght": 900})
        t9, g9 = color_glyph_tiles(f, [gid], 64, eng)
        left0 = (g0[0].min_x
                 + np.nonzero(np.asarray(t0[0])[..., 3].max(axis=0)
                              > 0.1)[0].min()) / g0[0].scale
        left9 = (g9[0].min_x
                 + np.nonzero(np.asarray(t9[0])[..., 3].max(axis=0)
                              > 0.1)[0].min()) / g9[0].scale
        # square translated +300 units; alpha drops to 0.25
        assert 280 <= (left9 - left0) <= 320
        assert float(np.asarray(t9[0])[..., 3].max()) < 0.3


class TestPaletteSelection:
    def test_palette_types_parse(self, cfont):
        # fixture: palette 0 flagged light, palette 1 dark (CPAL v1)
        assert cfont.cpal.version == 1
        assert cfont.cpal.palette_types == (1, 2)

    def test_select(self, cfont):
        assert cfont.cpal.select("light") == 0
        assert cfont.cpal.select("dark") == 1
        assert cfont.cpal.select(1) == 1
        with pytest.raises(ValueError):
            cfont.cpal.select("sepia")

    def test_select_unflagged_falls_back(self):
        f = Font.open(COLRV1TEST)  # CPAL v0: no flags
        assert f.cpal.palette_types == (0,)
        assert f.cpal.select("dark") == 0

    def test_cli_dark_palette(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "d.qoi"
        rc = main(["-f", COLRTEST, "-t", "A", "-m", "color",
                   "-s", "64", "--palette", "dark", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        # dark palette: black big square, white small square
        assert np.all(img == 0, axis=2).sum() > 1000

    def test_cli_bad_selector_warns(self, tmp_path, caplog):
        from fontrx.cli.main import main

        out = tmp_path / "x.qoi"
        rc = main(["-f", COLRTEST, "-t", "A", "-m", "color",
                   "-s", "48", "--palette", "sepia", "-o", str(out)])
        assert rc == 0  # falls back to palette 0


class TestBlendFormulas:
    """_blend against hand-computed W3C compositing values (opaque
    operands so the mix reduces to B(cb, cs) composited src-over)."""

    @staticmethod
    def blend(mode, cs_rgb, cb_rgb, sa=1.0, ba=1.0):
        import jax.numpy as jnp

        from fontrx.engine.colorglyphs import _blend

        src = jnp.asarray(
            [[list(np.asarray(cs_rgb) * sa) + [sa]]], jnp.float32)
        bdp = jnp.asarray(
            [[list(np.asarray(cb_rgb) * ba) + [ba]]], jnp.float32)
        return np.asarray(_blend(mode, src, bdp))[0, 0]

    def test_multiply_screen_darken_lighten(self):
        cs, cb = (0.8, 0.2, 1.0), (0.5, 0.5, 0.25)
        out = self.blend(23, cs, cb)          # multiply
        np.testing.assert_allclose(out[:3], (0.4, 0.1, 0.25), atol=1e-6)
        out = self.blend(13, cs, cb)          # screen
        np.testing.assert_allclose(out[:3], (0.9, 0.6, 1.0), atol=1e-6)
        out = self.blend(15, cs, cb)          # darken
        np.testing.assert_allclose(out[:3], (0.5, 0.2, 0.25), atol=1e-6)
        out = self.blend(16, cs, cb)          # lighten
        np.testing.assert_allclose(out[:3], (0.8, 0.5, 1.0), atol=1e-6)

    def test_difference_exclusion(self):
        cs, cb = (0.8, 0.2, 1.0), (0.5, 0.5, 0.25)
        out = self.blend(21, cs, cb)          # difference
        np.testing.assert_allclose(
            out[:3], (0.3, 0.3, 0.75), atol=1e-6)
        out = self.blend(22, cs, cb)          # exclusion
        exp = tuple(b + s - 2 * b * s for b, s in zip(cb, cs))
        np.testing.assert_allclose(out[:3], exp, atol=1e-6)

    def test_hard_light_both_branches(self):
        # cs <= 0.5 -> multiply(b, 2s); cs > 0.5 -> screen(b, 2s-1)
        out = self.blend(19, (0.25, 0.75, 0.5), (0.4, 0.4, 0.4))
        exp = (0.4 * 0.5,                      # multiply branch
               0.4 + 0.5 - 0.4 * 0.5,          # screen branch
               0.4 * 1.0)                      # boundary (<= 0.5)
        np.testing.assert_allclose(out[:3], exp, atol=1e-6)

    def test_dodge_burn_edges(self):
        # color-dodge: cb/(1-cs) clamped; cs==1 -> 1 (unless cb==0)
        out = self.blend(17, (0.5, 1.0, 0.0), (0.3, 0.5, 0.0))
        np.testing.assert_allclose(out[:3], (0.6, 1.0, 0.0), atol=1e-6)
        # color-burn: 1-(1-cb)/cs clamped; cs==0 -> 0 (unless cb==1)
        out = self.blend(18, (0.5, 0.0, 1.0), (0.6, 0.5, 1.0))
        np.testing.assert_allclose(out[:3], (0.2, 0.0, 1.0), atol=1e-6)

    def test_hsl_luminosity_and_color(self):
        # luminosity: backdrop color with the source's luminosity
        cs, cb = (0.0, 0.0, 1.0), (1.0, 0.0, 0.0)
        lum = lambda c: 0.3 * c[0] + 0.59 * c[1] + 0.11 * c[2]
        out = self.blend(27, cs, cb)
        np.testing.assert_allclose(lum(out[:3]), lum(cs), atol=1e-5)
        # color: source hue/sat with the backdrop's luminosity
        out = self.blend(26, cs, cb)
        np.testing.assert_allclose(lum(out[:3]), lum(cb), atol=1e-5)
        assert out[2] > out[0]                 # stays blue-hued

    def test_alpha_composition(self):
        # transparent source: backdrop unchanged (any mode)
        for mode in (13, 23, 27):
            out = self.blend(mode, (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                             sa=0.0)
            np.testing.assert_allclose(out, (0.0, 1.0, 0.0, 1.0),
                                       atol=1e-6)
        # transparent backdrop: blend mixes toward plain source
        out = self.blend(23, (0.8, 0.2, 1.0), (0.5, 0.5, 0.25),
                         ba=0.0)
        np.testing.assert_allclose(out[:3], (0.8, 0.2, 1.0), atol=1e-6)


class TestClipList:
    """COLR v1 ClipList: the clip box is the authoritative render
    bounds — the fixture crops the 100..900 linear-gradient square
    ('C') to its right half."""

    def test_clip_box_lookup(self):
        f = Font.open(COLRV1TEST)
        assert f.colr.clip_box(f.glyph_index("C")) == (500, 100, 900, 900)
        assert f.colr.clip_box(f.glyph_index("A")) is None
        assert f.colr.clip_box(9999) is None

    def test_render_clips(self):
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        f = Font.open(COLRV1TEST)
        tiles, grids = color_glyph_tiles(
            f, [f.glyph_index("C")], 64, RasterEngine())
        t = np.asarray(tiles[0])
        g = grids[0]
        ink_cols = np.nonzero((t[..., 3] > 0.5).any(axis=0))[0]
        left_em = (g.min_x + ink_cols.min()) / g.scale
        # the square spans 100..900; the clip crops to 500..900
        assert 495 <= left_em <= 520
        # the surviving ink carries the RIGHT half of the gradient
        # (t >= 0.5 -> blue-dominant at the left edge of the clip)
        mid_row = t.shape[0] // 2
        edge = t[mid_row, ink_cols.min() + 1]
        assert edge[2] >= edge[0] - 0.1


class TestVerticalColor:
    def test_vertical_column_of_color_glyphs(self, tmp_path):
        """--vertical composes with color mode: glyphs stack
        top-to-bottom in a column taller than wide, keeping their
        layer colors."""
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "v.qoi"
        rc = main(["-f", COLRTEST, "-t", "ABC", "-m", "color",
                   "-s", "48", "--vertical", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        assert img.shape[0] > img.shape[1]
        blue = ((img[:, :, 2] == 255) & (img[:, :, 0] == 0))
        black = np.all(img == 0, axis=2)
        assert blue.sum() > 200 and black.sum() > 50
        # top-to-bottom order: A's blue center above C's black bar
        assert (np.nonzero(blue.any(axis=1))[0].mean()
                < np.nonzero(black.any(axis=1))[0].mean())
