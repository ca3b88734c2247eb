"""OT-SVG color glyph tests (capability extension — the reference has
no color support; ``src/main.zig`` maps codepoints to monochrome
outlines only).

The load-bearing oracle is the SVG-vs-COLR *equivalence twins* in
``tests/data/svgtest.ttf``: the same square + gradient expressed as an
SVG document and as glyf+COLR v1 must render PIXEL-IDENTICAL through
the shared color pipeline — which pins the whole lowering chain
(document list, viewBox/y-flip mapping, path parsing, gradient
coordinate spaces, the inverse-mapped gradient affine) against the
independently-validated COLR path.  Unit vectors pin the parsers
directly.
"""

import gzip
import struct

import numpy as np
import pytest

from fontrx.font.font import Font
from fontrx.font.svgdoc import (
    SvgDocument,
    _arc_to_cubics,
    affine_apply,
    affine_mul,
    chains_to_glyph,
    parse_color,
    parse_path_data,
    parse_transform,
)
from fontrx.font.ttf import CorruptedFont

SVGTEST = "tests/data/svgtest.ttf"


@pytest.fixture(scope="module")
def font():
    return Font.open(SVGTEST)


@pytest.fixture(scope="module")
def engine():
    from fontrx.engine.raster import RasterEngine

    return RasterEngine()


class TestTransformParse:
    def test_matrix_order_and_values(self):
        t = parse_transform("matrix(2 0 0 3 10 20)")
        assert affine_apply(t, 1, 1) == (12.0, 23.0)

    def test_composition_left_to_right(self):
        t = parse_transform("translate(10) scale(2)")
        # scale applies first to the point, then translate
        assert affine_apply(t, 1, 0) == (12.0, 0.0)

    def test_rotate_about_point(self):
        t = parse_transform("rotate(90 10 10)")
        x, y = affine_apply(t, 20, 10)
        assert abs(x - 10) < 1e-9 and abs(y - 20) < 1e-9

    def test_skew(self):
        t = parse_transform("skewX(45)")
        x, y = affine_apply(t, 0, 1)
        assert abs(x - 1) < 1e-9 and y == 1

    def test_affine_mul_associativity(self):
        a = parse_transform("rotate(30)")
        b = parse_transform("translate(5 7)")
        c = parse_transform("scale(2 3)")
        p = (1.25, -2.5)
        lhs = affine_apply(affine_mul(affine_mul(a, b), c), *p)
        rhs = affine_apply(a, *affine_apply(b, *affine_apply(c, *p)))
        assert abs(lhs[0] - rhs[0]) < 1e-9
        assert abs(lhs[1] - rhs[1]) < 1e-9


class TestColorParse:
    def test_forms(self):
        fg = (1, 2, 3, 4)
        assert parse_color("#f00", fg) == (255, 0, 0, 255)
        assert parse_color("#00ff00", fg) == (0, 255, 0, 255)
        assert parse_color("#0000ff80", fg) == (0, 0, 255, 128)
        assert parse_color("rgb(10, 20, 30)", fg) == (10, 20, 30, 255)
        assert parse_color("rgb(100%, 0%, 50%)", fg) == (
            255, 0, 128, 255)
        assert parse_color("rgba(1,2,3,0.5)", fg) == (1, 2, 3, 128)
        assert parse_color("tomato", fg) == (0xFF, 0x63, 0x47, 255)
        assert parse_color("currentColor", fg) == fg
        assert parse_color("none", fg) is None

    def test_unknown_is_black(self):
        assert parse_color("notacolor", (0, 0, 0, 255)) == (0, 0, 0, 255)


class TestPathParse:
    def _points(self, d):
        chains = parse_path_data(d)
        return [[it for it in ch] for ch in chains]

    def test_absolute_and_relative(self):
        a = self._points("M10 10 L20 10 l0 10")
        b = self._points("M10 10 20 10 L20 20")  # implicit lineto
        assert a == b

    def test_h_v(self):
        [ch] = self._points("M0 0 H10 v5 h-10 V0")
        pts = [it[1] for it in ch]
        assert pts == [(0, 0), (10, 0), (10, 5), (0, 5), (0, 0)]

    def test_quadratic_and_smooth(self):
        [ch] = self._points("M0 0 Q10 10 20 0 T40 0")
        # T reflects the previous control (10,10) about (20,0) -> (30,-10)
        ctrls = [it[1] for it in ch if it[0] == "pt" and not it[2]]
        assert ctrls == [(10, 10), (30, -10)]

    def test_cubic_and_smooth(self):
        [ch] = self._points("M0 0 C0 10 20 10 20 0 S40 -10 40 0")
        cubs = [it for it in ch if it[0] == "cub"]
        assert len(cubs) == 2
        # S reflects c2=(20,10) about (20,0) -> (20,-10)
        assert cubs[1][1] == (20, -10)

    def test_error_recovery_keeps_prefix(self):
        [ch] = self._points("M0 0 L10 0 L10 Q")  # truncated L
        pts = [it[1] for it in ch]
        assert pts == [(0, 0), (10, 0)]

    def test_multiple_subpaths(self):
        chains = parse_path_data("M0 0 H10 V10 Z M20 20 H30 V30 Z")
        assert len(chains) == 2


class TestArcs:
    def test_endpoints_exact(self):
        cubs = _arc_to_cubics((0, 0), 10, 10, 0, False, True, (20, 0))
        assert cubs[0][0] == (0, 0)
        end = cubs[-1][3]
        assert abs(end[0] - 20) < 1e-9 and abs(end[1]) < 1e-9

    def test_semicircle_touches_extreme(self):
        # sweep=1 is clockwise on screen (y-down): raw y NEGATIVE
        # (the arc renders above the chord); sweep=0 positive
        for sweep, ey in ((True, -10.0), (False, 10.0)):
            cubs = _arc_to_cubics((0, 0), 10, 10, 0, False, sweep,
                                  (20, 0))
            mids = []
            for (p0, c1, c2, p1) in cubs:
                for t in np.linspace(0.0, 1.0, 9):
                    mt = 1 - t
                    x = (mt**3 * p0[0] + 3 * mt * mt * t * c1[0]
                         + 3 * mt * t * t * c2[0] + t**3 * p1[0])
                    y = (mt**3 * p0[1] + 3 * mt * mt * t * c1[1]
                         + 3 * mt * t * t * c2[1] + t**3 * p1[1])
                    mids.append((float(x), float(y)))
            ys = [y for _, y in mids]
            ex = min(ys) if ey < 0 else max(ys)
            assert abs(ex - ey) < 0.05  # 90-degree cubic arc error
            # every sample on the circle within tolerance
            for x, y in mids:
                r = ((x - 10) ** 2 + y**2) ** 0.5
                assert abs(r - 10) < 0.05

    def test_degenerate_radius_is_line(self):
        cubs = _arc_to_cubics((0, 0), 0, 10, 0, False, True, (20, 0))
        assert cubs == [((0, 0), (0, 0), (20, 0), (20, 0))]


class TestChains:
    def test_evenodd_orientations(self):
        chains = parse_path_data(
            "M0 0 H100 V100 H0 Z M25 25 H75 V75 H25 Z")
        g = chains_to_glyph(chains, (1, 0, 0, 1, 0, 0),
                            fill_rule="evenodd")
        signs = []
        for c in g.contours:
            x = c.points[:, 0].astype(float)
            y = c.points[:, 1].astype(float)
            signs.append(np.sign(
                np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y)))
        assert sorted(signs) == [-1.0, 1.0]  # hole opposes the outer

    def test_contour_invariants(self):
        chains = parse_path_data("M0 0 Q50 100 100 0 Z")
        g = chains_to_glyph(chains, (1, 0, 0, 1, 0, 0))
        for c in g.contours:
            assert len(c.points) % 2 == 1          # 2k+1 points
            assert (c.points[0] == c.points[-1]).all()  # closed

    def test_cubic_tolerance_in_font_units(self):
        # the same curve at 100x document scale converts with the same
        # font-unit accuracy (transform applied before cu2qu)
        d = "M0 0 C0 10 20 10 20 0 Z"
        g1 = chains_to_glyph(parse_path_data(d),
                             (100, 0, 0, 100, 0, 0))
        d2 = "M0 0 C0 1000 2000 1000 2000 0 Z"
        g2 = chains_to_glyph(parse_path_data(d2), (1, 0, 0, 1, 0, 0))
        np.testing.assert_array_equal(g1.contours[0].points,
                                      g2.contours[0].points)


class TestSvgTable:
    def test_ranges_and_shared_documents(self, font):
        svg = font.svg
        assert svg.covered(1) and svg.covered(2) and svg.covered(7)
        assert not svg.covered(6) and not svg.covered(9)
        assert svg.document(1) == svg.document(2)  # shared doc
        assert svg.document(6) is None

    def test_gzip_document_decodes(self, font):
        raw = font._table_bytes(b"SVG ")
        # entry for gid 3 is stored compressed on the wire
        (n,) = struct.unpack_from(">H", raw, 10)
        found = False
        for i in range(n):
            s, e, off, ln = struct.unpack_from(">HHII", raw, 12 + 12 * i)
            if s == 3:
                blob = raw[10 + off : 10 + off + ln]
                assert blob[:2] == b"\x1f\x8b"
                assert gzip.decompress(blob) == font.svg.document(3)
                found = True
        assert found

    def test_truncation_robustness(self, font):
        """The facade fuzz contract (tests/test_robustness.py):
        truncations fail with parse-failure types only."""
        raw = open(SVGTEST, "rb").read()
        acceptable = (CorruptedFont, NotImplementedError, ValueError,
                      struct.error)
        for cut in range(0, len(raw), max(len(raw) // 61, 1)):
            try:
                f = Font(raw[:cut])
                for gid in range(1, 9):
                    f.color_paint_tree(gid)
            except acceptable:
                pass


class TestEquivalenceTwins:
    def test_linear_gradient_pixel_identical(self, font, engine):
        from fontrx.engine.colorglyphs import color_tiles

        tiles = color_tiles(
            font, [font.glyph_index("E"), font.glyph_index("F")],
            100, engine)
        np.testing.assert_array_equal(tiles[0], tiles[1])
        assert int((tiles[0] != 255).sum()) > 1000  # really painted

    def test_radial_gradient_pixel_identical(self, font, engine):
        from fontrx.engine.colorglyphs import color_tiles

        tiles = color_tiles(
            font, [font.glyph_index("G"), font.glyph_index("H")],
            100, engine)
        np.testing.assert_array_equal(tiles[0], tiles[1])
        assert int((tiles[0] != 255).sum()) > 1000


class TestDocumentRendering:
    def test_solid_shape_colors_land(self, font, engine):
        """Pinned pixels: the 'A' doc's rect is #00aa44, its circle
        rgb(255,0,255) — sample well inside each shape."""
        from fontrx.engine.colorglyphs import color_glyph_tiles

        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("A")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def px(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return tile[row, col]

        rect = px(300, 550)       # inside the rect (glyph units)
        assert rect[3] > 0.99
        np.testing.assert_allclose(
            rect[:3], np.array([0x00, 0xAA, 0x44]) / 255.0, atol=0.02)
        circ = px(700, 300)
        np.testing.assert_allclose(
            circ[:3], np.array([1.0, 0.0, 1.0]), atol=0.02)

    def test_shared_doc_second_glyph_transformed(self, font, engine):
        from fontrx.engine.colorglyphs import color_tiles

        tiles = color_tiles(font, [font.glyph_index("B")], 80, engine)
        assert int((tiles[0] != 255).sum()) > 500

    def test_evenodd_donut_has_hole(self, font, engine):
        from fontrx.engine.colorglyphs import color_glyph_tiles

        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("D")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def a(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return float(tile[row, col, 3])

        assert a(200, 500) > 0.9       # donut ring painted
        assert a(500, 850) > 0.9
        # inside the evenodd hole, away from the rotated square and
        # the use'd chip: truly empty
        assert a(650, 350) < 0.05
        # the rotated half-opacity square at its center
        assert 0.3 < a(420, 420) < 0.7

    def test_currentcolor_and_use(self, font, engine):
        """The rotated square is currentColor (#663300) at opacity
        0.5; the use'd chip is gold."""
        from fontrx.engine.colorglyphs import color_glyph_tiles

        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("D")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def px(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return tile[row, col]

        center = px(420, 420)          # premultiplied
        assert abs(center[3] - 0.5) < 0.05
        un = center[:3] / max(center[3], 1e-6)
        np.testing.assert_allclose(
            un, np.array([0x66, 0x33, 0x00]) / 255.0, atol=0.03)
        chip = px(180, 180)            # use'd gold chip at (120..240)
        np.testing.assert_allclose(
            chip[:3] / max(chip[3], 1e-6),
            np.array([0xFF, 0xD7, 0x00]) / 255.0, atol=0.03)

    def test_gradient_doc_renders_both_kinds(self, font):
        t = font.color_paint_tree(font.glyph_index("C"))
        kinds = [leaf[2][0] for leaf in t[1]]
        assert kinds == ["linear", "radial"]
        # reflect spread survived the lowering
        assert t[1][0][2][2] == 2

    def test_malformed_document_degrades(self, font):
        doc = b"<svg xmlns='x'><path id='glyph1' d='M0 0"
        from fontrx.font.svgdoc import SvgDocument

        with pytest.raises(ValueError):
            SvgDocument(doc, 1000)

    def test_unclosed_fill_none_and_display_none_skipped(self, font):
        t = font.color_paint_tree(font.glyph_index("D"))
        assert len(t[1]) == 3  # donut + rotated square + chip only


class TestCli:
    def test_color_mode_renders_svg_font(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "o.qoi"
        assert main(["-f", SVGTEST, "-t", "ABCD", "-m", "color",
                     "-s", "64", "-o", str(out)]) == 0
        img = decode(out.read_bytes())
        assert int((img != 255).sum()) > 2000


class TestStrokeIntegration:
    """Stroke-vs-fill equivalence twins: glyph 'I' strokes three
    shapes (butt line, square-cap line, stroked rect), 'J' is the same
    geometry as explicit fill paths.  Straight-segment strokes are
    EXACT hand constructions (tests/test_stroke.py), so the renders
    must be pixel-identical through the shared pipeline."""

    def test_stroke_vs_fill_pixel_identical(self, font, engine):
        from fontrx.engine.colorglyphs import color_tiles

        tiles = color_tiles(
            font, [font.glyph_index("I"), font.glyph_index("J")],
            100, engine)
        np.testing.assert_array_equal(tiles[0], tiles[1])
        assert int((tiles[0] != 255).sum()) > 1000  # really painted

    def test_stroked_rect_annulus_has_hole(self, font, engine):
        from fontrx.engine.colorglyphs import color_glyph_tiles

        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("I")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def a(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return float(tile[row, col, 3])

        assert a(500, 870) > 0.9     # on the stroked rect's top band
        assert a(500, 760) < 0.05    # inside the rect: unpainted
        assert a(500, 500) > 0.9     # the butt-cap line body
        assert a(170, 200) > 0.9     # square cap extension painted
        assert a(170, 500) < 0.05    # butt cap: no extension


class TestClipPath:
    def test_clip_window_masks_the_circle(self, font, engine):
        from fontrx.engine.colorglyphs import color_glyph_tiles

        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("K")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def a(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return float(tile[row, col, 3])

        assert a(500, 500) > 0.99    # circle center, inside the window
        # inside the circle but OUTSIDE the 400x400 clip window
        assert a(500, 770) < 0.01
        assert a(230, 500) < 0.01
        # outside the circle entirely
        assert a(150, 150) < 0.01

    def test_tree_structure_srcin(self, font):
        tree = font.color_paint_tree(font.glyph_index("K"), 0,
                                     (0, 0, 0, 255))
        assert tree[0] == "layers" and len(tree[1]) == 1
        node = tree[1][0]
        assert node[0] == "composite" and node[1] == 5  # SrcIn
        assert node[2][0] == "outline"  # the circle content
        assert node[3][0] == "outline"  # the clip mask

    def test_object_bounding_box_units(self):
        from fontrx.font.svgdoc import SvgDocument

        # clip the unit-square LEFT HALF of the rect's bbox
        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><clipPath id="c" clipPathUnits="objectBoundingBox">
            <rect x="0" y="0" width="0.5" height="1"/>
          </clipPath></defs>
          <rect id="glyph1" x="100" y="-600" width="400" height="400"
                fill="black" clip-path="url(#c)"/>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        node = tree[1][0]
        assert node[0] == "composite" and node[1] == 5
        clip_glyph = node[3][1]
        # left half of x [100, 500] in glyph units
        assert clip_glyph.box.x_min == 100
        assert clip_glyph.box.x_max == 300

    def test_empty_clip_clips_everything(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><clipPath id="c"/></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" clip-path="url(#c)"/>
        </svg>""", 1000)
        assert doc.glyph_tree(1) is None

    def test_ancestor_clip_wraps_the_tree(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><clipPath id="c">
            <rect x="0" y="-500" width="500" height="500"/>
          </clipPath></defs>
          <g clip-path="url(#c)">
            <rect id="glyph1" x="0" y="-100" width="100" height="100"
                  fill="black"/>
          </g>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        assert tree[1][0][0] == "composite" and tree[1][0][1] == 5


class TestGroupOpacityExact:
    def test_overlap_reads_half_not_three_quarters(self, font, engine):
        from fontrx.engine.colorglyphs import color_glyph_tiles

        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("L")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def a(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return float(tile[row, col, 3])

        # single-circle regions: 0.5
        assert abs(a(300, 500) - 0.5) < 0.01
        assert abs(a(700, 500) - 0.5) < 0.01
        # the OVERLAP also reads exactly 0.5 (offscreen-composited
        # group; per-leaf folding would read 0.75)
        assert abs(a(500, 500) - 0.5) < 0.01
        # nothing anywhere exceeds the group opacity
        assert float(np.max(tile[..., 3])) <= 0.5 + 1e-5

    def test_alpha_node_in_tree(self, font):
        tree = font.color_paint_tree(font.glyph_index("L"), 0,
                                     (0, 0, 0, 255))
        node = tree[1][0]
        assert node[0] == "alpha" and node[1] == 0.5
        assert node[2][0] == "layers" and len(node[2][1]) == 2


class TestStrokeStyleResolution:
    def test_stroke_properties_inherit(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <g stroke="#102030" stroke-width="40">
            <line id="glyph1" x1="0" y1="-500" x2="1000" y2="-500"/>
          </g>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        leaf = tree[1][0]
        assert leaf[0] == "outline"
        assert leaf[2] == ("solid", (0x10, 0x20, 0x30, 255))
        # butt-cap 40-wide stroke of the horizontal line
        assert leaf[1].box.y_min == 480 and leaf[1].box.y_max == 520

    def test_fill_and_stroke_both_emit(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <rect id="glyph1" x="100" y="-600" width="400" height="400"
                fill="green" stroke="blue" stroke-width="20"/>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        # a single fill+stroke pair IS the root layers list
        assert tree[0] == "layers" and len(tree[1]) == 2
        fill_leaf, stroke_leaf = tree[1]
        assert fill_leaf[2][1][:3] == (0, 0x80, 0)
        assert stroke_leaf[2][1][:3] == (0, 0, 0xFF)
        # stroke paints over fill (document paint order)
        assert stroke_leaf[1].box.x_min == 90  # half-width outside

    def test_stroke_none_width_zero_skip(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <rect id="glyph1" x="100" y="-600" width="400" height="400"
                fill="black" stroke="red" stroke-width="0"/>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        assert tree[1][0][0] == "outline"  # only the fill leaf

    def test_paint_order_stroke_first(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <rect id="glyph1" x="100" y="-600" width="400" height="400"
                fill="green" stroke="blue" stroke-width="20"
                paint-order="stroke fill"/>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        first, second = tree[1]
        assert first[2][1][:3] == (0, 0, 0xFF)   # stroke painted first
        assert second[2][1][:3] == (0, 0x80, 0)  # fill on top


class TestMask:
    def test_luminance_mask_scales_alpha(self, engine):
        from fontrx.engine.colorglyphs import _eval_node
        from fontrx.font.svgdoc import SvgDocument
        import jax.numpy as jnp

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><mask id="m">
            <rect x="0" y="-1000" width="500" height="1000"
                  fill="white"/>
            <rect x="500" y="-1000" width="500" height="1000"
                  fill="#808080"/>
          </mask></defs>
          <rect id="glyph1" x="100" y="-600" width="800" height="400"
                fill="red" mask="url(#m)"/>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        node = tree[1][0]
        assert node[0] == "mask"
        # render through a synthetic single-glyph pipeline: build a
        # tiny Font-like fixture is overkill — evaluate structure
        # numerically instead via the engine path on the svgtest font
        # is not possible for an inline doc, so pin the node algebra:
        assert node[1][0] == "outline"      # the red rect
        assert node[2][0] == "layers"       # white + gray mask rects

    def test_mask_pixels_through_pipeline(self, engine, tmp_path):
        # build an on-disk font with the mask doc and render it
        import io

        import numpy as np
        from fontTools.fontBuilder import FontBuilder
        from fontTools.pens.ttGlyphPen import TTGlyphPen
        from fontTools.ttLib import newTable
        from fontTools.ttLib.tables.S_V_G_ import SVGDocument as SD

        fb = FontBuilder(1000, isTTF=True)
        names = [".notdef", "m"]
        fb.setupGlyphOrder(names)
        fb.setupCharacterMap({ord("M"): "m"})
        gl = {}
        for n in names:
            pen = TTGlyphPen(glyphSet={})
            pen.moveTo((0, 0)); pen.lineTo((10, 0))
            pen.lineTo((5, 10)); pen.closePath()
            gl[n] = pen.glyph()
        fb.setupGlyf(gl)
        fb.setupHorizontalMetrics({n: (1000, 0) for n in names})
        fb.setupHorizontalHeader(ascent=800, descent=-200)
        fb.setupNameTable({"familyName": "MaskT", "styleName": "R"})
        fb.setupOS2(); fb.setupPost()
        doc = """<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 1000 1000">
          <defs><mask id="m">
            <rect x="0" y="-1000" width="500" height="1000" fill="white"/>
            <rect x="500" y="-1000" width="500" height="1000" fill="#808080"/>
          </mask></defs>
          <rect id="glyph1" x="100" y="-600" width="800" height="400" fill="red" mask="url(#m)"/>
        </svg>"""
        svg = newTable("SVG ")
        svg.docList = [SD(doc, 1, 1)]
        fb.font["SVG "] = svg
        buf = io.BytesIO()
        fb.font.save(buf)
        p = tmp_path / "mask.ttf"
        p.write_bytes(buf.getvalue())

        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.font.font import Font

        font = Font.open(str(p))
        rgba, grids = color_glyph_tiles(
            font, [font.glyph_index("M")], 100, engine)
        tile = np.asarray(rgba[0])
        g = grids[0]
        scale = float(g.scale)

        def a(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return float(tile[row, col, 3])

        assert a(300, 400) > 0.99                    # white mask half
        assert abs(a(700, 400) - 0x80 / 255) < 0.02  # gray: lum scales
        assert a(300, 900) < 0.01                    # outside the rect
