"""SVG ``filter`` support (the last documented-out SVG property):
raster-space primitives evaluated on the composited color tile.

Oracles, strongest first:

- **equivalence twins** in ``tests/data/svgtest.ttf`` (the suite's
  established idiom): feOffset == plain rect at the offset position,
  feColorMatrix saturate(1) == unfiltered, feFlood∘feComposite-in ==
  plain solid fill — all must render PIXEL-IDENTICAL through the real
  color pipeline;
- **independent numpy oracles** for the spec algorithms: the
  feGaussianBlur three-box composite kernel checked against direct
  dense convolution, colormatrix against explicit matrix math;
- pinned drop-shadow pixels and the documented fallbacks (unsupported
  primitive -> renders unfiltered; filter-region hard clip).
"""

import numpy as np
import pytest

from fontrx.font.font import Font

SVGTEST = "tests/data/svgtest.ttf"


@pytest.fixture(scope="module")
def font():
    return Font.open(SVGTEST)


@pytest.fixture(scope="module")
def engine():
    from fontrx.engine.raster import RasterEngine

    return RasterEngine()


def _tiles(font, engine, chars, size=100):
    from fontrx.engine.colorglyphs import color_glyph_tiles

    rgba, grids = color_glyph_tiles(
        font, [font.glyph_index(c) for c in chars], size, engine)
    return [np.asarray(t) for t in rgba], grids


def _common_window(tiles, grids):
    """Crop two per-glyph tiles to their shared pixel window (the
    tiles anchor at different grid corners when a filter region
    widens one union box; the pixel LATTICE is shared).  Also returns
    each tile's ink outside the window."""
    (ta, tb), (ga, gb) = tiles, grids
    t = ta.shape[0]
    xlo = max(ga.min_x, gb.min_x)
    xhi = min(ga.min_x, gb.min_x) + t - 1
    yhi = min(ga.max_y, gb.max_y)
    ylo = max(ga.max_y, gb.max_y) - t + 1

    def crop(tile, g):
        r0 = g.max_y - yhi
        c0 = xlo - g.min_x
        win = tile[r0: r0 + (yhi - ylo + 1), c0: c0 + (xhi - xlo + 1)]
        outside = float(tile[..., 3].sum() - win[..., 3].sum())
        return win, outside

    wa, oa = crop(ta, ga)
    wb, ob = crop(tb, gb)
    return wa, wb, oa, ob


class TestEquivalenceTwins:
    def _twin(self, font, engine, a, b, atol=0.0):
        tiles, grids = _tiles(font, engine, a + b)
        wa, wb, oa, ob = _common_window(tiles, grids)
        assert float(wa[..., 3].sum()) > 10  # really painted
        if atol == 0.0:
            np.testing.assert_array_equal(wa, wb)
        else:
            np.testing.assert_allclose(wa, wb, atol=atol)
        # neither twin paints outside the shared window
        assert oa < 1e-6 and ob < 1e-6

    def test_offset_equals_moved_rect(self, font, engine):
        self._twin(font, engine, "M", "N")

    def test_saturate_identity_equals_unfiltered(self, font, engine):
        # one f32 quantization step: the matrix round-trips colors
        self._twin(font, engine, "O", "P", atol=1.5e-3)

    def test_flood_in_alpha_equals_solid_fill(self, font, engine):
        self._twin(font, engine, "Q", "R", atol=1.5e-3)


class TestDropShadow:
    def test_shadow_below_source(self, font, engine):
        tiles, grids = _tiles(font, engine, "S")
        tile, g = tiles[0], grids[0]
        scale = float(g.scale)

        def px(ux, uy):
            col = int(round(ux * scale)) - g.min_x
            row = g.max_y - int(round(uy * scale))
            return tile[row, col]

        # source interior: the rect's own color, on top
        src = px(400, 600)
        np.testing.assert_allclose(
            src[:3] / max(src[3], 1e-6),
            np.array([0xDD, 0xAA, 0x00]) / 255.0, atol=0.02)
        # shadow-only region (offset +120,-120 in doc = +120 glyph x,
        # -120 glyph y), far enough inside that the blur is saturated
        sh = px(680, 350)
        assert sh[3] > 0.95
        np.testing.assert_allclose(
            sh[:3] / sh[3], np.array([0x00, 0x44, 0x00]) / 255.0,
            atol=0.02)
        # empty corner: nothing
        assert px(120, 150)[3] < 0.01


class TestPrimitiveOracles:
    """Engine primitives vs independent numpy implementations."""

    def _eval(self, prims, cov_tile, region=None, tile=32,
              paint=(255, 255, 255, 255)):
        import jax.numpy as jnp

        from fontrx.engine.colorglyphs import _eval_node
        from fontrx.kernels.grid import RasterGrid

        grid = RasterGrid(width=tile, height=tile, min_x=0,
                          max_y=tile - 1, scale=np.float32(1.0))
        cov = [jnp.asarray(cov_tile, jnp.float32)]
        node = ("filter", region, tuple(prims),
                ("glyph", 0, ("solid", paint), None))
        return np.asarray(_eval_node(node, cov, grid, tile))

    def test_gaussian_blur_matches_dense_convolution(self):
        from fontrx.engine.colorglyphs import _blur_kernel

        rng = np.random.default_rng(7)
        cov = (rng.random((32, 32)) > 0.6).astype(np.float32)
        sigma = 2.5
        out = self._eval([("blur", "", sigma, sigma, "")], cov)

        kern, center = _blur_kernel(sigma)
        # independent oracle: dense 2-D convolution of the separable
        # kernel over the premultiplied source, zero-padded edges
        pad = len(kern)
        src = np.pad(cov, pad)
        expect = np.zeros_like(src)
        for j, w in enumerate(kern):
            expect += w * np.roll(src, center - j, axis=1)
        out2 = np.zeros_like(src)
        for j, w in enumerate(kern):
            out2 += w * np.roll(expect, center - j, axis=0)
        expect = out2[pad:-pad, pad:-pad]
        np.testing.assert_allclose(out[..., 3], expect, atol=1e-4)
        # all four premultiplied channels blur identically
        np.testing.assert_allclose(out[..., 0], expect, atol=1e-4)

    def test_blur_kernel_is_spec_three_box(self):
        from fontrx.engine.colorglyphs import _blur_kernel

        # sigma -> d per the spec formula
        for sigma, d in ((1.0, 2), (2.0, 4), (3.0, 6), (1.4, 3)):
            kern, center = _blur_kernel(sigma)
            assert abs(kern.sum() - 1.0) < 1e-6
            if d % 2 == 1:
                assert len(kern) == 3 * d - 2
            else:
                assert len(kern) == 3 * d - 1
        assert _blur_kernel(0.0) is None

    def test_offset_shifts_and_zero_fills(self):
        cov = np.zeros((32, 32), np.float32)
        cov[10, 10] = 1.0
        # +3 em x, +2 em y (em y up -> 2 rows up)
        out = self._eval([("offset", "", 3.0, 2.0, "")], cov)
        assert out[8, 13, 3] == 1.0
        assert out[10, 10, 3] == 0.0

    def test_colormatrix_saturate_zero_is_gray(self):
        cov = np.ones((8, 8), np.float32)
        out = self._eval(
            [("colormatrix", "", "saturate", (0.0,), "")],
            cov, tile=8, paint=(200, 40, 90, 255))
        lum = (0.213 * 200 + 0.715 * 40 + 0.072 * 90) / 255.0
        np.testing.assert_allclose(out[4, 4, :3],
                                   [lum, lum, lum], atol=0.01)

    def test_colormatrix_luminance_to_alpha(self):
        cov = np.ones((8, 8), np.float32)
        out = self._eval(
            [("colormatrix", "", "luminanceToAlpha", (), "")],
            cov, tile=8, paint=(255, 255, 255, 255))
        np.testing.assert_allclose(out[4, 4, 3], 1.0, atol=0.01)
        np.testing.assert_allclose(out[4, 4, :3], 0.0, atol=1e-6)

    def test_composite_arithmetic(self):
        cov = np.ones((8, 8), np.float32)
        # k2*src alone with k2=0.5 halves the (premultiplied) source
        out = self._eval(
            [("flood", (0.0, 0.0, 0.0, 0.0), "bg"),
             ("composite", "SourceGraphic", "bg", "arithmetic",
              (0.0, 0.5, 0.0, 0.0), "")],
            cov, tile=8)
        np.testing.assert_allclose(out[4, 4, 3], 0.5, atol=1e-6)

    def test_merge_stacks_in_order(self):
        cov = np.ones((8, 8), np.float32)
        out = self._eval(
            [("flood", (1.0, 0.0, 0.0, 1.0), "red"),
             ("flood", (0.0, 1.0, 0.0, 1.0), "green"),
             ("merge", ["red", "green"], "")],
            cov, tile=8)
        # green merges on top
        np.testing.assert_allclose(out[4, 4, :3], [0, 1, 0],
                                   atol=1e-6)

    def test_region_hard_clips(self):
        cov = np.ones((32, 32), np.float32)
        # region = em box x[0,15] y[16,31] (upper-left quadrant)
        out = self._eval([("flood", (1.0, 1.0, 1.0, 1.0), "")],
                         cov, region=(0.0, 16.0, 15.0, 31.0))
        assert out[2, 2, 3] == 1.0       # inside (row 2 = em y 29)
        assert out[2, 20, 3] == 0.0      # right of region
        assert out[20, 2, 3] == 0.0      # below region


class TestFallbacks:
    def test_unsupported_primitive_renders_unfiltered(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="u"><feTurbulence/></filter></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#u)"/>
        </svg>""", 1000)
        tree = doc.glyph_tree(1)
        assert tree[1][0][0] == "outline"  # no filter node

    def test_unresolved_reference_renders_unfiltered(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#nope)"/>
        </svg>""", 1000)
        assert doc.glyph_tree(1)[1][0][0] == "outline"

    def test_filter_on_group_wraps_children(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="b">
            <feGaussianBlur stdDeviation="5"/></filter></defs>
          <g id="glyph1" filter="url(#b)">
            <rect x="0" y="-100" width="100" height="100"
                  fill="black"/>
          </g>
        </svg>""", 1000)
        node = doc.glyph_tree(1)[1][0]
        assert node[0] == "filter"
        assert node[2][0][0] == "blur"
        # default region: bbox -10% / +120% mapped to glyph space
        x0, y0, x1, y1 = node[1]
        assert (x0, x1) == (-10.0, 110.0)
        assert (y0, y1) == (-10.0, 110.0)

    def test_named_results_chain(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="c">
            <feGaussianBlur in="SourceAlpha" stdDeviation="2"
                            result="blur"/>
            <feOffset in="blur" dx="10" dy="10" result="off"/>
            <feMerge><feMergeNode in="off"/>
                     <feMergeNode in="SourceGraphic"/></feMerge>
          </filter></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#c)"/>
        </svg>""", 1000)
        node = doc.glyph_tree(1)[1][0]
        assert node[0] == "filter"
        kinds = [p[0] for p in node[2]]
        assert kinds == ["blur", "offset", "merge"]
        assert node[2][0][1] == "SourceAlpha"
        assert node[2][0][-1] == "blur"
        assert node[2][2][1] == ["off", "SourceGraphic"]


class TestLongTailPrimitives:
    """Round-5 long tail: feMorphology, feConvolveMatrix, feTile —
    numpy oracles for the engine primitives + lowering semantics
    (rejection rules, feTile input-subregion resolution)."""

    _eval = TestPrimitiveOracles._eval

    # -- feMorphology ---------------------------------------------------

    @pytest.mark.parametrize("op", ["erode", "dilate"])
    def test_morphology_matches_numpy_window(self, op):
        rng = np.random.default_rng(11)
        cov = rng.random((24, 24)).astype(np.float32)
        rx, ry = 2, 1
        out = self._eval([("morph", "", op, float(rx), float(ry), "")],
                         cov, tile=24)
        # oracle: direct min/max over the (2ry+1, 2rx+1) window with
        # transparent-black outside
        pad_val = 0.0 if op == "dilate" else 0.0
        src = np.pad(cov, ((ry, ry), (rx, rx)),
                     constant_values=pad_val)
        fold = np.maximum if op == "dilate" else np.minimum
        expect = None
        for i in range(2 * ry + 1):
            for j in range(2 * rx + 1):
                s = src[i:i + 24, j:j + 24]
                expect = s if expect is None else fold(expect, s)
        np.testing.assert_allclose(out[..., 3], expect, atol=1e-6)
        np.testing.assert_allclose(out[..., 0], expect, atol=1e-6)

    def test_morphology_zero_radius_is_identity(self):
        cov = np.random.default_rng(3).random((8, 8)).astype(np.float32)
        out = self._eval([("morph", "", "erode", 0.0, 0.0, "")],
                         cov, tile=8)
        np.testing.assert_allclose(out[..., 3], cov, atol=1e-6)

    def test_morphology_lowering_rejects_negative_radius(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="m"><feMorphology radius="-2"/></filter></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#m)"/>
        </svg>""", 1000)
        assert doc.glyph_tree(1)[1][0][0] == "outline"  # unfiltered

    def test_morphology_lowering(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="m">
            <feMorphology operator="dilate" radius="20 10"/>
          </filter></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#m)"/>
        </svg>""", 1000)
        node = doc.glyph_tree(1)[1][0]
        assert node[0] == "filter"
        assert node[2][0][:5] == ("morph", "", "dilate", 20.0, 10.0)

    # -- feConvolveMatrix -----------------------------------------------

    def test_convolve_identity_kernel(self):
        cov = np.random.default_rng(5).random((8, 8)).astype(np.float32)
        out = self._eval(
            [("convolve", "", (1, 1), (1.0,), 1.0, 0.0, (0, 0),
              "duplicate", False, "")], cov, tile=8)
        np.testing.assert_allclose(out[..., 3], cov, atol=1e-6)

    @pytest.mark.parametrize("edge", ["duplicate", "wrap", "none"])
    def test_convolve_matches_spec_formula(self, edge):
        rng = np.random.default_rng(17)
        cov = rng.random((16, 16)).astype(np.float32)
        ox, oy, tx, ty = 3, 2, 1, 0
        kern = tuple(rng.random(ox * oy).round(3))
        div, bias = 2.0, 0.0
        out = self._eval(
            [("convolve", "", (ox, oy), kern, div, bias, (tx, ty),
              edge, False, "")], cov, tile=16)
        # oracle: the spec formula, scalar loops
        k = np.asarray(kern).reshape(oy, ox)
        expect = np.zeros((16, 16))
        for y in range(16):
            for x in range(16):
                acc = 0.0
                for i in range(oy):
                    for j in range(ox):
                        sx, sy = x - tx + j, y - ty + i
                        if edge == "duplicate":
                            sx = min(max(sx, 0), 15)
                            sy = min(max(sy, 0), 15)
                        elif edge == "wrap":
                            sx %= 16
                            sy %= 16
                        elif not (0 <= sx < 16 and 0 <= sy < 16):
                            continue
                        acc += cov[sy, sx] * k[oy - i - 1, ox - j - 1]
                expect[y, x] = min(max(acc / div + bias, 0.0), 1.0)
        np.testing.assert_allclose(out[..., 3], expect, atol=1e-5)

    def test_convolve_preserve_alpha(self):
        # preserveAlpha: straight-RGB convolution, source alpha kept
        cov = np.ones((8, 8), np.float32) * 0.5
        out = self._eval(
            [("convolve", "", (3, 3),
              (0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
              1.0, 0.0, (1, 1), "duplicate", True, "")],
            cov, tile=8, paint=(200, 100, 50, 255))
        np.testing.assert_allclose(out[..., 3], cov, atol=1e-6)
        # identity kernel on straight color -> original premultiplied
        np.testing.assert_allclose(out[4, 4, :3],
                                   np.array([200, 100, 50]) / 255 * 0.5,
                                   atol=1e-5)

    def test_convolve_lowering_rejections(self):
        from fontrx.font.svgdoc import SvgDocument

        cases = [
            b'<feConvolveMatrix order="3" kernelMatrix="1 1"/>',
            b'<feConvolveMatrix order="2" kernelMatrix="1 1 1 1" divisor="0"/>',
            b'<feConvolveMatrix order="2" kernelMatrix="1 1 1 1" targetX="5"/>',
            b'<feConvolveMatrix order="2" kernelMatrix="1 1 1 1" kernelUnitLength="1"/>',
            b'<feConvolveMatrix order="2" kernelMatrix="1 1 1 1" edgeMode="bogus"/>',
        ]
        for prim in cases:
            doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
                 viewBox="0 0 1000 1000">
              <defs><filter id="c">""" + prim + b"""</filter></defs>
              <rect id="glyph1" x="0" y="-100" width="100" height="100"
                    fill="black" filter="url(#c)"/>
            </svg>""", 1000)
            assert doc.glyph_tree(1)[1][0][0] == "outline", prim

    def test_convolve_default_divisor_is_kernel_sum(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="c">
            <feConvolveMatrix order="2" kernelMatrix="1 1 1 1"/>
          </filter></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#c)"/>
        </svg>""", 1000)
        p = doc.glyph_tree(1)[1][0][2][0]
        assert p[0] == "convolve" and p[4] == 4.0

    # -- feTile ---------------------------------------------------------

    def test_tile_replicates_subregion(self):
        cov = np.zeros((16, 16), np.float32)
        cov[12:16, 0:4] = 1.0  # em box x[0,4) y[0,4) (bottom-left)
        # subregion em x[0,4] y[0,4] -> rows 12..16, cols 0..4
        out = self._eval(
            [("tile", "", (0.0, 0.0, 4.0, 4.0), "")], cov, tile=16)
        # the filled square tiles the whole raster
        expect = np.ones((16, 16), np.float32)
        np.testing.assert_allclose(out[..., 3], expect, atol=1e-6)

    def test_tile_pattern_phase(self):
        cov = np.zeros((8, 8), np.float32)
        cov[7, 0] = 1.0  # em (0.?, 0.?) single pixel at box corner
        out = self._eval(
            [("tile", "", (0.0, 0.0, 2.0, 2.0), "")], cov, tile=8)
        expect = np.zeros((8, 8), np.float32)
        expect[1::2, 0::2] = 1.0
        np.testing.assert_allclose(out[..., 3], expect, atol=1e-6)

    def test_tile_without_subregion_is_identity(self):
        cov = np.random.default_rng(9).random((8, 8)).astype(np.float32)
        out = self._eval([("tile", "", None, "")], cov, tile=8)
        np.testing.assert_allclose(out[..., 3], cov, atol=1e-6)

    def test_tile_lowering_resolves_input_subregion(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="t">
            <feFlood flood-color="red" x="100" y="-200" width="50"
                     height="50" result="sq"/>
            <feTile in="sq"/>
          </filter></defs>
          <rect id="glyph1" x="0" y="-500" width="500" height="500"
                fill="black" filter="url(#t)"/>
        </svg>""", 1000)
        node = doc.glyph_tree(1)[1][0]
        prims = node[2]
        assert prims[1][0] == "tile"
        # y-flip: user y in [-200, -150] -> em y in [150, 200]
        assert prims[1][2] == (100.0, 150.0, 150.0, 200.0)

    def test_tile_of_source_is_identity_lowering(self):
        from fontrx.font.svgdoc import SvgDocument

        doc = SvgDocument(b"""<svg xmlns="http://www.w3.org/2000/svg"
             viewBox="0 0 1000 1000">
          <defs><filter id="t"><feTile in="SourceGraphic"/></filter></defs>
          <rect id="glyph1" x="0" y="-100" width="100" height="100"
                fill="black" filter="url(#t)"/>
        </svg>""", 1000)
        assert doc.glyph_tree(1)[1][0][2][0][2] is None


class TestLongTailTwins:
    """Fixture-font equivalence twins for the round-5 primitives:
    T erode(40) rect == U inset rect (separable rect coverage makes
    the windowed min exactly the inset rect's coverage); V a tiled
    100x100 flood cell == W the plain solid rect (mod-copy replicates
    exact pixels across the userSpaceOnUse region)."""

    _twin = TestEquivalenceTwins._twin

    def test_erode_equals_inset_rect(self, font, engine):
        self._twin(font, engine, "T", "U")

    def test_tile_equals_solid_rect(self, font, engine):
        self._twin(font, engine, "V", "W")
