"""Font-fallback-stack tests (`fontrx/font/stack.py`) — a capability
extension (the reference loads exactly one font, ``Appli.zig:101-115``).
"""

import os

import numpy as np
import pytest

from fontrx.font.font import Font
from fontrx.font.stack import GID_SHIFT, FontStack

DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
SERIF = "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf"


def _stix_path():
    try:
        import matplotlib

        p = os.path.join(
            matplotlib.get_data_path(), "fonts", "ttf", "STIXGeneral.ttf"
        )
        return p if os.path.exists(p) else None
    except ImportError:
        return None


STIX = _stix_path()


@pytest.fixture(scope="module")
def stack():
    if STIX is None:
        pytest.skip("matplotlib STIX fonts unavailable")
    return FontStack.open([DEJAVU, STIX])


class TestResolution:
    def test_primary_wins(self, stack):
        # 'A' exists in both; the primary's gid must be used (font 0)
        sgid = stack.glyph_index("A")
        assert sgid >> GID_SHIFT == 0
        assert sgid == Font.open(DEJAVU).glyph_index("A")

    def test_fallback_resolves_missing_char(self, stack):
        # U+210A (script small g) is in STIXGeneral, not DejaVu
        assert Font.open(DEJAVU).glyph_index(0x210A) == 0
        sgid = stack.glyph_index(0x210A)
        assert sgid >> GID_SHIFT == 1
        assert (sgid & 0xFFFF) != 0

    def test_char_missing_everywhere_is_notdef(self, stack):
        assert stack.glyph_index(0xE0101) in (0,)  # unused selector cp

    def test_char_for_glyph_round_trips(self, stack):
        sgid = stack.glyph_index(0x210A)
        assert stack.charmap.char_for_glyph(sgid) == 0x210A


class TestScaling:
    def test_fallback_glyph_rescaled_to_primary_em(self, stack):
        # STIX is 1000 upem, DejaVu 2048: outline and advance scale up
        stix = Font.open(STIX)
        gid = stix.glyph_index(0x210A)
        native = stix.load_glyph(gid)
        scaled = stack.load_glyph((1 << GID_SHIFT) | gid)
        factor = 2048 / 1000
        assert scaled.box.x_max == int(np.ceil(native.box.x_max * factor))
        assert scaled.num_segments == native.num_segments
        w_native = int(stix.advance_widths[gid])
        w_scaled = stack.advance_widths[(1 << GID_SHIFT) | gid]
        assert w_scaled == round(w_native * factor)

    def test_same_upem_fallback_identical(self):
        st = FontStack.open([DEJAVU, SERIF])
        serif = Font.open(SERIF)
        gid = serif.glyph_index("Q")
        g1 = st.load_glyph((1 << GID_SHIFT) | gid)
        g2 = serif.load_glyph(gid)
        assert g1.box == g2.box


class TestKernSafety:
    def test_synthetic_ids_never_alias_kern_pairs(self, stack):
        """The flattened kern table packs left<<16|right; a synthetic
        id (fi<<16|gid) would alias the pair (gid', right) — the stack
        wrapper must return 0 for any pair touching a fallback glyph."""
        prim = Font.open(DEJAVU)
        keys = prim.kerning.keys
        left = int(keys[0] >> 16)
        right = int(keys[0] & 0xFFFF)
        real = prim.kerning.lookup(np.array([left]), np.array([right]))[0]
        assert real != 0
        # the aliasing pair: synthetic id whose low bits equal `left`
        alias_left = (1 << GID_SHIFT) | left
        v = stack.kerning.lookup(np.array([alias_left]), np.array([right]))
        assert v[0] == 0
        # and primary pairs still kern through the wrapper
        v2 = stack.kerning.lookup(np.array([left]), np.array([right]))
        assert v2[0] == real


class TestLayoutIntegration:
    def test_layout_renders_fallback_glyphs(self, stack):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer
        from fontrx.scene.transform import ViewTransform

        lt = layout_text(stack, "AbℊC", kern=True, ligatures=True)
        assert any(g >> GID_SHIFT == 1 for g in lt.slot_gids)
        view = ViewTransform.init(stack.info.units_per_em, 256, 128)
        page = PageRenderer(
            stack, lt, 256, 128, RasterEngine()
        ).render(view)
        assert (page > 0).sum() > 100

    def test_primary_only_text_matches_plain_font(self, stack):
        from fontrx.scene.layout import layout_text

        text = "AVATAR fi."
        a = layout_text(Font.open(DEJAVU), text, kern=True, ligatures=True)
        b = layout_text(stack, text, kern=True, ligatures=True)
        pa = [(i.x, i.y) for i in a.instances]
        pb = [(i.x, i.y) for i in b.instances]
        assert pa == pb

    def test_wrap_composes_with_stack(self, stack):
        from fontrx.scene.layout import layout_text

        lt = layout_text(
            stack, "alpha ℊ beta gamma", wrap_width=6000
        )
        assert len({i.y for i in lt.instances}) > 1

    def test_stack_requires_fonts(self):
        with pytest.raises(ValueError):
            FontStack([])


class TestStackColor:
    """Color surface through fallback stacks: per-owner COLR/bitmap
    resolution with layer gids remapped into stack space."""

    def test_primary_color_font_renders(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "c.qoi"
        rc = main(["-f", "tests/data/colrtest.ttf", "--fallback",
                   "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                   "-t", "Ax", "-m", "color", "-s", "48",
                   "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        blue = (img[:, :, 2] == 255) & (img[:, :, 0] == 0)
        black = np.all(img == 0, axis=2)
        assert blue.sum() > 200      # colored 'A' from the primary
        assert black.sum() > 20      # mono 'x' from the fallback

    def test_fallback_color_glyph_remaps_layers(self):
        from fontrx.font.font import Font
        from fontrx.font.stack import GID_SHIFT, FontStack

        stack = FontStack([
            Font.open("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"),
            Font.open("tests/data/colrtest.ttf"),
        ])
        colr_font = stack.fonts[1]
        gid = colr_font.glyph_index("A")
        sgid = (1 << GID_SHIFT) | gid
        tree = stack.color_paint_tree(sgid)
        assert tree is not None and tree[0] == "layers"
        for node in tree[1]:
            assert node[0] == "glyph"
            assert node[1] >> GID_SHIFT == 1   # layers stay in-owner
        # the remapped layer outlines load (and rescale) through the
        # stack facade
        g = stack.load_glyph_safe(tree[1][0][1])
        assert g.contours

    def test_monochrome_stack_has_no_color(self):
        from fontrx.font.font import Font
        from fontrx.font.stack import FontStack

        stack = FontStack([Font.open(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")])
        assert stack.colr is None
        assert stack.color_paint_tree(
            stack.glyph_index("A")) is None
        assert stack.color_bitmap(stack.glyph_index("A"), 32) is None


class TestColorTreeNodeForms:
    def test_svg_composite_nodes_flow_through_stack(self):
        """clip-path/alpha/mask render-tree forms survive the stack's
        gid remap (the review-found walker gap)."""
        import numpy as np

        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine
        from fontrx.font.stack import FontStack

        stack = FontStack.open([
            "tests/data/svgtest.ttf",
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        ])
        gid = int(stack.glyph_index("K"))  # clip-path composite
        tree = stack.color_paint_tree(gid, 0, (0, 0, 0, 255))
        assert tree is not None
        eng = RasterEngine()
        rgba, _ = color_glyph_tiles(stack, [gid], 64, eng)
        assert float(np.asarray(rgba)[..., 3].sum()) > 0
