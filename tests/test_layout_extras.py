"""Tracking (letter/word spacing) and per-line decoration bars
(`layout_text(letter_spacing=, word_spacing=, underline=,
strikethrough=)`) — capability extensions; metrics differential vs
fontTools pins `Font.decoration_metrics`."""

import numpy as np
import pytest

from fontrx.font.font import Font
from fontrx.scene.layout import layout_text

DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


@pytest.fixture(scope="module")
def dj():
    return Font.open(DEJAVU)


class TestTracking:
    def test_letter_spacing_widens_every_cell(self, dj):
        base = layout_text(dj, "hello world")
        ls = layout_text(dj, "hello world", letter_spacing=100)
        assert ls.width == base.width + 11 * 100

    def test_word_spacing_hits_spaces_only(self, dj):
        base = layout_text(dj, "a b c")
        ws = layout_text(dj, "a b c", word_spacing=300)
        assert ws.width == base.width + 2 * 300

    def test_tracking_composes_with_kern(self, dj):
        k = layout_text(dj, "AV", kern=True)
        kls = layout_text(dj, "AV", kern=True, letter_spacing=50)
        # second glyph starts 50 further (kern delta preserved)
        assert kls.instances[1].x - k.instances[1].x == 50

    def test_tracking_in_rtl_mirror(self, dj):
        # spacing lives inside the advance box, so mirrored lines keep
        # pair order with wider cells
        r = layout_text(dj, "שלום", rtl=True, letter_spacing=80)
        b = layout_text(dj, "שלום", rtl=True)
        xs_r = sorted(i.x for i in r.instances)
        xs_b = sorted(i.x for i in b.instances)
        gaps_r = np.diff(xs_r)
        gaps_b = np.diff(xs_b)
        np.testing.assert_allclose(gaps_r - gaps_b, 80)

    def test_vertical_tracking_deepens_column(self, dj):
        v = layout_text(dj, "ab", vertical=True)
        vt = layout_text(dj, "ab", vertical=True, letter_spacing=100)
        assert vt.height == v.height + 2 * 100


class TestDecorations:
    def test_metrics_match_fonttools(self, dj):
        from fontTools.ttLib import TTFont

        ft = TTFont(DEJAVU)
        u_pos, u_thick, s_pos, s_thick = dj.decoration_metrics
        assert u_pos == ft["post"].underlinePosition
        assert u_thick == ft["post"].underlineThickness
        assert s_pos == ft["OS/2"].yStrikeoutPosition
        assert s_thick == ft["OS/2"].yStrikeoutSize

    def test_bars_per_line_and_kind(self, dj):
        lt = layout_text(dj, "hi\nthere", underline=True,
                         strikethrough=True)
        bars = [i for i in lt.instances
                if lt.slot_chars[i.glyph_slot] == -1]
        assert len(bars) == 4  # 2 lines x 2 kinds
        # bar slots carry unique negative synthetic gids
        neg = [g for g in lt.slot_gids if g < 0]
        assert len(neg) == len(set(neg)) == 4

    def test_bar_geometry_spans_the_line(self, dj):
        lt = layout_text(dj, "hello", underline=True)
        base = layout_text(dj, "hello")
        bar_slots = [s for s, c in enumerate(lt.slot_chars) if c == -1]
        assert len(bar_slots) == 1
        u_pos, u_thick, _, _ = dj.decoration_metrics
        box = lt.batch.boxes[bar_slots[0]]
        assert box[0] == 0 and box[2] == round(base.width)
        assert box[3] == u_pos and box[1] == u_pos - u_thick

    def test_bar_renders_ink(self, dj):
        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.grid import RasterGrid

        lt = layout_text(dj, "x", underline=True)
        bar_slot = lt.slot_chars.index(-1)
        seg = lt.batch.segments[bar_slot:bar_slot + 1]
        box = lt.batch.boxes[bar_slot]
        grid = RasterGrid.for_glyph_box(
            tuple(int(v) for v in box), 64, dj.info.units_per_em)
        w = RasterEngine().winding_batch(
            seg, np.array([grid.min_x], np.int32),
            np.array([grid.max_y], np.int32), grid.scale,
            height=grid.height, width=grid.width)
        assert int((np.asarray(w) != 0).sum()) > 0

    def test_empty_line_gets_no_bar(self, dj):
        lt = layout_text(dj, "a\n\nb", underline=True)
        bars = [i for i in lt.instances
                if lt.slot_chars[i.glyph_slot] == -1]
        assert len(bars) == 2  # the empty middle line is skipped


class TestHyphenation:
    """Soft hyphens (U+00AD) and UAX#14 HY break-after-hyphen in the
    greedy wrapper."""

    def _em(self, dj, text, **kw):
        lt = layout_text(dj, text, **kw)
        return lt

    def test_soft_hyphen_invisible_without_wrap(self, dj):
        a = layout_text(dj, "super­cali")
        b = layout_text(dj, "supercali")
        assert a.width == b.width
        assert len(a.instances) == len(b.instances)

    def test_soft_hyphen_materializes_at_break(self, dj):
        # budget fits "super-" but not "supercali"
        word = "super­califragilistic"
        w_super = layout_text(dj, "super-").width
        lt = layout_text(dj, word, wrap_width=w_super + 10)
        hyphen_gid = int(dj.charmap.glyph_index(0x2D))
        # two lines; line 0 ends with the materialized hyphen
        rows = sorted({i.y for i in lt.instances}, reverse=True)
        assert len(rows) == 2
        line0 = [i for i in lt.instances if i.y == rows[0]]
        last = max(line0, key=lambda i: i.x)
        assert lt.slot_gids[last.glyph_slot] == hyphen_gid

    def test_soft_hyphen_skipped_when_hyphen_does_not_fit(self, dj):
        # budget smaller than "super-": the shy at 5 can't be taken,
        # the line overflows to the next opportunity instead
        word = "super­cali jam"
        w = layout_text(dj, "sup").width
        lt = layout_text(dj, word, wrap_width=w)
        hyphen_gid = int(dj.charmap.glyph_index(0x2D))
        gids = {lt.slot_gids[i.glyph_slot] for i in lt.instances}
        assert hyphen_gid not in gids  # no materialized hyphen

    def test_break_after_explicit_hyphen(self, dj):
        text = "well-known"
        w = layout_text(dj, "well-k").width
        lt = layout_text(dj, text, wrap_width=w)
        rows = sorted({i.y for i in lt.instances}, reverse=True)
        assert len(rows) == 2
        # the hyphen stays at the end of line 0 (nothing consumed)
        hyphen_gid = int(dj.charmap.glyph_index(0x2D))
        line0 = [i for i in lt.instances if i.y == rows[0]]
        last = max(line0, key=lambda i: i.x)
        assert lt.slot_gids[last.glyph_slot] == hyphen_gid

    def test_no_break_before_digit_after_hyphen(self, dj):
        # UAX#14 HY: "3-4" must not split after the hyphen
        text = "abc 3-4"
        w = layout_text(dj, "abc 3-").width
        lt = layout_text(dj, text, wrap_width=w)
        rows = sorted({i.y for i in lt.instances}, reverse=True)
        assert len(rows) == 2
        # the break fell at the space, keeping "3-4" together
        line1 = [i for i in lt.instances if i.y == rows[1]]
        assert len(line1) == 3  # 3, -, 4


class TestNfdFallback:
    def _font(self):
        from tests import ttf_builder as tb

        # maps 'e' (0x65) and combining acute (0x301), NOT é (0xE9)
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4(
            [(0x65, 0x65, 1 - 0x65, None),
             (0x301, 0x301, 2 - 0x301, None)]))])
        tri = tb.build_simple_glyph(
            [[(0, 0, True), (50, 100, False), (100, 0, True)]],
            box=(0, 0, 100, 100))
        return Font(tb.build_font([b"", tri, tri], cmap))

    def test_missing_precomposed_decomposes(self):
        f = self._font()
        assert int(f.charmap.glyph_index(0xE9)) == 0
        lt = layout_text(f, "é")  # U+00E9
        gids = [lt.slot_gids[i.glyph_slot] for i in lt.instances]
        assert gids == [1, 2]  # base e + combining acute, no .notdef

    def test_present_precomposed_untouched(self, dj):
        a = layout_text(dj, "é")
        assert len(a.instances) == 1
        assert 0 not in a.slot_gids

    def test_unmappable_still_notdef(self):
        f = self._font()
        lt = layout_text(f, "ä")  # diaeresis unmapped: stays .notdef
        gids = [lt.slot_gids[i.glyph_slot] for i in lt.instances]
        assert gids == [0]


class TestUseMyMetrics:
    def test_component_metrics_patch_advance(self):
        from tests import ttf_builder as tb

        # glyph 1 (advance 600), glyph 2 = composite of glyph 1 with
        # USE_MY_METRICS set but its OWN hmtx advance 900: loading the
        # composite must patch its effective advance to 600
        tri = tb.build_simple_glyph(
            [[(0, 0, True), (50, 100, False), (100, 0, True)]],
            box=(0, 0, 100, 100))
        comp = tb.build_compound_glyph(
            [{"glyph_index": 1, "dx": 0, "dy": 0}])
        # splice USE_MY_METRICS (0x0200) into the part flags
        import struct
        flags = struct.unpack(">H", comp[10:12])[0] | 0x0200
        comp = comp[:10] + struct.pack(">H", flags) + comp[12:]
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4(
            [(65, 66, 1 - 65, None)]))])
        f = Font(tb.build_font(
            [b"", tri, comp], cmap,
            metrics=[(500, 0), (600, 0), (900, 0)]))
        assert int(f.advance_widths[2]) == 900  # pre-load: raw hmtx
        f.load_glyph(2)
        assert int(f.advance_widths[2]) == 600  # patched

    def test_dejavu_composites_consistent(self):
        # real-font sanity: loading every DejaVu composite leaves the
        # hmtx advances unchanged (the font keeps them consistent)
        f = Font.open("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
        import numpy as np
        before = np.array(f.advance_widths, copy=True)
        for gid in (f.charmap.glyph_index(0xE0),  # à: composite
                    f.charmap.glyph_index(0xC5)):  # Å
            f.load_glyph(int(gid))
        np.testing.assert_array_equal(before, f.advance_widths)


class TestReviewRegressions:
    """Pinned fixes from the round-3-extension code review."""

    def test_shy_without_cmap_entry_degrades_cleanly(self):
        # font lacks U+00AD: SHY never enters the stream (no tofu)
        f = Font.open("tests/data/kerx_pairs.ttf")
        lt = layout_text(f, "A­V", wrap_width=10000)
        gids = [lt.slot_gids[i.glyph_slot] for i in lt.instances]
        assert gids == [1, 2]

    def test_tracking_defers_past_attached_marks(self, dj):
        a = layout_text(dj, "x̂y", positioning=(), marks=True)
        b = layout_text(dj, "x̂y", positioning=(), marks=True,
                        letter_spacing=100)
        # the mark stays on its GPOS anchor; the next base shifts once
        assert b.instances[1].x == a.instances[1].x
        assert b.instances[2].x - a.instances[2].x == 100

    def test_morx_applies_under_bidi(self):
        f = Font.open("tests/data/morx_nonctx.ttf")
        lt = layout_text(f, "AC", bidi=True)
        gids = [lt.slot_gids[i.glyph_slot] for i in lt.instances]
        assert gids == [2, 3]


class TestAlignment:
    def test_right_and_center(self, dj):
        left = layout_text(dj, "hi\nlonger line", wrap_width=None)
        right = layout_text(dj, "hi\nlonger line", align="right")
        center = layout_text(dj, "hi\nlonger line", align="center")
        # line 1 ("longer line") is the widest: unmoved under right
        rows = sorted({i.y for i in right.instances}, reverse=True)
        r0 = [i for i in right.instances if i.y == rows[0]]
        l0 = [i for i in left.instances if i.y == rows[0]]
        shift = r0[0].x - l0[0].x
        assert shift > 0  # the short line moved right
        c0 = [i for i in center.instances if i.y == rows[0]]
        assert abs((c0[0].x - l0[0].x) - shift / 2) < 1e-6

    def test_justify_stretches_spaces_only(self, dj):
        text = "a b c d e f g h\nlast"
        base = layout_text(dj, text, wrap_width=9000)
        just = layout_text(dj, text, wrap_width=9000, align="justify")
        rows = sorted({i.y for i in just.instances}, reverse=True)
        j0 = sorted((i for i in just.instances if i.y == rows[0]),
                    key=lambda i: i.x)
        b0 = sorted((i for i in base.instances if i.y == rows[0]),
                    key=lambda i: i.x)
        # first glyph unmoved, last glyph pushed toward the budget
        assert j0[0].x == b0[0].x
        assert j0[-1].x > b0[-1].x
        # the LAST line never justifies
        last = rows[-1]
        j1 = [i for i in just.instances if i.y == last]
        b1 = [i for i in base.instances if i.y == last]
        assert sorted(i.x for i in j1) == sorted(i.x for i in b1)

    def test_underline_follows_alignment(self, dj):
        lt = layout_text(dj, "hi\nlonger line", align="right",
                         underline=True)
        bars = [i for i in lt.instances
                if lt.slot_chars[i.glyph_slot] == -1]
        assert len(bars) == 2
        # the short line's bar starts at its shifted origin (non-zero)
        assert max(b.x for b in bars) > 0
        assert min(b.x for b in bars) == 0.0  # the wide line's bar


class TestLineHeight:
    def test_override(self, dj):
        a = layout_text(dj, "a\nb")
        b = layout_text(dj, "a\nb", line_height=3000)
        assert b.instances[1].y == -3000.0
        assert a.instances[1].y != b.instances[1].y

    def test_interactive_layout_options(self, dj):
        from fontrx.scene.interactive import InteractiveSession

        s = InteractiveSession(dj, "hi", 160, 100,
                               layout_options={"underline": True})
        bars = [i for i in s.layout.instances
                if s.layout.slot_chars[i.glyph_slot] == -1]
        assert len(bars) == 1
        s._set_text("hello there")
        bars = [i for i in s.layout.instances
                if s.layout.slot_chars[i.glyph_slot] == -1]
        assert len(bars) == 1  # options survive re-layout


class TestReviewRegressions2:
    """Second review batch, regression-pinned."""

    def test_align_works_with_positioner(self, dj):
        left = layout_text(dj, "hi\nlonger line", positioning=(),
                           kern=True)
        right = layout_text(dj, "hi\nlonger line", positioning=(),
                            kern=True, align="right")
        rows = sorted({i.y for i in right.instances}, reverse=True)
        r0 = [i for i in right.instances if i.y == rows[0]]
        l0 = [i for i in left.instances if i.y == rows[0]]
        assert r0[0].x > l0[0].x  # the short line moved

    def test_justify_skips_paragraph_final_lines(self, dj):
        text = "tiny one.\nlong words that wrap around the budget end"
        w = layout_text(dj, "long words that").width
        base = layout_text(dj, text, wrap_width=w)
        just = layout_text(dj, text, wrap_width=w, align="justify")
        rows_b = sorted({i.y for i in base.instances}, reverse=True)
        # line 0 = 'tiny one.' ends at a HARD break: never justified
        j0 = [i for i in just.instances if i.y == rows_b[0]]
        b0 = [i for i in base.instances if i.y == rows_b[0]]
        assert sorted(i.x for i in j0) == sorted(i.x for i in b0)

    def test_trak_without_default_track_is_none(self):
        import struct

        from fontrx.font.trak import TrakTable
        from fontrx.utils.reader import BigEndianReader

        # one NAMED track (1.0), no 0.0 default -> None (hb behavior)
        td_off = 12
        size_off = td_off + 8 + 8
        val_off = size_off + 4
        data = (struct.pack(">IHHHH", 0x10000, 0, td_off, 0, 0)
                + struct.pack(">HHI", 1, 1, size_off)
                + struct.pack(">iHH", 1 << 16, 0, val_off)
                + struct.pack(">i", 12 << 16)
                + struct.pack(">h", -50))
        assert TrakTable.parse(BigEndianReader(data)) is None

    def test_render_text_fallback_builds_stack(self):
        import fontrx

        img = fontrx.render_text(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            "ab", size=32,
            fallback="/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf")
        assert img.shape[2] == 3

    def test_render_text_rejects_cli_only_options(self):
        import fontrx
        import pytest

        with pytest.raises(TypeError):
            fontrx.render_text(
                "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                "x", interactive=True)

    def test_interactive_cli_flags_reach_layout(self, dj):
        # the CLI wires --underline/--align into layout_options
        from fontrx.cli.config import parse_args
        cfg = parse_args([
            "-f", "x.ttf", "-t", "hi", "--underline", "--align",
            "center"])
        assert cfg.underline and cfg.align == "center"


class TestDefaultIgnorables:
    """Unmapped default-ignorable codepoints render INVISIBLE (no
    .notdef tofu), while staying visible to the shaping passes
    through the parallel codepoint stream."""

    def test_zwnj_breaks_joining_without_tofu(self):
        from fontrx.native import hb

        f = Font.open("tests/data/arabictest.ttf")
        lt = layout_text(f, "ب‌ب", ligatures=True, rtl=True)
        gids = [lt.slot_gids[i.glyph_slot] for i in lt.instances]
        assert 0 not in gids          # no tofu
        assert gids == [4, 4]         # both ISOLATED (ZWNJ broke it)
        # and withOUT the ZWNJ the pair joins (init+fina)
        lt2 = layout_text(f, "بب", ligatures=True, rtl=True)
        gids2 = [lt2.slot_gids[i.glyph_slot] for i in lt2.instances]
        assert gids2 != gids

    def test_unmapped_zwsp_is_invisible(self):
        f = Font.open("tests/data/kerx_pairs.ttf")  # maps only A/V
        lt = layout_text(f, "A​V")
        gids = [lt.slot_gids[i.glyph_slot] for i in lt.instances]
        assert gids == [1, 2]         # the ZWSP left no instance

    def test_mapped_ignorables_keep_their_glyph(self, dj):
        # DejaVu maps the word joiner: the font's own (zero-width)
        # glyph renders, we don't override mapped characters
        if int(dj.charmap.glyph_index(0x2060)) == 0:
            pytest.skip("font doesn't map WJ")
        lt = layout_text(dj, "a⁠b")
        assert len(lt.instances) == 3
