"""TTF parser unit tests against hand-built minimal font blobs and real
DejaVu fonts (SURVEY §4 item 1)."""

import numpy as np
import pytest

from fontrx.font import ttf
from fontrx.font.font import Font
from fontrx.utils.reader import BigEndianReader, CorruptedFont
from tests import ttf_builder as tb


def square_glyph(size=100, on_all=True):
    """A simple square contour (clockwise in TTF y-up convention =
    filled positively)."""
    pts = [(0, 0, True), (0, size, True), (size, size, True), (size, 0, True)]
    return tb.build_simple_glyph([pts], box=(0, 0, size, size))


def minimal_font(**kw):
    cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 66, -64, None)]))])
    glyphs = [b"", square_glyph(), square_glyph(200)]
    return tb.build_font(glyphs, cmap, **kw)


class TestDirectory:
    def test_parses_required_tables(self):
        font = Font(minimal_font())
        for tag in ttf.REQUIRED_TABLES:
            assert tag in font.tables

    def test_rejects_non_truetype(self):
        with pytest.raises(CorruptedFont):
            Font(b"OTTO" + b"\x00" * 100)

    def test_missing_table_rejected(self):
        blob = bytearray(minimal_font())
        idx = blob.find(b"glyf")
        blob[idx : idx + 4] = b"glyX"
        with pytest.raises(CorruptedFont):
            Font(bytes(blob))


class TestHead:
    def test_fields(self):
        font = Font(minimal_font(units_per_em=2048))
        assert font.info.units_per_em == 2048
        assert font.info.y0_baseline
        assert font.info.loca_format == 0

    def test_bad_magic(self):
        blob = minimal_font()
        font = Font(blob)
        start = font.tables[b"head"].offset
        corrupt = bytearray(blob)
        corrupt[start + 12 : start + 16] = b"\x00\x00\x00\x00"
        with pytest.raises(CorruptedFont):
            Font(bytes(corrupt))


class TestLoca:
    def test_short_and_long_agree(self):
        f_short = Font(minimal_font(loca_format=0))
        f_long = Font(minimal_font(loca_format=1))
        for idx in range(3):
            gs = f_short.load_glyph(idx)
            gl = f_long.load_glyph(idx)
            assert len(gs.contours) == len(gl.contours)
            for cs, cl in zip(gs.contours, gl.contours):
                np.testing.assert_array_equal(cs.points, cl.points)

    def test_empty_glyph(self):
        font = Font(minimal_font())
        g = font.load_glyph(0)
        assert g.contours == ()


class TestSimpleGlyph:
    def test_square_points(self):
        font = Font(minimal_font())
        g = font.load_glyph(1)
        assert len(g.contours) == 1
        pts = g.contours[0].points
        # closed and odd-length (even/odd invariant)
        np.testing.assert_array_equal(pts[0], pts[-1])
        assert len(pts) % 2 == 1
        # all 4 corners present
        corners = {(0, 0), (0, 100), (100, 100), (100, 0)}
        assert corners <= {tuple(p) for p in pts}

    def test_repeat_flag_roundtrip(self):
        # staircase of identical short deltas -> one long flag run
        pts = [(0, 0, True)] + [(10 * i, 10 * i, True) for i in range(1, 6)] \
            + [(40, 0, True)]
        plain = tb.build_simple_glyph([pts], use_repeat=False)
        rle = tb.build_simple_glyph([pts], use_repeat=True)
        assert len(rle) < len(plain)  # repeat actually engaged
        for blob in (plain, rle):
            r = BigEndianReader(blob)
            desc = ttf.GlyphDescription.parse(r)
            sg = ttf.SimpleGlyph.parse(r, desc.number_of_contours)
            np.testing.assert_array_equal(
                sg.coordinates, np.array([(p[0], p[1]) for p in pts])
            )
            assert sg.on_curve.all()

    def test_long_coordinates(self):
        pts = [(0, 0, True), (1000, 0, True), (1000, 1000, True), (0, 1000, True)]
        blob = tb.build_simple_glyph([pts], box=(0, 0, 1000, 1000))
        r = BigEndianReader(blob)
        desc = ttf.GlyphDescription.parse(r)
        sg = ttf.SimpleGlyph.parse(r, desc.number_of_contours)
        np.testing.assert_array_equal(
            sg.coordinates, np.array([(p[0], p[1]) for p in pts])
        )

    def test_off_curve_points(self):
        pts = [(0, 0, True), (50, 100, False), (100, 0, True)]
        blob = tb.build_simple_glyph([pts])
        r = BigEndianReader(blob)
        desc = ttf.GlyphDescription.parse(r)
        sg = ttf.SimpleGlyph.parse(r, desc.number_of_contours)
        np.testing.assert_array_equal(sg.on_curve, [True, False, True])


class TestCompoundGlyph:
    def _font_with_compound(self, part_kwargs):
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 65, -63, None)]))])
        compound = tb.build_compound_glyph(
            [dict(glyph_index=1, **part_kwargs)], box=(0, 0, 300, 300)
        )
        glyphs = [b"", square_glyph(), compound]
        return Font(tb.build_font(glyphs, cmap))

    def test_translate(self):
        font = self._font_with_compound(dict(dx=10, dy=20))
        base = font.load_glyph(1)
        comp = font.load_glyph(2)
        np.testing.assert_array_equal(
            comp.contours[0].points, base.contours[0].points + [10, 20]
        )

    def test_uniform_scale(self):
        font = self._font_with_compound(dict(dx=0, dy=0, scale=0.5))
        base = font.load_glyph(1)
        comp = font.load_glyph(2)
        np.testing.assert_array_equal(
            comp.contours[0].points, base.contours[0].points // 2
        )

    def test_two_by_two_rotation(self):
        # 90-degree rotation: (x, y) -> (-y, x); matrix [a b c d] applied
        # as x' = a*x + c*y, y' = b*x + d*y
        font = self._font_with_compound(
            dict(dx=0, dy=0, matrix=(0.0, 1.0, -1.0, 0.0))
        )
        base = font.load_glyph(1)
        comp = font.load_glyph(2)
        expect = np.stack(
            [-base.contours[0].points[:, 1], base.contours[0].points[:, 0]], axis=1
        )
        np.testing.assert_array_equal(comp.contours[0].points, expect)

    def test_cycle_detection(self):
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 65, -64, None)]))])
        self_ref = tb.build_compound_glyph([dict(glyph_index=1, dx=0, dy=0)])
        font = Font(tb.build_font([b"", self_ref], cmap))
        with pytest.raises(CorruptedFont, match="cycle"):
            font.load_glyph(1)


class TestLegacyCmapFormats:
    """Formats 0 and 6 — capability extensions beyond the reference,
    which ``@compileError``s them (``ttf.zig:349-360,497-570``)."""

    def _font_with_cmap(self, cmap):
        glyphs = [b"", square_glyph(), square_glyph(200)]
        return Font(tb.build_font(glyphs, cmap))

    def test_format0_mac_only_font(self):
        ids = [0] * 256
        ids[65], ids[66] = 1, 2  # 'A'->1, 'B'->2
        cmap = tb.build_cmap([(1, 0, tb.build_cmap_format0(ids))])
        font = self._font_with_cmap(cmap)
        assert font.glyph_index("A") == 1
        assert font.glyph_index("B") == 2
        assert font.glyph_index("C") == 0
        assert font.glyph_index(0x1F600) == 0  # out of byte range

    def test_format0_run_compression(self):
        ids = [0] * 256
        for i in range(65, 91):  # A..Z -> 1..26 consecutive
            ids[i] = i - 64
        ids[97] = 2  # lone 'a' -> same glyph as 'B' (non-consecutive run)
        sub = ttf.CmapFormat0.parse(
            BigEndianReader(tb.build_cmap_format0(ids), 2)
        )
        rows = sub.collect_range_mappings()
        assert rows.shape == (2, 3)  # one 26-char run + one singleton
        assert rows[0].tolist() == [91, 26, 27]
        assert rows[1].tolist() == [98, 1, 3]

    def test_format6_trimmed_table(self):
        cmap = tb.build_cmap([(1, 0, tb.build_cmap_format6(65, [1, 2]))])
        font = self._font_with_cmap(cmap)
        assert font.glyph_index("A") == 1
        assert font.glyph_index("B") == 2
        assert font.glyph_index("@") == 0  # below first_code
        assert font.glyph_index("C") == 0  # past the table

    def test_unicode_subtable_still_preferred(self):
        ids = [0] * 256
        ids[65] = 2  # Mac table disagrees: 'A'->2
        cmap = tb.build_cmap([
            (1, 0, tb.build_cmap_format0(ids)),
            (3, 1, tb.build_cmap_format4([(65, 66, -64, None)])),
        ])
        font = self._font_with_cmap(cmap)
        assert isinstance(font.cmap_subtable, ttf.CmapFormat4)
        assert font.glyph_index("A") == 1  # unicode table wins

    def test_format13_many_to_one(self):
        # chars 0x40..0x5A all -> glyph 1, 0x60..0x7A all -> glyph 2
        cmap = tb.build_cmap([
            (3, 10, tb.build_cmap_format13([(0x40, 0x5A, 1), (0x60, 0x7A, 2)]))
        ])
        font = self._font_with_cmap(cmap)
        assert isinstance(font.cmap_subtable, ttf.CmapFormat13)
        for ch in "@AZ":
            assert font.glyph_index(ch) == 1
        for ch in "`az":
            assert font.glyph_index(ch) == 2
        assert font.glyph_index("0") == 0  # outside any group
        # vectorized batch lookup agrees with scalar
        chars = np.array([0x40, 0x41, 0x5A, 0x5B, 0x60, 0x7A, 0x30])
        np.testing.assert_array_equal(
            font.charmap.glyph_indices(chars), [1, 1, 1, 0, 2, 2, 0]
        )
        # reverse lookup returns the first char of the constant range
        assert font.charmap.char_for_glyph(1) == 0x40
        assert font.charmap.char_for_glyph(2) == 0x60
        # raster end-to-end through the constant mapping
        g, _ = font.get_glyph("M")
        assert g.num_segments > 0
        # debug dump marks constant ranges
        assert "(constant)" in font.dump_charmap()

    def test_unusable_only_cmap_raises(self):
        import struct

        # an unknown format (the 2/8/10 legacy formats parse since
        # round 3, completing the set)
        body = struct.pack(">HHH", 99, 6, 0)
        cmap = tb.build_cmap([(1, 0, body)])
        with pytest.raises(CorruptedFont, match="no usable"):
            self._font_with_cmap(cmap)

    def test_format6_raster_parity_with_format4(self):
        # same glyphs exposed through format 6 and format 4 must raster
        # identically end-to-end
        f6 = self._font_with_cmap(
            tb.build_cmap([(1, 0, tb.build_cmap_format6(65, [1, 2]))])
        )
        f4 = self._font_with_cmap(
            tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 66, -64, None)]))])
        )
        g6, aw6 = f6.get_glyph("B")
        g4, aw4 = f4.get_glyph("B")
        assert aw6 == aw4
        assert g6.num_segments == g4.num_segments
        np.testing.assert_array_equal(
            g6.contours[0].points, g4.contours[0].points
        )


class TestHmtx:
    def test_runout_advances(self):
        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4([(65, 66, -64, None)]))])
        blob = tb.build_font(
            [b"", square_glyph(), square_glyph()],
            cmap,
            metrics=[(500, 0), (777, 0)],  # fewer metrics than glyphs
        )
        font = Font(blob)
        assert list(font.advance_widths) == [500, 777, 777]


class TestRealFonts:
    def test_dejavu_loads(self, dejavu):
        assert dejavu.info.units_per_em == 2048
        assert dejavu.num_glyphs > 5000

    def test_all_ascii_glyphs_load(self, dejavu):
        for code in range(32, 127):
            g, aw = dejavu.get_glyph(code)
            assert aw > 0
            for c in g.contours:
                assert len(c.points) % 2 == 1
                np.testing.assert_array_equal(c.points[0], c.points[-1])

    def test_serif_loads(self, dejavu_serif):
        g, _ = dejavu_serif.get_glyph("B")
        assert g.num_segments > 0


MPL_FONTS = "/opt/venv/lib/python3.12/site-packages/matplotlib/mpl-data/fonts/ttf"


class TestFontZoo:
    """Real-font sweep: formats, units, and raster sanity across the
    matplotlib font bundle (format-4 cmaps, 1000-upem fonts, computer
    modern)."""

    def test_format4_font_loads_and_rasters(self):
        import glob

        from fontrx.font.font import Font
        from fontrx.font.ttf import CmapFormat4
        from fontrx.kernels import oracle
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments

        font = Font.open(f"{MPL_FONTS}/STIXNonUni.ttf")
        assert isinstance(font.cmap_subtable, CmapFormat4)
        # raster a mapped glyph
        code = None
        for r in font.charmap.ranges:
            if r.end_glyph:
                code = r.end_char - 1
                break
        assert code is not None
        g = font.load_glyph_safe(font.glyph_index(code))
        if g.num_segments:
            grid = RasterGrid.for_glyph_box(
                (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                48, font.info.units_per_em,
            )
            oracle.winding_map(glyph_segments(g), grid)

    def test_cm_and_stix_ascii_kernel_parity(self):
        """Kernel == oracle on fonts with non-2048 upem."""
        import jax.numpy as jnp

        from fontrx.font.font import Font
        from fontrx.kernels import oracle
        from fontrx.kernels.grid import RasterGrid
        from fontrx.kernels.winding import winding_grid
        from fontrx.pack.segments import glyph_segments

        for name in ("cmr10.ttf", "STIXGeneral.ttf"):
            font = Font.open(f"{MPL_FONTS}/{name}")
            for ch in "Ag8":
                idx = font.glyph_index(ch)
                if idx == 0:
                    continue
                g = font.load_glyph_safe(idx)
                if not g.num_segments:
                    continue
                segs = glyph_segments(g)
                grid = RasterGrid.for_glyph_box(
                    (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
                    64, font.info.units_per_em,
                )
                np.testing.assert_array_equal(
                    np.asarray(winding_grid(segs, grid)),
                    oracle.winding_map(segs, grid),
                    err_msg=f"{name}:{ch}",
                )

    def test_all_mpl_fonts_parse(self):
        import glob

        from fontrx.font.font import Font

        ok = 0
        for p in glob.glob(f"{MPL_FONTS}/*.ttf"):
            Font.open(p)  # should never raise on this bundle
            ok += 1
        assert ok > 20


class TestParserHardening:
    """Corrupt-input edges flagged in review: degrade or raise typed
    errors instead of crashing / silently mis-mapping."""

    def test_kern_zero_pairs_degrades(self):
        import struct

        # kern v0, 1 subtable: format 0, horizontal, nPairs == 0
        data = (
            struct.pack(">HH", 0, 1)
            + struct.pack(">HHH", 0, 14, 0x0001)
            + struct.pack(">HHHH", 0, 0, 0, 0)
        )
        kt = ttf.KernTable.parse(BigEndianReader(data))
        assert kt is not None
        out = kt.lookup(np.array([3, 5]), np.array([7, 9]))
        np.testing.assert_array_equal(out, [0, 0])

    def test_cmap4_negative_range_offset_rejected(self):
        import struct

        # 2 segments; segment 0's idRangeOffset=2 makes the
        # glyphIndexArray base negative (i + ro/2 - seg = 0 + 1 - 2)
        seg = 2
        body = (
            struct.pack(">HHH", 0, 0, seg * 2)   # length, language, segX2
            + struct.pack(">HHH", 0, 0, 0)       # search/entry/rangeShift
            + struct.pack(">HH", 0x42, 0xFFFF)   # endCode
            + struct.pack(">H", 0)               # reservedPad
            + struct.pack(">HH", 0x41, 0xFFFF)   # startCode
            + struct.pack(">HH", 0, 1)           # idDelta
            + struct.pack(">HH", 2, 0)           # idRangeOffset (bogus)
        )
        with pytest.raises(CorruptedFont, match="idRangeOffset"):
            ttf.CmapFormat4.parse(BigEndianReader(body))

    def test_cmap4_valid_range_offset_still_parses(self):
        # the builder emits correct in-bounds offsets; must still parse
        sub = tb.build_cmap_format4([(65, 66, 0, [1, 2])])
        cm = ttf.CmapFormat4.parse(BigEndianReader(sub, 2))
        assert cm.glyph_index(65) == 1
        assert cm.glyph_index(66) == 2


class TestCmapFormat14:
    """Unicode Variation Sequences (beyond the reference, which stubs
    format 14 at ttf.zig:349-360)."""

    VS15, VS16 = 0xFE0E, 0xFE0F

    def _font(self):
        # base map: 'A'(65)->1, 'B'(66)->2; VS16 on 'A' -> glyph 2
        # (non-default); VS15 on 'A' -> default glyph (default range)
        f4 = tb.build_cmap_format4([(65, 66, -64, None)])
        f14 = tb.build_cmap_format14([
            (self.VS15, [(65, 0)], []),
            (self.VS16, [], [(65, 2)]),
        ])
        cmap = tb.build_cmap([(3, 1, f4), (0, 5, f14)])
        glyphs = [b"", square_glyph(), square_glyph(200)]
        return Font(tb.build_font(glyphs, cmap))

    def test_parse_and_lookup(self):
        font = self._font()
        assert font.uvs is not None
        # non-default sequence: explicit variant glyph
        assert font.glyph_index_variant("A", self.VS16) == 2
        # default sequence: the regular cmap glyph
        assert font.glyph_index_variant("A", self.VS15) == 1
        # sequence not in the table: base glyph fallback
        assert font.glyph_index_variant("B", self.VS16) == 2
        assert font.glyph_index_variant("A", 0xFE00) == 1

    def test_layout_applies_selector(self):
        from fontrx.scene.layout import layout_text

        font = self._font()
        base = layout_text(font, "AB")
        seq = layout_text(font, "A" + chr(self.VS16) + "B")
        # the selector occupies no slot and modifies the preceding glyph
        assert len(seq.instances) == len(base.instances) == 2
        a_var = seq.instances[0]
        assert seq.batch.boxes[a_var.glyph_slot][2] == 200  # glyph 2 box
        # dangling selector is ignored
        dangling = layout_text(font, chr(self.VS16) + "A")
        assert len(dangling.instances) == 1

    def test_font_without_uvs(self):
        font = Font(minimal_font())
        assert font.uvs is None
        assert font.glyph_index_variant("A", self.VS16) == font.glyph_index("A")


class TestTTC:
    """TrueType Collections (beyond the reference: its scaler check
    rejects 'ttcf' outright, ttf.zig offset-subtable validation)."""

    def _collection(self):
        f1 = minimal_font(units_per_em=1000)
        f2 = minimal_font(units_per_em=2048)
        return tb.build_ttc([f1, f2])

    def test_members_parse_independently(self):
        data = self._collection()
        a = Font(data, index=0)
        b = Font(data, index=1)
        assert a.num_collection_fonts == 2
        assert a.info.units_per_em == 1000
        assert b.info.units_per_em == 2048
        # glyphs load identically from both members
        ga = a.load_glyph(1)
        gb = b.load_glyph(1)
        np.testing.assert_array_equal(
            ga.contours[0].points, gb.contours[0].points
        )

    def test_default_index_and_range(self):
        data = self._collection()
        assert Font(data).info.units_per_em == 1000
        with pytest.raises(CorruptedFont, match="out of range"):
            Font(data, index=2)

    def test_index_on_plain_ttf_rejected(self):
        with pytest.raises(CorruptedFont, match="non-TTC"):
            Font(minimal_font(), index=1)

    def test_truncated_ttc_rejected(self):
        data = self._collection()[:8]
        with pytest.raises(Exception):
            Font(data)


class TestTtcWithCffMembers:
    def test_collection_of_otf_members_parses(self):
        """TTC containers may hold OpenType-CFF members; the scaler
        check accepts OTTO and outlines come from the CFF frontend."""
        import os

        import tests.ttf_builder as tb
        from fontrx.font.font import Font

        otf = ("/opt/venv/lib/python3.12/site-packages/pygame/tests/"
               "fixtures/fonts/PyGameMono.otf")
        if not os.path.exists(otf):
            import pytest

            pytest.skip("pygame CFF fixture unavailable")
        blob = open(otf, "rb").read()
        ttc = tb.build_ttc([blob, blob])
        f0 = Font(ttc, index=0)
        f1 = Font(ttc, index=1)
        assert f0.num_collection_fonts == 2
        g = f0.load_glyph(1)
        assert g.num_segments > 0
        assert f1.load_glyph(1).box == g.box


class TestKernFormats:
    """Legacy kern coverage beyond the common case: AAT headers,
    format-2 class matrices, multi-subtable accumulation."""

    @staticmethod
    def _fmt0_sub(pairs):
        import struct

        body = struct.pack(">HHHH", len(pairs), 0, 0, 0)
        for left, right, v in sorted(pairs):
            body += struct.pack(">HHh", left, right, v)
        return struct.pack(">HHH", 0, 6 + len(body), 0x0001) + body

    def test_two_format0_subtables_accumulate(self):
        import struct

        data = (struct.pack(">HH", 0, 2)
                + self._fmt0_sub([(4, 5, -80), (4, 6, 30)])
                + self._fmt0_sub([(4, 5, -20), (7, 8, 10)]))
        kt = ttf.KernTable.parse(BigEndianReader(data))
        out = kt.lookup(np.array([4, 4, 7, 9]), np.array([5, 6, 8, 9]))
        np.testing.assert_array_equal(out, [-100, 30, 10, 0])

    def test_aat_header_format0(self):
        import struct

        sub = self._fmt0_sub([(2, 3, -55)])
        # AAT subtable: u32 length, u16 coverage (fmt low byte,
        # horizontal = bit15 CLEAR), u16 tupleIndex
        body = sub[6:]
        aat_sub = struct.pack(">IHH", 8 + len(body), 0x0000, 0) + body
        data = struct.pack(">HHI", 1, 0, 1) + aat_sub
        kt = ttf.KernTable.parse(BigEndianReader(data))
        assert kt is not None
        out = kt.lookup(np.array([2, 3]), np.array([3, 2]))
        np.testing.assert_array_equal(out, [-55, 0])

    def test_aat_vertical_subtable_skipped(self):
        import struct

        body = self._fmt0_sub([(2, 3, -55)])[6:]
        aat_sub = struct.pack(">IHH", 8 + len(body), 0x8000, 0) + body
        data = struct.pack(">HHI", 1, 0, 1) + aat_sub
        assert ttf.KernTable.parse(BigEndianReader(data)) is None

    @staticmethod
    def _fmt2_sub(left_glyphs, right_glyphs, matrix):
        """Build a format-2 subtable: matrix[i][j] kerns
        (left_glyphs[i+1], right_glyphs[j+1]); row/col 0 are the
        zero classes."""
        import struct

        n_rows = len(matrix)          # includes class-0 row
        n_cols = len(matrix[0])
        row_width = n_cols * 2
        header = 6 + 8                # subtable header + fmt2 header
        left_off = header
        left_len = 4 + 2 * len(left_glyphs)
        right_off = left_off + left_len
        right_len = 4 + 2 * len(right_glyphs)
        array_off = right_off + right_len
        # left class values: array offset + row index * row_width
        left_tab = struct.pack(">HH", min(left_glyphs), len(left_glyphs))
        for i, _ in enumerate(left_glyphs):
            left_tab += struct.pack(">H", array_off + (i + 1) * row_width)
        right_tab = struct.pack(">HH", min(right_glyphs),
                                len(right_glyphs))
        for j, _ in enumerate(right_glyphs):
            right_tab += struct.pack(">H", (j + 1) * 2)
        arr = b"".join(
            struct.pack(">h", v) for row in matrix for v in row)
        length = array_off + len(arr)
        return (struct.pack(">HHH", 0, length, 0x0201)
                + struct.pack(">HHHH", row_width, left_off, right_off,
                              array_off)
                + left_tab + right_tab + arr)

    def test_format2_class_matrix(self):
        import struct

        # left glyphs 10,11 -> classes 1,2; right glyphs 20,21 ->
        # classes 1,2; matrix rows include the zero class
        matrix = [
            [0, 0, 0],
            [0, -40, 15],
            [0, 7, -90],
        ]
        data = struct.pack(">HH", 0, 1) + self._fmt2_sub(
            [10, 11], [20, 21], matrix)
        kt = ttf.KernTable.parse(BigEndianReader(data))
        assert kt is not None and len(kt.matrices) == 1
        out = kt.lookup(np.array([10, 10, 11, 11, 10, 99]),
                        np.array([20, 21, 20, 21, 99, 20]))
        np.testing.assert_array_equal(out, [-40, 15, 7, -90, 0, 0])

    def test_format2_plus_format0_accumulate(self):
        import struct

        matrix = [[0, 0], [0, -40]]
        data = (struct.pack(">HH", 0, 2)
                + self._fmt0_sub([(10, 20, -10)])
                + self._fmt2_sub([10], [20], matrix))
        kt = ttf.KernTable.parse(BigEndianReader(data))
        out = kt.lookup(np.array([10]), np.array([20]))
        np.testing.assert_array_equal(out, [-50])

    def test_format2_truncated_degrades(self):
        import struct

        sub = self._fmt2_sub([10], [20], [[0, 0], [0, -40]])
        data = struct.pack(">HH", 0, 1) + sub[:20]  # cut mid-header
        kt = ttf.KernTable.parse(BigEndianReader(data))
        # degrade to no kerning rather than crash
        assert kt is None or not kt.matrices or int(kt.lookup(
            np.array([10]), np.array([20]))[0]) in (0, -40)


class TestNameTable:
    """`Font.names` / family/style — decoded name records, differential
    vs fontTools across the system fonts."""

    @pytest.mark.parametrize("path", [
        "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        "/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf",
        "/usr/share/fonts/truetype/dejavu/DejaVuSansMono.ttf",
    ])
    def test_matches_fonttools(self, path):
        from fontTools.ttLib import TTFont

        from fontrx.font.font import Font

        f = Font.open(path)
        ft = TTFont(path)
        for nid in (1, 2, 4, 6):
            expect = ft["name"].getDebugName(nid)
            if expect is not None:
                assert f.names.get(nid) == expect, (path, nid)
        assert f.family_name == ft["name"].getDebugName(1)

    def test_absent_table_is_empty(self):
        from tests import ttf_builder as tb

        from fontrx.font.font import Font

        cmap = tb.build_cmap([(3, 1, tb.build_cmap_format4(
            [(65, 65, 1 - 65, None)]))])
        tri = tb.build_simple_glyph(
            [[(0, 0, True), (50, 100, False), (100, 0, True)]],
            box=(0, 0, 100, 100))
        f = Font(tb.build_font([b"", tri], cmap))
        assert f.names == {}
        assert f.family_name == ""
