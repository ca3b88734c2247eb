"""Variable-font tests (`fontrx/font/variations.py`) — fvar axis
normalization, avar remapping, gvar tuple-variation deltas with IUP and
phantom-point advances, on fixtures built with fontTools varLib
(tests/data/vartest*.ttf; vartest2 adds an avar map and a composite
glyph).  The definitive check is a raster differential against
fontTools' varLib.instancer at several design locations."""

import io
import os

import numpy as np
import pytest

from fontrx.font.font import Font
from fontrx.kernels import oracle
from fontrx.kernels.grid import RasterGrid
from fontrx.pack.segments import glyph_segments

VF1 = os.path.join(os.path.dirname(__file__), "data", "vartest.ttf")
VF2 = os.path.join(os.path.dirname(__file__), "data", "vartest2.ttf")


def _instancer_font(path, wght):
    from fontTools.ttLib import TTFont
    from fontTools.varLib.instancer import instantiateVariableFont

    inst = instantiateVariableFont(TTFont(path), {"wght": wght})
    buf = io.BytesIO()
    inst.save(buf)
    return Font(buf.getvalue())


def _raster_equal(a, b, size=48):
    box = (
        min(a.box.x_min, b.box.x_min), min(a.box.y_min, b.box.y_min),
        max(a.box.x_max, b.box.x_max), max(a.box.y_max, b.box.y_max),
    )
    grid = RasterGrid.for_glyph_box(box, size, 1000)
    wa = oracle.winding_map(glyph_segments(a), grid)
    wb = oracle.winding_map(glyph_segments(b), grid)
    np.testing.assert_array_equal(wa, wb)


class TestAxes:
    def test_fvar_parse_and_normalize(self):
        f = Font.open(VF1)
        (ax,) = f.fvar.axes
        assert (ax.tag, ax.min_value, ax.default_value, ax.max_value) == (
            b"wght", 100.0, 100.0, 900.0,
        )
        n = f.fvar.normalize({b"wght": 500.0})
        assert n[0] == pytest.approx(0.5)
        assert f.fvar.normalize({b"wght": 50.0})[0] == 0.0   # clamped
        assert f.fvar.normalize({b"wght": 2000.0})[0] == 1.0

    def test_static_font_ignores_variation(self, dejavu):
        dejavu.set_variation(wght=700)  # warns, no-op
        g, _ = dejavu.get_glyph("A")
        assert g.num_segments > 0


class TestInstancerDifferential:
    @pytest.mark.parametrize("wght", [100, 250, 400, 650, 900])
    def test_vf1_rasters_match(self, wght):
        ref = _instancer_font(VF1, wght)
        vf = Font.open(VF1)
        vf.set_variation(wght=wght)
        for ch in "ABO":  # B and O carry IUP-implied deltas
            _raster_equal(
                ref.load_glyph(ref.glyph_index(ch)),
                vf.load_glyph(vf.glyph_index(ch)),
            )

    @pytest.mark.parametrize("wght", [100, 300, 650, 900])
    def test_vf2_avar_and_composite_match(self, wght):
        ref = _instancer_font(VF2, wght)
        vf = Font.open(VF2)
        vf.set_variation(wght=wght)
        for cp in (ord("A"), 0xB4, 0xC1):  # 0xC1 = composite Aacute
            _raster_equal(
                ref.load_glyph(ref.glyph_index(cp)),
                vf.load_glyph(vf.glyph_index(cp)),
            )

    def test_varied_advance_matches_instancer(self):
        for wght in (100, 650, 900):
            ref = _instancer_font(VF1, wght)
            vf = Font.open(VF1)
            vf.set_variation(wght=wght)
            for ch in "ABO":
                gid = vf.glyph_index(ch)
                assert vf.varied_advance(gid) == int(
                    ref.advance_widths[ref.glyph_index(ch)]
                )


class TestLayoutIntegration:
    def test_layout_uses_varied_advances(self):
        from fontrx.scene.layout import layout_text

        vf = Font.open(VF1)
        vf.set_variation(wght=900)
        heavy = layout_text(vf, "AA")
        vf2 = Font.open(VF1)
        light = layout_text(vf2, "AA")
        # this fixture keeps hmtx advances constant across weights;
        # both must lay out, and the glyph OUTLINES must differ
        assert len(heavy.instances) == len(light.instances) == 2
        assert not np.array_equal(
            heavy.batch.segments, light.batch.segments
        )

    def test_set_variation_invalidates_cache(self):
        vf = Font.open(VF1)
        g1 = vf.load_glyph(vf.glyph_index("A"))
        vf.set_variation(wght=900)
        g2 = vf.load_glyph(vf.glyph_index("A"))
        assert g1.box != g2.box

    def test_default_location_is_identity(self):
        vf = Font.open(VF1)
        base = vf.load_glyph(vf.glyph_index("O"))
        vf.set_variation(wght=100)  # the default: no deltas applied
        same = vf.load_glyph(vf.glyph_index("O"))
        for c1, c2 in zip(base.contours, same.contours):
            np.testing.assert_array_equal(c1.points, c2.points)


class TestVarFuzz:
    def test_gvar_bit_flips_degrade(self, rng):
        import struct

        from fontrx.utils.reader import CorruptedFont

        blob = open(VF1, "rb").read()
        acceptable = (CorruptedFont, NotImplementedError, ValueError,
                      IndexError, KeyError, struct.error, OverflowError)
        for _ in range(120):
            b2 = bytearray(blob)
            pos = int(rng.integers(0, len(b2)))
            b2[pos] ^= 1 << int(rng.integers(0, 8))
            try:
                f = Font(bytes(b2))
                f.set_variation(wght=700)
                for gid in range(min(f.num_glyphs, 4)):
                    f.load_glyph_safe(gid)
            except acceptable:
                pass


class TestNamedInstances:
    def test_instances_parse(self):
        f = Font.open(VF1)
        # varLib writes one instance per axis extreme mapping point;
        # every instance must carry a wght user coordinate in range
        for _name_id, loc in f.fvar.instances:
            assert b"wght" in loc
            assert 100.0 <= loc[b"wght"] <= 900.0


class TestHvar:
    """HVAR advance deltas (ItemVariationStore), preferred over gvar
    phantom points; fixture vartest3 varies advances 400->720."""

    VF3 = os.path.join(os.path.dirname(__file__), "data", "vartest3.ttf")

    @pytest.mark.parametrize("wght", [100, 300, 500, 700, 900])
    def test_advances_match_instancer(self, wght):
        ref = _instancer_font(self.VF3, wght)
        vf = Font.open(self.VF3)
        vf.set_variation(wght=wght)
        assert vf.hvar is not None
        for ch in "AB":
            assert vf.varied_advance(vf.glyph_index(ch)) == int(
                ref.advance_widths[ref.glyph_index(ch)]
            )

    def test_layout_pen_uses_hvar_advances(self):
        from fontrx.scene.layout import layout_text

        vf = Font.open(self.VF3)
        vf.set_variation(wght=900)
        lt = layout_text(vf, "AA")
        assert lt.instances[1].x == 720.0  # varied advance, not 400

    @pytest.mark.parametrize("wght", [250, 800])
    def test_vf3_outlines_still_match(self, wght):
        ref = _instancer_font(self.VF3, wght)
        vf = Font.open(self.VF3)
        vf.set_variation(wght=wght)
        for ch in "AB":
            _raster_equal(
                ref.load_glyph(ref.glyph_index(ch)),
                vf.load_glyph(vf.glyph_index(ch)),
            )


class TestMvar:
    """MVAR font-wide metric deltas (same ItemVariationStore);
    vartest4 varies hhea ascent 760->920, descent -240->-320."""

    VF4 = os.path.join(os.path.dirname(__file__), "data", "vartest4.ttf")

    def test_metric_interpolation(self):
        vf = Font.open(self.VF4)
        assert vf.mvar is not None
        vf.set_variation(wght=500)
        assert vf.varied_metric(b"hasc", vf.info.ascent) == 840
        assert vf.varied_metric(b"hdsc", vf.info.descent) == -280
        vf.set_variation(wght=900)
        assert vf.varied_metric(b"hasc", vf.info.ascent) == 920
        # unmapped tag: identity
        assert vf.varied_metric(b"zzzz", 123) == 123

    def test_layout_line_height_varies(self):
        from fontrx.scene.layout import layout_text

        vf = Font.open(self.VF4)
        a = layout_text(vf, "A\nA")
        vf.set_variation(wght=900)
        b = layout_text(vf, "A\nA")
        gap_a = a.instances[0].y - a.instances[1].y
        gap_b = b.instances[0].y - b.instances[1].y
        assert gap_a == 1000 and gap_b == 1240


class TestCff2:
    """CFF2 (variable CFF): blend/vsindex charstrings over the
    ItemVariationStore; instancer raster differential like the glyf
    path."""

    VFC = os.path.join(
        os.path.dirname(__file__), "data", "vartest_cff2.otf"
    )

    @pytest.mark.parametrize("wght", [100, 300, 500, 700, 900])
    def test_rasters_and_advances_match_instancer(self, wght):
        ref = _instancer_font(self.VFC, wght)
        vf = Font.open(self.VFC)
        vf.set_variation(wght=wght)
        for ch in "AB":
            _raster_equal(
                ref.load_glyph(ref.glyph_index(ch)),
                vf.load_glyph(vf.glyph_index(ch)),
            )
            assert vf.varied_advance(vf.glyph_index(ch)) == int(
                ref.advance_widths[ref.glyph_index(ch)]
            )

    def test_default_instance_needs_no_set_variation(self):
        vf = Font.open(self.VFC)
        g = vf.load_glyph(vf.glyph_index("A"))
        assert (g.box.x_max - g.box.x_min) == 60  # light stem

    def test_cff2_fuzz_degrades(self, rng):
        import struct

        from fontrx.font.cff import Cff2Font
        from fontrx.utils.reader import BigEndianReader, CorruptedFont
        from fontTools.ttLib import TTFont

        blob = bytes(TTFont(self.VFC).reader["CFF2"])
        acceptable = (CorruptedFont, NotImplementedError, ValueError,
                      IndexError, KeyError, struct.error, OverflowError)
        for _ in range(120):
            b2 = bytearray(blob)
            pos = int(rng.integers(0, len(b2)))
            b2[pos] ^= 1 << int(rng.integers(0, 8))
            try:
                cf = Cff2Font.parse(BigEndianReader(bytes(b2), 0))
                for gid in range(cf.num_glyphs):
                    cf.glyph(gid, np.array([0.7]))
            except acceptable:
                pass


class TestNonRepresentableLocations:
    @pytest.mark.parametrize("wght", [433, 617])
    def test_f2dot14_quantization_matches_instancer(self, wght):
        """Locations not representable in F2DOT14 must quantize the
        normalized coordinate like conforming implementations do, or
        scaled deltas drift by an otRound ulp."""
        ref = _instancer_font(VF1, wght)
        vf = Font.open(VF1)
        vf.set_variation(wght=wght)
        for ch in "ABO":
            _raster_equal(
                ref.load_glyph(ref.glyph_index(ch)),
                vf.load_glyph(vf.glyph_index(ch)),
            )


class TestInteractiveVariation:
    def test_bracket_keys_step_weight(self):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        vf = Font.open(VF1)
        s = InteractiveSession(
            vf, "ABO", 192, 128, RasterEngine()
        )
        f0 = s.frame()
        for _ in range(4):
            s.key("]")
        f1 = s.frame()
        assert not np.array_equal(f0, f1)
        for _ in range(8):
            s.key("[")  # clamps at the axis minimum
        f2 = s.frame()
        np.testing.assert_array_equal(f0, f2)

    def test_static_font_ignores_bracket_keys(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        s = InteractiveSession(
            dejavu, "AB", 128, 96, RasterEngine()
        )
        f0 = s.frame()
        s.key("]")
        np.testing.assert_array_equal(s.frame(), f0)


class TestVariationStepRegressions:
    def test_composite_mode_tiles_follow_axis_steps(self):
        """Tile-cache keys include the design location: composite-mode
        frames must change when the weight steps."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        vf = Font.open(VF1)
        s = InteractiveSession(
            vf, "ABO", 192, 128, RasterEngine(),
            mode="composite",
        )
        f0 = s.frame()
        for _ in range(4):
            s.key("]")
        f1 = s.frame()
        assert not np.array_equal(f0, f1)

    def test_step_starts_from_current_location(self):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        vf = Font.open(VF1)
        vf.set_variation(wght=700)
        s = InteractiveSession(
            vf, "A", 128, 96, RasterEngine()
        )
        s.key("]")
        assert vf._var_user[b"wght"] == 800.0  # 700 + range/8


class TestRegionScalars:
    """Differentials for the OpenType per-axis region scalar rules
    (`variations._region_scalar`), fontTools `supportScalar(ot=True)`
    as the oracle — notably the zero-straddling rule: a region with
    start < 0 < end and a nonzero peak ignores that axis."""

    def test_matches_fonttools_supportscalar(self):
        from fontTools.varLib.models import supportScalar

        from fontrx.font.variations import _region_scalar

        regions = [
            (0.0, 0.5, 1.0), (-1.0, -0.5, 0.0), (0.0, 1.0, 1.0),
            (-1.0, 0.5, 1.0),     # zero-straddling: axis ignored
            (-0.5, 0.25, 0.75),   # also straddling
            (0.5, 0.25, 0.75),    # invalid (start > peak): ignored
            (0.0, 0.0, 0.0),      # peak 0: ignored
            (0.25, 0.25, 0.25),   # point region
            (0.25, 0.25, 0.75),   # peak == start
            (0.25, 0.75, 0.75),   # peak == end
        ]
        for lo, p, hi in regions:
            for v in np.linspace(-1.0, 1.0, 17):
                ours = _region_scalar(
                    np.array([v]), [p], [lo], [hi])
                ft = supportScalar(
                    {"a": float(v)}, {"a": (lo, p, hi)}, ot=True)
                assert ours == pytest.approx(ft), (lo, p, hi, v)

    def test_two_axis_product_with_straddling_axis(self):
        from fontTools.varLib.models import supportScalar

        from fontrx.font.variations import _region_scalar

        peaks, starts, ends = [0.5, 0.5], [-1.0, 0.0], [1.0, 1.0]
        for v0 in (-0.5, 0.25, 0.9):
            for v1 in (0.0, 0.25, 0.8):
                ours = _region_scalar(
                    np.array([v0, v1]), peaks, starts, ends)
                ft = supportScalar(
                    {"a": v0, "b": v1},
                    {"a": (-1.0, 0.5, 1.0), "b": (0.0, 0.5, 1.0)},
                    ot=True)
                assert ours == pytest.approx(ft), (v0, v1)

    def test_gvar_straddling_tuple_applies_at_scalar_one(self, tmp_path):
        """A gvar tuple with a zero-straddling intermediate region has
        per-axis scalar 1 at every location (the axis is ignored) — the
        spec renderer algorithm and fontTools' direct rendering
        (``getGlyphSet(location=...)``) agree on this; the instancer
        instead drops such ill-formed tents entirely, so the pin here
        is the exact scalar: the poisoned glyph must equal the clean
        glyph shifted by exactly 1.0x the poison delta."""
        from fontTools.ttLib import TTFont
        from fontTools.ttLib.tables.TupleVariation import TupleVariation

        ft = TTFont(VF1)
        var_a = ft["gvar"].variations["A"]
        npts = len(var_a[0].coordinates)
        var_a.append(TupleVariation(
            {"wght": (-1.0, 0.5, 1.0)},   # start < 0 < end, peak != 0
            [(0, 60)] * npts,
        ))
        buf = io.BytesIO()
        ft.save(buf)
        # wght=300 -> v=0.25 != peak: the pre-rule code scaled by
        # (v-lo)/(p-lo) = 0.833 instead of 1.0
        vf = Font(buf.getvalue())
        vf.set_variation(wght=300)
        clean = Font.open(VF1)
        clean.set_variation(wght=300)
        gp = vf.load_glyph(vf.glyph_index("A"))
        gc = clean.load_glyph(clean.glyph_index("A"))
        for cp, cc in zip(gp.contours, gc.contours, strict=True):
            np.testing.assert_array_equal(
                cp.points, cc.points + np.array([0, 60]))

class TestAvarRequantization:
    def test_avar_coords_on_f2dot14_grid(self):
        """avar output must re-quantize to F2DOT14 (fontTools/FreeType
        parity), not just the pre-avar normalized coordinate."""
        vf = Font.open(VF2)
        vf.set_variation(wght=433)
        c = vf._var_coords
        assert c is not None
        np.testing.assert_array_equal(c * 16384.0,
                                      np.round(c * 16384.0))

    @pytest.mark.parametrize("wght", [433, 617])
    def test_avar_font_matches_instancer(self, wght):
        ref = _instancer_font(VF2, wght)
        vf = Font.open(VF2)
        vf.set_variation(wght=wght)
        for ch in "A":
            _raster_equal(
                ref.load_glyph(ref.glyph_index(ch)),
                vf.load_glyph(vf.glyph_index(ch)),
            )


VF5 = os.path.join(os.path.dirname(__file__), "data", "vartest5.ttf")


class TestVvar:
    """VVAR + vertical phantom points + MVAR vertical tags — the
    variation x vertical matrix (VERDICT r2 item 4).  Oracle:
    fontTools varLib.instancer's recalculated ``vmtx``/``vhea``."""

    @pytest.mark.parametrize("wght", [300, 500, 760, 900])
    def test_vertical_metrics_match_instancer(self, wght):
        from fontTools.ttLib import TTFont
        from fontTools.varLib.instancer import instantiateVariableFont

        inst = instantiateVariableFont(TTFont(VF5), {"wght": wght})
        vf = Font.open(VF5)
        vf.set_variation(wght=wght)
        vhea, ah, tsb = vf.vertical_metrics
        for name in ("A", "B"):
            gid = vf.glyph_index(name)
            got = (
                vf.varied_advance_height(gid, int(ah[gid])),
                vf.varied_tsb(gid, int(tsb[gid])),
            )
            assert got == tuple(inst["vmtx"][name]), (name, wght)
        # MVAR vasc/vdsc flow through varied_metric
        assert vf.varied_metric(b"vasc", vhea.ascent) == \
            inst["vhea"].ascent
        assert vf.varied_metric(b"vdsc", vhea.descent) == \
            inst["vhea"].descent

    def test_vertical_layout_uses_varied_heights(self):
        from fontrx.scene.layout import layout_text

        thin = Font.open(VF5)
        thin.set_variation(wght=100)
        heavy = Font.open(VF5)
        heavy.set_variation(wght=900)
        lt_thin = layout_text(thin, "AA", vertical=True)
        lt_heavy = layout_text(heavy, "AA", vertical=True)
        # second glyph's pen drop = first glyph's advance height
        drop_thin = lt_thin.instances[0].y - lt_thin.instances[1].y
        drop_heavy = lt_heavy.instances[0].y - lt_heavy.instances[1].y
        assert drop_thin == 800.0 and drop_heavy == 1100.0

    def test_default_location_unchanged(self):
        vf = Font.open(VF5)
        _, ah, tsb = vf.vertical_metrics
        gid = vf.glyph_index("A")
        assert vf.varied_advance_height(gid, int(ah[gid])) == int(ah[gid])
        assert vf.varied_tsb(gid, int(tsb[gid])) == int(tsb[gid])


VF6 = os.path.join(os.path.dirname(__file__), "data", "vartest6.ttf")


class TestGposVariations:
    """GPOS VariationIndex device records over the GDEF v1.3
    ItemVariationStore: variable fonts vary their kerning/placement
    with the design location (round 3; previously device offsets were
    dropped).  Fixture: varLib-merged masters with A-V kern
    -40 -> -160."""

    @pytest.mark.parametrize("wght,kern", [
        (100, -40), (300, -70), (500, -100), (760, -139), (900, -160),
    ])
    def test_kern_interpolates(self, wght, kern):
        from fontrx.scene.layout import layout_text

        vf = Font.open(VF6)
        vf.set_variation(wght=wght)
        lt = layout_text(vf, "AV", positioning=(b"kern",))
        assert lt.instances[1].x - lt.instances[0].x == 600 + kern

    def test_matches_instancer_kern(self):
        """The instancer bakes the delta into a static PairPos — the
        independent oracle for the resolved value."""
        from fontTools.ttLib import TTFont
        from fontTools.varLib.instancer import instantiateVariableFont

        inst = instantiateVariableFont(TTFont(VF6), {"wght": 700})
        pair = (inst["GPOS"].table.LookupList.Lookup[0]
                .SubTable[0].PairSet[0].PairValueRecord[0])
        expected = pair.Value1.XAdvance

        vf = Font.open(VF6)
        vf.set_variation(wght=700)
        from fontrx.scene.layout import layout_text

        lt = layout_text(vf, "AV", positioning=(b"kern",))
        assert lt.instances[1].x - lt.instances[0].x == 600 + expected

    def test_default_location_static_value(self):
        from fontrx.scene.layout import layout_text

        vf = Font.open(VF6)   # no set_variation: static -40
        lt = layout_text(vf, "AV", positioning=(b"kern",))
        assert lt.instances[1].x - lt.instances[0].x == 560.0

    def test_static_font_unaffected(self, dejavu):
        from fontrx.scene.layout import layout_text

        a = layout_text(dejavu, "AV", positioning=(b"kern",))
        assert len(a.instances) == 2   # no VariationIndex machinery

    @pytest.mark.parametrize("wght,anchor_y", [
        (100, 500), (500, 620), (900, 740),
    ])
    def test_mark_anchor_interpolates(self, wght, anchor_y):
        """Anchor format 3 with VariationIndex device records: the
        base mark anchor moves with the design location (masters
        y=500 -> 740)."""
        from fontrx.scene.layout import layout_text

        vf = Font.open(VF6)
        vf.set_variation(wght=wght)
        lt = layout_text(vf, "A\u0301", marks=True,
                         positioning=(b"mark",))
        assert len(lt.instances) == 2
        assert lt.instances[1].y == float(anchor_y)
