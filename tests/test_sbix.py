"""sbix bitmap-strike tests (capability extension — the reference
renders outlines only).

Fixture ``sbixtest.ttf``: strikes at 32/64 ppem whose PNG payload is a
quadrant test card (TL red / TR green / BL blue / BR white) built with
fontrx's own PNG encoder; a ``dupe`` redirect and a ``jpg `` graphic
pin the redirect and unsupported-type fallbacks.  The PNG decoder
itself is validated against a libpng-written file exercising all five
filter types.
"""

import numpy as np
import pytest
from struct import error as struct_error

from fontrx.font.font import Font

SBIXTEST = "tests/data/sbixtest.ttf"


@pytest.fixture(scope="module")
def sfont():
    return Font.open(SBIXTEST)


class TestPngDecode:
    def test_roundtrip_all_shapes(self, rng):
        from fontrx.io.png import decode, encode

        for shape in [(7, 5), (8, 8, 3), (9, 4, 4)]:
            img = rng.integers(0, 256, shape).astype(np.uint8)
            out = decode(encode(img))
            assert np.array_equal(np.squeeze(out), np.squeeze(img))

    def test_libpng_differential_all_filters(self, rng, tmp_path):
        """Decode a libpng-encoded PNG (pygame/SDL_image writer, which
        uses adaptive per-row filters 0-4) and compare pixels."""
        import os

        os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
        pygame = pytest.importorskip("pygame")

        from fontrx.io.png import decode

        img = rng.integers(0, 256, (33, 47, 3)).astype(np.uint8)
        surf = pygame.surfarray.make_surface(img.swapaxes(0, 1))
        p = tmp_path / "ft.png"
        pygame.image.save(surf, str(p))
        out = decode(p.read_bytes())
        assert np.array_equal(out[..., :3] if out.ndim == 3 else out,
                              img)

    def test_rejects_non_png(self):
        from fontrx.io.png import decode

        with pytest.raises(ValueError):
            decode(b"definitely not a png")


class TestSbixTable:
    def test_strikes_parse_sorted(self, sfont):
        assert [s.ppem for s in sfont.sbix.strikes] == [32, 64]

    def test_best_strike_selection(self, sfont):
        assert sfont.sbix.best_strike(20).ppem == 32
        assert sfont.sbix.best_strike(32).ppem == 32
        assert sfont.sbix.best_strike(48).ppem == 64
        assert sfont.sbix.best_strike(200).ppem == 64

    def test_bitmap_decodes_with_origin(self, sfont):
        img, ox, oy, ppem = sfont.sbix_bitmap(
            sfont.glyph_index("A"), 64)
        assert img.shape == (64, 64, 4)
        assert (ox, oy, ppem) == (2, -3, 64)
        # quadrants (PNG row 0 = top)
        assert tuple(img[0, 0, :3]) == (255, 0, 0)
        assert tuple(img[0, 63, :3]) == (0, 255, 0)
        assert tuple(img[63, 0, :3]) == (0, 0, 255)

    def test_dupe_redirect(self, sfont):
        a = sfont.sbix_bitmap(sfont.glyph_index("A"), 64)
        b = sfont.sbix_bitmap(sfont.glyph_index("B"), 64)
        np.testing.assert_array_equal(a[0], b[0])

    def test_non_png_graphic_degrades(self, sfont):
        assert sfont.sbix_bitmap(sfont.glyph_index("C"), 64) is None

    def test_missing_glyph_none(self, sfont):
        assert sfont.sbix_bitmap(0, 64) is None        # .notdef empty
        assert sfont.sbix_bitmap(9999, 64) is None


class TestSbixRender:
    def test_color_tiles_use_bitmap(self, sfont):
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        tiles, grids = color_glyph_tiles(
            sfont, [sfont.glyph_index("A")], 48,
            RasterEngine())
        t = np.asarray(tiles[0])
        assert tuple(np.round(t[2, 2, :3]).astype(int)) == (1, 0, 0)
        assert tuple(np.round(t[2, 40, :3]).astype(int)) == (0, 1, 0)
        assert tuple(np.round(t[40, 2, :3]).astype(int)) == (0, 0, 1)
        # origin offsets scale with the strike ratio (2, -3 at 64 ->
        # 48/64 = 0.75)
        assert grids[0].min_x == 2          # round(2 * 0.75) = 2
        assert grids[0].max_y == 45         # round(-3*0.75) + 48 - 1

    def test_jpg_glyph_falls_back_to_outline(self, sfont):
        from fontrx.engine.colorglyphs import color_glyph_tiles
        from fontrx.engine.raster import RasterEngine

        tiles, _ = color_glyph_tiles(
            sfont, [sfont.glyph_index("C")], 48,
            RasterEngine(), foreground=(10, 20, 30, 255))
        t = np.asarray(tiles[0])
        # the 10-unit outline square covers under a pixel at 48px:
        # partial coverage ink, in the foreground color
        assert 0.05 < float(t[..., 3].max()) <= 1.0

    def test_cli_color_mode_sbix(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "s.qoi"
        rc = main(["-f", SBIXTEST, "-t", "AB", "-m", "color",
                   "-s", "48", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        reds = ((img[:, :, 0] == 255) & (img[:, :, 1] == 0)
                & (img[:, :, 2] == 0))
        blues = ((img[:, :, 2] == 255) & (img[:, :, 0] == 0)
                 & (img[:, :, 1] == 0))
        assert reds.sum() > 400 and blues.sum() > 400  # both glyphs


class TestCbdt:
    """CBDT/CBLC (Google-style) bitmap strikes — the handcrafted
    fixture has one 64-ppem strike, index format 1 / image format 17,
    plus an empty-range glyph pinning the no-bitmap fallback."""

    CBDTTEST = "tests/data/cbdttest.ttf"

    @pytest.fixture(scope="class")
    def cfont(self):
        return Font.open(self.CBDTTEST)

    def test_strike_parses(self, cfont):
        assert [(s.ppem, s.bit_depth) for s in cfont.cbdt.strikes] \
            == [(64, 32)]

    def test_small_metrics_and_png(self, cfont):
        img, bx, bottom, ppem = cfont.color_bitmap(
            cfont.glyph_index("A"), 48)
        assert img.shape == (64, 64, 4)
        # smallGlyphMetrics bearingY 60, height 64 -> bottom -4
        assert (bx, bottom, ppem) == (1, -4, 64)
        assert tuple(img[0, 0, :3]) == (255, 0, 0)
        assert tuple(img[63, 63, :3]) == (255, 255, 255)

    def test_second_glyph_distinct(self, cfont):
        img, bx, bottom, ppem = cfont.color_bitmap(
            cfont.glyph_index("B"), 48)
        assert img.shape == (32, 32, 4)
        assert tuple(img[16, 16, :3]) == (255, 0, 255)
        assert (bx, bottom) == (0, 0)

    def test_empty_range_degrades(self, cfont):
        assert cfont.color_bitmap(cfont.glyph_index("C"), 48) is None
        assert cfont.color_bitmap(0, 48) is None

    def test_cli_color_renders_cbdt(self, tmp_path):
        from fontrx.cli.main import main
        from fontrx.io.qoi import decode

        out = tmp_path / "c.qoi"
        rc = main(["-f", self.CBDTTEST, "-t", "AB", "-m", "color",
                   "-s", "48", "-o", str(out)])
        assert rc == 0
        img = decode(out.read_bytes())
        magenta = ((img[:, :, 0] == 255) & (img[:, :, 1] == 0)
                   & (img[:, :, 2] == 255))
        red = ((img[:, :, 0] == 255) & (img[:, :, 1] == 0)
               & (img[:, :, 2] == 0))
        assert red.sum() > 200 and magenta.sum() > 200


class TestBitmapRobustness:
    def test_png_truncation_fuzz(self, rng):
        """Every truncation/corruption of a PNG raises ValueError or
        zlib.error — decode never crashes with an unexpected type."""
        import zlib

        from fontrx.io.png import decode, encode

        img = rng.integers(0, 256, (16, 16, 4)).astype(np.uint8)
        blob = bytearray(encode(img))
        for cut in range(0, len(blob), max(len(blob) // 53, 1)):
            try:
                decode(bytes(blob[:cut]))
            except (ValueError, zlib.error, struct_error):
                pass
        for _ in range(200):
            b = bytearray(blob)
            for _ in range(int(rng.integers(1, 5))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(
                    rng.integers(0, 8))
            try:
                decode(bytes(b))
            except (ValueError, zlib.error, struct_error):
                pass

    def test_cbdt_flip_fuzz(self, rng):
        """Bit-flipped CBDT/CBLC degrade through the typed contract."""
        import struct

        from fontrx.font.ttf import CorruptedFont

        blob0 = open("tests/data/cbdttest.ttf", "rb").read()
        acceptable = (CorruptedFont, ValueError, IndexError, KeyError,
                      struct.error, OverflowError, NotImplementedError)
        for it in range(120):
            b = bytearray(blob0)
            for _ in range(int(rng.integers(1, 6))):
                b[int(rng.integers(0, len(b)))] ^= 1 << int(
                    rng.integers(0, 8))
            try:
                f = Font(bytes(b))
                for gid in range(min(f.num_glyphs, 4)):
                    f.color_bitmap(gid, 48)
            except acceptable:
                pass
