"""Geometry engine tests: triangulation, classification, loop-blinn fill
equivalence with the winding fill."""

import numpy as np
import pytest

from fontrx.geometry.triangulate import (
    ear_clip,
    point_in_polygon,
    signed_area2,
    triangulate_polygon,
)
from fontrx.geometry.triangulated_glyph import TriangulatedGlyph
from fontrx.kernels.grid import RasterGrid


def sq(size=10, rev=False):
    pts = [(0, 0, 0), (size, 0, 1), (size, size, 2), (0, size, 3)]
    return pts[::-1] if rev else pts


class TestPrimitives:
    def test_signed_area(self):
        assert signed_area2(sq()) > 0       # CCW positive
        assert signed_area2(sq(rev=True)) < 0

    def test_point_in_polygon(self):
        poly = sq(10)
        assert point_in_polygon(5, 5, poly)
        assert not point_in_polygon(15, 5, poly)
        assert not point_in_polygon(-1, 5, poly)


def tri_area2(vmap, tri):
    a, b, c = (vmap[i] for i in tri)
    return (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])


class TestTriangulation:
    def total_area(self, verts, tris):
        vmap = {i: (x, y) for x, y, i in verts}
        return sum(abs(tri_area2(vmap, t)) for t in tris)

    def test_square(self):
        tris = triangulate_polygon(sq(10), [])
        assert len(tris) == 2
        assert self.total_area(sq(10), tris) == 2 * 100

    def test_concave_polygon(self):
        # L-shape
        poly = [(0, 0, 0), (20, 0, 1), (20, 10, 2), (10, 10, 3), (10, 20, 4), (0, 20, 5)]
        tris = triangulate_polygon(poly, [])
        assert self.total_area(poly, tris) == 2 * 300

    def test_square_with_hole(self):
        outer = [(0, 0, 0), (30, 0, 1), (30, 30, 2), (0, 30, 3)]
        hole = [(10, 10, 4), (20, 10, 5), (20, 20, 6), (10, 20, 7)]
        tris = triangulate_polygon(outer, [hole])
        verts = outer + hole
        assert self.total_area(verts, tris) == 2 * (900 - 100)

    def test_triangles_emitted_clockwise(self):
        tris = triangulate_polygon(sq(10), [])
        vmap = {i: (x, y) for x, y, i in sq(10)}
        for t in tris:
            assert tri_area2(vmap, t) < 0  # clockwise (reference convention)


class TestTriangulatedGlyph:
    def test_class_counts_and_order(self, dejavu):
        g, _ = dejavu.get_glyph("O")
        tg = TriangulatedGlyph.from_glyph(g)
        # 'O' is all curves: every segment classifies concave or convex
        assert tg.concave_count > 0 and tg.convex_count > 0
        assert tg.solid_count > 0
        assert len(tg.triangles) == tg.concave_count + tg.convex_count + tg.solid_count

    def test_texcoord_convention(self, dejavu):
        g, _ = dejavu.get_glyph("I")
        tg = TriangulatedGlyph.from_glyph(g)
        # controls (odd vertices within each pair) are (0,0); on-curve
        # points alternate (1,0)/(0,1)
        assert set(map(tuple, tg.texcoords)) <= {(0, 0), (1, 0), (0, 1)}

    @pytest.mark.parametrize("ch", list("AOBg8@&WQ%"))
    def test_fill_matches_winding(self, dejavu, ch):
        """Triangulation-equivalent fill == winding fill at tie-free
        sample offsets (exact, all pixels)."""
        import jax.numpy as jnp

        from fontrx.kernels.loopblinn import (
            _pack_triangle_arrays,
            loopblinn_batch,
            pad_triangles,
        )
        from fontrx.kernels.winding import winding_batch
        from fontrx.pack.segments import glyph_segments

        g, _ = dejavu.get_glyph(ch)
        tg = TriangulatedGlyph.from_glyph(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
            64, dejavu.info.units_per_em,
        )
        off = (1 / 3, 1 / 3)
        tris = _pack_triangle_arrays(tg)
        padded, cls = pad_triangles(tris, tg.classes, len(tris))
        args = (
            jnp.array([grid.min_x], jnp.int32),
            jnp.array([grid.max_y], jnp.int32),
            jnp.float32(grid.scale),
        )
        ft = np.asarray(
            loopblinn_batch(
                jnp.asarray(padded)[None], jnp.asarray(cls)[None], *args,
                height=grid.height, width=grid.width, sample_offset=off,
            )
        )[0]
        w = np.asarray(
            winding_batch(
                jnp.asarray(glyph_segments(g))[None], *args,
                height=grid.height, width=grid.width, sample_offset=off,
            )
        )[0]
        np.testing.assert_array_equal(ft, w != 0)

    def test_debug_render_has_three_classes(self, dejavu):
        from fontrx.kernels.loopblinn import debug_render

        g, _ = dejavu.get_glyph("O")
        tg = TriangulatedGlyph.from_glyph(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 48, 2048
        )
        img = debug_render(tg, grid)
        # red, green and blue channels all present somewhere
        assert (img[:, :, 0] > 0).any()
        assert (img[:, :, 1] > 0).any()
        assert (img[:, :, 2] > 0).any()


class TestSelfIntersection:
    """The reference's acknowledged failure (disabled float
    crossing-splitter, ``geometry.zig:74-127``; README TODO "fix wrong
    glyph triangulation"): crossing outlines are exactly *detected* and
    renderers fall back to the winding fill, which handles them natively
    via the nonzero rule — defined behavior, no wrong silent fill."""

    @staticmethod
    def bowtie_glyph():
        from fontrx.font.glyph import Box, Contour, Glyph

        # figure-8: (0,0)->(100,100)->(100,0)->(0,100)->close; straight
        # segments encoded with collinear midpoint controls to satisfy
        # the even/odd invariant
        corners = [(0, 0), (100, 100), (100, 0), (0, 100)]
        pts = []
        for i, c in enumerate(corners):
            nxt = corners[(i + 1) % 4]
            pts.append(c)
            pts.append(((c[0] + nxt[0]) // 2, (c[1] + nxt[1]) // 2))
        pts.append(corners[0])
        return Glyph(
            Box(0, 0, 100, 100),
            (Contour(np.array(pts, np.int32)),),
        )

    def test_bowtie_flagged(self):
        tg = TriangulatedGlyph.from_glyph(self.bowtie_glyph())
        assert tg.self_intersecting

    def test_clean_glyphs_not_flagged(self, dejavu):
        for ch in "AHgo8@":
            g, _ = dejavu.get_glyph(ch)
            assert not TriangulatedGlyph.from_glyph(g).self_intersecting, ch

    def test_strict_crossing_predicate(self):
        from fontrx.geometry.triangulate import _segments_cross_strictly

        a, b = (0, 0, 0), (10, 10, 1)
        c, d = (0, 10, 2), (10, 0, 3)
        assert _segments_cross_strictly(a, b, c, d)          # X cross
        assert not _segments_cross_strictly(a, b, b, c)      # shared end
        assert not _segments_cross_strictly(a, b, (5, 5, 4), (20, 5, 5))  # T-junction
        assert not _segments_cross_strictly(a, b, (2, 2, 4), (8, 8, 5))   # collinear

    def test_cli_falls_back_to_winding(self, tmp_path, monkeypatch):
        """Triangulation mode on a self-intersecting glyph produces the
        exact winding fill (via fallback), not the broken mesh fill."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels import oracle
        from fontrx.kernels.grid import RasterGrid
        from fontrx.kernels.loopblinn import loopblinn_fill
        from fontrx.pack.segments import glyph_segments

        glyph = self.bowtie_glyph()
        grid = RasterGrid.for_glyph_box((0, 0, 100, 100), 50, 100)
        segs = glyph_segments(glyph)
        want = np.where(oracle.winding_map(segs, grid) != 0, 255, 0)

        # the mesh fill IS wrong for the bowtie (this is why we fence):
        tg = TriangulatedGlyph.from_glyph(glyph)
        mesh = loopblinn_fill(tg, grid)
        assert (mesh != want).any()

        # CLI path falls back to the winding fill
        import fontrx.cli.main as cli_main

        class FakeFont:
            class info:
                units_per_em = 100

            def get_glyph(self, ch):
                return glyph, 100

        class Cfg:
            mode = "triangulation"
            debug = False
            size = 50

        out = cli_main._render(FakeFont(), "X", Cfg(), RasterEngine())
        np.testing.assert_array_equal(out[:, :, 0], want)


class TestLoopBlinnBoundaryConvention:
    """The triangle-mesh fill and the winding fill use different tie
    conventions on rows/columns sampled EXACTLY on outline coordinates:
    the winding oracle's half-open root interval (t in [0,1),
    render_glyph.zig:63-68) vs edge-function rasterization's >=0
    inclusion.  Off tie samples the two fills agree; on tie samples the
    difference is confined to the glyph-box boundary.  (Found on
    DejaVuSerif 'A', whose bottom edge lands exactly on a sample row.)
    The reference has the same split — its GPU triangles and its CPU
    oracle never agreed on ties either."""

    def test_serif_A_mismatch_confined_to_boundary_rows(self):
        import numpy as np

        from fontrx.font.font import Font
        from fontrx.kernels import oracle
        from fontrx.kernels.loopblinn import loopblinn_fill
        from fontrx.pack.segments import glyph_segments

        font = Font.open("/usr/share/fonts/truetype/dejavu/DejaVuSerif.ttf")
        g, _ = font.get_glyph("A")
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max),
            64, font.info.units_per_em,
        )
        tg = TriangulatedGlyph.from_glyph(g)
        mesh = loopblinn_fill(tg, grid)
        w = np.where(oracle.winding_map(glyph_segments(g), grid) != 0, 255, 0)
        diff_rows = np.unique(np.nonzero(mesh != w)[0])
        # all disagreement on the first/last sample row (the tie rows)
        assert set(diff_rows.tolist()) <= {0, grid.height - 1}, diff_rows
