"""Aux-subsystem tests: artifact cache, fallible glyph loading, metrics,
RGBA output, debug helpers (SURVEY §5)."""

import numpy as np
import pytest


class TestArtifactCache:
    def test_roundtrip_and_hit(self, dejavu, tmp_path):
        from fontrx.engine.artifacts import ArtifactCache, cached_atlas
        from fontrx.engine.raster import RasterEngine

        cache = ArtifactCache(str(tmp_path))
        s1, l1 = cached_atlas(dejavu, "ABC", 48, 64,
                              RasterEngine(), cache)
        assert cache.stats()["entries"] == 1
        s2, l2 = cached_atlas(dejavu, "ABC", 48, 64,
                              RasterEngine(), cache)
        np.testing.assert_array_equal(s1, s2)
        assert (l1.cols, l1.rows) == (l2.cols, l2.rows)

    def test_key_sensitivity(self, dejavu):
        from fontrx.engine.artifacts import ArtifactCache

        data = dejavu._reader.data
        k1 = ArtifactCache.key(data, [65], 64, "fill", tile=64)
        assert k1 == ArtifactCache.key(data, [65], 64, "fill", tile=64)
        assert k1 != ArtifactCache.key(data, [66], 64, "fill", tile=64)
        assert k1 != ArtifactCache.key(data, [65], 65, "fill", tile=64)
        assert k1 != ArtifactCache.key(data, [65], 64, "sdf", tile=64)

    def test_corrupt_entry_degrades_to_miss(self, tmp_path):
        from fontrx.engine.artifacts import ArtifactCache

        cache = ArtifactCache(str(tmp_path))
        cache.put("deadbeef", x=np.arange(3))
        (tmp_path / "deadbeef.npz").write_bytes(b"garbage")
        assert cache.get("deadbeef") is None


class TestSafeLoading:
    def test_bad_glyph_masks_empty(self, dejavu):
        # out-of-range index raises in strict mode, masks in safe mode
        from fontrx.utils.reader import CorruptedFont

        with pytest.raises(CorruptedFont):
            dejavu.load_glyph(10**6)
        g = dejavu.load_glyph_safe(10**6)
        assert g.contours == ()


class TestMetrics:
    def test_counters(self):
        import time

        from fontrx.utils.metrics import RasterMetrics

        m = RasterMetrics()
        with m.step(glyphs=10, pixels=1000):
            time.sleep(0.01)
        assert m.glyphs_per_s > 0
        assert m.mpix_per_s > 0
        s = m.summary()
        assert s["steps"] == 1


class TestRGBA:
    def test_transparent_mode(self):
        from fontrx.scene.page import PageRenderer

        page = np.array([[0, 255], [128, 0]], np.uint8)
        opaque = PageRenderer.to_rgba(page, transparent=False)
        assert (opaque[..., 3] == 255).all()
        transparent = PageRenderer.to_rgba(page, transparent=True)
        np.testing.assert_array_equal(transparent[..., 3], page)
        np.testing.assert_array_equal(transparent[..., 0], page)


class TestDebugHelpers:
    def test_diff_report(self):
        from fontrx.utils.debug import diff_report

        a = np.zeros((4, 4), np.int32)
        b = a.copy()
        assert diff_report(a, b)["mismatched"] == 0
        b[1, 2] = 5
        r = diff_report(a, b)
        assert r["mismatched"] == 1 and r["first"] == (1, 2)

    def test_assert_finite(self):
        from fontrx.utils.debug import assert_finite

        assert_finite(np.ones(3))
        with pytest.raises(FloatingPointError):
            assert_finite(np.array([1.0, np.nan]))

    def test_checked_wrapper(self):
        import jax.numpy as jnp

        from fontrx.utils.debug import checked

        fn = checked(lambda x: jnp.log(x))
        fn(jnp.array([1.0, 2.0]))  # fine
        with pytest.raises(Exception):
            fn(jnp.array([-1.0]))  # nan -> checkify error

    def test_engine_padded_grid_matches_oracle(self, dejavu):
        """A grid padded past the glyph box (extra rows and columns
        that sample empty space) rasters oracle-exact."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments
        from fontrx.kernels import oracle

        g, _ = dejavu.get_glyph("T")
        seg = glyph_segments(g)
        grid = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 32, 2048
        ).padded(8, 128)
        out = RasterEngine().winding_glyph(seg, grid)
        np.testing.assert_array_equal(
            np.asarray(out), oracle.winding_map(seg, grid)
        )


class TestBucketedPacking:
    def test_buckets_and_mapping(self, dejavu):
        from fontrx.pack.segments import pack_glyphs_bucketed

        # mix of simple and complex glyphs -> multiple buckets
        chars = "Il.@%&WM#"
        glyphs = [dejavu.get_glyph(c)[0] for c in chars]
        sizes = (16, 32, 64)
        buckets = pack_glyphs_bucketed(
            glyphs, range(len(glyphs)), sizes, min_occupancy=1
        )
        assert len(buckets) >= 2
        seen = set()
        for batch, idxs in buckets:
            assert batch.capacity in sizes
            for row, orig in enumerate(idxs):
                assert batch.seg_counts[row] == glyphs[orig].num_segments
                assert batch.seg_counts[row] <= batch.capacity
                assert batch.advance_widths[row] == orig
                seen.add(orig)
        assert seen == set(range(len(glyphs)))

    def test_tail_buckets_merge_upward(self, dejavu):
        from fontrx.pack.segments import pack_glyphs_bucketed

        # 9 simple + 1 complex glyph: with min_occupancy=8 the
        # 1-glyph large bucket can't merge down, but any small bucket
        # UNDER it must not exist below occupancy unless it's the only
        # populated one; here the simple bucket (9 >= 8) survives and
        # nothing folds into an empty bucket
        chars = "IIIIlllli@"
        glyphs = [dejavu.get_glyph(c)[0] for c in chars]
        buckets = pack_glyphs_bucketed(glyphs, range(10), (16, 32, 64, 128))
        caps = sorted(b.capacity for b, _ in buckets)
        # every glyph accounted for exactly once
        seen = sorted(i for _, idxs in buckets for i in idxs)
        assert seen == list(range(10))
        # a tiny bucket below a populated larger one folds upward:
        # force it by demanding occupancy 100
        merged = pack_glyphs_bucketed(
            glyphs, range(10), (16, 32, 64, 128), min_occupancy=100
        )
        assert len(merged) == 1
        assert merged[0][0].capacity == max(caps)
        assert sorted(merged[0][1]) == list(range(10))
        # merging never targets an EMPTY larger bucket: all-simple set
        # stays in its small bucket even with a huge occupancy demand
        solo = pack_glyphs_bucketed(
            glyphs[:4], range(4), (16, 32, 64, 128), min_occupancy=100
        )
        assert len(solo) == 1
        assert solo[0][0].capacity <= 32

    def test_split_raster_matches_flat_bitexact(self, dejavu):
        """Winding additivity: a glyph split across small-capacity rows
        and segment-summed must equal the whole-glyph raster EXACTLY
        (integer crossing contributions commute)."""
        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import pack_glyphs, pack_glyphs_split

        chars = "I@%&WMm gQ"
        glyphs = [dejavu.get_glyph(c)[0] for c in chars]
        eng = RasterEngine()
        whole, _ = eng.winding_packed(pack_glyphs(glyphs), 64, 2048, 64)
        split = pack_glyphs_split(glyphs, capacity=16)
        assert len(split) > len(glyphs)  # actually split something
        summed, grids = eng.winding_split(split, 64, 2048, 64)
        np.testing.assert_array_equal(np.asarray(summed), np.asarray(whole))
        assert len(grids) == len(glyphs)

    def test_split_empty_glyph_gets_a_row(self, dejavu):
        from fontrx.font.glyph import Glyph
        from fontrx.pack.segments import pack_glyphs_split

        split = pack_glyphs_split([Glyph.empty(), dejavu.get_glyph("I")[0]])
        assert split.num_glyphs == 2
        assert (split.row_owner == np.array([0, 1])).all()

    def test_bucketed_raster_matches_flat(self, dejavu):
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import pack_glyphs, pack_glyphs_bucketed

        chars = "Io@"
        glyphs = [dejavu.get_glyph(c)[0] for c in chars]
        eng = RasterEngine()
        flat = pack_glyphs(glyphs)
        w_flat, grids = eng.winding_packed(flat, 64, 2048, 64)
        w_flat = np.asarray(w_flat)
        for batch, idxs in pack_glyphs_bucketed(glyphs):
            w_b, _ = eng.winding_packed(batch, 64, 2048, 64)
            for row, orig in enumerate(idxs):
                np.testing.assert_array_equal(
                    np.asarray(w_b)[row], w_flat[orig]
                )


class TestPipelinedFrames:
    def test_frames_in_flight(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "pq", 256, 128, RasterEngine(),
            mode="direct", pipeline=True,
        )
        f0 = sess.frame()          # returns frame 0 (nothing in flight)
        sess.scroll(2.0, (0.0, 0.0))
        f1 = sess.frame()          # returns frame 0 again (lag 1)
        np.testing.assert_array_equal(f0, f1)
        f2 = sess.frame()          # now the zoomed frame arrives
        assert not np.array_equal(f1, f2)


class TestPNG:
    def test_roundtrip_shapes(self, rng):
        import io
        import struct
        import zlib

        from fontrx.io.png import encode

        for shape in ((5, 7), (5, 7, 3), (5, 7, 4)):
            img = rng.integers(0, 256, shape).astype(np.uint8)
            data = encode(img)
            assert data[:8] == b"\x89PNG\r\n\x1a\n"
            # parse IHDR + IDAT back out and verify pixel payload
            w, h = struct.unpack(">II", data[16:24])
            assert (w, h) == (7, 5)
            idat_start = data.index(b"IDAT") + 4
            (idat_len,) = struct.unpack(">I", data[idat_start - 8:idat_start - 4])
            raw = zlib.decompress(data[idat_start:idat_start + idat_len])
            ch = 1 if img.ndim == 2 else img.shape[2]
            rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 7 * ch)
            assert (rows[:, 0] == 0).all()  # filter None
            np.testing.assert_array_equal(
                rows[:, 1:].reshape(img.shape), img
            )


class TestWebSocketViewer:
    """The /ws push channel: RFC 6455 handshake + framing, one binary
    PNG frame pushed after the handshake and after every applied
    event."""

    def test_codec_roundtrip(self):
        import io

        from fontrx.cli.serve import ws_accept_key, ws_read_frame, ws_send_frame

        # the RFC 6455 §1.3 worked example
        assert ws_accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
            "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
        buf = io.BytesIO()
        ws_send_frame(buf, b"x" * 200, opcode=2)   # 126-length path
        buf.seek(0)
        op, payload = ws_read_frame(buf)
        assert op == 2 and payload == b"x" * 200
        # masked client frame decodes
        masked = bytes([0x81, 0x80 | 3, 1, 2, 3, 4,
                        ord("a") ^ 1, ord("b") ^ 2, ord("c") ^ 3])
        op, payload = ws_read_frame(io.BytesIO(masked))
        assert op == 1 and payload == b"abc"

    def test_push_channel(self, dejavu):
        import json
        import socket
        import struct
        import threading
        from http.server import ThreadingHTTPServer

        from fontrx.cli.serve import make_handler
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "Hi", 128, 96, RasterEngine()
        )
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(sess))
        httpd.daemon_threads = True
        port = httpd.server_port
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            s = socket.create_connection(("127.0.0.1", port), timeout=20)
            s.sendall(
                b"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                b"Connection: Upgrade\r\nSec-WebSocket-Key: "
                b"dGhlIHNhbXBsZSBub25jZQ==\r\nSec-WebSocket-Version: 13"
                b"\r\n\r\n"
            )
            f = s.makefile("rb")
            status = f.readline()
            assert b"101" in status
            while f.readline() not in (b"\r\n", b""):
                pass

            def read_frame():
                hdr = f.read(2)
                op = hdr[0] & 0x0F
                n = hdr[1] & 0x7F
                if n == 126:
                    n = struct.unpack(">H", f.read(2))[0]
                elif n == 127:
                    n = struct.unpack(">Q", f.read(8))[0]
                return op, f.read(n)

            def send_text(obj):
                payload = json.dumps(obj).encode()
                mask = b"\x07\x03\x05\x01"
                body = bytes(
                    b ^ mask[i % 4] for i, b in enumerate(payload)
                )
                assert len(payload) < 126
                s.sendall(bytes([0x81, 0x80 | len(payload)]) + mask + body)

            op, frame0 = read_frame()     # initial push
            assert op == 2 and frame0[:8] == b"\x89PNG\r\n\x1a\n"
            send_text({"scroll": 2.0, "cx": 0.0, "cy": 0.0})
            op, frame1 = read_frame()     # event-triggered push
            assert op == 2 and frame1 != frame0
            send_text({"op": "stats"})
            op, stats = read_frame()
            assert op == 1 and json.loads(stats)["frames"] >= 2
            # clean close handshake
            s.sendall(bytes([0x88, 0x80]) + b"\x00" * 4)
            op, _ = read_frame()
            assert op == 8
            s.close()
        finally:
            httpd.shutdown()


class TestLiveViewer:
    def test_http_surface(self, dejavu):
        import json
        import threading
        import urllib.request
        from http.server import HTTPServer

        from fontrx.cli.serve import make_handler
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "Hi", 128, 96, RasterEngine()
        )
        httpd = HTTPServer(("127.0.0.1", 0), make_handler(sess))
        port = httpd.server_port
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            def get(path):
                with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{path}"
                ) as r:
                    return r.status, r.read()

            status, body = get("/")
            assert status == 200 and b"onwheel" in body
            status, frame0 = get("/frame?n=0")
            assert status == 200 and frame0[:8] == b"\x89PNG\r\n\x1a\n"
            # zoom event -> frame changes
            status, _ = get("/ev?scroll=2.0&cx=0&cy=0")
            _, frame1 = get("/frame?n=1")
            assert frame1 != frame0
            # transparent toggle reaches the PNG (RGBA color type 6)
            get("/ev?key=t")
            _, frame2 = get("/frame?n=2")
            assert frame2[25] == 6  # IHDR color type byte
            _, stats = get("/stats")
            assert json.loads(stats)["frames"] >= 3
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestYSortPacking:
    """Raster packing y-sorts segments (a pure perf property: tighter
    chunk y-culls + higher group-elision hit rate, measured +15% on the
    headline batch).  Correctness contract: winding is an
    order-independent integer sum, so rasters must be BIT-identical
    under any segment order."""

    def test_ysort_is_permutation(self, dejavu):
        from fontrx.pack.segments import glyph_segments, ysort_segments

        g, _ = dejavu.get_glyph("B")
        seg = glyph_segments(g)
        srt = ysort_segments(seg)
        assert srt.shape == seg.shape
        # same multiset of segments
        a = np.sort(seg.reshape(len(seg), -1), axis=0)
        b = np.sort(srt.reshape(len(srt), -1), axis=0)
        np.testing.assert_array_equal(a, b)
        # and actually y-ordered
        ymid = srt[:, :, 1].min(axis=1) + srt[:, :, 1].max(axis=1)
        assert (np.diff(ymid) >= 0).all()

    def test_ysort_bitexact(self, dejavu):
        """Sorted vs contour-order segment arrays raster identically."""
        import jax.numpy as jnp

        from fontrx.engine.raster import RasterEngine
        from fontrx.kernels.grid import RasterGrid
        from fontrx.pack.segments import glyph_segments, pack_glyph

        for ch in "BgQ@":
            g, _ = dejavu.get_glyph(ch)
            packed = pack_glyph(g)  # y-sorted
            plain = np.zeros_like(packed.segments)
            seg = glyph_segments(g)  # contour order
            plain[: len(seg)] = seg
            grid = RasterGrid.for_glyph_box(
                packed.box, 64, dejavu.info.units_per_em
            )
            eng = RasterEngine()
            a = eng.winding_glyph(packed.segments, grid)
            b = eng.winding_glyph(plain, grid)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_pack_glyphs_sorted(self, dejavu):
        from fontrx.pack.segments import pack_glyphs

        g, _ = dejavu.get_glyph("B")
        batch = pack_glyphs([g])
        n = int(batch.seg_counts[0])
        seg = batch.segments[0, :n]
        ymid = seg[:, :, 1].min(axis=1) + seg[:, :, 1].max(axis=1)
        assert (np.diff(ymid) >= 0).all()


class TestHybridPacking:
    """Hybrid split packing: single-row glyphs unfolded, multi-row
    glyphs folded by dense per-row-count reshape sums — must be
    bit-identical to the flat per-glyph raster."""

    def test_matches_flat_bitexact(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.pack.segments import pack_glyphs, pack_glyphs_hybrid

        # mix: mostly small glyphs + '@' (and 'B') to force multi-row
        chars = list("Hello@Big, Wrld!#&")
        glyphs = [dejavu.get_glyph(c)[0] for c in chars]
        eng = RasterEngine()
        hb = pack_glyphs_hybrid(glyphs, capacity=16)
        assert any(r > 1 for r, _ in hb.groups)  # the point of the test
        out, grids = eng.winding_hybrid(hb, 48, dejavu.info.units_per_em, 48)
        out = np.asarray(out)
        # flat reference, glyph by glyph
        flat = pack_glyphs(glyphs)
        ref, ref_grids = eng.winding_packed(
            flat, 48, dejavu.info.units_per_em, 48
        )
        ref = np.asarray(ref)
        for slot, gi in enumerate(np.asarray(hb.order)):
            np.testing.assert_array_equal(out[slot], ref[gi], err_msg=chars[gi])
            assert grids[slot].min_x == ref_grids[gi].min_x
            assert grids[slot].max_y == ref_grids[gi].max_y

    def test_group_structure(self, dejavu):
        from fontrx.pack.segments import pack_glyphs_hybrid

        glyphs = [dejavu.get_glyph(c)[0] for c in "il@"]
        hb = pack_glyphs_hybrid(glyphs, capacity=16)
        rs = [r for r, _ in hb.groups]
        assert rs == sorted(rs)  # group-major ascending
        assert sum(r * n for r, n in hb.groups) == len(hb)
        assert hb.num_glyphs == 3
        # every original glyph appears exactly once in order
        assert sorted(np.asarray(hb.order).tolist()) == [0, 1, 2]

    def test_empty_glyph_single_row(self, dejavu):
        from fontrx.pack.segments import pack_glyphs_hybrid

        space = dejavu.get_glyph(" ")[0]
        hb = pack_glyphs_hybrid([space], capacity=16)
        assert hb.groups == ((1, 1),)


class TestViewerAxisUI:
    """Round-3 viewer polish: axis sliders (absolute set_axis backed by
    fvar) + mode cycling + the /ui descriptor endpoint."""

    def _vf(self):
        import os

        from fontrx.font.font import Font

        return Font.open(os.path.join(
            os.path.dirname(__file__), "data", "vartest.ttf"))

    def test_axes_info_and_set_axis(self):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            self._vf(), "AB", 128, 96, RasterEngine())
        (ax,) = sess.axes_info()
        assert ax["tag"] == "wght" and ax["value"] == ax["default"]
        sess.set_axis("wght", 700.0)
        assert sess.axes_info()[0]["value"] == 700.0
        sess.set_axis("wght", 99999.0)   # clamps to axis max
        assert sess.axes_info()[0]["value"] == 900.0
        sess.set_axis("nope", 5.0)       # unknown tag: no-op

    def test_static_font_has_no_axes(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "A", 128, 96, RasterEngine())
        assert sess.axes_info() == []
        sess.set_axis("wght", 700)  # no-op, no crash

    def test_cycle_mode_key(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            dejavu, "A", 128, 96, RasterEngine())
        assert sess.mode == "direct"
        sess.key("c")
        assert sess.mode == "composite"
        sess.frame()  # renders in the new mode
        sess.key("c")
        assert sess.mode == "direct"

    def test_ui_endpoint(self):
        import json
        import threading
        import urllib.request
        from http.server import ThreadingHTTPServer

        from fontrx.cli.serve import make_handler
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        sess = InteractiveSession(
            self._vf(), "A", 96, 64, RasterEngine())
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(sess))
        httpd.daemon_threads = True
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_port}/ui", timeout=20
            ) as r:
                d = json.loads(r.read())
            assert d["mode"] == "direct"
            assert d["axes"][0]["tag"] == "wght"
            # slider event applies through the shared /ev surface
            with urllib.request.urlopen(
                f"http://127.0.0.1:{httpd.server_port}"
                "/ev?axis=wght&value=500", timeout=20
            ) as r:
                r.read()
            assert sess.axes_info()[0]["value"] == 500.0
        finally:
            httpd.shutdown()
            httpd.server_close()


class TestRenderTextApi:
    """`fontrx.render_text` — the one-call library surface."""

    def test_fill_render(self):
        import fontrx

        img = fontrx.render_text(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            "Hi", size=48, kern=True)
        assert img.ndim == 3 and img.shape[2] == 3
        assert img.dtype.name == "uint8"
        assert (img != img.flat[0]).any()  # something rendered

    def test_bytes_and_font_inputs(self):
        import fontrx
        from fontrx.font.font import Font

        path = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
        with open(path, "rb") as f:
            data = f.read()
        a = fontrx.render_text(data, "x", size=32)
        b = fontrx.render_text(Font(data), "x", size=32)
        import numpy as np

        np.testing.assert_array_equal(a, b)

    def test_variation_option(self):
        import fontrx
        import numpy as np

        a = fontrx.render_text("tests/data/vartest.ttf", "A", size=48)
        b = fontrx.render_text("tests/data/vartest.ttf", "A", size=48,
                               variation="wght=700")
        assert a.shape != b.shape or (np.asarray(a) != np.asarray(b)).any()

    def test_unknown_option_raises(self):
        import fontrx
        import pytest

        with pytest.raises(TypeError, match="unknown render options"):
            fontrx.render_text(
                "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                "x", sizee=10)

    def test_color_mode(self):
        import fontrx

        img = fontrx.render_text("tests/data/svgtest.ttf", "IK",
                                 size=64, mode="color")
        assert img.shape[2] == 3


class TestInfoCli:
    def test_info_lists_inventory(self, capsys):
        from fontrx.cli.main import main

        rc = main(["-f",
                   "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
                   "--info"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "DejaVu Sans" in out
        assert "GSUB features:" in out and "liga" in out
        assert "GPOS features:" in out and "kern" in out
        assert "glyphs: 6253" in out

    def test_info_shows_axes_and_families(self, capsys):
        from fontrx.cli.main import main

        main(["-f", "tests/data/vartest.ttf", "--info"])
        out = capsys.readouterr().out
        assert "wght[100..100..900]" in out
        main(["-f", "tests/data/svgtest.ttf", "--info"])
        out = capsys.readouterr().out
        assert "COLR" in out and "SVG" in out
