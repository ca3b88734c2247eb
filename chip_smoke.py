"""GPU smoke test: fontrx's atlas, coverage, SDF, editor and CLI paths
on one card, each checked against an unculled evaluation of the same
float program (every row band reads every segment) and the CPU oracle.

Run from the repository root on a machine with one NVIDIA GPU::

    python3 chip_smoke.py

Phases, in one process (the first failure ends the run with a nonzero
exit and no result line):

1. device — JAX must report a GPU; prints its kind, the device count,
   ``nvidia-smi``'s name and power limit, and whether the native
   library is built;
2. atlases — ASCII at 256 px, the whole of DejaVu Sans at 64 px
   (capacity buckets) and 1000 synthetic 288-segment glyphs at 64 px:
   the engine's row-binned route against the unculled route (0
   differing pixels) and every 13th glyph against
   ``oracle.winding_at`` (0 differing pixels);
3. coverage and SDF — 2x2 coverage of ASCII at 64 px against the
   unculled multipass reference (exact); the CJK-regime SDF at 64 px
   against the same code on the CPU device within ``SDF_TOL_PX``;
4. editor — an ``InteractiveSession`` at 1920x1080 (direct mode, 150
   paragraphs, kern + liga + marks, GPOS kern/mark/mkmk): a first
   frame, 4 edits on the dirty-strip band path, zoom and drag frames
   and one MSAA frame, each page equal to the unculled page; sampled
   rows equal to the oracle; each spliced edit frame equal to a fresh
   full render; no compile during the edit frames;
5. CLI — ``-m fill`` and ``-m color`` (COLR v1 fixture) write
   decodable QOI files.

Compile seconds and ``memory_analysis()`` print as information.  The
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

FONT = str(ROOT / "data" / "fonts" / "DejaVuSans.ttf")
COLRV1 = str(ROOT / "tests" / "data" / "colrv1test.ttf")
ASCII = [c for c in range(33, 127)]
# SDF distances: the GPU's f32 divide and sqrt are not correctly
# rounded (the Newton solve uses both), so distances may differ from the
# CPU's in the last bits; 1/256 px is far below the 8-bit atlas step
# (spread / 127 = 0.063 px at the default 8 px spread)
SDF_TOL_PX = 1.0 / 256.0


T0 = time.perf_counter()


def log(*args):
    print(f"[{time.perf_counter() - T0:7.1f} s]", *args, flush=True)


def check_equal(what, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    bad = int(np.count_nonzero(got != want))
    log(f"  {what}: {bad} of {got.size} pixels differ")
    if bad:
        raise AssertionError(f"{what}: {bad} pixels differ")


def timed(label, fn):
    t0 = time.perf_counter()
    out = fn()
    jax_block(out)
    log(f"  {label}: {time.perf_counter() - t0:.3f} s (first call: "
        "compile included)")
    return out


def jax_block(x):
    import jax

    jax.tree_util.tree_map(
        lambda a: a.block_until_ready() if hasattr(a, "block_until_ready")
        else a, x)


def memory_note(label, fn, *args, **kw):
    """Print the compiled memory analysis of one jitted call."""
    mem = fn.lower(*args, **kw).compile().memory_analysis()
    if mem is not None:
        log(f"  {label} memory: args {mem.argument_size_in_bytes} B, "
            f"out {mem.output_size_in_bytes} B, "
            f"temp {mem.temp_size_in_bytes} B")


# -- phase 1 ------------------------------------------------------------


def device_phase():
    import jax

    from fontrx.engine.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {dev.platform!r})")
    log(f"cache: {enable_compilation_cache()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    from fontrx import native

    log(f"device: {dev.device_kind}, count {len(jax.devices())}")
    log(smi)
    log(f"native library built: {native._load() is not None}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# -- phase 2 ------------------------------------------------------------


def oracle_check(what, segments, grids, out, every=13):
    from fontrx.kernels import oracle

    bad = 0
    n = 0
    for i in range(0, len(grids), every):
        xs, ys = grids[i].sample_coords()
        wo = oracle.winding_at(segments[i], xs[None, :], ys[:, None],
                               contract=False)
        bad += int(np.count_nonzero(wo != out[i]))
        n += wo.size
    log(f"  {what} vs oracle: {bad} of {n} sampled pixels differ")
    if bad:
        raise AssertionError(f"{what}: {bad} oracle pixels differ")


def atlas_routes(what, engine, segments, mx, my, scale, size,
                 memory=True):
    import jax

    from fontrx.kernels.winding import bin_glyph_rows, winding_bins_xla

    got = timed(f"{what} binned", lambda: engine.winding_batch(
        segments, mx, my, scale, height=size, width=size))
    # traced inputs cannot bin on the host: every band reads every
    # segment of its glyph
    want = timed(f"{what} unculled", lambda: jax.jit(
        lambda s, x, y: engine.winding_batch(
            s, x, y, scale, height=size, width=size))(segments, mx, my))
    check_equal(f"{what} binned vs unculled", got, want)
    if not memory:
        return np.asarray(got)
    bins = bin_glyph_rows(segments, my, scale, size)
    args = (bins.soa, bins.start, bins.count, mx, my, np.float32(scale),
            np.zeros(2, np.float32))
    kw = dict(n_bands=bins.n_bands, cap=bins.cap, width=size)
    memory_note(f"{what} binned", winding_bins_xla, *args, **kw)
    return np.asarray(got)


def atlas_phase(font, engine, n_cjk=1000, font_glyphs=None):
    from benchmarks.cjk import UPEM, make_batch
    from fontrx.engine.atlas import pack_charset
    from fontrx.kernels.grid import RasterGrid
    from fontrx.pack.segments import pack_glyphs_bucketed

    upem = font.info.units_per_em

    def grids_for(boxes, size):
        return [RasterGrid.fixed_tile(tuple(b), size, upem, size)
                for b in np.asarray(boxes)]

    log("atlas: ASCII, 94 glyphs at 256 px")
    batch = pack_charset(font, ASCII)
    grids = grids_for(batch.boxes, 256)
    mx = np.array([g.min_x for g in grids], np.int32)
    my = np.array([g.max_y for g in grids], np.int32)
    out = atlas_routes("ascii@256", engine, batch.segments, mx, my,
                       grids[0].scale, 256)
    oracle_check("ascii@256", batch.segments, grids, out)

    glyphs = [font.load_glyph_safe(i)
              for i in range(font_glyphs or font.num_glyphs)]
    glyphs = [g for g in glyphs if g.num_segments]
    log(f"atlas: DejaVu Sans, {len(glyphs)} glyphs at 64 px, bucketed")
    segs_all, grids_all, outs = [], [], []
    for k, (batch, _) in enumerate(pack_glyphs_bucketed(glyphs)):
        grids = grids_for(batch.boxes, 64)
        mx = np.array([g.min_x for g in grids], np.int32)
        my = np.array([g.max_y for g in grids], np.int32)
        out = atlas_routes(
            f"font@64 cap {batch.segments.shape[1]} x {len(batch)}",
            engine, batch.segments, mx, my, grids[0].scale, 64,
            memory=k == 0)
        segs_all.extend(batch.segments)
        grids_all.extend(grids)
        outs.extend(out)
    oracle_check("font@64", segs_all, grids_all, outs)

    log(f"atlas: {n_cjk} synthetic 288-segment glyphs at 64 px")
    segs = make_batch(n_cjk, 288)
    scale = float(np.float32(64 / UPEM))
    mx = np.zeros(n_cjk, np.int32)
    my = np.full(n_cjk, 63, np.int32)
    out = atlas_routes("cjk@64", engine, segs, mx, my, scale, 64)
    grids = [RasterGrid(64, 64, 0, 63, scale)] * n_cjk
    oracle_check("cjk@64", segs, grids, out)


# -- phase 3 ------------------------------------------------------------


def coverage_sdf_phase(font, engine, n_cjk=1000):
    import jax
    import jax.numpy as jnp

    from benchmarks.cjk import UPEM, make_batch
    from fontrx.engine.atlas import pack_charset
    from fontrx.kernels.coverage import coverage_batch
    from fontrx.kernels.grid import RasterGrid
    from fontrx.kernels.sdf import sdf_batch

    log("coverage: 2x2 on ASCII at 64 px")
    batch = pack_charset(font, ASCII)
    grids = [RasterGrid.fixed_tile(tuple(b), 64, font.info.units_per_em, 64)
             for b in np.asarray(batch.boxes)]
    args = (batch.segments, np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32), grids[0].scale)
    got = timed("coverage binned", lambda: engine.coverage_batch(
        *args, height=64, width=64, samples=2))
    want = timed("coverage unculled", lambda: coverage_batch(
        *[jnp.asarray(a) for a in args[:3]], jnp.float32(args[3]),
        height=64, width=64, samples=2))
    check_equal("coverage binned vs unculled", got, want)

    log(f"sdf: {n_cjk} synthetic 288-segment glyphs at 64 px")
    segs = make_batch(n_cjk, 288)
    sargs = (segs, np.zeros(n_cjk, np.int32), np.full(n_cjk, 63, np.int32),
             np.float32(64 / UPEM))
    gpu = np.asarray(timed("sdf gpu", lambda: engine.sdf_batch(
        *sargs, height=64, width=64)))
    cpu_dev = jax.devices("cpu")[0]
    cpu = np.asarray(timed("sdf cpu", lambda: sdf_batch(
        *[jax.device_put(a, cpu_dev) for a in sargs], height=64, width=64)))
    err = float(np.max(np.abs(gpu - cpu)))
    log(f"  sdf gpu vs cpu: max |diff| {err:.3g} px (tolerance "
        f"{SDF_TOL_PX:.3g} px), finite {bool(np.isfinite(gpu).all())}")
    if not (err <= SDF_TOL_PX and np.isfinite(gpu).all()):
        raise AssertionError(f"sdf differs by {err} px")


# -- phase 4 ------------------------------------------------------------


class CompileCounter:
    """Counts JAX trace/compile events between ``start`` and ``stop``."""

    def __init__(self):
        import jax

        self.on = False
        self.events = []
        jax.monitoring.register_event_duration_secs_listener(self._hear)

    def _hear(self, name, secs, **kw):
        if self.on and ("compile" in name or "trace" in name):
            self.events.append(name)


def page_oracle_rows(renderer, view, page, rows):
    from fontrx.kernels import oracle

    segs = renderer.page_segments(view)
    ymin = segs[:, :, 1].min(1)
    ymax = segs[:, :, 1].max(1)
    xs = np.arange(renderer.width, dtype=np.float32)
    bad = 0
    for r in rows:
        y = np.float32(renderer.height - 1 - r)
        near = segs[(ymin <= y + 1) & (ymax >= y - 1)]
        w = oracle.winding_at(near, xs, y, contract=False)
        bad += int(np.count_nonzero((w != 0) != (page[r] != 0)))
    log(f"  page vs oracle on {len(rows)} rows: {bad} pixels differ")
    if bad:
        raise AssertionError(f"page rows: {bad} oracle pixels differ")


def unculled_page(renderer, view, msaa=False):
    """The page with every band reading the whole stream: the same
    float program as ``render_direct`` without the per-band ranges."""
    import jax.numpy as jnp

    from fontrx.kernels.coverage import sample_offsets
    from fontrx.kernels.winding import BAND_ROWS, bucket
    from fontrx.scene.page import _direct_page_step

    stream, idx, xs, s_px, _, inst_seg_start, _ = renderer._frame(view)
    n = int(inst_seg_start[-1])
    n_bands = -(-renderer.height // BAND_ROWS)
    offsets = sample_offsets(2) if msaa else np.zeros((1, 2), np.float32)
    return np.asarray(_direct_page_step(
        stream, idx, jnp.asarray(xs), s_px,
        jnp.zeros(n_bands, jnp.int32), jnp.full(n_bands, n, jnp.int32),
        np.int32(renderer.height - 1), jnp.asarray(offsets),
        n_bands=n_bands, cap=bucket(n, 256), page_w=renderer.width,
        out_h=renderer.height, mode="msaa" if msaa else "fill"))


def editor_phase(font, engine, n_para=150, size=(1920, 1080)):
    from benchmarks.harness import editor_session
    from fontrx.scene.page import PageRenderer

    sess = editor_session(font, engine, n_para, size)
    log(f"editor: {len(sess.text)} chars, {size[0]}x{size[1]}, direct mode")

    def plain_page(msaa=False):
        return unculled_page(PageRenderer(
            font, sess.layout, sess.width, sess.height, engine,
        ), sess.view, msaa=msaa)

    page = timed("first frame", sess.frame)
    log(f"  instances {len(sess.layout.instance_arrays()[0])}, "
        f"inked pixels {int(np.count_nonzero(page))}")
    check_equal("first frame vs unculled", page, plain_page())
    page_oracle_rows(sess.renderer, sess.view, page,
                     np.linspace(0, sess.height - 1, 24).astype(int))

    # one edit pair compiles the band variant; the 4 edits after it
    # must not compile
    sess.char_input("x")
    sess.frame()
    sess.backspace()
    sess.frame()
    counter = CompileCounter()
    for i, edit in enumerate(("a", "b", None, "c")):
        counter.on = True
        t0 = time.perf_counter()
        if edit is None:
            sess.backspace()
        else:
            sess.char_input(edit)
        page = sess.frame()
        dt = time.perf_counter() - t0
        counter.on = False
        log(f"  edit {i}: {dt * 1e3:.1f} ms (host layout + band + fetch)")
        fresh = np.asarray(sess.renderer.render_direct(sess.view))
        check_equal(f"edit {i} spliced vs fresh full render", page, fresh)
        check_equal(f"edit {i} vs unculled", page, plain_page())
    log(f"  compile/trace events during edit frames: {len(counter.events)}")
    if counter.events:
        raise AssertionError(f"edit frames compiled: {counter.events}")

    for i, (kind, arg) in enumerate((("scroll", 0.5), ("drag", 0.02),
                                     ("scroll", -1.0), ("drag", -0.03))):
        if kind == "scroll":
            sess.scroll(arg, (0.1, 0.1))
        else:
            sess.drag(arg, arg / 2)
        page = timed(f"{kind} frame {i}", sess.frame)
        check_equal(f"{kind} frame {i} vs unculled", page, plain_page())
    page_oracle_rows(sess.renderer, sess.view, page,
                     np.linspace(3, sess.height - 5, 16).astype(int))

    sess.key("m")
    page = timed("msaa frame", sess.frame)
    check_equal("msaa frame vs unculled", page, plain_page(msaa=True))
    log(f"  msaa levels: {sorted(set(np.unique(page).tolist()))}")


# -- phase 5 ------------------------------------------------------------


def cli_phase():
    from fontrx.cli.main import main
    from fontrx.io.qoi import decode

    with tempfile.TemporaryDirectory() as tmp:
        for args in (["-f", FONT, "-t", "Hello, GPU!", "-m", "fill"],
                     ["-f", COLRV1, "-t", "A", "-m", "color"]):
            out = str(pathlib.Path(tmp) / "out.qoi")
            rc = main(args + ["-s", "48", "-o", out])
            img = decode(pathlib.Path(out).read_bytes())
            log(f"  cli {args[-1]}: exit {rc}, image {img.shape}, "
                f"inked {int(np.count_nonzero(img))}")
            if rc != 0 or img.size == 0 or not img.any():
                raise AssertionError(f"cli {args}: exit {rc}")


def main() -> int:
    device = device_phase()

    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font

    font = Font.open(FONT)
    engine = RasterEngine()
    atlas_phase(font, engine)
    coverage_sdf_phase(font, engine)
    editor_phase(font, engine)
    log("cli")
    cli_phase()
    log("all phases passed")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
