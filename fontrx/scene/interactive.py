"""Headless interactive session: zoom/pan/toggle events -> re-rendered
frames.

The headless analog of the reference's GLFW window loop
(``src/VulkanContext.zig:95-213`` + ``src/CallbackContext.zig``): event
flags accumulate between frames (scroll accumulator, drag state, toggle
keys), each ``frame()`` consumes them, updates the view transform, and
re-rasters the page (BASELINE config 5).  There is no display in this
environment, so frames return as arrays (and can stream to QOI files);
the event surface matches the reference's keybinds:

- scroll        -> exponential zoom about the cursor (``Appli.zig:376``)
- drag          -> pan (``Appli.zig:392``)
- ``m``         -> toggle MSAA (Ctrl+M, ``VulkanContext.zig:114-130``)
- ``d``         -> toggle debug render (Ctrl+D)
- ``t``         -> toggle transparent background (Ctrl+T)
- resize        -> aspect-ratio update (``Appli.zig:364-369``)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from fontrx.engine.raster import RasterEngine
from fontrx.font.font import Font
from fontrx.scene.layout import TextLayout
from fontrx.scene.page import GlyphTileCache, PageRenderer
from fontrx.scene.transform import ViewTransform
from fontrx.utils.log import get_logger
from fontrx.utils.timer import PhaseTimer

log = get_logger("Interactive")


@dataclass
class EventState:
    """Accumulated inter-frame events (``CallbackContext.zig:10-17``)."""

    scroll: float = 0.0
    cursor: tuple[float, float] = (0.0, 0.0)  # NDC
    dragging: bool = False
    drag_delta: tuple[float, float] = (0.0, 0.0)
    resized: tuple[int, int] | None = None
    toggle_msaa: bool = False
    toggle_debug: bool = False
    toggle_transparent: bool = False


@dataclass
class InteractiveSession:
    """``mode``: "composite" renders per-glyph tiles + a composite pass
    (glyph tiles cached across pans, like the reference's GPU-resident
    meshes); "direct" rasters the page straight from instance segments
    in one kernel launch (subpixel placement, no recompiles on zoom)."""

    font: Font
    text: str
    width: int = 1920
    height: int = 1080
    engine: RasterEngine = field(default_factory=RasterEngine)
    mode: str = "direct"
    pipeline: bool = False
    msaa: bool = False
    debug: bool = False
    transparent: bool = False
    kern: bool = False
    ligatures: bool = False
    marks: bool = False
    features: tuple[bytes, ...] | None = None
    positioning: tuple[bytes, ...] | None = None
    rtl: bool = False
    bidi: bool = False
    # extra layout_text options (underline=True, letter_spacing=...,
    # align=..., tracking_ptem=..., ...) applied on every re-layout
    layout_options: dict = field(default_factory=dict)

    def __post_init__(self):
        # paragraph-cached incremental layout: edits re-lay only the
        # changed paragraphs (exact merge, bit-identical to a full
        # layout_text — tests/test_incremental.py); the reference
        # re-runs its whole addChar pipeline per char (Appli.zig:318)
        from fontrx.scene.incremental import IncrementalLayoutEngine

        self._layout_engine = IncrementalLayoutEngine(
            self.font, kern=self.kern, ligatures=self.ligatures,
            marks=self.marks, features=self.features,
            positioning=self.positioning, rtl=self.rtl, bidi=self.bidi,
            **self.layout_options)
        self.layout: TextLayout = self._layout_engine.layout(self.text)
        self.view = ViewTransform.init(
            self.font.info.units_per_em, self.width, self.height
        )
        self.events = EventState()
        # glyph-tile LRU shared across re-layouts/resizes: zoom-return
        # and text edits re-raster only never-seen (glyph, zoom) tiles
        self.tile_cache = GlyphTileCache()
        self.renderer = PageRenderer(
            self.font, self.layout, self.width, self.height, self.engine,
            tile_cache=self.tile_cache,
        )
        self.timer = PhaseTimer()
        self.frame_count = 0
        self.frame_ms: list[float] = []
        self.compute_ms: list[float] = []
        # dirty-strip edit cache: the last direct-mode page (device),
        # the view/size state it was rendered under, and the line span
        # edits have dirtied since ("all" = full render needed)
        self._page_dev = None
        self._page_state = None
        self._pending_dirty: object = "all"
        self._dirty_margin = self._layout_margins()
        # prime the dirty-line baseline so the FIRST edit already
        # reports a span (consume compares against the initial layout)
        self._layout_engine.consume_dirty_lines()

    def _layout_margins(self) -> tuple[float, float]:
        boxes = np.asarray(self.layout.batch.boxes)
        if len(boxes) == 0:
            return (0.0, 0.0)
        return (float(boxes[:, 1].min()), float(boxes[:, 3].max()))

    # -- event feeds (the GLFW-callback surface) --------------------------

    def scroll(self, amount: float, cursor_ndc=(0.0, 0.0)):
        self.events.scroll += amount
        self.events.cursor = cursor_ndc

    def drag(self, dx_ndc: float, dy_ndc: float):
        self.events.dragging = True
        d = self.events.drag_delta
        self.events.drag_delta = (d[0] + dx_ndc, d[1] + dy_ndc)

    def resize(self, width: int, height: int):
        self.events.resized = (width, height)

    def key(self, k: str):
        if k == "m":
            self.events.toggle_msaa = True
        elif k == "d":
            self.events.toggle_debug = True
        elif k == "t":
            self.events.toggle_transparent = True
        elif k in ("[", "]"):
            self.step_variation(-1 if k == "[" else 1)
        elif k == "c":
            self.cycle_mode()

    def step_variation(self, direction: int, axis: bytes = b"wght"):
        """Step a variable-font axis live ('[' / ']' keys): moves the
        design location by 1/8 of the axis range, re-layouts, and keeps
        rendering — a beyond-reference demo of fvar/gvar interactivity.
        No-op on static fonts."""
        fv = getattr(self.font, "fvar", None)
        if fv is None:
            return
        ax = next((a for a in fv.axes if a.tag == axis), None)
        if ax is None:
            return
        # start from the font's CURRENT user-space location (set via
        # --variation or earlier steps) so other axes are preserved
        loc = dict(getattr(self.font, "_var_user", {}))
        cur = loc.get(axis, ax.default_value)
        step = (ax.max_value - ax.min_value) / 8.0
        loc[axis] = min(
            max(cur + direction * step, ax.min_value), ax.max_value
        )
        self.font.set_variation(loc)
        self._set_text(self.text)  # re-layout + renderer rebuild

    def axes_info(self) -> list[dict]:
        """Variable-axis descriptors for UI sliders: tag, range,
        default and the CURRENT user-space value.  Empty for static
        fonts."""
        fv = getattr(self.font, "fvar", None)
        if fv is None:
            return []
        loc = dict(getattr(self.font, "_var_user", {}))
        return [
            {
                "tag": a.tag.decode("latin-1"),
                "min": float(a.min_value),
                "default": float(a.default_value),
                "max": float(a.max_value),
                "value": float(loc.get(a.tag, a.default_value)),
            }
            for a in fv.axes
        ]

    def set_axis(self, tag: str, value: float):
        """Set one variable axis to an absolute user-space value
        (viewer slider backend; other axes keep their location).
        No-op on static fonts / unknown tags."""
        fv = getattr(self.font, "fvar", None)
        if fv is None:
            return
        t = tag.encode("latin-1") if isinstance(tag, str) else tag
        ax = next((a for a in fv.axes if a.tag == t), None)
        if ax is None:
            return
        loc = dict(getattr(self.font, "_var_user", {}))
        loc[t] = min(max(float(value), ax.min_value), ax.max_value)
        self.font.set_variation(loc)
        self._set_text(self.text)

    def cycle_mode(self):
        """Cycle the render pipeline live — the viewer's 'c' key /
        mode button.  direct <-> composite; fonts carrying COLR/CPAL
        add a third "color" stop (layered color composite)."""
        order = ["direct", "composite"]
        if self.font.colr is not None and self.font.cpal is not None:
            order.append("color")
        i = order.index(self.mode) if self.mode in order else 0
        self.mode = order[(i + 1) % len(order)]
        self._set_text(self.text)  # rebuild the renderer for the mode

    def char_input(self, text: str):
        """Append typed characters to the scene and re-layout — the
        feature the reference's char callback stubs out with a print
        (``CallbackContext.zig:80-88``, README TODO 'user text input')."""
        self._set_text(self.text + text)

    def backspace(self, n: int = 1):
        """Delete the last ``n`` GRAPHEME CLUSTERS (UAX#29 extended
        clusters via :mod:`fontrx.font.uax29` — one backspace removes
        a whole base+marks stack, Hangul syllable, emoji ZWJ sequence,
        or flag pair, the way editors behave) and re-layout; glyph
        tiles for the remaining text stay warm in the tile cache."""
        if n > 0 and self.text:
            from fontrx.font.uax29 import grapheme_clusters

            # clusters never cross LF (UAX#29 GB4/GB5; CR+LF is one
            # cluster, GB3), so segmenting only the final paragraph
            # keeps backspace O(paragraph), not O(text)
            text = self.text
            while n > 0 and text:
                head, sep, last = text.rpartition("\n")
                if not last:  # trailing newline is its own cluster
                    text = head[:-1] if head.endswith("\r") else head
                    n -= 1
                    continue
                clusters = grapheme_clusters(last)
                take = min(n, len(clusters))
                text = head + sep + "".join(clusters[:-take] if take
                                            < len(clusters) else [])
                n -= take
            self._set_text(text)

    def _set_text(self, text: str):
        self.text = text
        self.layout = self._layout_engine.layout(self.text)
        # accumulate the edit's dirty line span (for the direct-mode
        # strip re-raster); glyph-extent margins union OLD and NEW
        # layouts so overhanging ink from the pre-edit content is
        # covered by the re-rendered band
        d = self._layout_engine.consume_dirty_lines()
        if d is None:
            self._pending_dirty = "all"
        elif d != (0, 0) and self._pending_dirty != "all":
            p = self._pending_dirty
            self._pending_dirty = d if p == () else (
                min(p[0], d[0]), max(p[1], d[1]))
        mn, mx = self._layout_margins()
        self._dirty_margin = (min(self._dirty_margin[0], mn),
                              max(self._dirty_margin[1], mx))
        self.renderer = PageRenderer(
            self.font, self.layout, self.width, self.height, self.engine,
            tile_cache=self.tile_cache,
        )

    # -- frame loop --------------------------------------------------------

    def frame(self) -> np.ndarray:
        """Consume events, update the view, re-raster; returns the page
        (uint8 [H, W]).  Mirrors the order of ``renderingFn``
        (``Appli.zig:148-150``): aspect, zoom, drag."""
        t0 = time.perf_counter()
        ev = self.events
        if ev.resized is not None:
            self.width, self.height = ev.resized
            self.view = self.view.with_aspect(self.width, self.height)
            self.renderer = PageRenderer(
                self.font, self.layout, self.width, self.height, self.engine,
                tile_cache=self.tile_cache,
            )
            ev.resized = None
        if ev.toggle_msaa:
            self.msaa = not self.msaa
            ev.toggle_msaa = False
        if ev.toggle_debug:
            self.debug = not self.debug
            ev.toggle_debug = False
        if ev.toggle_transparent:
            self.transparent = not self.transparent
            ev.toggle_transparent = False
        if ev.scroll != 0.0:
            self.view = self.view.zoomed(ev.scroll, ev.cursor)
            ev.scroll = 0.0
        if ev.drag_delta != (0.0, 0.0):
            self.view = self.view.dragged(*ev.drag_delta)
            ev.drag_delta = (0.0, 0.0)
            ev.dragging = False

        render_kwargs = {"msaa": self.msaa, "debug": self.debug}
        if self.mode == "direct" and self.pipeline:
            # frames-in-flight (the analog of the reference's
            # max_frames_in_flight=2, VulkanContext.zig:48): dispatch
            # frame N, fetch frame N-1 — device compute overlaps the
            # host fetch of the previous frame
            page_dev = self.renderer.render_direct(self.view, **render_kwargs)
            prev = getattr(self, "_inflight", None)
            self._inflight = page_dev
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
            page = np.asarray(prev if prev is not None else page_dev)
        elif self.mode == "direct":
            page_dev = self._render_direct_cached(**render_kwargs)
            float(page_dev[0, 0])  # force device completion
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
            # the host fetch is the display boundary, tracked
            # separately in stats()
            page = np.asarray(page_dev)
        elif self.mode == "color":
            # COLR/CPAL layered composite (uint8 [H, W, 3]); msaa/debug
            # don't apply — layer coverage is already antialiased
            page = self.renderer.render_color(self.view)
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
        else:
            page = self.renderer.render(self.view, **render_kwargs)
            self.compute_ms.append((time.perf_counter() - t0) * 1e3)
        self.frame_count += 1
        dt = (time.perf_counter() - t0) * 1e3
        self.frame_ms.append(dt)
        return page

    _BAND_H = 256  # static dirty-strip height (one compiled variant)

    def _render_direct_cached(self, msaa: bool = False,
                              debug: bool = False):
        """Direct-mode frame with the dirty-strip edit cache: when only
        the text changed (same view/size/toggles), re-raster ONLY the
        256-row band covering the edited paragraphs and splice it into
        the cached page — bit-identical to a full render because page
        winding is row-local (the full render is itself computed in row
        bands).  Any view/zoom/resize/toggle change, a tall dirty span,
        or msaa/debug falls back to the full render."""
        import jax

        view_state = (tuple(self.view.scale), tuple(self.view.offset),
                      self.view.aspect_ratio, self.width, self.height,
                      msaa, debug)
        band = None
        if (self._page_dev is not None
                and self._page_state == view_state
                and not msaa and not debug
                and self._pending_dirty != "all"):
            if self._pending_dirty == ():
                return self._page_dev  # nothing changed at all
            band = self._dirty_band(*self._pending_dirty)
            if band == (0, 0):  # dirty span entirely offscreen
                self._pending_dirty = ()
                self._dirty_margin = self._layout_margins()
                return self._page_dev
        if band is not None:
            y0, bh = band
            strip = self.renderer.render_direct(self.view, band=(y0, bh))
            page_dev = jax.lax.dynamic_update_slice(
                self._page_dev, strip, (np.int32(y0), np.int32(0)))
        else:
            page_dev = self.renderer.render_direct(
                self.view, msaa=msaa, debug=debug)
        self._page_dev = page_dev
        self._page_state = view_state
        self._pending_dirty = ()
        self._dirty_margin = self._layout_margins()
        return page_dev

    def _dirty_band(self, l0: int, l1: int):
        """Map a dirty visual-line span to a page-row band ``(y0,
        _BAND_H)``; ``(0, 0)`` = offscreen (no visible change), ``None``
        = too tall for one band (full render)."""
        lh = float(self._layout_engine._line_height())
        mn, mx = self._dirty_margin
        s1 = self.view.scale[1]
        o1 = self.view.offset[1]
        ar = self.view.aspect_ratio

        def py(em_y: float) -> float:
            return (1.0 - (em_y * s1 + o1) * ar) / 2.0 * self.height

        y_top = int(np.floor(py(-l0 * lh + mx))) - 1
        y_bot = int(np.ceil(py(-(l1 - 1) * lh + mn))) + 1
        if y_bot <= 0 or y_top >= self.height:
            return (0, 0)
        bh = self._BAND_H
        if y_bot - y_top > bh or self.height < bh:
            return None
        return (max(0, min(y_top, self.height - bh)), bh)

    def display_frame(self) -> np.ndarray:
        """One frame as displayable RGBA (uint8 ``[H, W, 4]``): the
        ``t`` toggle becomes observable here — transparent background
        (alpha = coverage, the reference's premultiplied-composite-alpha
        mode, ``VulkanContext.zig:891`` + Ctrl+T) vs. opaque over
        black."""
        page = np.asarray(self.frame())
        return PageRenderer.to_rgba(page, self.transparent)

    def stats(self) -> dict:
        ms = self.frame_ms[1:] or self.frame_ms  # drop compile frame
        cms = self.compute_ms[1:] or self.compute_ms
        return {
            "frames": self.frame_count,
            "mean_ms": float(np.mean(ms)) if ms else 0.0,
            "p99_ms": float(np.percentile(ms, 99)) if ms else 0.0,
            "fps": 1000.0 / float(np.mean(ms)) if ms else 0.0,
            # raster-only time (excludes the page host fetch)
            "compute_ms": float(np.mean(cms)) if cms else 0.0,
            "compute_fps": 1000.0 / float(np.mean(cms)) if cms else 0.0,
            "tile_cache": self.tile_cache.stats(),
        }
