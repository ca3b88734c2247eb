"""fontrx CLI entry point.

The equivalent of the reference's ``src/main.zig``: parse config, open
the font, lay out the text, render, and either write QOI output or run
the interactive session.  Modes cover the BASELINE configs:

- ``fill`` / ``gray``: nonzero-winding raster (config 1)
- ``coverage``: k x k supersampled antialiasing (config 2)
- ``sdf``: signed-distance output (config 4)
- ``triangulation``: triangle-mesh fill, ``--debug`` for the colored
  class visualization (config 3; Ctrl+D analog)
- ``--interactive``: headless zoom/pan session (config 5)
"""

from __future__ import annotations

import sys

import numpy as np

from fontrx.cli.config import Config, ConfigError, HelpRequested, parse_args
from fontrx.utils.log import get_logger

log = get_logger("Main")


def main(argv: list[str] | None = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        cfg = parse_args(argv)
    except HelpRequested as e:
        print(e)
        return 0
    except ConfigError as e:
        for err in e.errors:
            print(f"error: {err}", file=sys.stderr)
        return 2

    if cfg.cache:
        from fontrx.engine.cache import enable_compilation_cache

        enable_compilation_cache()

    from fontrx.engine.raster import RasterEngine
    from fontrx.font.font import Font
    from fontrx.io.qoi import encode_rgb

    if cfg.fallback:
        from fontrx.font.stack import FontStack

        font = FontStack.open(
            [cfg.font_file]
            + [p.strip() for p in cfg.fallback.split(",") if p.strip()]
        )
    else:
        font = Font.open(cfg.font_file)
    if cfg.variation and hasattr(font, "set_variation"):
        font.set_variation(parse_variation_str(cfg.variation))
    if cfg.info:
        print(font_info_text(font))
        return 0
    engine = RasterEngine()
    text = cfg.text if cfg.text is not None else "A"

    if cfg.interactive:
        return _run_interactive(font, text, cfg, engine)

    # single-line render of the text's first glyph per char, written as
    # one page (or per-glyph for sdf/triangulation modes)
    out_img = _render(font, text, cfg, engine)
    if cfg.output:
        with open(cfg.output, "wb") as f:
            f.write(encode_rgb(out_img))
        log.info("wrote %s", cfg.output)
    else:
        _print_ascii(out_img)
    return 0


def font_info_text(font) -> str:
    """Human-readable font inventory for ``--info``: names, tables,
    glyph/coverage counts, variation axes, layout features, and which
    color/AAT families the font carries."""
    lines = []
    fam = getattr(font, "family_name", "")
    sty = getattr(font, "style_name", "")
    if fam or sty:
        lines.append(f"{fam} {sty}".strip())
    names = getattr(font, "names", {})
    if 5 in names:
        lines.append(f"version: {names[5]}")
    info = font.info
    lines.append(
        f"upem {info.units_per_em}, ascent {info.ascent}, "
        f"descent {info.descent}, line gap {info.line_gap}")
    tables = getattr(font, "tables", {})
    if tables:
        lines.append("tables: " + " ".join(
            sorted(t.decode("ascii", "replace").strip()
                   for t in tables)))
        lines.append(f"glyphs: {font.maxp.num_glyphs}")
    cm = getattr(font, "charmap", None)
    if cm is not None and hasattr(cm, "__len__"):
        lines.append(f"cmap ranges: {len(cm)}")
    fvar = getattr(font, "fvar", None)
    if fvar is not None:
        axes = ", ".join(
            f"{a.tag.decode('ascii', 'replace')}"
            f"[{a.min_value:g}..{a.default_value:g}..{a.max_value:g}]"
            for a in fvar.axes)
        lines.append(f"variation axes: {axes}")
    for tag, label in ((b"GSUB", "GSUB features"),
                       (b"GPOS", "GPOS features")):
        if tag not in tables or not hasattr(font, "_at"):
            continue
        try:
            from fontrx.font.shape import parse_layout_header

            hdr = parse_layout_header(font._at(tag), ())
        except Exception:
            hdr = None
        if hdr is not None:
            feats = sorted({fr[0].decode("ascii", "replace")
                            for fr in hdr[4]})
            if feats:
                lines.append(label + ": " + " ".join(feats))
            scripts = sorted(
                s.decode("ascii", "replace") for s in hdr[5])
            if scripts and label.startswith("GSUB"):
                lines.append("scripts: " + " ".join(scripts))
    fams = []
    for attr, label in (("colr", "COLR"), ("cpal", "CPAL"),
                        ("svg", "SVG"), ("sbix", "sbix"),
                        ("cbdt", "CBDT"), ("ebdt", "EBDT"),
                        ("morx", "morx"), ("trak", "trak")):
        if getattr(font, attr, None) is not None:
            fams.append(label)
    if b"kerx" in tables:
        fams.append("kerx")
    if b"kern" in tables:
        fams.append("kern")
    if fams:
        lines.append("families: " + " ".join(fams))
    return "\n".join(lines)


def parse_variation_str(spec: str) -> dict:
    """``"wght=700,wdth=80"`` -> a design-location dict (shared by the
    CLI and :func:`fontrx.render_text`)."""
    loc = {}
    for part in spec.split(","):
        if "=" in part:
            k, v = part.split("=", 1)
            loc[k.strip()] = float(v)
    return loc


def _feature_tags(cfg) -> tuple[bytes, ...] | None:
    """``--features ccmp,dlig`` -> 4-byte OpenType tags (space-padded)."""
    if not cfg.features:
        return None
    return tuple(
        t.strip().encode("ascii")[:4].ljust(4)
        for t in cfg.features.split(",")
        if t.strip()
    ) or None


def _positioning_tags(cfg) -> tuple[bytes, ...] | None:
    """``--positioning kern,cswh`` -> GPOS tags for the full
    positioning engine (``None`` disables the engine)."""
    if cfg.positioning is None:
        return None
    return tuple(
        t.strip().encode("ascii")[:4].ljust(4)
        for t in cfg.positioning.split(",")
        if t.strip()
    )


def _layout_for(font, text, cfg, vertical_ok: bool = False):
    """One layout for any render mode — all CLI layout flags (kern,
    ligatures, marks, features, positioning, wrap, oblique, rtl, and
    vertical where the mode supports it) apply uniformly."""
    from fontrx.scene.layout import layout_text

    wrap_units = (
        cfg.wrap * font.info.units_per_em / cfg.size if cfg.wrap else None
    )
    return layout_text(
        font, text, kern=cfg.kern, ligatures=cfg.ligatures,
        marks=cfg.marks, features=_feature_tags(cfg),
        vertical=cfg.vertical if vertical_ok else False,
        positioning=_positioning_tags(cfg), wrap_width=wrap_units,
        oblique=cfg.oblique, rtl=cfg.rtl, bidi=cfg.bidi,
        alternate=cfg.alternate,
        letter_spacing=cfg.letter_spacing * font.info.units_per_em
        / cfg.size,
        word_spacing=cfg.word_spacing * font.info.units_per_em
        / cfg.size,
        underline=cfg.underline, strikethrough=cfg.strikethrough,
        tracking_ptem=float(cfg.size) if cfg.tracking else None,
        align=cfg.align, kashida=cfg.kashida,
    )


def _sdf_for_layout(layout, font, cfg, engine, spread_px: float):
    """Shared SDF scaffolding for the sdf/smooth/outline modes: fixed
    per-glyph tiles through the engine's SDF atlas."""
    from fontrx.kernels.grid import RasterGrid

    del spread_px  # distances come back unclamped
    grids = [
        RasterGrid.fixed_tile(
            tuple(b), cfg.size, font.info.units_per_em, cfg.size
        )
        for b in np.asarray(layout.batch.boxes)
    ]
    return engine.sdf_batch(
        layout.batch.segments,
        np.array([g.min_x for g in grids], np.int32),
        np.array([g.max_y for g in grids], np.int32),
        grids[0].scale, height=cfg.size, width=cfg.size,
    )


def _render_hinted(font, text, cfg, engine) -> np.ndarray:
    """``--hinting`` render path (fill/gray): every glyph is grid-fitted
    by the TrueType bytecode interpreter at ``ppem == --size``
    (:mod:`fontrx.font.hinting`; the reference panics on instructed
    glyphs, ``src/font/Glyph.zig:85``), positioned on a whole-pixel pen
    with the HINTED advances, and rastered straight from the F26Dot6
    outlines — 64 units = 1 px, so the grid scale is exactly 1/64 and
    the stems the interpreter snapped to the grid land on pixel
    boundaries."""
    import jax.numpy as jnp

    from fontrx.kernels.grid import RasterGrid
    from fontrx.pack.segments import pack_glyphs

    ppem = cfg.size
    # gasp advice: fonts flag per-size whether bilevel grid-fit or
    # antialiasing is intended; warn when the user's mode contradicts
    # the font (render proceeds as asked — explicit flags win)
    behavior = font.gasp_behavior(ppem)
    if cfg.mode == "fill" and (behavior & 0x2) and not (behavior & 0x1):
        log.info(
            "gasp: font asks for antialiasing without grid-fitting at "
            "%d ppem; consider -m gray without --hinting", ppem)
    eng26 = font.hinting_engine(ppem)
    gids = [font.charmap.glyph_index(ord(ch)) for ch in text]
    # --bitmaps: embedded EBDT/EBLC strikes at exactly this ppem
    # substitute for the outline (the FreeType embedded-bitmap rule);
    # their advances come from the strike metrics, already in pixels
    use_bitmaps = getattr(cfg, "bitmaps", False)
    bitmaps = [None] * len(gids)
    glyphs, advs = [], []
    from fontrx.font.glyph import Glyph as _Glyph

    for i, gid in enumerate(gids):
        if use_bitmaps:
            bm = font.embedded_bitmap(gid, ppem)
            if bm is not None:
                bitmaps[i] = bm
                glyphs.append(_Glyph.empty())
                advs.append(int(bm[3]) << 6)
                continue
        g, adv = font.hinted_glyph(gid, ppem)
        glyphs.append(g)
        advs.append(int(adv))
    # pair kerning, scaled then rounded to whole pixels (the classic
    # hinted-text convention: fractional kerns would undo grid fitting)
    kerns = [0] * len(gids)
    if cfg.kern and len(gids) > 1:
        positioner = font.positioner((b"kern",))
        if positioner is not None:
            # full GPOS engine with the hint context: per-ppem device
            # deltas and contour-point anchors resolve against the
            # grid-fitted outlines (fontrx.font.gpos_shape)
            adv_du = [int(font.advance_widths[g]) for g in gids]
            pos = positioner.positions_features(
                gids, adv_du, (b"kern",), hint=font.hint_context(ppem))
            adj_du = np.asarray(pos.x_advance, np.float64) - np.asarray(
                adv_du, np.float64)
            px26 = adj_du * (64.0 * ppem / font.info.units_per_em)
            for i in range(len(gids) - 1):
                kerns[i + 1] = (int(np.floor(px26[i] + 0.5)) + 32) & -64
        else:
            table = font.kerning or font.gpos_kerning
            if table is not None:
                left = np.asarray(gids[:-1], np.uint16)
                right = np.asarray(gids[1:], np.uint16)
                vals = np.asarray(table.lookup(left, right), np.int64)
                for i, v in enumerate(vals):
                    kerns[i + 1] = (eng26.scale(int(v)) + 32) & -64

    # pen positions in F26Dot6 (advances are already grid-rounded by
    # the font's prep/glyph programs when it wants them to be)
    pens, pen = [], 0
    for adv, kern in zip(advs, kerns):
        pen += kern
        pens.append(pen)
        pen += adv

    # page metrics: scaled ascent/descent, whole-pixel margins
    margin = max(ppem // 8, 2)
    ascent_px = (eng26.scale(font.info.ascent) + 63) >> 6
    descent_px = (-eng26.scale(font.info.descent) + 63) >> 6
    width = ((pen + 63) >> 6) + 2 * margin
    height = ascent_px + descent_px + 2 * margin
    base_row = margin + ascent_px

    # one batched raster over fixed tiles sized to the largest hinted
    # box (26.6 units; RasterGrid scale = 1/64 exactly in float32).
    # Grid-fitted outlines land EXACTLY on the integer sample lattice
    # (that is the point of hinting), so sampling at integer pixel
    # positions hits horizontal/vertical edges dead-on and the
    # crossing tie rules paint whole phantom rows.  Shift the outline
    # by (-32, +32) F26Dot6 (half a pixel) so every sample lands at
    # its cell CENTER — the classic hinted-raster convention.
    from fontrx.font.glyph import Contour, Glyph

    shifted = [
        Glyph(g.box, tuple(
            Contour(c.points + np.array([-32, 32], c.points.dtype))
            for c in g.contours))
        for g in glyphs
    ]
    batch = pack_glyphs(shifted, sort="x")
    boxes = np.asarray(batch.boxes)
    tile = 8
    for g in glyphs:
        gr = RasterGrid.for_glyph_box(
            (g.box.x_min, g.box.y_min, g.box.x_max, g.box.y_max), 1, 64)
        tile = max(tile, gr.width, gr.height)
    tile = _round_up_int(tile, 8)
    grids = [
        RasterGrid.fixed_tile(tuple(b), 1, 64, tile) for b in boxes
    ]
    w = np.asarray(engine.winding_batch(
        jnp.asarray(batch.segments),
        jnp.array([g.min_x for g in grids], jnp.int32),
        jnp.array([g.max_y for g in grids], jnp.int32),
        jnp.float32(grids[0].scale),
        height=tile, width=tile,
    ))

    page = np.zeros((height, width), np.uint8)
    for i, (grid, pen26) in enumerate(zip(grids, pens)):
        if bitmaps[i] is not None:
            alpha, bbx, bottom, _adv, _sp = bitmaps[i]
            bh, bw = alpha.shape
            x0 = margin + ((pen26 + 32) >> 6) + bbx
            y0 = base_row - (bottom + bh)
            ys, xs = np.nonzero(alpha)
            vs = alpha[ys, xs]
            ys = ys + y0
            xs = xs + x0
            keep = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
            np.maximum.at(page, (ys[keep], xs[keep]), vs[keep])
            continue
        if not glyphs[i].contours:
            continue
        ink = (w[i] != 0)
        x0 = margin + ((pen26 + 32) >> 6) + grid.min_x
        y0 = base_row - grid.max_y
        ys, xs = np.nonzero(ink)
        ys = ys + y0
        xs = xs + x0
        keep = (ys >= 0) & (ys < height) & (xs >= 0) & (xs < width)
        page[ys[keep], xs[keep]] = 255
    if cfg.mode == "gray":
        page = np.where(page > 0, 255, 100).astype(np.uint8)
    return np.repeat(page[:, :, None], 3, axis=2)


def _round_up_int(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _render(font, text, cfg, engine) -> np.ndarray:
    import jax.numpy as jnp

    from fontrx.kernels.grid import RasterGrid

    hinting = getattr(cfg, "hinting", False)
    bitmaps = getattr(cfg, "bitmaps", False)
    if (hinting or bitmaps) and cfg.mode in ("fill", "gray"):
        return _render_hinted(font, text, cfg, engine)
    if hinting or bitmaps:
        log.warning(
            "--hinting/--bitmaps apply to the fill/gray modes only; "
            "rendering %r unhinted", cfg.mode,
        )

    if cfg.mode in ("fill", "gray"):
        from fontrx.scene.layout import layout_text
        from fontrx.scene.page import PageRenderer
        from fontrx.scene.transform import ViewTransform

        layout = _layout_for(font, text, cfg, vertical_ok=True)
        upem = font.info.units_per_em
        px_per_unit = cfg.size / upem
        margin = max(cfg.size // 8, 4)
        width = int(layout.width * px_per_unit) + 2 * margin
        height = int(layout.height * px_per_unit) + 2 * margin
        pr = PageRenderer(font, layout, width, height, engine)
        # 1 em == cfg.size px; text origin at (margin, bottom margin
        # above the last baseline's descent)
        s = 2.0 * px_per_unit / width
        sy = 2.0 * px_per_unit / height
        ox = -1.0 + 2.0 * margin / width
        if cfg.vertical:
            # vertical layout: content hangs from em y=0 down to
            # -layout.height (no baseline/ascent bookkeeping)
            oy = -1.0 + 2.0 * (margin + layout.height * px_per_unit) / height
        else:
            descent_px = -font.info.descent * px_per_unit
            oy = -1.0 + 2.0 * (margin + descent_px
                               + layout.height * px_per_unit
                               - (font.info.ascent + font.info.line_gap
                                  - font.info.descent) * px_per_unit) / height
        # ViewTransform.apply multiplies y by aspect; pre-divide so the
        # net y scale is sy
        view = ViewTransform(
            (s, sy * height / width), (ox, oy * height / width),
            width / height,
        )
        page = pr.render_direct(view)
        if cfg.mode == "gray":
            page = np.where(page > 0, 255, 100).astype(np.uint8)
        return np.repeat(page[:, :, None], 3, axis=2)

    if cfg.mode == "color":
        # COLR/CPAL layered color glyphs (capability extension — the
        # reference is monochrome end to end): every (unique glyph,
        # layer) coverage rasters in one batched launch, the layer
        # stack folds src-over into premultiplied RGBA tiles, and the
        # tiles composite at the layout's pen positions (kerning,
        # ligatures, marks — every layout flag applies).  Monochrome
        # glyphs render as a single foreground layer.
        from fontrx.engine.colorglyphs import (
            color_glyph_tiles,
            composite_color_page,
        )

        layout = _layout_for(font, text, cfg, vertical_ok=True)
        has_bitmaps = (getattr(font, "sbix", None) is not None
                       or getattr(font, "cbdt", None) is not None)
        has_svg = getattr(font, "svg", None) is not None
        if (font.colr is None or font.cpal is None) \
                and not has_bitmaps and not has_svg:
            log.warning(
                "font has no COLR/CPAL, SVG documents, or bitmap "
                "strikes; color mode renders the monochrome outlines")
        palette = getattr(cfg, "palette", "0")
        if font.cpal is not None:
            try:
                palette = (int(palette) if str(palette).lstrip("-")
                           .isdigit() else font.cpal.select(palette))
            except ValueError:
                log.warning("unknown palette selector %r; using 0",
                            palette)
                palette = 0
            if not 0 <= palette < font.cpal.num_palettes:
                log.warning(
                    "palette %d out of range (%d palettes); using 0",
                    palette, font.cpal.num_palettes)
                palette = 0
        else:
            palette = 0
        tiles, grids = color_glyph_tiles(
            font, [int(g) for g in layout.slot_gids], cfg.size, engine,
            palette=palette, samples=max(cfg.samples, 2),
        )
        upem = font.info.units_per_em
        ppu = cfg.size / upem
        margin = max(cfg.size // 8, 4)
        width = int(layout.width * ppu) + 2 * margin
        height = int(layout.height * ppu) + 2 * margin
        slots, offsets_em = layout.instance_arrays()
        pen = np.empty((len(slots), 2), np.float64)
        pen[:, 0] = margin + offsets_em[:, 0] * ppu
        if cfg.vertical:
            # vertical columns hang from em y = 0 downward (the fill
            # mode's convention): y = 0 at the top margin
            pen[:, 1] = margin - offsets_em[:, 1] * ppu
        else:
            # first baseline sits one ascent below the top margin;
            # em y up -> page y down
            pen[:, 1] = margin + font.info.ascent * ppu \
                - offsets_em[:, 1] * ppu
        return composite_color_page(
            tiles, grids, slots, pen, page_h=height, page_w=width,
        )

    if cfg.mode == "coverage":
        from fontrx.kernels.coverage import coverage_to_gray
        from fontrx.scene.layout import layout_text

        layout = _layout_for(font, text, cfg)
        grids = [
            RasterGrid.fixed_tile(tuple(b), cfg.size, font.info.units_per_em, cfg.size)
            for b in np.asarray(layout.batch.boxes)
        ]
        cov = engine.coverage_batch(
            layout.batch.segments,
            np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32),
            grids[0].scale,
            height=cfg.size,
            width=cfg.size,
            samples=max(cfg.samples, 2),
        )
        sheet = np.concatenate(list(np.asarray(coverage_to_gray(cov))), axis=1)
        return np.repeat(sheet[:, :, None], 3, axis=2)

    if cfg.mode == "smooth":
        # antialiased fill from the distance field: coverage =
        # clamp(d + 0.5 + embolden, 0, 1) — one-pixel soft edges
        # without MSAA, and --embolden E dilates (E>0) or thins (E<0)
        # the outline by E pixels (synthetic bold/light)
        layout = _layout_for(font, text, cfg)
        sdf = _sdf_for_layout(
            layout, font, cfg, engine, abs(cfg.embolden) + 2.0
        )
        cov = jnp.clip(sdf + 0.5 + cfg.embolden, 0.0, 1.0)
        sheet = np.concatenate(
            list(np.asarray(jnp.round(cov * 255).astype(jnp.uint8))), axis=1
        )
        return np.repeat(sheet[:, :, None], 3, axis=2)

    if cfg.mode == "lcd":
        # LCD subpixel antialiasing: per-channel coverage at the RGB
        # stripe centers (R -1/3 px, G 0, B +1/3) — a capability
        # extension (no subpixel rendering in the reference)
        from fontrx.kernels.coverage import coverage_to_gray

        layout = _layout_for(font, text, cfg)
        grids = [
            RasterGrid.fixed_tile(tuple(b), cfg.size, font.info.units_per_em, cfg.size)
            for b in np.asarray(layout.batch.boxes)
        ]
        cov = engine.lcd_coverage_batch(
            layout.batch.segments,
            np.array([g.min_x for g in grids], np.int32),
            np.array([g.max_y for g in grids], np.int32),
            grids[0].scale,
            height=cfg.size, width=cfg.size,
            samples=max(cfg.samples, 2),
        )
        return np.concatenate(
            list(np.asarray(coverage_to_gray(cov))), axis=1
        )

    if cfg.mode == "outline":
        # stroked outlines from the distance field: coverage =
        # clamp(stroke/2 + 0.5 - |d|, 0, 1) — one-pixel antialiased
        # edges on both sides, any stroke width, no new kernel
        layout = _layout_for(font, text, cfg)
        half = max(cfg.stroke / 2.0, 0.5)
        sdf = _sdf_for_layout(layout, font, cfg, engine, half + 1.0)
        cov = jnp.clip(half + 0.5 - jnp.abs(sdf), 0.0, 1.0)
        sheet = np.concatenate(
            list(np.asarray(jnp.round(cov * 255).astype(jnp.uint8))), axis=1
        )
        return np.repeat(sheet[:, :, None], 3, axis=2)

    if cfg.mode == "sdf":
        from fontrx.kernels.sdf import sdf_to_u8

        layout = _layout_for(font, text, cfg)
        sdf = _sdf_for_layout(layout, font, cfg, engine, 8.0)
        sheet = np.concatenate(list(np.asarray(sdf_to_u8(sdf))), axis=1)
        return np.repeat(sheet[:, :, None], 3, axis=2)

    if cfg.mode == "triangulation":
        from fontrx.geometry import TriangulatedGlyph
        from fontrx.kernels.loopblinn import debug_render, loopblinn_fill

        ch = text[0]
        glyph, _ = font.get_glyph(ch)
        grid = RasterGrid.for_glyph_box(
            (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max),
            cfg.size,
            font.info.units_per_em,
        )
        tg = TriangulatedGlyph.from_glyph(glyph)
        if cfg.debug:
            return debug_render(tg, grid)
        if tg.self_intersecting:
            # the triangle mesh would fill the wrong region (the
            # reference's acknowledged failure, README TODO "fix wrong
            # glyph triangulation"); the winding fill handles crossing
            # contours natively via the nonzero rule
            from fontrx.pack.segments import glyph_segments

            log.warning(
                "%r outline self-intersects: triangulation mode falling "
                "back to the winding fill", ch,
            )
            w = engine.winding_glyph(glyph_segments(glyph), grid)
            fill = np.where(np.asarray(w) != 0, 255, 0).astype(np.uint8)
            return np.repeat(fill[:, :, None], 3, axis=2)
        fill = loopblinn_fill(tg, grid)
        return np.repeat(fill[:, :, None], 3, axis=2)

    raise SystemExit(f"unknown mode {cfg.mode!r}")


def _run_interactive(font, text, cfg, engine) -> int:
    """Headless interactive loop: reads events from stdin, one per line:
    ``scroll <amt> [cx cy]`` / ``drag <dx> <dy>`` / ``resize <w> <h>`` /
    ``key <m|d|t>`` / ``type <text>`` / ``back [n]`` / ``frame`` /
    ``stats`` / ``quit``.  Writes frames
    to ``--output`` (numbered) when given."""
    from fontrx.io.qoi import encode_rgb
    from fontrx.scene.interactive import InteractiveSession

    sess = InteractiveSession(
        font, text, 1920, 1080, engine,
        kern=cfg.kern, ligatures=cfg.ligatures,
        marks=cfg.marks,
        features=_feature_tags(cfg),
        positioning=_positioning_tags(cfg),
        rtl=cfg.rtl, bidi=cfg.bidi,
        layout_options={
            "letter_spacing": cfg.letter_spacing
            * font.info.units_per_em / cfg.size,
            "word_spacing": cfg.word_spacing
            * font.info.units_per_em / cfg.size,
            "underline": cfg.underline,
            "strikethrough": cfg.strikethrough,
            "tracking_ptem": (float(cfg.size) if cfg.tracking
                              else None),
            "align": cfg.align,
            "kashida": cfg.kashida,
            "oblique": cfg.oblique,
        })
    if cfg.serve:
        from fontrx.cli.serve import serve

        serve(sess, cfg.serve)
        return 0
    n = 0
    for line in sys.stdin:
        parts = line.split()
        if not parts:
            continue
        cmd, *args = parts
        try:
            n = _dispatch(sess, cfg, cmd, args, n)
        except StopIteration:
            break
        except (ValueError, IndexError) as e:
            print(f"error: bad command {line.strip()!r} ({e})", file=sys.stderr)
    print(sess.stats(), flush=True)
    return 0


def _dispatch(sess, cfg, cmd, args, n) -> int:
    import numpy as np

    from fontrx.io.qoi import encode_rgb

    if cmd == "quit":
        raise StopIteration
    elif cmd == "scroll":
        cur = (float(args[1]), float(args[2])) if len(args) >= 3 else (0.0, 0.0)
        sess.scroll(float(args[0]), cur)
    elif cmd == "drag":
        sess.drag(float(args[0]), float(args[1]))
    elif cmd == "resize":
        sess.resize(int(args[0]), int(args[1]))
    elif cmd == "key":
        sess.key(args[0])
    elif cmd == "type":
        sess.char_input(" ".join(args))
    elif cmd == "back":
        sess.backspace(int(args[0]) if args else 1)
    elif cmd == "frame":
        # display_frame routes through to_rgba so the 't' (transparent
        # background) toggle is observable in the emitted file: RGBA
        # with alpha=coverage when on, opaque RGB otherwise
        rgba = sess.display_frame()
        if cfg.output:
            from fontrx.io.qoi import encode_rgba

            path = cfg.output.replace(".qoi", f"_{n:04d}.qoi")
            with open(path, "wb") as f:
                f.write(
                    encode_rgba(rgba) if sess.transparent
                    else encode_rgb(rgba[:, :, :3])
                )
        n += 1
    elif cmd == "stats":
        print(sess.stats(), flush=True)
    else:
        raise ValueError(f"unknown command {cmd!r}")
    return n


def _print_ascii(img: np.ndarray, max_w: int = 100) -> None:
    g = img[:, :, 0]
    step = max(1, g.shape[1] // max_w)
    for row in g[:: 2 * step]:
        print("".join("#" if v > 64 else "." for v in row[::step]))


if __name__ == "__main__":
    raise SystemExit(main())
