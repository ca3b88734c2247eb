"""Schema-derived CLI config parser.

Behavioral equivalent of the reference's comptime-generated parser
(``src/Config.zig``): option types and required-ness derive from the
dataclass field types (``Optional`` => not required, ``bool`` =>
valueless flag), long ``--name`` / short ``-x`` matching, duplicate
detection, and **error accumulation** — all problems are reported
together instead of stopping at the first (``Config.zig:144-206``).

The reference's four flags are preserved with the same names/shorts
(``-f/--font_file``, ``-t/--text``, ``-c/--cache``, ``-d/--debug``,
``Config.zig:10-13``) plus raster options for the raster engine.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

from fontrx.utils.log import get_logger

log = get_logger("Config")


class ConfigError(ValueError):
    """Accumulated parse errors, one per line."""

    def __init__(self, errors: list[str]):
        super().__init__("\n".join(errors))
        self.errors = errors


class HelpRequested(Exception):
    """Raised by the parser when -h/--help is present."""


def option(short: str | None = None, default=dataclasses.MISSING, help: str = ""):
    """Declare a CLI option on a dataclass field."""
    return field(
        default=default,
        metadata={"short": short, "help": help},
    )


@dataclass
class Config:
    """Runtime configuration (flags mirror ``Config.zig:10-13``)."""

    font_file: str = option("f", help="path to a .ttf font file")
    text: Optional[str] = option("t", default=None, help="text to render")
    cache: bool = option("c", default=False, help="enable the XLA compilation cache")
    debug: bool = option("d", default=False, help="debug render (triangle classes)")
    # raster extensions
    size: int = option("s", default=256, help="font size in pixels")
    samples: int = option(None, default=1, help="MSAA supersample factor k (k*k samples)")
    mode: str = option("m", default="fill", help="fill|gray|coverage|sdf|outline|smooth|lcd|color|triangulation")
    palette: str = option(None, default="0", help="color mode: CPAL palette index, or dark|light (picks the first palette flagged for that background)")
    stroke: float = option(None, default=2.0, help="outline mode: stroke width in pixels")
    oblique: float = option(None, default=0.0, help="synthetic italic slant ratio (e.g. 0.21)")
    rtl: bool = option(None, default=False, help="right-to-left lines (paragraph base direction)")
    bidi: bool = option(None, default=False, help="mixed-direction lines (bidi-lite run itemization; rtl selects the base direction)")
    variation: Optional[str] = option(None, default=None, help="variable-font design location, e.g. wght=700,wdth=80 (fvar/gvar)")
    embolden: float = option(None, default=0.0, help="smooth mode: dilate (+) / thin (-) the outline by this many pixels (synthetic bold)")
    output: Optional[str] = option("o", default=None, help="output .qoi path")
    interactive: bool = option("i", default=False, help="interactive zoom/pan session")
    kern: bool = option("k", default=False, help="apply pair kerning (kern table or GPOS)")
    ligatures: bool = option("l", default=False, help="apply GSUB standard ligatures")
    features: Optional[str] = option(None, default=None, help="comma-separated GSUB feature tags (e.g. ccmp,dlig,smcp) shaped with the full lookup engine")
    alternate: int = option(None, default=0, help="which alternate type-3 (salt/aalt) substitution to pick (default 0)")
    hinting: bool = option(None, default=False, help="grid-fit outlines with the TrueType bytecode interpreter at ppem == --size (fill/gray modes)")
    bitmaps: bool = option(None, default=False, help="use embedded EBDT/EBLC bitmap strikes at ppem == --size (fill/gray; glyphs without a strike render through the hinted pipeline)")
    positioning: Optional[str] = option(None, default=None, help="comma-separated GPOS feature tags (e.g. kern,cswh) applied with the full positioning engine; replaces the flattened -k/marks paths")
    marks: bool = option(None, default=False, help="attach combining marks (GPOS MarkToBase)")
    vertical: bool = option(None, default=False, help="vertical layout: top-to-bottom columns, right-to-left (vhea/vmtx + GSUB vert)")
    wrap: int = option(None, default=0, help="greedy word wrap at this pixel width (0 = no wrap)")
    letter_spacing: float = option(None, default=0.0, help="extra tracking per glyph in pixels (CSS letter-spacing)")
    word_spacing: float = option(None, default=0.0, help="extra advance on space glyphs in pixels (CSS word-spacing)")
    underline: bool = option(None, default=False, help="draw per-line underline bars (post metrics; MVAR-varied)")
    strikethrough: bool = option(None, default=False, help="draw per-line strikeout bars (OS/2 metrics; MVAR-varied)")
    tracking: bool = option(None, default=False, help="apply the font's AAT trak curve at --size points")
    align: str = option(None, default="left", help="left|right|center|justify (justify needs --wrap; applies per wrapped block)")
    kashida: bool = option(None, default=False, help="justify Arabic with tatweel elongation at joined-letter junctions (with --align justify)")
    info: bool = option(None, default=False, help="print font metadata (names, tables, axes, features, coverage) and exit")
    fallback: Optional[str] = option(None, default=None, help="comma-separated fallback font paths: characters the primary font lacks resolve through these in order")
    serve: int = option(None, default=0, help="serve a live browser viewer on this port (with -i)")


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        out[f.name] = f
    return out


def help_text(cls=Config) -> str:
    """Usage text generated from the schema (the reference has no help
    output; its README documents the flags — ``README.md:47-56``)."""
    import dataclasses as _dc

    lines = ["usage: fontrx [options]", "", "options:"]
    for f in _dc.fields(cls):
        short = f.metadata.get("short")
        names = (f"-{short}, " if short else "    ") + f"--{f.name}"
        ftype = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", "")
        is_bool = ftype == "bool" or f.type is bool
        required = (
            f.default is _dc.MISSING and f.default_factory is _dc.MISSING
        )
        val = "" if is_bool else " <value>"
        req = "  (required)" if required else ""
        lines.append(f"  {names}{val:<9} {f.metadata.get('help', '')}{req}")
    return "\n".join(lines)


def parse_args(argv: list[str], cls=Config):
    """Parse ``argv`` (no program name) into ``cls``.

    Mirrors the reference's behavior: ``--long`` and ``-x`` forms, bool
    flags take no value, typed values parse with error accumulation,
    duplicates rejected, missing required options reported at build time
    (``Config.zig:122-134``).
    """
    fields = _fields(cls)
    by_long = {f.name: f for f in fields.values()}
    by_short = {
        f.metadata.get("short"): f
        for f in fields.values()
        if f.metadata.get("short")
    }

    if "-h" in argv or "--help" in argv:
        raise HelpRequested(help_text(cls))

    values: dict[str, object] = {}
    errors: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if arg.startswith("--"):
            f = by_long.get(arg[2:])
        elif arg.startswith("-") and len(arg) == 2:
            f = by_short.get(arg[1])
        else:
            errors.append(f"unexpected positional argument {arg!r}")
            continue
        if f is None:
            errors.append(f"unknown option {arg!r}")
            continue
        if f.name in values:
            errors.append(f"duplicate option {arg!r}")
            continue
        ftype = f.type
        is_bool = ftype in (bool, "bool")
        if is_bool:
            values[f.name] = True
            continue
        if i >= len(argv):
            errors.append(f"option {arg!r} requires a value")
            continue
        raw = argv[i]
        i += 1
        try:
            values[f.name] = _convert(raw, ftype)
        except ValueError:
            errors.append(f"invalid value {raw!r} for option {arg!r}")

    # required = fields without defaults
    for f in fields.values():
        required = (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        )
        if required and f.name not in values:
            errors.append(f"missing required option --{f.name}"
                          + (f" (-{f.metadata['short']})" if f.metadata.get("short") else ""))

    if errors:
        raise ConfigError(errors)
    return cls(**values)


def _convert(raw: str, ftype):
    s = ftype if isinstance(ftype, str) else getattr(ftype, "__name__", "")
    if s == "int" or ftype is int:
        return int(raw)
    if s == "float" or ftype is float:
        return float(raw)
    return raw
