"""TrueType wire-format structures and parsers.

Behavioral equivalent of the reference's ``src/font/ttf.zig`` (966 LoC of
byte-exact ``extern struct`` readers), re-designed for the host side of an
accelerator pipeline: coordinate/flag streams are decoded with NumPy vectorized
ops so that packing thousands of glyphs (CJK atlas configs) stays fast.

Covered, matching the reference's support matrix:
- offset subtable + table directory       (``ttf.zig:102-130``)
- ``head``                                (``ttf.zig:132-214``)
- ``maxp``                                (``ttf.zig:216-246``)
- ``hhea`` + ``hmtx`` long metrics        (``ttf.zig:931-966``)
- ``cmap`` index + encoding-subtable selection (``ttf.zig:263-312``)
- ``cmap`` **format 4** parse/lookup/flatten   (``ttf.zig:387-494``)
- ``cmap`` **format 12** parse/lookup/flatten  (``ttf.zig:590-630``)
- ``cmap`` formats **0/6/13** implemented *beyond* the reference (legacy
  byte table, trimmed table, many-to-one coverage; see ``CmapFormat0/6/13``
  below) — the reference stubs all of 0/2/6/8/10/13/14 with
  ``@compileError`` (``ttf.zig:349-360``); format **14** (Unicode
  Variation Sequences) is also implemented beyond the reference as a
  mapping *supplement* (``CmapFormat14``); round 3 completes the set
  with the legacy formats 2 (high-byte CJK), 8 and 10
- ``glyf`` simple glyphs (RLE flags, short/long deltas) (``ttf.zig:759-817``)
- ``glyf`` compound glyphs (2.14 transforms)            (``ttf.zig:857-921``)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from fontrx.utils.fixed_point import F2D14, FixedPoint
from fontrx.utils.log import get_logger
from fontrx.utils.reader import BigEndianReader, CorruptedFont, ensure_mono_increase

log = get_logger("ttf")

# Required tables for a renderable TrueType font (reference required set,
# ``ttf.zig:94-95``).
REQUIRED_TABLES = (b"cmap", b"head", b"hhea", b"hmtx", b"maxp")
# glyf fonts additionally need loca; CFF ('OTTO') fonts need neither
GLYF_TABLES = (b"glyf", b"loca")


# --------------------------------------------------------------------------
# Table directory
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class OffsetSubtable:
    scaler_type: int
    num_tables: int
    search_range: int
    entry_selector: int
    range_shift: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "OffsetSubtable":
        return cls(*r.unpack("IHHHH"))


@dataclass(frozen=True, slots=True)
class TableEntry:
    tag: bytes
    checksum: int
    offset: int
    length: int


def parse_ttc_header(r: BigEndianReader) -> list[int]:
    """TrueType Collection header: returns the per-font absolute
    offsets of the member offset subtables.  Beyond the reference
    (which rejects anything but a bare TrueType scaler); TTC table
    offsets are file-absolute, so each member parses as a normal
    directory starting at its offset."""
    tag = r.tag()
    if tag != b"ttcf":
        raise CorruptedFont(f"not a TTC header: {tag!r}")
    _version, num_fonts = r.unpack("II")
    if not 0 < num_fonts < 4096:
        raise CorruptedFont(f"implausible TTC font count {num_fonts}")
    return [r.unpack("I")[0] for _ in range(num_fonts)]


def parse_table_directory(r: BigEndianReader) -> dict[bytes, TableEntry]:
    """Parse offset subtable + directory into a tag -> entry map
    (reference keeps a linear array + ``findIndex``; a dict is the
    idiomatic equivalent)."""
    sub = OffsetSubtable.parse(r)
    # 'OTTO' (OpenType-CFF) accepted beyond the reference, which
    # rejects it (``ttf.zig:24-31``); outlines then come from `CFF `
    if sub.scaler_type not in (0x00010000, 0x74727565, 0x4F54544F):
        raise CorruptedFont(f"not a TrueType scaler type: {sub.scaler_type:#x}")
    tables: dict[bytes, TableEntry] = {}
    for _ in range(sub.num_tables):
        tag = r.tag()
        checksum, offset, length = r.unpack("III")
        tables[tag] = TableEntry(tag, checksum, offset, length)
    return tables


# --------------------------------------------------------------------------
# head / maxp / hhea / hmtx
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class Head:
    """``head`` table (fields per ``ttf.zig:132-214``)."""

    flags: int
    units_per_em: int
    x_min: int
    y_min: int
    x_max: int
    y_max: int
    mac_style: int
    lowest_rec_ppem: int
    font_direction_hint: int
    index_to_loc_format: int  # 0 = short (u16*2), 1 = long (u32)
    glyph_data_format: int

    MAGIC = 0x5F0F3CF5

    @property
    def y0_is_baseline(self) -> bool:
        """head.flags bit 0: y value of 0 specifies baseline."""
        return bool(self.flags & 1)

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Head":
        _version, _revision, _checksum_adj, magic = r.unpack("IIII")
        if magic != cls.MAGIC:
            raise CorruptedFont(f"bad head magic {magic:#x}")
        flags, units_per_em = r.unpack("HH")
        r.skip(16)  # created + modified longDateTime
        x_min, y_min, x_max, y_max = r.unpack("hhhh")
        mac_style, lowest_rec_ppem, direction, loca_fmt, glyph_fmt = r.unpack("HHhhh")
        return cls(flags, units_per_em, x_min, y_min, x_max, y_max, mac_style,
                   lowest_rec_ppem, direction, loca_fmt, glyph_fmt)


@dataclass(frozen=True, slots=True)
class Maxp:
    """``maxp`` table (``ttf.zig:216-246``)."""

    num_glyphs: int
    max_points: int
    max_contours: int
    max_component_points: int
    max_component_contours: int
    max_component_elements: int
    max_component_depth: int
    # hinting limits (v1.0 fields; zero for CFF maxp v0.5)
    max_twilight: int = 0
    max_storage: int = 0
    max_function_defs: int = 0
    max_instruction_defs: int = 0
    max_stack: int = 0

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Maxp":
        version = r.u32()
        num_glyphs = r.u16()
        if version < 0x00010000:
            # maxp 0.5 (CFF outlines): numGlyphs only
            return cls(num_glyphs, 0, 0, 0, 0, 0, 0)
        max_points, max_contours, max_cpoints, max_ccontours = r.unpack("HHHH")
        _zones, max_twi, max_sto, max_fdef, max_idef, max_stack, _isize = \
            r.unpack("HHHHHHH")
        max_celems, max_cdepth = r.unpack("HH")
        return cls(num_glyphs, max_points, max_contours, max_cpoints,
                   max_ccontours, max_celems, max_cdepth,
                   max_twi, max_sto, max_fdef, max_idef, max_stack)


@dataclass(frozen=True, slots=True)
class Hhea:
    """``hhea`` table (``ttf.zig:931-961``)."""

    ascent: int
    descent: int
    line_gap: int
    advance_width_max: int
    num_of_long_hor_metrics: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Hhea":
        _version = r.u32()
        ascent, descent, line_gap, advance_width_max = r.unpack("hhhH")
        r.skip(2 * 3 + 2 * 8)  # minLSB..metricDataFormat (incl. reserved)
        num_metrics = r.u16()
        return cls(ascent, descent, line_gap, advance_width_max, num_metrics)


def parse_hmtx(r: BigEndianReader, num_metrics: int, num_glyphs: int) -> np.ndarray:
    """Advance widths per glyph; trailing glyphs reuse the last long
    metric's advance (reference ``loadAdvanceWidths``,
    ``Font.zig:123-139``).  Returns uint16 array of length num_glyphs."""
    if num_metrics == 0:
        raise CorruptedFont("hmtx: zero long metrics")
    pairs = np.frombuffer(r.data, dtype=">u2", count=2 * num_metrics, offset=r.pos)
    advances = pairs[0::2].astype(np.uint16)
    out = np.empty(num_glyphs, dtype=np.uint16)
    n = min(num_metrics, num_glyphs)
    out[:n] = advances[:n]
    out[n:] = advances[n - 1]
    return out


@dataclass(frozen=True, slots=True)
class Vhea:
    """``vhea`` table — vertical layout metrics, a capability extension
    (the reference has no vertical text; its pen only advances
    horizontally, ``src/Appli.zig:343-351``).  Same wire shape as
    ``hhea`` with vertical semantics."""

    ascent: int          # vertTypoAscender: half the column pitch, + right
    descent: int         # vertTypoDescender (negative, - left)
    line_gap: int        # vertTypoLineGap: extra column spacing
    advance_height_max: int
    num_of_long_ver_metrics: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "Vhea":
        _version = r.u32()
        ascent, descent, line_gap, advance_height_max = r.unpack("hhhH")
        r.skip(2 * 3 + 2 * 8)  # minTSB..metricDataFormat (incl. reserved)
        num_metrics = r.u16()
        return cls(ascent, descent, line_gap, advance_height_max, num_metrics)


def parse_vmtx(
    r: BigEndianReader, num_metrics: int, num_glyphs: int
) -> tuple[np.ndarray, np.ndarray]:
    """``(advance_heights uint16[n], top_side_bearings int16[n])`` per
    glyph.  Trailing glyphs reuse the last long metric's advance and
    read their top side bearing from the run-out i16 array (mirror of
    the ``hmtx`` run-out rule the reference implements at
    ``Font.zig:123-139``)."""
    if num_metrics == 0:
        raise CorruptedFont("vmtx: zero long metrics")
    pairs = np.frombuffer(r.data, dtype=">u2", count=2 * num_metrics, offset=r.pos)
    advances = pairs[0::2].astype(np.uint16)
    tsbs = pairs[1::2].astype(np.int16)
    n = min(num_metrics, num_glyphs)
    adv_out = np.empty(num_glyphs, dtype=np.uint16)
    adv_out[:n] = advances[:n]
    adv_out[n:] = advances[n - 1]
    tsb_out = np.zeros(num_glyphs, dtype=np.int16)
    tsb_out[:n] = tsbs[:n]
    if num_glyphs > num_metrics:
        extra = num_glyphs - num_metrics
        run_out = np.frombuffer(
            r.data, dtype=">i2", count=extra,
            offset=r.pos + 4 * num_metrics,
        ).astype(np.int16)
        tsb_out[num_metrics:] = run_out
    return adv_out, tsb_out


# --------------------------------------------------------------------------
# cmap
# --------------------------------------------------------------------------

PLATFORM_UNICODE = 0
PLATFORM_MACINTOSH = 1
PLATFORM_MICROSOFT = 3

# Unicode platform-specific ids (``ttf.zig:673-697``)
UNI_DEFAULT = 0
UNI_V11 = 1
UNI_ISO_10646 = 2          # deprecated -> discarded by selection
UNI_2_0_BMP = 3
UNI_2_0_FULL = 4
UNI_VARIATION = 5
UNI_LAST_RESORT = 6        # reference calls it last_report
# Microsoft platform-specific ids (``ttf.zig:699-715``)
MS_UNICODE_BMP = 1
MS_UNICODE_UCS4 = 10


@dataclass(frozen=True, slots=True)
class CmapEncodingSubtable:
    """One cmap encoding record, with the reference's selection logic
    (``ttf.zig:263-312``)."""

    platform_id: int
    platform_specific_id: int
    offset: int

    def is_unicode(self) -> bool:
        if self.platform_id == PLATFORM_UNICODE:
            return self.platform_specific_id != UNI_VARIATION
        if self.platform_id == PLATFORM_MICROSOFT:
            return self.platform_specific_id in (MS_UNICODE_BMP, MS_UNICODE_UCS4)
        return False

    def bmp_restriction(self) -> int:
        """-1 unknown, 1 restricted-to-BMP, 0 full-repertoire — ordered so
        that bigger-is-better matches the reference enum order
        (unknown=0, true=1, false=2 in ``ttf.zig:295-312``)."""
        if self.platform_id == PLATFORM_UNICODE:
            if self.platform_specific_id == UNI_2_0_BMP:
                return 1
            if self.platform_specific_id in (UNI_2_0_FULL, UNI_LAST_RESORT):
                return 2
            return 0
        if self.platform_id == PLATFORM_MICROSOFT:
            if self.platform_specific_id == MS_UNICODE_BMP:
                return 1
            if self.platform_specific_id == MS_UNICODE_UCS4:
                return 2
            return 0
        return 0

    def is_unicode_discarded(self) -> bool:
        return (self.platform_id == PLATFORM_UNICODE
                and self.platform_specific_id == UNI_ISO_10646)

    def is_the_best(self) -> bool:
        return (self.is_unicode() and not self.is_unicode_discarded()
                and self.bmp_restriction() == 2)

    def is_better_than(self, other: "CmapEncodingSubtable") -> bool:
        if not self.is_unicode():
            return False
        if not other.is_unicode():
            return True
        if self.is_unicode_discarded():
            return False
        if other.is_unicode_discarded():
            return True
        return self.bmp_restriction() >= other.bmp_restriction()


def select_best_cmap_subtable(
    subtables: list[CmapEncodingSubtable],
) -> CmapEncodingSubtable | None:
    """Pick the best encoding subtable (reference selection loop,
    ``Font.zig:91-99``): first take-if-best short circuit, else the
    pairwise-better survivor."""
    best: CmapEncodingSubtable | None = None
    for sub in subtables:
        if sub.is_the_best():
            return sub
        if best is None or sub.is_better_than(best):
            best = sub
    if best is not None and not best.is_unicode():
        return None
    return best


def parse_cmap_index(r: BigEndianReader) -> list[CmapEncodingSubtable]:
    _version, count = r.unpack("HH")
    return [CmapEncodingSubtable(*r.unpack("HHI")) for _ in range(count)]


@dataclass(frozen=True, slots=True)
class CmapFormat4:
    """Segment-mapping-to-delta subtable (``ttf.zig:387-494``).

    Arrays are kept as NumPy for vectorized lookup/flatten.
    """

    end_code: np.ndarray       # u16[seg]
    start_code: np.ndarray     # u16[seg]
    id_delta: np.ndarray       # u16[seg] (mod-65536 arithmetic)
    id_range_offset: np.ndarray  # u16[seg]
    glyph_index_array: np.ndarray  # u16[n]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat4":
        _length, _language, seg_count_x2 = r.unpack("HHH")
        if seg_count_x2 & 1:
            raise CorruptedFont("cmap4: odd segCountX2")
        seg = seg_count_x2 // 2
        r.skip(6)  # searchRange, entrySelector, rangeShift
        end_code = r.u16_array(seg)
        r.skip(2)  # reservedPad
        start_code = r.u16_array(seg)
        id_delta = r.u16_array(seg)
        id_range_offset = r.u16_array(seg)
        ensure_mono_increase(end_code, "cmap4 endCode")
        if seg == 0 or end_code[-1] != 0xFFFF:
            raise CorruptedFont("cmap4: last endCode must be 0xFFFF")
        if np.any(end_code < start_code):
            raise CorruptedFont("cmap4: endCode < startCode")
        if np.any(id_range_offset & 1):
            raise CorruptedFont("cmap4: odd idRangeOffset")

        # Size of glyphIndexArray actually referenced (reference computes
        # max index, ``ttf.zig:410-418``).
        seg_idx = np.arange(seg, dtype=np.int64)
        used = id_range_offset.astype(np.int64) != 0
        max_index = -1
        if np.any(used):
            base = seg_idx + id_range_offset.astype(np.int64) // 2 - seg
            # a base before the glyphIndexArray would turn into a
            # negative Python index (silently wrapping to the array
            # tail) in glyph_index/collect_range_mappings — corrupt
            if np.any(base[used] < 0):
                raise CorruptedFont(
                    "cmap4: idRangeOffset points before glyphIndexArray"
                )
            idx = base + (
                end_code.astype(np.int64) - start_code.astype(np.int64)
            )
            max_index = int(idx[used].max())
        glyph_index_array = r.u16_array(max_index + 1) if max_index >= 0 else np.empty(0, np.uint16)
        return cls(end_code, start_code, id_delta, id_range_offset, glyph_index_array)

    def glyph_index(self, char: int) -> int:
        """Single-char lookup (``ttf.zig:433-449``)."""
        if char > 0xFFFF:
            return 0
        seg = len(self.end_code)
        i = int(np.searchsorted(self.end_code, char, side="left"))
        if i >= seg or self.start_code[i] > char:
            return 0
        ro = int(self.id_range_offset[i])
        if ro != 0:
            offset = i + ro // 2 - seg + (char - int(self.start_code[i]))
            return (int(self.id_delta[i]) + int(self.glyph_index_array[offset])) & 0xFFFF
        return (int(self.id_delta[i]) + char) & 0xFFFF

    def collect_range_mappings(self) -> np.ndarray:
        """Flatten to ``(end_char, char_count, end_glyph)`` rows with the
        reference's conventions (``ttf.zig:451-494``): glyph-index-array
        segments become per-char singleton ranges; delta segments that
        wrap past 65535 split at the wrap point (first half maps to
        glyph 0 sentinel)."""
        rows: list[tuple[int, int, int]] = []
        seg = len(self.end_code)
        for i in range(seg):
            start = int(self.start_code[i])
            end = int(self.end_code[i])
            delta = int(self.id_delta[i])
            ro = int(self.id_range_offset[i])
            if ro != 0:
                base = i + ro // 2 - seg
                g = self.glyph_index_array[base + 0 : base + (end - start + 1)].astype(np.int64)
                for char_offset, glyph in enumerate(g):
                    rows.append((start + char_offset + 1, 1, (delta + int(glyph) + 1) & 0xFFFF))
            else:
                start_glyph = (delta + start) & 0xFFFF
                end_glyph = (delta + end) & 0xFFFF
                if start_glyph > end_glyph:  # wraps through 0xFFFF
                    mid_code = (-start_glyph) & 0xFFFF
                    rows.append((mid_code + 1, mid_code - start + 1, 0))
                    rows.append((end + 1, end - mid_code, (end_glyph + 1) & 0xFFFF))
                else:
                    rows.append((end + 1, end - start + 1, (end_glyph + 1) & 0xFFFF))
        return np.array(rows, dtype=np.int64).reshape(-1, 3)


@dataclass(frozen=True, slots=True)
class CmapFormat12:
    """Segmented-coverage subtable (``ttf.zig:590-630``)."""

    start_char: np.ndarray  # u32[groups]
    end_char: np.ndarray    # u32[groups]
    start_glyph: np.ndarray  # u32[groups]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat12":
        r.skip(2)  # reserved (format is 12.0: format u16 already consumed)
        _length, _language, n_groups = r.unpack("III")
        raw = np.frombuffer(r.data, dtype=">u4", count=3 * n_groups, offset=r.pos)
        raw = raw.astype(np.uint32).reshape(-1, 3)
        ensure_mono_increase(raw[:, 0], "cmap12 startCharCode")
        return cls(raw[:, 0].copy(), raw[:, 1].copy(), raw[:, 2].copy())

    def glyph_index(self, char: int) -> int:
        i = int(np.searchsorted(self.end_char, char, side="left"))
        if i >= len(self.end_char) or self.start_char[i] > char:
            return 0
        return int(self.start_glyph[i]) + (char - int(self.start_char[i]))

    def collect_range_mappings(self) -> np.ndarray:
        count = self.end_char.astype(np.int64) - self.start_char.astype(np.int64) + 1
        end_char = self.end_char.astype(np.int64) + 1
        end_glyph = self.start_glyph.astype(np.int64) + count - 1 + 1
        return np.stack([end_char, count, end_glyph], axis=1)


@dataclass(frozen=True, slots=True)
class CmapFormat0:
    """Byte-encoding subtable: a flat 256-entry u8 table (classic Mac
    fonts).  The reference stubs this format out
    (``ttf.zig:349-360``); supported here as a capability extension."""

    glyph_ids: np.ndarray  # u8[256]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat0":
        _length, _language = r.unpack("HH")
        ids = np.frombuffer(r.data, dtype=np.uint8, count=256, offset=r.pos)
        return cls(ids.copy())

    def glyph_index(self, char: int) -> int:
        if not 0 <= char < 256:
            return 0
        return int(self.glyph_ids[char])

    def collect_range_mappings(self) -> np.ndarray:
        return _runs_to_range_rows(
            np.arange(256, dtype=np.int64), self.glyph_ids.astype(np.int64)
        )


@dataclass(frozen=True, slots=True)
class CmapFormat6:
    """Trimmed-table subtable: one dense glyph array for
    ``[first_code, first_code + entry_count)``.  Stubbed by the
    reference (``ttf.zig:497-570``); supported here as an extension."""

    first_code: int
    glyph_ids: np.ndarray  # u16[entry_count]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat6":
        _length, _language, first_code, entry_count = r.unpack("HHHH")
        return cls(first_code, r.u16_array(entry_count))

    def glyph_index(self, char: int) -> int:
        off = char - self.first_code
        if not 0 <= off < len(self.glyph_ids):
            return 0
        return int(self.glyph_ids[off])

    def collect_range_mappings(self) -> np.ndarray:
        chars = self.first_code + np.arange(len(self.glyph_ids), dtype=np.int64)
        return _runs_to_range_rows(chars, self.glyph_ids.astype(np.int64))


@dataclass(frozen=True, slots=True)
class CmapFormat2:
    """High-byte mapping subtable (legacy CJK encodings: Shift-JIS /
    Big5 / Wansung era).  Char codes are 8-bit where the high byte's
    subHeaderKey is 0 and 16-bit otherwise; a subHeader maps the low
    byte through ``glyphIndexArray`` with the classic idRangeOffset
    self-relative pointer arithmetic.  Flattened here into a dense
    ``char -> glyph`` table over the 16-bit code space (the codes map
    as given, matching how the charmap is queried).  Stubbed by the
    reference (``ttf.zig:349-360``); capability extension."""

    chars: np.ndarray    # i64[n] mapped char codes (sorted)
    glyphs: np.ndarray   # i64[n]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat2":
        base = r.pos - 2                       # subtable start (format u16 read)
        length, _language = r.unpack("HH")
        keys = r.u16_array(256)                # subHeaderKeys (byte offsets)
        sub_base = r.pos
        n_sub = (int(keys.max()) // 8) + 1
        data = r.data
        chars: list[int] = []
        glyphs: list[int] = []
        end = base + length
        for hi in range(256):
            k = int(keys[hi]) // 8
            if k >= n_sub:
                continue
            pos = sub_base + k * 8
            if pos + 8 > end:
                continue
            first, count, delta, range_off = struct.unpack_from(
                ">HHhH", data, pos)
            # the glyph array starts at the idRangeOffset FIELD address
            # plus the offset (self-relative, like format 4)
            arr_pos = pos + 6 + range_off
            for low in range(first, min(first + count, 256)):
                gpos = arr_pos + 2 * (low - first)
                if gpos + 2 > end:
                    break
                (g,) = struct.unpack_from(">H", data, gpos)
                if g != 0:
                    g = (g + delta) & 0xFFFF
                if g == 0:
                    continue
                if k == 0:
                    # one-byte codes: only high bytes whose key is 0
                    # use subHeader 0, and the code IS the byte
                    if int(keys[low]) // 8 == 0 and low < 256:
                        chars.append(low)
                        glyphs.append(g)
                else:
                    chars.append((hi << 8) | low)
                    glyphs.append(g)
        if not chars:
            return cls(np.empty(0, np.int64), np.empty(0, np.int64))
        order = np.argsort(np.asarray(chars))
        ca = np.asarray(chars, np.int64)[order]
        ga = np.asarray(glyphs, np.int64)[order]
        # one-byte codes can be emitted once per qualifying high byte;
        # dedupe on char
        keep = np.concatenate(([True], np.diff(ca) != 0))
        return cls(ca[keep], ga[keep])

    def glyph_index(self, char: int) -> int:
        i = int(np.searchsorted(self.chars, char))
        if i < len(self.chars) and self.chars[i] == char:
            return int(self.glyphs[i])
        return 0

    def collect_range_mappings(self) -> np.ndarray:
        return _runs_to_range_rows(self.chars, self.glyphs)


@dataclass(frozen=True, slots=True)
class CmapFormat8:
    """Mixed 16/32-bit coverage subtable: an ``is32`` bitmap plus
    sequential map groups — the group structure is format 12's, so
    lookup and flattening reuse its semantics.  Stubbed by the
    reference; capability extension."""

    groups: CmapFormat12

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat8":
        r.skip(2)                               # reserved (format 8.0)
        _length, _language = r.unpack("II")
        r.skip(8192)                            # is32 bitmap (unused: the
        # groups carry full 32-bit codes either way)
        n_groups = r.u32()
        raw = np.frombuffer(
            r.data, dtype=">u4", count=3 * n_groups, offset=r.pos
        ).astype(np.uint32).reshape(-1, 3)
        ensure_mono_increase(raw[:, 0], "cmap8 startCharCode")
        return cls(CmapFormat12(
            raw[:, 0].copy(), raw[:, 1].copy(), raw[:, 2].copy()))

    def glyph_index(self, char: int) -> int:
        return self.groups.glyph_index(char)

    def collect_range_mappings(self) -> np.ndarray:
        return self.groups.collect_range_mappings()


@dataclass(frozen=True, slots=True)
class CmapFormat10:
    """Trimmed array subtable: format 6's dense table with 32-bit char
    codes.  Stubbed by the reference; capability extension."""

    first_code: int
    glyph_ids: np.ndarray  # u16[num_chars]

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat10":
        r.skip(2)                               # reserved (format 10.0)
        _length, _language, first_code, num_chars = r.unpack("IIII")
        return cls(int(first_code), r.u16_array(num_chars))

    def glyph_index(self, char: int) -> int:
        off = char - self.first_code
        if not 0 <= off < len(self.glyph_ids):
            return 0
        return int(self.glyph_ids[off])

    def collect_range_mappings(self) -> np.ndarray:
        chars = self.first_code + np.arange(
            len(self.glyph_ids), dtype=np.int64)
        return _runs_to_range_rows(chars, self.glyph_ids.astype(np.int64))


def _runs_to_range_rows(chars: np.ndarray, glyphs: np.ndarray) -> np.ndarray:
    """Compress a dense ``char -> glyph`` table into
    ``(end_char, char_count, end_glyph)`` rows: maximal runs where the
    glyph index advances in lockstep with the char code.  Glyph 0
    entries are unmapped and dropped (``CharGlyphMapping`` already
    resolves missing chars to glyph 0)."""
    keep = glyphs != 0
    chars, glyphs = chars[keep], glyphs[keep]
    if len(chars) == 0:
        return np.empty((0, 3), dtype=np.int64)
    # a new run starts wherever char or glyph does not advance by 1
    breaks = np.flatnonzero(
        (np.diff(chars) != 1) | (np.diff(glyphs) != 1)
    )
    starts = np.concatenate(([0], breaks + 1))
    ends = np.concatenate((breaks, [len(chars) - 1]))
    count = chars[ends] - chars[starts] + 1
    return np.stack([chars[ends] + 1, count, glyphs[ends] + 1], axis=1)


@dataclass(frozen=True, slots=True)
class CmapFormat13:
    """Many-to-one range mappings (last-resort fonts): every char in a
    group maps to the SAME glyph.  Stubbed by the reference
    (``ttf.zig:633-670``); supported here via the stride-0 extension of
    the range table (``fontrx.font.charmap.RangeMapping``)."""

    start_char: np.ndarray  # u32[groups]
    end_char: np.ndarray    # u32[groups] (inclusive)
    glyph: np.ndarray       # u32[groups] (constant per group)

    @classmethod
    def parse(cls, r: BigEndianReader) -> "CmapFormat13":
        r.skip(2)  # reserved (format u16 already consumed)
        _length, _language, n_groups = r.unpack("III")
        raw = np.frombuffer(r.data, dtype=">u4", count=3 * n_groups, offset=r.pos)
        raw = raw.astype(np.uint32).reshape(-1, 3)
        ensure_mono_increase(raw[:, 0], "cmap13 startCharCode")
        if np.any(raw[:, 1] < raw[:, 0]):
            raise CorruptedFont("cmap13: endCharCode < startCharCode")
        return cls(raw[:, 0].copy(), raw[:, 1].copy(), raw[:, 2].copy())

    def glyph_index(self, char: int) -> int:
        i = int(np.searchsorted(self.end_char, char, side="left"))
        if i >= len(self.end_char) or self.start_char[i] > char:
            return 0
        return int(self.glyph[i])

    def collect_range_mappings(self) -> np.ndarray:
        end = self.end_char.astype(np.int64)
        count = end - self.start_char.astype(np.int64) + 1
        end_glyph = self.glyph.astype(np.int64) + 1
        stride = np.zeros(len(end), dtype=np.int64)
        return np.stack([end + 1, count, end_glyph, stride], axis=1)


@dataclass(frozen=True, slots=True)
class CmapFormat14:
    """Unicode Variation Sequences subtable (format 14) — beyond the
    reference (stubbed at ``ttf.zig:349-360``); the one legacy-free
    optional format modern fonts actually use (CJK ideograph variants,
    emoji text/em presentation).

    Unlike every other cmap format this is not a char->glyph map: it
    *supplements* the default mapping for ``(base char, variation
    selector)`` pairs.  Default UVS ranges say "use the regular cmap
    glyph"; non-default mappings name an explicit variant glyph.  See
    :meth:`glyph_for_variant` and ``Font.glyph_index_variant``.
    """

    var_selectors: np.ndarray  # u32[n], ascending
    # per record: (range_start u32[], range_end u32[] inclusive)
    default_ranges: tuple[tuple[np.ndarray, np.ndarray], ...]
    # per record: (unicode u32[] ascending, glyph u16[])
    nondefault: tuple[tuple[np.ndarray, np.ndarray], ...]

    @classmethod
    def parse(cls, r: BigEndianReader, subtable_start: int) -> "CmapFormat14":
        """``r`` positioned after the format u16; ``subtable_start`` is
        the format field's offset (UVS offsets are relative to it)."""
        r.pos = subtable_start + 2
        _length, n_records = r.unpack("II")
        recs = []
        for _ in range(n_records):
            hi = r.u8()
            lo = r.unpack("H")[0]
            selector = (hi << 16) | lo
            def_off, nondef_off = r.unpack("II")
            recs.append((selector, def_off, nondef_off))
        selectors = np.array([s for s, _, _ in recs], np.uint32)
        ensure_mono_increase(selectors, "cmap14 varSelector")
        defaults = []
        nondefaults = []
        for _sel, def_off, nondef_off in recs:
            if def_off:
                r.pos = subtable_start + def_off
                (n,) = r.unpack("I")
                starts = np.zeros(n, np.uint32)
                ends = np.zeros(n, np.uint32)
                for i in range(n):
                    hi = r.u8()
                    lo = r.unpack("H")[0]
                    start = (hi << 16) | lo
                    extra = r.u8()
                    starts[i] = start
                    ends[i] = start + extra
                ensure_mono_increase(starts, "cmap14 defaultUVS start")
                defaults.append((starts, ends))
            else:
                defaults.append(
                    (np.empty(0, np.uint32), np.empty(0, np.uint32))
                )
            if nondef_off:
                r.pos = subtable_start + nondef_off
                (n,) = r.unpack("I")
                uni = np.zeros(n, np.uint32)
                gid = np.zeros(n, np.uint16)
                for i in range(n):
                    hi = r.u8()
                    lo = r.unpack("H")[0]
                    uni[i] = (hi << 16) | lo
                    gid[i] = r.unpack("H")[0]
                ensure_mono_increase(uni, "cmap14 nonDefaultUVS unicode")
                nondefaults.append((uni, gid))
            else:
                nondefaults.append(
                    (np.empty(0, np.uint32), np.empty(0, np.uint16))
                )
        return cls(selectors, tuple(defaults), tuple(nondefaults))

    def glyph_for_variant(self, char: int, selector: int, default_lookup):
        """Resolve ``(base char, variation selector)``.

        Returns the variant glyph index, ``default_lookup(char)`` for
        default-UVS sequences, or ``None`` when the sequence is not in
        the table (caller falls back to the base glyph)."""
        i = int(np.searchsorted(self.var_selectors, selector))
        if i >= len(self.var_selectors) or self.var_selectors[i] != selector:
            return None
        uni, gid = self.nondefault[i]
        j = int(np.searchsorted(uni, char))
        if j < len(uni) and uni[j] == char:
            return int(gid[j])
        starts, ends = self.default_ranges[i]
        j = int(np.searchsorted(starts, char, side="right")) - 1
        if j >= 0 and char <= int(ends[j]):
            return default_lookup(char)
        return None


UNSUPPORTED_CMAP_FORMATS = ()   # round 3: the set is complete


def parse_cmap_subtable(r: BigEndianReader):
    """Dispatch on the format number.  The reference supports only
    formats 4 and 12 and stubs the rest with ``@compileError("not
    impl")`` (``ttf.zig:349-360,497-570,633-670``); fontrx additionally
    parses formats 0, 2, 6, 8, 10 and 13 — the COMPLETE charmap format
    set (format 14 supplements the mapping and is parsed separately)."""
    fmt = r.u16()
    if fmt == 0:
        return CmapFormat0.parse(r)
    if fmt == 2:
        return CmapFormat2.parse(r)
    if fmt == 4:
        return CmapFormat4.parse(r)
    if fmt == 6:
        return CmapFormat6.parse(r)
    if fmt == 8:
        return CmapFormat8.parse(r)
    if fmt == 10:
        return CmapFormat10.parse(r)
    if fmt == 12:
        return CmapFormat12.parse(r)
    if fmt == 13:
        return CmapFormat13.parse(r)
    if fmt == 14:
        raise NotImplementedError(
            "cmap format 14 supplements the default mapping with "
            "variation sequences rather than providing a charmap; it is "
            "parsed separately (CmapFormat14 / Font.glyph_index_variant)"
        )
    if fmt in UNSUPPORTED_CMAP_FORMATS:
        raise NotImplementedError(f"cmap format {fmt} not implemented")
    raise CorruptedFont(f"unknown cmap format {fmt}")


# --------------------------------------------------------------------------
# glyf
# --------------------------------------------------------------------------

# Simple-glyph outline flags (``ttf.zig:742-757``)
FLAG_ON_CURVE = 0x01
FLAG_X_SHORT = 0x02
FLAG_Y_SHORT = 0x04
FLAG_REPEAT = 0x08
FLAG_X_SAME_OR_POS = 0x10
FLAG_Y_SAME_OR_POS = 0x20


@dataclass(frozen=True, slots=True)
class GlyphDescription:
    """Per-glyph header (``ttf.zig:717-729``)."""

    number_of_contours: int  # >=0 simple, <0 compound
    x_min: int
    y_min: int
    x_max: int
    y_max: int

    @classmethod
    def parse(cls, r: BigEndianReader) -> "GlyphDescription":
        return cls(*r.unpack("hhhhh"))


@dataclass(frozen=True, slots=True)
class SimpleGlyph:
    """Decoded simple glyph: absolute points + on-curve bits
    (``SimpleGlyph.initFromReader``, ``ttf.zig:759-817``)."""

    end_pts_of_contours: np.ndarray  # u16[contours]
    instructions: bytes
    on_curve: np.ndarray             # bool[points]
    coordinates: np.ndarray          # i32[points, 2] absolute

    @classmethod
    def parse(cls, r: BigEndianReader, num_contours: int) -> "SimpleGlyph":
        end_pts = r.u16_array(num_contours)
        ensure_mono_increase(end_pts, "endPtsOfContours")
        n_points = int(end_pts[-1]) + 1 if num_contours else 0
        instr_len = r.u16()
        instructions = r.bytes(instr_len)

        # --- flag stream (run-length encoded) ---
        flags = np.empty(n_points, dtype=np.uint8)
        i = 0
        data, pos = r.data, r.pos
        while i < n_points:
            if pos >= len(data):
                raise CorruptedFont("glyf: flag stream truncated")
            f = data[pos]
            pos += 1
            flags[i] = f
            i += 1
            if f & FLAG_REPEAT:
                if pos >= len(data):
                    raise CorruptedFont("glyf: flag repeat truncated")
                rep = data[pos]
                pos += 1
                flags[i : i + rep] = f
                i += rep
        if i != n_points:
            raise CorruptedFont("glyf: flag run overruns point count")
        r.pos = pos

        # --- coordinate streams (vectorized delta decode) ---
        def decode_axis(short_bit: int, same_bit: int) -> np.ndarray:
            short = (flags & short_bit) != 0
            same = (flags & same_bit) != 0
            n_short = int(short.sum())
            n_long = int((~short & ~same).sum())
            nbytes = n_short + 2 * n_long
            raw = np.frombuffer(r.data, dtype=np.uint8, count=nbytes, offset=r.pos)
            r.skip(nbytes)
            deltas = np.zeros(n_points, dtype=np.int32)
            # byte offsets of each point's encoded delta
            size = np.where(short, 1, np.where(same, 0, 2)).astype(np.int64)
            starts = np.concatenate(([0], np.cumsum(size)[:-1]))
            if n_short:
                s_starts = starts[short]
                mag = raw[s_starts].astype(np.int32)
                sign = np.where(same[short], 1, -1)  # same_bit doubles as sign for short
                deltas[short] = mag * sign
            long_mask = ~short & ~same
            if n_long:
                l_starts = starts[long_mask]
                hi = raw[l_starts].astype(np.int32)
                lo = raw[l_starts + 1].astype(np.int32)
                val = (hi << 8) | lo
                val = np.where(val >= 0x8000, val - 0x10000, val)
                deltas[long_mask] = val
            return np.cumsum(deltas, dtype=np.int64).astype(np.int32)

        xs = decode_axis(FLAG_X_SHORT, FLAG_X_SAME_OR_POS)
        ys = decode_axis(FLAG_Y_SHORT, FLAG_Y_SAME_OR_POS)
        coords = np.stack([xs, ys], axis=1)
        return cls(end_pts.astype(np.uint16), instructions,
                   (flags & FLAG_ON_CURVE) != 0, coords)


# Compound-glyph component flags (``ttf.zig:829-855``)
ARG_1_AND_2_ARE_WORDS = 0x0001
ARGS_ARE_XY_VALUES = 0x0002
ROUND_XY_TO_GRID = 0x0004
WE_HAVE_A_SCALE = 0x0008
MORE_COMPONENTS = 0x0020
WE_HAVE_AN_X_AND_Y_SCALE = 0x0040
WE_HAVE_A_TWO_BY_TWO = 0x0080
WE_HAVE_INSTRUCTIONS = 0x0100
USE_MY_METRICS = 0x0200
OVERLAP_COMPOUND = 0x0400


@dataclass(frozen=True, slots=True)
class ComponentPart:
    """One component reference inside a compound glyph
    (``ComponentGlyph.initFromReader``, ``ttf.zig:857-921``).

    ``transform`` is the (a, b, c, d) 2.14 matrix — reference stores it in
    the order [a, b, c, d] and applies x' via (a, c), y' via (b, d)
    (``Glyph.zig:138-139``).
    """

    flags: int
    glyph_index: int
    argument1: int  # dx (or point index when not ARGS_ARE_XY_VALUES)
    argument2: int  # dy
    transform: tuple[FixedPoint, FixedPoint, FixedPoint, FixedPoint]

    @property
    def args_are_xy_values(self) -> bool:
        return bool(self.flags & ARGS_ARE_XY_VALUES)

    @property
    def round_xy_to_grid(self) -> bool:
        return bool(self.flags & ROUND_XY_TO_GRID)

    @property
    def use_my_metrics(self) -> bool:
        return bool(self.flags & USE_MY_METRICS)


@dataclass(frozen=True, slots=True)
class ComponentGlyph:
    parts: tuple[ComponentPart, ...]
    instructions: bytes
    metrics_index: int | None  # component index supplying metrics, if any

    @classmethod
    def parse(cls, r: BigEndianReader) -> "ComponentGlyph":
        parts: list[ComponentPart] = []
        metrics_index: int | None = None
        has_instructions = False
        while True:
            flags, glyph_index = r.unpack("HH")
            if flags & ARG_1_AND_2_ARE_WORDS:
                arg1, arg2 = r.unpack("hh")
            else:
                b1, b2 = r.unpack("bb") if flags & ARGS_ARE_XY_VALUES else r.unpack("BB")
                arg1, arg2 = b1, b2
            one = FixedPoint.from_int(1, 14)
            zero = FixedPoint(0, 14)
            if flags & WE_HAVE_A_SCALE:
                s = F2D14(r.u16())
                transform = (s, zero, zero, s)
            elif flags & WE_HAVE_AN_X_AND_Y_SCALE:
                sx, sy = F2D14(r.u16()), F2D14(r.u16())
                transform = (sx, zero, zero, sy)
            elif flags & WE_HAVE_A_TWO_BY_TWO:
                a, b, c, d = (F2D14(r.u16()) for _ in range(4))
                transform = (a, b, c, d)
            else:
                transform = (one, zero, zero, one)
            parts.append(ComponentPart(flags, glyph_index, arg1, arg2, transform))
            if flags & USE_MY_METRICS:
                # the spec allows at most one, but real fonts (DejaVu
                # glyph sets) set it on several parts; keep the first
                # (graceful degradation, SURVEY §5.3)
                if metrics_index is None:
                    metrics_index = len(parts) - 1
            if flags & WE_HAVE_INSTRUCTIONS:
                has_instructions = True
            if not flags & MORE_COMPONENTS:
                break
        instructions = b""
        if has_instructions:
            n = r.u16()
            instructions = r.bytes(n)
        return cls(tuple(parts), instructions, metrics_index)


# --------------------------------------------------------------------------
# kern (extension beyond the reference, which does no kerning)
# --------------------------------------------------------------------------


@dataclass(frozen=True, slots=True)
class KernClassMatrix:
    """One ``kern`` format-2 subtable: class-matrix kerning (the
    legacy two-ClassTable form, Apple TrueType Reference Manual /
    OT legacy kern spec).  Class values are byte offsets — left
    values pre-multiplied by the row width and based at the kerning
    array, right values pre-multiplied by 2 — so a pair's value lives
    at ``subtable[leftValue + rightValue]``; out-of-range glyphs and
    out-of-bounds offsets kern 0 (the defensive convention shared by
    shipping implementations)."""

    sub: bytes          # the whole subtable (offsets are relative)
    left_first: int
    left_vals: np.ndarray    # uint16 byte offsets per left glyph
    right_first: int
    right_vals: np.ndarray

    def lookup(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        left = np.asarray(left, np.int64)
        right = np.asarray(right, np.int64)
        li = left - self.left_first
        ri = right - self.right_first
        lok = (li >= 0) & (li < len(self.left_vals))
        rok = (ri >= 0) & (ri < len(self.right_vals))
        lv = np.where(lok, self.left_vals[np.clip(li, 0, max(
            len(self.left_vals) - 1, 0))], 0)
        rv = np.where(rok, self.right_vals[np.clip(ri, 0, max(
            len(self.right_vals) - 1, 0))], 0)
        off = (lv + rv).astype(np.int64)
        ok = lok & rok & (lv > 0) & (off + 2 <= len(self.sub))
        off = np.where(ok, off, 0)
        raw = np.frombuffer(self.sub, np.uint8)
        hi = raw[off].astype(np.int32)
        lo = raw[np.minimum(off + 1, len(self.sub) - 1)].astype(np.int32)
        val = (hi << 8) | lo
        val = np.where(val >= 0x8000, val - 0x10000, val)
        return np.where(ok, val, 0).astype(np.int32)

    @classmethod
    def parse(cls, sub: bytes) -> "KernClassMatrix | None":
        if len(sub) < 14:
            return None

        def u16(o):
            return (sub[o] << 8) | sub[o + 1]

        left_off, right_off = u16(8), u16(10)

        def class_table(off):
            if off + 4 > len(sub):
                return None
            first, n = u16(off), u16(off + 2)
            if off + 4 + 2 * n > len(sub):
                return None
            vals = np.frombuffer(
                sub, dtype=">u2", count=n, offset=off + 4
            ).astype(np.int64)
            return first, vals

        lt = class_table(left_off)
        rt = class_table(right_off)
        if lt is None or rt is None:
            return None
        return cls(sub, lt[0], lt[1], rt[0], rt[1])


@dataclass(frozen=True, slots=True)
class KernTable:
    """Horizontal pair kerning from the legacy ``kern`` table.

    Handles both header versions (OT u16 version/nTables and the AAT
    u32 form with its 16-bit coverage layout), accumulating every
    horizontal non-cross-stream subtable per the spec: format 0 pair
    lists merge into one sorted ``(left << 16) | right`` key array for
    vectorized batch lookup, format 2 class matrices contribute
    through :class:`KernClassMatrix`.  (The rarely-used coverage
    override bit is treated as accumulate — documented divergence.)
    """

    keys: np.ndarray    # uint32[n], sorted
    values: np.ndarray  # int16[n]
    matrices: tuple = ()
    pair_memo: dict = field(default_factory=dict, compare=False)

    @classmethod
    def parse(cls, r: BigEndianReader) -> "KernTable | None":
        data = r.data
        version = r.u16()
        if version == 1:
            # AAT header: u32 version (0x00010000), u32 nTables
            r.skip(2)
            n_tables = int(r.unpack("I")[0])
            aat = True
        else:
            n_tables = r.u16()
            aat = False
        pair_keys: list[np.ndarray] = []
        pair_vals: list[np.ndarray] = []
        matrices: list[KernClassMatrix] = []
        for _ in range(min(n_tables, 64)):
            sub_start = r.pos
            if aat:
                if sub_start + 8 > len(data):
                    break
                length = int(r.unpack("I")[0])
                coverage = r.u16()
                r.skip(2)  # tupleIndex
                fmt = coverage & 0xFF
                horizontal = not (coverage & 0x8000)
                cross_stream = coverage & 0x4000
                header = 8
            else:
                if sub_start + 6 > len(data):
                    break
                _sub_version, length, coverage = r.unpack("HHH")
                fmt = coverage >> 8
                horizontal = coverage & 0x01
                cross_stream = coverage & 0x04
                header = 6
            if fmt == 0 and horizontal and not cross_stream:
                n_pairs = r.u16()
                r.skip(6)  # searchRange, entrySelector, rangeShift
                raw = np.frombuffer(
                    data, dtype=">u2", count=3 * n_pairs, offset=r.pos
                ).astype(np.int64).reshape(-1, 3)
                pair_keys.append(
                    (raw[:, 0].astype(np.uint32) << 16)
                    | raw[:, 1].astype(np.uint32))
                pair_vals.append(
                    raw[:, 2].astype(np.uint16).astype(np.int16))
            elif fmt == 2 and horizontal and not cross_stream:
                end = sub_start + max(length, header)
                m = KernClassMatrix.parse(
                    bytes(data[sub_start:min(end, len(data))]))
                if m is not None:
                    matrices.append(m)
            r.pos = sub_start + max(length, header)
            if r.pos > len(data):
                break
        if not pair_keys and not matrices:
            return None
        if pair_keys:
            keys = np.concatenate(pair_keys)
            values = np.concatenate(pair_vals)
            # accumulate duplicate pairs across subtables, then sort
            order = np.argsort(keys, kind="stable")
            keys, values = keys[order], values[order].astype(np.int64)
            uniq, inv = np.unique(keys, return_inverse=True)
            summed = np.zeros(len(uniq), np.int64)
            np.add.at(summed, inv, values)
            keys = uniq
            values = np.clip(summed, -0x8000, 0x7FFF).astype(np.int16)
            ensure_mono_increase(keys, "kern pair keys")
        else:
            keys = np.zeros(0, np.uint32)
            values = np.zeros(0, np.int16)
        return cls(keys, values, tuple(matrices))

    def lookup(self, left: np.ndarray, right: np.ndarray) -> np.ndarray:
        """Vectorized kerning values for glyph-index pairs; 0 when the
        pair is not kerned.  Format-0 pairs and format-2 class
        matrices accumulate.  Scalar pairs memoize (the layout pen
        walk queries one pair at a time; text repeats few)."""
        if isinstance(left, (int, np.integer)) and isinstance(
                right, (np.integer, int)):
            k = (int(left) << 16) | int(right)
            v = self.pair_memo.get(k)
            if v is None:
                v = self.pair_memo[k] = int(self._lookup_vec(
                    np.array([left]), np.array([right]))[0])
            return np.int32(v)  # 0-d scalar, like the pre-memo shape
        return self._lookup_vec(left, right)

    def _lookup_vec(self, left, right) -> np.ndarray:
        key = (np.asarray(left, np.uint32) << 16) | np.asarray(right, np.uint32)
        out = np.zeros(np.shape(key), np.int32)
        if len(self.keys):
            idx = np.searchsorted(self.keys, key)
            idx = np.clip(idx, 0, len(self.keys) - 1)
            hit = self.keys[idx] == key
            out = np.where(hit, self.values[idx], 0).astype(np.int32)
        for m in self.matrices:
            out = out + m.lookup(left, right)
        return out
