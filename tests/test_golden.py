"""Golden-hash regression corpus.

Locks the oracle's raster semantics (and transitively every backend,
since they're tested bit-exact against it) to known-good outputs on
DejaVu Sans.  If any of these hashes move, raster semantics changed —
that must be a deliberate, documented decision, never an accident.
"""

import hashlib

import numpy as np

from fontrx.kernels import oracle
from fontrx.kernels.grid import RasterGrid
from fontrx.pack.segments import glyph_segments

GOLDEN_WINDING = {
    ("A", 64): "c2fe7e4c0ac2f65f",
    ("A", 256): "2bf9201b2503d173",
    ("Q", 64): "110119b5b24aab57",
    ("Q", 256): "4f666c36e98c0d66",
    ("g", 64): "f16716c5ca8aeaf8",
    ("g", 256): "e3c3c41dad8a41a8",
    ("@", 64): "23828c8416da31b6",
    ("@", 256): "ad9d582dbde3911f",
    ("&", 64): "c8cb4d95a15499d9",
    ("&", 256): "ff19f48f6e6aa272",
    ("8", 64): "d9bb7aee3614ccde",
    ("8", 256): "948af87fe36b9f25",
}
GOLDEN_QOI_A256 = "1b69b3e296552893"


def _grid(glyph, size):
    return RasterGrid.for_glyph_box(
        (glyph.box.x_min, glyph.box.y_min, glyph.box.x_max, glyph.box.y_max),
        size, 2048,
    )


def test_winding_hashes(dejavu):
    for (ch, size), expected in GOLDEN_WINDING.items():
        g, _ = dejavu.get_glyph(ch)
        w = oracle.winding_map(glyph_segments(g), _grid(g, size))
        got = hashlib.sha256(w.tobytes()).hexdigest()[:16]
        assert got == expected, (ch, size, got)


def test_qoi_bytes_hash(dejavu):
    from fontrx.io.qoi import encode_rgb

    g, _ = dejavu.get_glyph("A")
    fill = oracle.render_fill(glyph_segments(g), _grid(g, 256))
    q = encode_rgb(np.repeat(fill[:, :, None], 3, axis=2))
    assert hashlib.sha256(q).hexdigest()[:16] == GOLDEN_QOI_A256


def test_engine_matches_golden(dejavu):
    """The engine path (jnp on CPU) reproduces the golden hashes too."""
    from fontrx.engine.raster import RasterEngine

    eng = RasterEngine()
    for (ch, size), expected in list(GOLDEN_WINDING.items())[:4]:
        g, _ = dejavu.get_glyph(ch)
        w = np.asarray(eng.winding_glyph(glyph_segments(g), _grid(g, size)))
        got = hashlib.sha256(w.astype(np.int32).tobytes()).hexdigest()[:16]
        assert got == expected, (ch, size)


def test_shaped_page_hash(tmp_path):
    """End-to-end CLI page with kerning + ligatures pinned by hash:
    catches regressions anywhere in cmap -> GSUB -> GPOS -> layout ->
    raster -> QOI (CPU/jnp path is deterministic)."""
    from fontrx.cli.main import main
    from fontrx.io.qoi import decode

    out = tmp_path / "shaped.qoi"
    rc = main([
        "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        "-t", "Tfi AVfl office", "-m", "fill", "-s", "32",
        "-o", str(out), "-k", "-l",
    ])
    assert rc == 0
    img = np.asarray(decode(out.read_bytes()))
    assert img.shape == (45, 217, 3)
    got = hashlib.sha256(img.tobytes()).hexdigest()[:16]
    assert got == "3636357199ae5572", got


def test_round2_features_page_hash(tmp_path):
    """End-to-end CLI page exercising the round-2 layout features in
    one run — GPOS-engine positioning + word wrap — pinned by hash
    (CPU/jnp path is deterministic)."""
    from fontrx.cli.main import main
    from fontrx.io.qoi import decode

    out = tmp_path / "r2.qoi"
    rc = main([
        "-f", "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
        "-t", "AVATAR wavy fjord", "-m", "fill", "-s", "32",
        "-o", str(out), "--positioning", "kern", "--wrap", "130",
    ])
    assert rc == 0
    img = np.asarray(decode(out.read_bytes()))
    assert img.shape == (119, 128, 3)  # 2 wrapped lines
    got = hashlib.sha256(img.tobytes()).hexdigest()[:16]
    assert got == "c01906163e351d1c", got
