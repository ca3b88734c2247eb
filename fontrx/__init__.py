"""fontrx — a glyph rasterization framework on JAX.

A ground-up JAX/XLA re-design of the capabilities of
nyasyamorina/font-renderer (a Zig + Vulkan interactive font renderer):

- ``fontrx.font``     — host-side TrueType frontend (tables, cmap, glyf,
  compound flattening, contour normalization).  Reference behavior:
  ``src/font/{ttf,Font,Glyph,CharGlyphMapping}.zig``.
- ``fontrx.pack``     — glyph outlines -> padded quadratic-segment tensors
  (the analog of the reference's GPU vertex/index buffers,
  ``src/Appli.zig:219-302``).
- ``fontrx.kernels``  — the row-binned XLA raster route: analytic
  winding fill (the math of ``src/tools/render_glyph.zig:35-73``), MSAA
  supersampled coverage, signed-distance fields, and a Loop-Blinn style
  triangle fill (the math of ``src/shaders/shader.slang:32-51``).
- ``fontrx.engine``   — jitted raster steps, atlas batching, multi-device
  sharding over a ``jax.sharding.Mesh``, compilation-cache wiring
  (the analog of ``src/VulkanContext.zig`` + ``src/CacheManager.zig``).
- ``fontrx.scene``    — text layout, view transforms, interactive loop
  (semantics of ``src/Appli.zig`` + ``src/CallbackContext.zig``).
- ``fontrx.io``       — image containers and a QOI encoder byte-compatible
  with ``src/tools/qoi.zig``.
- ``fontrx.geometry`` — host sweep-line triangulation compat mode
  (semantics of ``src/tools/{TriangulatedGlyph,geometry}.zig``).
- ``fontrx.cli``      — config/flag system + entry point
  (semantics of ``src/Config.zig`` + ``src/main.zig``).

Everything under jit is static-shape, fused, and batched; multi-chip
scaling is expressed with ``jax.sharding`` + ``shard_map`` so collectives
ride ICI.  This is a new architecture, not a port.
"""

__version__ = "0.1.0"

from fontrx.font.font import Font  # noqa: F401
from fontrx.font.stack import FontStack  # noqa: F401
from fontrx.pack.segments import pack_glyph, pack_glyphs  # noqa: F401


def render_text(font, text, *, size=256, mode="fill", engine=None,
                **options):
    """One-call library rendering: ``text`` -> uint8 RGB image array.

    ``font`` is a path, raw bytes, or an opened :class:`Font`/
    :class:`FontStack`; ``mode`` and ``options`` mirror the CLI flags
    (``kern=True``, ``ligatures=True``, ``mode="color"``,
    ``vertical=True``, ``underline=True``, ``wrap=800``,
    ``variation="wght=700"``, ...).  The same dispatch the ``fontrx``
    CLI uses renders the image; pass an :class:`~fontrx.engine.raster.
    RasterEngine` to reuse compiled kernels across calls.

    >>> img = render_text("DejaVuSans.ttf", "Hello", size=64,
    ...                   kern=True)
    >>> img.shape   # (H, W, 3) uint8
    """
    from fontrx.cli.config import Config
    from fontrx.cli.main import _render

    if isinstance(font, str):
        font = Font.open(font)
    elif isinstance(font, (bytes, bytearray)):
        font = Font(bytes(font))

    cfg_kwargs = {"font_file": "<memory>", "text": text, "size": size,
                  "mode": mode}
    import dataclasses

    valid = {f.name for f in dataclasses.fields(Config)}
    cli_only = {"interactive", "output", "serve", "font_file",
                "text", "cache"}
    unknown = set(options) - (valid - cli_only)
    if unknown:
        raise TypeError(f"unknown render options: {sorted(unknown)}")
    fallback = options.pop("fallback", None)
    if fallback and isinstance(font, Font):
        # the CLI's --fallback: characters the primary lacks resolve
        # through the listed fonts in order
        paths = [p.strip() for p in str(fallback).split(",")
                 if p.strip()]
        opened = [Font.open(p) for p in paths]
        font = FontStack([font] + opened)
    cfg = Config(**cfg_kwargs, **options)

    if engine is None:
        from fontrx.engine.raster import RasterEngine

        engine = RasterEngine()
    if cfg.variation and hasattr(font, "set_variation"):
        from fontrx.cli.main import parse_variation_str

        font.set_variation(parse_variation_str(cfg.variation))
    import numpy as np

    return np.asarray(_render(font, text, cfg, engine))
