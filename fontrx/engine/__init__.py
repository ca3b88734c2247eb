"""Raster engine: jitted raster steps, atlas batching, device sharding,
compilation-cache wiring.

The analog of the reference's device runtime (``src/VulkanContext.zig``
buffers/pipelines/frame loop + ``src/CacheManager.zig`` pipeline-cache
persistence): instead of staging buffers and graphics pipelines there are
``jax.device_put`` uploads, jit-compiled raster executables cached by
shape bucket, and the XLA persistent compilation cache.
"""

from fontrx.engine.raster import RasterEngine  # noqa: F401
from fontrx.engine.atlas import AtlasLayout, render_atlas  # noqa: F401
