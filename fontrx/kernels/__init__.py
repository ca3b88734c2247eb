"""Raster kernels: the row-binned XLA route and its references.

- ``grid``          — raster-grid geometry shared by every route (the
  exact pixel->em-space mapping of ``src/tools/render_glyph.zig:13-27``).
- ``oracle``        — NumPy float winding oracle, operation-for-operation
  with ``src/tools/render_glyph.zig:35-73`` (the bit-exactness anchor).
- ``winding``          — row-binned winding fill on the XLA route (GPU
  and CPU) and its host binning.
- ``exactmath``        — correctly-rounded f32 div/sqrt emulation.
- ``coverage``         — k x k supersampled coverage (the MSAA analog of
  ``src/VulkanContext.zig:303-371``).
- ``sdf``              — signed-distance output.
- ``loopblinn``        — triangulation-equivalent fill: point-in-triangle
  + implicit-quadratic test (math of ``src/shaders/shader.slang:32-51``).
- ``oracle_exact``     — tie-free exact-integer winding (symbolic
  perturbation).
"""

from fontrx.kernels.grid import RasterGrid  # noqa: F401
