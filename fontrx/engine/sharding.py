"""Multi-device raster sharding.

The reference is strictly single-GPU (SURVEY §2.8); this module splits
raster work over a ``jax.sharding.Mesh``: a ``glyphs`` axis that shards
the batch dimension of every raster input (each device rasters its
slice of the atlas; XLA all-gathers only if the caller asks for a
replicated result), and a ``rows`` axis of pixel-row bands (one large
page).  Winding is row-local and per-glyph, so no collective runs in
the hot loop.

Every helper runs the XLA route (``kernels/winding.py``) inside
``shard_map``.  Inside a trace the segments are device arrays, so each
shard bins them unculled (``kernels/winding.py:full_rows``).  Tested on
a virtual 8-device CPU mesh (``--xla_force_host_platform_device_count``);
``__graft_entry__.dryrun_multichip`` runs the same path.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fontrx.kernels.winding import full_rows, winding_bins_xla
from fontrx.utils.log import get_logger

log = get_logger("Sharding")

GLYPH_AXIS = "glyphs"
ROW_AXIS = "rows"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the glyph axis (atlas scale-out rides data
    parallelism; no tensor-style sharding is profitable for raster)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[: n_devices]
    return Mesh(np.array(devices), (GLYPH_AXIS,))


def make_mesh_2d(
    n_glyph: int, n_rows: int, devices=None
) -> Mesh:
    """2-D mesh (glyphs x row-bands): data parallelism over the glyph
    batch crossed with spatial parallelism over pixel-row bands — the
    raster analog of DP x SP.  Row bands are independent (winding is
    per-row), so the only collective is the output layout itself."""
    if devices is None:
        devices = jax.devices()
    devices = np.array(devices[: n_glyph * n_rows]).reshape(n_glyph, n_rows)
    return Mesh(devices, (GLYPH_AXIS, ROW_AXIS))


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with their leading (glyph) dim sharded over the
    mesh (the analog of per-glyph staging-buffer uploads,
    ``src/Appli.zig:243-275``, except the upload lands pre-sharded)."""
    sharding = NamedSharding(mesh, P(GLYPH_AXIS))
    return tuple(jax.device_put(a, sharding) for a in arrays)


def _winding(seg, mx, my, scale, height, width, sample_offset=(0.0, 0.0)):
    """Unculled winding maps of one shard."""
    bins = full_rows(seg, height)
    return winding_bins_xla(
        bins.soa, bins.start, bins.count, mx, my,
        jnp.asarray(scale, jnp.float32),
        jnp.asarray(sample_offset, jnp.float32),
        n_bands=bins.n_bands, cap=bins.cap, width=width,
    )[:, :height]


def _glyph_map(fn, mesh, n_in):
    spec = P(GLYPH_AXIS)
    return jax.shard_map(
        fn, mesh=mesh, in_specs=(spec,) * n_in, out_specs=spec,
        # the kernels build loop carries from shard-agnostic zeros;
        # varying-axis tracking would demand pvary noise inside them
        check_vma=False,
    )


def winding_sharded(
    segments, min_x, max_y, scale, *, height: int, width: int, mesh: Mesh,
    replicate_out: bool = False,
):
    """Batched winding maps with the glyph axis sharded over ``mesh``.

    ``B`` must divide by the mesh size (pad with empty glyphs via
    ``pack_glyphs(pad_batch_to=...)``).  Returns ``[B, H, W]`` int32 —
    sharded over glyphs, or replicated when ``replicate_out`` (one
    all-gather).
    """
    out = _glyph_map(
        lambda seg, mx, my: _winding(seg, mx, my, scale, height, width),
        mesh, 3)(segments, min_x, max_y)
    if replicate_out:
        out = jax.lax.with_sharding_constraint(out, NamedSharding(mesh, P()))
    return out


def winding_sharded_2d(
    segments, min_x, max_y, scale, *, height: int, width: int, mesh: Mesh,
):
    """Winding maps sharded over a 2-D (glyphs x row-bands) mesh.

    Each device rasters its glyph shard restricted to its horizontal
    band of the pixel grid — pure SPMD: the band grid is derived from
    ``jax.lax.axis_index(ROW_AXIS)`` (each band's ``max_y`` anchor drops
    by ``band_h`` rows), and the output's row dimension is sharded over
    the same axis, so XLA lays the bands out without any cross-device
    traffic.  ``height`` must divide by the row-axis size; segments are
    replicated along rows (small) and sharded along glyphs.
    """
    n_rows = mesh.shape[ROW_AXIS]
    if height % n_rows:
        raise ValueError(f"height {height} must divide by {n_rows} row shards")
    band_h = height // n_rows

    def local(seg, mx, my):
        band = jax.lax.axis_index(ROW_AXIS)
        return _winding(seg, mx, my - band * band_h, scale, band_h, width)

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(GLYPH_AXIS), P(GLYPH_AXIS), P(GLYPH_AXIS)),
        out_specs=P(GLYPH_AXIS, ROW_AXIS),
        check_vma=False,
    )
    return fn(segments, min_x, max_y)


def sdf_sharded(
    segments, min_x, max_y, scale, *, height: int, width: int, mesh: Mesh,
):
    """SDF atlas with the glyph axis sharded over ``mesh`` — the same
    embarrassing data parallelism as :func:`winding_sharded`.  Returns
    float32 ``[B, H, W]`` signed distances, glyph-sharded."""
    from fontrx.kernels.sdf import sdf_batch

    return _glyph_map(
        lambda seg, mx, my: sdf_batch(seg, mx, my, scale, height=height,
                                      width=width),
        mesh, 3)(segments, min_x, max_y)


def loopblinn_sharded(
    tris, classes, min_x, max_y, scale, *, height: int, width: int,
    mesh: Mesh,
):
    """Triangle-mesh fill with the glyph axis sharded over ``mesh``.
    Returns bool ``[B, H, W]`` coverage, glyph-sharded."""
    from fontrx.kernels.loopblinn import loopblinn_batch

    return _glyph_map(
        lambda tri, cls, mx, my: loopblinn_batch(
            tri, cls, mx, my, scale, height=height, width=width),
        mesh, 4)(tris, classes, min_x, max_y)


def coverage_sharded(
    segments, min_x, max_y, scale, *, height: int, width: int,
    samples: int = 2, mesh: Mesh,
):
    """k x k supersampled coverage with the glyph axis sharded over
    ``mesh``: k^2 sub-pixel-offset passes of the winding route per
    shard.  Returns float32 ``[B, H, W]`` coverage, glyph-sharded."""
    from fontrx.kernels.coverage import sample_offsets

    def local(seg, mx, my):
        hits = sum(
            (_winding(seg, mx, my, scale, height, width, off) != 0)
            .astype(jnp.int32)
            for off in sample_offsets(samples))
        return hits.astype(jnp.float32) / jnp.float32(samples * samples)

    return _glyph_map(local, mesh, 3)(segments, min_x, max_y)


def make_row_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over page pixel-row bands (spatial parallelism for one
    large page — the multi-chip interactive/page path)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[: n_devices]
    return Mesh(np.array(devices), (ROW_AXIS,))


def page_rows_sharded(
    flat_segments, page_h: int, page_w: int, *, mesh: Mesh,
):
    """Direct-page raster with pixel-row BANDS sharded over ``mesh``:
    every device holds the full (replicated) page-space segment set and
    rasters its contiguous band of rows — winding is per-row, so bands
    are independent and the result is bit-identical to the
    single-device page (each row's ``cy`` equals ``page_h - 1 - row``
    regardless of the band split; see ``scene/page.py``).

    ``flat_segments``: float32 ``[1, S, 3, 2]`` page-pixel-space
    segments.  Returns int32 ``[page_h_padded, page_w]`` winding,
    row-sharded; callers crop to ``page_h``."""
    n = mesh.devices.size
    rows_per = -(-page_h // n)

    def local(seg):
        k = jax.lax.axis_index(ROW_AXIS)
        my = jnp.full(1, page_h - 1, jnp.int32) - k * rows_per
        return _winding(seg, jnp.zeros(1, jnp.int32), my, 1.0, rows_per,
                        page_w)[0]

    fn = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(),),
        out_specs=P(ROW_AXIS, None),
        check_vma=False,
    )
    return fn(flat_segments)
