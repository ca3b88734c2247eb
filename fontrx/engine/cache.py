"""Compilation-cache persistence.

The analog of the reference's Vulkan pipeline-cache store
(``src/CacheManager.zig``): where the reference persists
``vkGetPipelineCacheData`` blobs per pipeline under ``<exe>/.cache`` and
reloads them as initial data, we wire up the **XLA persistent
compilation cache** so jitted raster executables survive process
restarts.  Enabled by the ``-c`` flag (``Config.zig:12`` semantics) and
by the benchmark and smoke scripts.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when the
environment sets it (JAX then reads it itself and nothing here
overrides it), else a fixed, git-ignored directory inside the checkout
(``.cache/xla`` at the repository root) — a fixed path, because the
path is part of the cache key.

The staleness story the reference implements by MD5-diffing the cache
blob (``CacheManager.zig:163-188``) is handled by XLA itself: cache
keys include the HLO fingerprint, compiler version, and device kind.
"""

from __future__ import annotations

import os
import pathlib

from fontrx.utils.log import get_logger

log = get_logger("CacheManager")

CHECKOUT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".cache" / "xla"


def cache_dir(directory: str | None = None) -> str:
    """The cache directory in use: the environment's, else
    ``directory``, else the checkout's."""
    return str(os.environ.get("JAX_COMPILATION_CACHE_DIR")
               or directory or CHECKOUT_DIR)


def enable_compilation_cache(directory: str | None = None) -> str:
    """Enable the persistent XLA compilation cache.  Returns the cache
    directory in use."""
    import jax

    directory = cache_dir(directory)
    pathlib.Path(directory).mkdir(parents=True, exist_ok=True)
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", directory)
    # cache even fast compiles — raster kernels are small but recompiled
    # per shape bucket
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    log.info("XLA compilation cache at %s", directory)
    return directory


def cache_stats(directory: str | None = None) -> dict:
    """Report cache contents (entry count / bytes) for observability."""
    p = pathlib.Path(cache_dir(directory))
    if not p.exists():
        return {"entries": 0, "bytes": 0, "dir": str(p)}
    files = [f for f in p.rglob("*") if f.is_file()]
    return {
        "entries": len(files),
        "bytes": sum(f.stat().st_size for f in files),
        "dir": str(p),
    }
