"""Shared benchmark harness.

Each benchmark module measures one scenario and prints JSON lines.  A
timing is the host clock around a call that ends in
``block_until_ready``, after a warm-up call that compiles; every line
names the device it ran on.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEJAVU = str(ROOT / "data" / "fonts" / "DejaVuSans.ttf")
PARA = "The quick brown fox jumps over the lazy dog, flying off 0123456789."


def block(x):
    import jax

    return jax.block_until_ready(x)


def timeit(fn, n: int = 10, warmup: int = 1) -> dict:
    """Seconds per call of ``fn()`` (its result is waited for): the
    median, the 90th percentile and the sample count, after ``warmup``
    calls that compile."""
    for _ in range(warmup):
        block(fn())
    samples = []
    for _ in range(n):
        t0 = time.perf_counter()
        block(fn())
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return {"median_s": statistics.median(samples),
            "p90_s": samples[min(n - 1, int(0.9 * n))], "n": n}


def device_info() -> dict:
    """The device every number is measured on (and the card's power
    limit, which bounds its clocks under load)."""
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    if dev.platform == "gpu":
        info["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    return info


def emit(config: str, metric: str, value: float, unit: str, **extra) -> dict:
    out = {"config": config, "metric": metric, "value": value, "unit": unit}
    out.update(extra)
    print(json.dumps(out), flush=True)
    return out


def setup_cache():
    from fontrx.engine.cache import enable_compilation_cache

    enable_compilation_cache()


def editor_session(font, engine, n_para: int = 150, size=(1920, 1080),
                   px_per_em: float = 16.0):
    """The editor workload: ``n_para`` paragraphs of ``PARA`` (150 make
    10,200 characters) with kern + liga + marks and GPOS kern/mark/mkmk
    in a direct-mode session, zoomed about the top-left corner to
    ``px_per_em`` and panned so the end of the text — where typing
    lands — sits near the page bottom."""
    import math

    from fontrx.scene.interactive import InteractiveSession
    from fontrx.scene.transform import ZOOM_FACTOR

    sess = InteractiveSession(
        font, "\n".join(PARA for _ in range(n_para)), size[0], size[1],
        engine, mode="direct", kern=True, ligatures=True, marks=True,
        positioning=(b"kern", b"mark", b"mkmk"),
    )
    upem = font.info.units_per_em
    now = sess.view.scale[0] * upem * sess.width / 2.0
    sess.view = sess.view.zoomed(
        math.log(px_per_em / now) / math.log(ZOOM_FACTOR), (-1.0, 1.0))
    v = sess.view
    last_y = float(sess.layout.instance_arrays()[1][:, 1].min())
    sess.view = v.dragged(
        0.0, (-0.85 / v.aspect_ratio - last_y * v.scale[1] - v.offset[1])
        * v.aspect_ratio)
    return sess
