"""Phase timer for hot-loop profiling.

Flag-controlled equivalent of the reference's global nanosecond phase
timer (``src/helpers.zig:284-299``), whose call sites were committed but
commented out; here enablement is a constructor flag / env var instead
(SURVEY §5.1).  Also provides ``trace`` — a context manager that both
phase-times and emits a ``jax.profiler`` TraceAnnotation so phases show
up in device profiles.
"""

from __future__ import annotations

import contextlib
import os
import time

from fontrx.utils.log import get_logger

log = get_logger("timer")


class PhaseTimer:
    """Records named phase durations between ``restart()`` and ``report()``.

    >>> t = PhaseTimer(enabled=True)
    >>> t.restart()
    >>> t.phase("parse")
    >>> t.phase("raster")
    >>> t.report()
    """

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = bool(os.environ.get("FONTRX_TIMER"))
        self.enabled = enabled
        self._last = 0
        self._phases: list[tuple[str, int]] = []

    def restart(self) -> None:
        if not self.enabled:
            return
        self._phases.clear()
        self._last = time.perf_counter_ns()

    def phase(self, name: str) -> None:
        if not self.enabled:
            return
        now = time.perf_counter_ns()
        self._phases.append((name, now - self._last))
        self._last = now

    def report(self) -> None:
        if not self.enabled:
            return
        for name, ns in self._phases:
            log.info("%s |> %d ns", name, ns)

    @contextlib.contextmanager
    def trace(self, name: str):
        """Time a block and annotate it in the JAX profiler timeline."""
        if not self.enabled:
            yield
            return
        import jax.profiler

        start = time.perf_counter_ns()
        with jax.profiler.TraceAnnotation(name):
            yield
        self._phases.append((name, time.perf_counter_ns() - start))
