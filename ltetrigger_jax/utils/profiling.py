"""Tracing and per-stage timing — the observability layer the reference
lacks entirely (SURVEY §5: 'Tracing/profiling: none', muted tag_debug taps
and commented printfs).

Two tools:
  * `trace(dir)` — context manager around jax.profiler for full XLA/device
    traces viewable in TensorBoard/Perfetto;
  * `StageTimer` — lightweight named wall-clock accumulators for the host
    driver's stages (gather/step/drain), queryable like the reference's
    block telemetry probes.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a jax.profiler device trace into `log_dir`."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Decorator: mark a function as a named region in device traces."""
    import jax

    def deco(fn):
        return jax.profiler.annotate_function(fn, name=name)

    return deco


class StageTimer:
    """Accumulates wall-clock per named stage; thread-unsafe by design (one
    per driver thread, like GR's per-block perf counters)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
