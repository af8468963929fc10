"""Observability: stage timers, throughput counters, device profiler.

The reference has no tracing/profiling at all (SURVEY.md §5); these are
the batched-build equivalents promised there: jax.profiler traces for device
timelines plus lightweight host-side counters.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional


class StageTimers:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {t*1e3:9.1f} ms total  "
                         f"{t/n*1e3:8.2f} ms/call  x{n}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """jax.profiler trace scope (view with TensorBoard / xprof)."""
    import jax

    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
