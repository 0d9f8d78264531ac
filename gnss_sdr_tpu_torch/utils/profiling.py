"""Structured per-stage timing + torch.profiler traces.

The reference's only observability is ad-hoc Instant prints inside
tests (SURVEY.md section 5); here timing is a first-class subsystem: a
``StageTimer`` accumulates wall-time and throughput per pipeline stage,
and ``trace()`` wraps ``torch.profiler`` for Chrome/Perfetto-compatible
host and device traces (the JAX package's ``jax.profiler`` trace).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Iterator


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0
    items: float = 0.0      # user-defined unit (samples, epochs, ...)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.calls, 1)

    @property
    def items_per_s(self) -> float:
        return self.items / self.total_s if self.total_s > 0 else 0.0


class StageTimer:
    """Accumulating wall-clock timer keyed by stage name."""

    def __init__(self):
        self.stats: dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str, items: float = 0.0) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            s = self.stats[name]
            s.calls += 1
            s.total_s += time.perf_counter() - t0
            s.items += items

    def report(self) -> dict[str, dict]:
        return {
            name: {
                "calls": s.calls,
                "total_s": round(s.total_s, 6),
                "mean_ms": round(s.mean_s * 1e3, 4),
                "items_per_s": round(s.items_per_s, 1),
            }
            for name, s in sorted(self.stats.items())
        }

    def realtime_factor(self, stage: str, fs_hz: float) -> float:
        """Signal-seconds per wall-second for a stage whose items are
        IQ samples."""
        s = self.stats[stage]
        return s.items_per_s / fs_hz if fs_hz else 0.0



@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """Profile the block's host ops, and its CUDA kernels and copies
    where a card is present, into ``log_dir/trace_<pid>_<ns>.json``, a
    Chrome trace that Perfetto and chrome://tracing open. Yields the
    ``torch.profiler.profile`` object (``key_averages()``, ``events()``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
