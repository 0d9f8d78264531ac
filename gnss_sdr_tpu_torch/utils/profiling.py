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

import torch
import torch.autograd.profiler as _autograd_profiler


# A stage's range is of the user scope, as torch.profiler.record_function
# opens one (the same name and category in a trace), but opened without
# record_function's dispatcher op: on the H100's host 2-11 us a range
# against its 9-19 us (PERF.md).
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit


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
    """Accumulating wall-clock timer keyed by stage name.

    A sub-step is a stage with a dotted name (``track.wait``) entered
    inside its parent stage (``track``): ``stats`` holds it beside the
    parent, whose total includes it. While a profiler records (``trace``
    below, or any ``torch.profiler.profile``), each interval is also a
    profiler range named ``stage.<prefix>.<name>`` (``prefix``: the
    receiver's signal, so each branch of a multi-constellation receiver
    names its own), on the profiler's clock beside the card's activity.
    With no profiler running a stage makes one state check and opens
    no range."""

    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.stats: dict[str, StageStats] = defaultdict(StageStats)

    def stage(self, name: str, items: float = 0.0) -> "_Stage":
        """A context manager: one interval of stage ``name``, counting
        ``items`` (samples, epochs, ...)."""
        return _Stage(self, name, items)

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


class _Stage:
    """One interval of a StageTimer stage. The clock starts before the
    profiler range opens and stops after it closes, so a range's cost
    shows in the stage's total."""

    __slots__ = ("timer", "name", "items", "t0", "rng")

    def __init__(self, timer: StageTimer, name: str, items: float):
        self.timer, self.name, self.items = timer, name, items
        self.rng = None

    def __enter__(self) -> None:
        self.t0 = time.perf_counter()
        # the flag torch.autograd.profiler keeps while any profiler runs,
        # its cheapest check (a profiler of the card alone sets it too)
        if _autograd_profiler._is_profiler_enabled:
            prefix = self.timer.prefix
            self.rng = _range_enter(f"stage.{prefix}.{self.name}" if prefix
                                    else f"stage.{self.name}")

    def __exit__(self, *exc) -> None:
        if self.rng is not None:
            _range_exit(self.rng)
        s = self.timer.stats[self.name]
        s.calls += 1
        s.total_s += time.perf_counter() - self.t0
        s.items += self.items


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator:
    """Profile the block's host ops, and its CUDA kernels and copies
    where a card is present, into ``log_dir/trace_<pid>_<ns>.json``, a
    Chrome trace that Perfetto and chrome://tracing open. Yields the
    ``torch.profiler.profile`` object (``key_averages()``, ``events()``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
