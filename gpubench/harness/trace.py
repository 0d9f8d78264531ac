"""A stretch of the window under ``torch.profiler``, read into what the
per-layer metrics and the result's ``device`` and ``breakdown`` need.

The profiler's Chrome trace gives every kernel, copy and set on the
card with its stream and the correlation id of the host call that
launched it. Kernels launched from inside the generator's range
(``gpubench.generate``), and everything on their streams, are the
benchmark's and not the program's: they are named apart and left out
of the program's busy time. Idle stretches of the card are named by the
innermost host range around them: the benchmark's span of a receiver
step (``gpubench.step.<branch>``) or the receiver's stage
(``stage.<branch>.<stage>``).
"""
from __future__ import annotations

import collections
import json
import os
import time

import torch

from .stats import gaps, union_seconds
from .stream import GENERATE_RANGE

WINDOW_RANGE = "gpubench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"       # torch.cuda._sleep's kernel: names a stream


class Tracer:
    def __init__(self, device, out_dir: str):
        self.device = torch.device(device)
        self.out_dir = out_dir
        self.active = False
        self.summary = None
        self._prof = self._range = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW_RANGE)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        self.active = True

    def stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self.t0
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active = False
        path = os.path.join(self.out_dir,
                            f"gpubench_trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.summary = summarize(events, self.wall_s)
        self._prof = None


def summarize(events, wall_s: float) -> dict:
    """The trace's numbers: the window, the program's busy seconds and
    its device operations by name, the generator's device seconds, the
    graph launches and their kernels, and the idle stretches by host
    range."""
    spans = [e for e in events if e.get("ph") == "X"]
    win = [e for e in spans if e.get("name") == WINDOW_RANGE]
    lo = win[0]["ts"] if win else min(e["ts"] for e in spans)
    hi = lo + (win[0]["dur"] if win else wall_s * 1e6)
    gen_ranges = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                  if e.get("name") == GENERATE_RANGE]
    runtime = [e for e in spans if e.get("cat") == "cuda_runtime"]
    gen_corr, graph_corr = set(), set()
    for e in runtime:
        corr = e.get("args", {}).get("correlation")
        if any(a <= e["ts"] <= b for a, b in gen_ranges):
            gen_corr.add(corr)
        if "GraphLaunch" in e.get("name", ""):
            graph_corr.add(corr)
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    gen_streams = {e.get("args", {}).get("stream") for e in dev
                   if e.get("args", {}).get("correlation") in gen_corr}
    program, generator = [], []
    for e in dev:
        a = e.get("args", {})
        (generator if a.get("stream") in gen_streams
         or a.get("correlation") in gen_corr else program).append(e)

    def clip(e):
        return max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
    busy = [clip(e) for e in program if e["ts"] < hi and
            e["ts"] + e["dur"] > lo]
    ops = collections.Counter()
    counts = collections.Counter()
    for e in program:
        ops[e["name"]] += e["dur"] * 1e-6
        counts[e["name"]] += 1
    gen_s = sum(e["dur"] for e in generator) * 1e-6
    graph_kernels = sum(1 for e in program if e.get("cat") == "kernel"
                        and e.get("args", {}).get("correlation")
                        in graph_corr)
    # idle stretches named by the innermost host range around them
    ranges = [e for e in spans if e.get("cat") == "user_annotation"
              and (e["name"].startswith("stage.")
                   or e["name"].startswith("gpubench.step."))]
    idle = collections.Counter()
    for a, b in gaps(busy, lo, hi):
        mid = 0.5 * (a + b)
        inner = [e for e in ranges if e["ts"] <= mid <= e["ts"] + e["dur"]]
        name = (max(inner, key=lambda e: e["ts"])["name"] if inner
                else "host.outside_steps")
        idle[name] += (b - a) * 1e-6
    device_ops = ops.most_common()
    if gen_s > 0:
        device_ops.append((GENERATE_RANGE, gen_s))
        device_ops.sort(key=lambda kv: -kv[1])
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=union_seconds(busy) * 1e-6,
        device_ops=device_ops,
        kernel_counts=dict(counts),
        generator_s=gen_s,
        graph_launches=len(graph_corr),
        graph_kernels=graph_kernels,
        idle_gaps=idle.most_common(),
    )


def kernel_seconds(summary: dict, match: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels whose name holds
    ``match``."""
    n = sum(c for k, c in summary["kernel_counts"].items() if match in k)
    s = sum(v for k, v in summary["device_ops"] if match in k
            and k != GENERATE_RANGE)
    return n, s


class CardClock:
    """The program's busy time on the card over a whole window: the
    profiler with the card's activity only (no host operations
    recorded), every kernel, copy and set united, those on the
    generator's stream left out. The window is recorded in laps of
    ``LAP_S`` seconds (the profiler stopped, read and started again,
    the card idle between): records of laps five to ten times longer
    came without one of their markers.

    The record dates the card's work by a clock of its own converted to
    the host's, and the conversion strays by some milliseconds from lap
    to lap; the profiler leaves out whatever it dates outside the
    record's span, so a kernel near either end of a lap can be lost.
    Each lap therefore keeps the card idle for ``PAD_S`` at both ends,
    inside the record, and is bracketed by two marker kernels on the
    generator's stream, each run alone: one before the lap's first
    launch and one after its last kernel has ended. A lap whose record
    lacks either marker raises, because kernels near its ends may be
    lost with it. The markers name the generator's stream."""

    LAP_S = 1.0
    PAD_S = 0.025

    def __init__(self, device, side_stream):
        self.device = torch.device(device)
        self.side = side_stream
        self.side_id = None
        self.busy_s = 0.0
        self.ops = 0
        self.laps = 0
        self._prof = None
        self._t_lap = None

    def _mark(self) -> None:
        """A marker kernel on the generator's stream, run alone."""
        torch.cuda.synchronize(self.device)
        with torch.cuda.stream(self.side):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(self.device)

    @staticmethod
    def _idle(seconds: float) -> None:
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            pass

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._idle(self.PAD_S)
        self._mark()
        self._t_lap = time.perf_counter()

    def due(self) -> bool:
        """Whether the lap has lasted ``LAP_S``."""
        return time.perf_counter() - self._t_lap >= self.LAP_S

    def _read(self) -> None:
        """Close the lap's record and count it."""
        self._mark()
        self._idle(self.PAD_S)
        self._prof.__exit__(None, None, None)
        cuda = torch._C._autograd.DeviceType.CUDA
        spans, marks = [], set()
        n_marks = 0
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != cuda:
                continue
            if MARKER in e.name():
                n_marks += 1
                marks.add(e.device_resource_id())
            spans.append((e.start_ns(), e.end_ns(),
                          e.device_resource_id()))
        self._prof = None
        self.laps += 1
        if n_marks != 2 or len(marks) != 1 or (
                self.side_id is not None and marks != {self.side_id}):
            raise RuntimeError(
                f"card clock lap {self.laps}: the record holds {n_marks} "
                f"of its 2 markers, on streams {sorted(marks)}: the lap's "
                "record is not whole")
        self.side_id = marks.pop()
        mine = [(a, b) for a, b, s in spans if s != self.side_id and b > a]
        self.busy_s += union_seconds(mine) * 1e-9
        self.ops += len(mine)

    def stop(self) -> None:
        self._read()

    def lap(self) -> None:
        self._read()
        self.start()
