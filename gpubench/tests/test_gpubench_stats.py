"""The metrics' arithmetic on synthetic timings: a rate over the whole
window, a nearest-rank tail, the union of device intervals, the idle
share and idle stretches of a synthetic trace, and the card clock's
laps on a synthetic record."""
import contextlib
from types import SimpleNamespace

import pytest
import torch

from gpubench.harness import stats, trace
from gpubench.harness.trace import GENERATE_RANGE, WINDOW_RANGE, summarize


def test_rate_is_all_work_over_all_time():
    assert stats.rate(30.0, 12.0) == 2.5
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2, 4], 50) == 2


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_seconds(iv) == 4
    assert stats.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def _ev(name, ts, dur, cat, **args):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, args=args)


def test_trace_idle_share_and_names():
    events = [
        _ev(WINDOW_RANGE, 0, 1000, "user_annotation"),
        _ev("stage.gps.track", 100, 400, "user_annotation"),
        _ev("gpubench.step.gps", 50, 590, "user_annotation"),
        _ev("cudaLaunchKernel", 110, 5, "cuda_runtime", correlation=1),
        _ev("cudaGraphLaunch", 120, 5, "cuda_runtime", correlation=2),
        _ev(GENERATE_RANGE, 700, 50, "user_annotation"),
        _ev("cudaLaunchKernel", 710, 5, "cuda_runtime", correlation=3),
        _ev("k_a", 200, 100, "kernel", correlation=1, stream=7),
        _ev("k_b", 250, 100, "kernel", correlation=2, stream=7),
        _ev("k_b", 360, 40, "kernel", correlation=2, stream=7),
        _ev("gen", 720, 200, "kernel", correlation=3, stream=9),
        _ev("Memcpy HtoD", 900, 100, "gpu_memcpy", correlation=4, stream=7),
    ]
    t = summarize(events, 0.001)
    assert t["window_s"] == pytest.approx(1e-3)
    # program intervals: [200, 350) [360, 400) [900, 1000): 290 us busy
    assert t["busy_s"] == pytest.approx(290e-6)
    assert t["generator_s"] == pytest.approx(200e-6)
    assert t["graph_launches"] == 1 and t["graph_kernels"] == 2
    idle = dict(t["idle_gaps"])
    # gaps [0,200) mid 100 -> the stage; [350,360) -> the stage;
    # [400,900) mid 650 -> outside every range
    assert idle["stage.gps.track"] == pytest.approx(210e-6)
    assert idle["host.outside_steps"] == pytest.approx(500e-6)
    names = [k for k, _ in t["device_ops"]]
    assert GENERATE_RANGE in names and "gen" not in names


def _recorded(monkeypatch, laps):
    """The card's record of each lap as ``laps`` gives it: (kernel,
    start, end, stream) a kernel; the card's calls do nothing."""
    cuda = torch._C._autograd.DeviceType.CUDA

    def event(name, a, b, stream):
        return SimpleNamespace(device_type=lambda: cuda, name=lambda: name,
                               start_ns=lambda: a, end_ns=lambda: b,
                               device_resource_id=lambda: stream)

    class Profile(contextlib.nullcontext):
        def __init__(self, activities):
            super().__init__()
            lap = laps.pop(0)
            self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
                events=lambda: [event(*e) for e in lap]))
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(trace.CardClock, "PAD_S", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())


def test_card_clock_counts_whole_laps_without_the_generator(monkeypatch):
    """Each lap's record holds its two markers on the generator's
    stream; the program's kernels on every other stream are united."""
    m = trace.MARKER
    _recorded(monkeypatch, [
        [(m, 0, 1, 9), ("k", 2, 12, 7), ("gen", 0, 40, 9), (m, 50, 51, 9)],
        [(m, 0, 1, 9), ("k", 2, 22, 7), ("k", 5, 30, 8), (m, 60, 61, 9)]])
    clock = trace.CardClock("cpu", None)
    clock.start()
    clock.lap()
    clock.stop()
    assert clock.laps == 2 and clock.ops == 3 and clock.side_id == 9
    assert clock.busy_s == pytest.approx((10 + 28) * 1e-9)


@pytest.mark.parametrize("lap", [
    [("k", 2, 12, 7), (trace.MARKER, 50, 51, 9)],
    [(trace.MARKER, 0, 1, 9), ("k", 2, 12, 7)],
    [(trace.MARKER, 0, 1, 9), ("k", 2, 12, 7), (trace.MARKER, 50, 51, 8)],
])
def test_card_clock_refuses_a_lap_whose_record_is_not_whole(monkeypatch,
                                                            lap):
    """A lap's record that lacks its first or its last marker, or holds
    them on two streams, raises."""
    _recorded(monkeypatch, [lap])
    clock = trace.CardClock("cpu", None)
    clock.start()
    with pytest.raises(RuntimeError, match="not whole"):
        clock.stop()


def test_card_clock_refuses_a_lap_on_another_stream(monkeypatch):
    m = trace.MARKER
    _recorded(monkeypatch, [[(m, 0, 1, 9), (m, 5, 6, 9)],
                            [(m, 0, 1, 7), (m, 5, 6, 7)]])
    clock = trace.CardClock("cpu", None)
    clock.start()
    clock.lap()
    with pytest.raises(RuntimeError, match="not whole"):
        clock.stop()
