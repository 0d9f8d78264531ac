"""The metrics' arithmetic on synthetic timings: a rate over the whole
window, a nearest-rank tail, the union of device intervals and the
idle share and idle stretches of a synthetic trace."""
import pytest

from gpubench.harness import stats
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
