"""The harness in spans, on the CPU: a small copy of the ``gps32_fused``
cells (4 channels, 20 ms blocks, spans of 2, a steady search every
200 ms so that a span hands a satellite off; ``tests/data``) runs in
both span modes, stops at its deadline, counts its blocks, keys the
telemetry once a block, and reads ``correct`` true; the control and
planted faults read it false: a ledger carried wrong between two blocks
of a span, a pipelined handoff applied a span later than the program
applies it, an in-scan search's ratio changed."""
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench.harness import checks, spec
from gpubench.harness.cell import run_cell

DATA = Path(__file__).resolve().parent / "data"
SEED = 1234567
SECONDS = 1.5


def _bench():
    bench = dict(spec.load_benchmark())
    bench["configs"] = bench["configs"] + [{
        "name": "gps4_spans", "source": "gpubench/tests/data",
        "file": "gpubench/tests/data/gps4_spans.json", "reduced": [],
        "why": "a test configuration"}]
    bench["workloads"] = [
        {"name": f"gps4.{t}", "config": "gps4_spans", "traffic": t,
         "chips": 1, "why": "a test cell"}
        for t in ("spans2", "spans2_pipelined")]
    return bench


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(spec, "load_traffic", lambda name, bench_dir=None:
                        spec.load_json(DATA / f"{name}.json"))

    def run(traffic, seconds=SECONDS):
        return run_cell(_bench(), f"gps4.{traffic}", SEED, seconds, False,
                        device="cpu", log=lambda m: None)
    return run


def _numbers(run):
    ok, numbers = checks.check(run, log=lambda m: None)
    return ok, {k: v for k, (v, _) in numbers.items()}


@pytest.mark.parametrize("traffic", ["spans2", "spans2_pipelined"])
def test_spans_run_sound(small, traffic):
    run = small(traffic)
    (br,) = run.branches.values()
    # the deadline stops the run within a span or two
    assert SECONDS <= run.window_s < SECONDS + 2.0
    # blocks, not units: every block of the window has its telemetry
    # summary once, keyed by its own number
    ids = list(run.window_block_ids())
    assert run.window_blocks == len(br.step_s) * run.span_blocks
    assert sorted(br.summary) == list(range(1, ids[-1] + 1))
    assert br.appended == ids[-1]
    # a span in the window handed a satellite off
    assert any(s["kind"] == "span" and s["handed"] for s in br.searches)
    ok, numbers = _numbers(run)
    assert ok, numbers
    assert len(br.sampled) == 3


def test_control_fails_a_limit(small):
    run = small("spans2_pipelined")
    ok, _ = _numbers(run)
    assert ok
    acq, _, _ = checks.check_acq(run, 4, control=True)
    trk, loop, _, _ = checks.check_tracking(run, control=True)
    limits = run.config["limits"]
    control = dict(acq_gap=acq, track_gap=trk, loop_gap_hz=loop)
    assert any(v > limits[k] for k, v in control.items()), control


def test_ledger_carried_wrong_inside_a_span(small, monkeypatch):
    from gnss_sdr_tpu_torch.receiver.fused_runner import FusedTracker

    orig = FusedTracker._scan_block

    def broken(self, led, b, *a, **kw):
        led_n, y = orig(self, led, b, *a, **kw)
        if b == 0:
            # a quarter cycle of carrier phase lost between the blocks
            cols = led_n[5].clone()
            cols[:, 1] = torch.remainder(cols[:, 1] + 0.25, 1.0)
            led_n = (*led_n[:5], cols)
        return led_n, y
    monkeypatch.setattr(FusedTracker, "_scan_block", broken)
    ok, numbers = _numbers(small("spans2"))
    assert not ok and numbers["track_gap"] > 0.1, numbers


def test_pipelined_handoff_a_span_late(small, monkeypatch):
    from gnss_sdr_tpu_torch.receiver.pipeline import Receiver

    orig = Receiver._pipeline_quick

    def late(self, extra, rowmap=None):
        before = list(self._pipeline_handoffs)
        orig(self, extra, rowmap)
        new = self._pipeline_handoffs[len(before):]
        self._pipeline_handoffs = before + getattr(self, "_late", [])
        self._late = new
    monkeypatch.setattr(Receiver, "_pipeline_quick", late)
    run = small("spans2_pipelined")
    (br,) = run.branches.values()
    assert any(s["kind"] == "span" and s["handed"] for s in br.searches)
    ok, numbers = _numbers(run)
    assert not ok and numbers["track_gap"] == 1.0, numbers


def test_in_scan_search_ratio_changed(small, monkeypatch):
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    orig = AcquisitionEngine.conv_search_device

    def broken(self, *a, **kw):
        res = orig(self, *a, **kw)
        return res._replace(ratio=res.ratio * 1.01)
    monkeypatch.setattr(AcquisitionEngine, "conv_search_device", broken)
    ok, numbers = _numbers(small("spans2"))
    assert not ok and numbers["acq_gap"] > 1e-3, numbers


def test_block_summaries_link_across_a_skipped_period():
    """carries_on_blocks: one code period on, or as many as the offset
    walk skipped, +-2 samples; a lost channel is not followed; a channel
    that stops or jumps fails."""
    n0 = 2046

    def summ(gs, so_first, so_last, ei_first, ei_last, lost=False):
        one = lambda v, t=np.int64: np.array([v], t)  # noqa: E731
        return (gs, one(True, bool), one(lost, bool), one(so_first),
                one(so_last), one(ei_first), one(ei_last))
    a = summ(0, 100, 100 + 19 * n0, 0, 19)
    assert checks.carries_on_blocks(a, summ(20 * n0, 101, 0, 20, 39), n0)
    assert checks.carries_on_blocks(a, summ(20 * n0, 101 + n0, 0, 21, 40),
                                    n0)
    assert not checks.carries_on_blocks(a, summ(20 * n0, 104, 0, 20, 39),
                                        n0)
    assert not checks.carries_on_blocks(a, summ(20 * n0, 101, 0, 19, 39),
                                        n0)
    gone = (20 * n0, np.array([False]), np.array([False]), *a[3:])
    assert not checks.carries_on_blocks(a, gone, n0)
    lost = summ(0, 100, 100 + 19 * n0, 0, 19, lost=True)
    assert checks.carries_on_blocks(lost, gone, n0)
