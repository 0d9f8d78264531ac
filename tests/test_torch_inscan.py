"""The in-scan search of the PyTorch port (ROADMAP A11): with the conv
acquisition engine and the fused tracker, the steady re-search is queued
inside each span (``FusedTracker.span_extra``) and its candidates come
down with the span's telemetry; synchronous spans hand them off at once,
pipelined spans apply them to the ledger on the card one span late. On
the CPU, the scene of tests/test_span_acq.py (PRN 4 rises at 0.24 s)
runs through the port's and the JAX package's receivers, on synchronous
and pipelined spans: the same acquisition events (PRN, and ms within
one span's latency), the same tracked set, each PRN's Doppler over the
last 20 epochs within the JAX suite's 5 Hz, and the same search stages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu import config as jcfg  # noqa: E402
from gnss_sdr_tpu.receiver import ArraySource as JArraySource  # noqa: E402
from gnss_sdr_tpu.receiver import Receiver as JReceiver  # noqa: E402
from tests.test_span_acq import FS, _rising_scene  # noqa: E402

from gnss_sdr_tpu_torch import config as tcfg  # noqa: E402
from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver  # noqa: E402

SECONDS = 0.6                       # PRN 4 rises at 0.24 s
SPAN = 4
BLOCK_MS = 20
RISER = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod):
    return mod.ReceiverConfig(
        rf=mod.RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=mod.AcqConfig(engine="conv", steady_threshold=2,
                          steady_pacing=(200, 8)),
        track=mod.TrackConfig(n_channels=4, correlator="fused",
                              fused_layout="mxu"),
        block_ms=BLOCK_MS)


@pytest.fixture(scope="module")
def runs():
    """{(package, pipelined): (receiver, summary)} on the rising scene."""
    sig = _rising_scene()[:int(SECONDS * FS)]
    out = {}
    for pipe in (False, True):
        rx = Receiver(_cfg(tcfg), ArraySource(sig, FS), device="cpu")
        out["port", pipe] = rx, rx.run(scan_blocks=SPAN, span_pipeline=pipe)
        rx = JReceiver(_cfg(jcfg), JArraySource(sig, FS))
        out["jax", pipe] = rx, rx.run(scan_blocks=SPAN, span_pipeline=pipe)
    return out


def _settled(rx, prn, n=20):
    """A PRN's mean carrier frequency over its last ``n`` epochs."""
    tr = rx.telemetry.traces[rx.active[prn]]
    return float(np.mean(tr.carr_freq[-n:]))


@pytest.mark.parametrize("pipe", [False, True],
                         ids=["synchronous", "pipelined"])
def test_rising_satellite_acquired_in_scan_as_in_jax(runs, pipe):
    """The riser is acquired by a span's own search in both packages, at
    the same PRN events (times within one span), and the receivers end
    with the same tracked set, epochs and settled Doppler."""
    (rx, s), (jrx, js) = runs["port", pipe], runs["jax", pipe]
    assert rx._span_acq and jrx._span_acq
    assert s["tracked_prns"] == js["tracked_prns"] == [3, 4, 7]
    ev = [(round(t), c.prn) for t, c in rx.acq_events]
    jev = [(round(t), c.prn) for t, c in jrx.acq_events]
    assert [p for _, p in ev] == [p for _, p in jev]
    for (t, _), (jt, _) in zip(ev, jev):
        assert abs(t - jt) <= SPAN * BLOCK_MS
    rise = [t for t, p in ev if p == RISER]
    assert rise and rise[0] >= 240
    for a, b in zip(rx.acq_events, jrx.acq_events):
        assert a[1].code_phase_samples == b[1].code_phase_samples
        assert abs(a[1].carrier_freq_hz - b[1].carrier_freq_hz) < 8.0
    ch = {c["prn"]: c for c in s["channels"]}
    jch = {c["prn"]: c for c in js["channels"]}
    for prn in (3, 4, 7):
        assert ch[prn]["epochs"] == jch[prn]["epochs"]
        assert abs(_settled(rx, prn) - _settled(jrx, prn)) < 5.0
    assert abs(ch[RISER]["last_doppler_hz"] - 1300.0) < 60
    assert rx.fused.last_span_extra is not None or pipe
    # the search ran in the spans: the boundary search never did
    # the port's own host stages and dotted sub-steps aside, the same
    # stages ran in both receivers
    port = {k for k in s["stage_timing"] if "." not in k}
    assert port - {"window", "lifecycle"} == set(js["stage_timing"])
    assert s["stage_timing"]["acquire"]["calls"] == \
        js["stage_timing"]["acquire"]["calls"]


def test_pipelined_matches_synchronous_spans(runs):
    """Within the port, as tests/test_span_pipeline.py holds the JAX
    receiver: the pipelined run tracks what the synchronous run tracks,
    each PRN's last Doppler within 5 Hz, its epochs within one, and the
    riser's handoff through the ledger on the card (one span later)."""
    (ra, sa), (rb, sb) = runs["port", False], runs["port", True]
    assert sb["tracked_prns"] == sa["tracked_prns"]
    assert sb["blocks"] == sa["blocks"]
    ca = {c["prn"]: c for c in sa["channels"]}
    cb = {c["prn"]: c for c in sb["channels"]}
    for prn in (3, 7):
        assert abs(cb[prn]["last_doppler_hz"]
                   - ca[prn]["last_doppler_hz"]) < 5.0
        assert abs(cb[prn]["epochs"] - ca[prn]["epochs"]) <= 1
    ta = [t for t, c in ra.acq_events if c.prn == RISER][0]
    tb = [t for t, c in rb.acq_events if c.prn == RISER][0]
    assert ta <= tb <= ta + 2 * SPAN * BLOCK_MS
    np.testing.assert_array_equal(np.asarray(rb.state.prn_idx),
                                  np.asarray(ra.state.prn_idx))
