"""The port's steady-state receiver on the CPU: ``Receiver.run`` with
multi-block spans, synchronous and pipelined, against the JAX receiver's
span path on tests/test_fused_scan.py's two-satellite scene (FFT
acquisition, steady mode at 2 tracked), and against the port's own
single-block run on both layouts and the slim2 wire."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu import ReceiverConfig as JReceiverConfig  # noqa: E402
from gnss_sdr_tpu import RfConfig as JRfConfig  # noqa: E402
from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import SatelliteScenario as JSat  # noqa: E402
from gnss_sdr_tpu.receiver import Receiver as JReceiver  # noqa: E402
from gnss_sdr_tpu.receiver import SyntheticSource as JSyntheticSource  # noqa: E402

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch.models import SatelliteScenario  # noqa: E402
from gnss_sdr_tpu_torch.receiver import (  # noqa: E402
    DeviceStreamWindow, Receiver, SyntheticSource)

FS = 2_046_000.0
SATS = [dict(prn=5, doppler_hz=2100.0, amplitude=0.35),
        dict(prn=9, doppler_hz=-1500.0, amplitude=0.35)]
N_BLOCKS = 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(**track_kw):
    return Receiver(
        ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(steady_threshold=2),
            track=TrackConfig(n_channels=4, correlator="fused", **track_kw),
            block_ms=20),
        SyntheticSource([SatelliteScenario(**s) for s in SATS], FS,
                        noise_std=1.0, seed=13), device="cpu")


@pytest.fixture(scope="module")
def jax_span_run():
    """The JAX receiver's synchronous span path (mxu, f32 wire)."""
    rx = JReceiver(
        JReceiverConfig(
            rf=JRfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=JAcqConfig(steady_threshold=2),
            track=JTrackConfig(n_channels=4, correlator="fused",
                               fused_layout="mxu"),
            block_ms=20),
        JSyntheticSource([JSat(**s) for s in SATS], FS, noise_std=1.0,
                         seed=13))
    return rx.run(max_blocks=N_BLOCKS, scan_blocks=4)


def _channels(summary):
    return {c["prn"]: c for c in summary["channels"]}


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["sync", "pipelined"])
def test_span_receiver_matches_jax(jax_span_run, pipelined):
    js = jax_span_run
    rx = _port(fused_layout="mxu")
    s = rx.run(max_blocks=N_BLOCKS, scan_blocks=4, span_pipeline=pipelined)
    assert (rx.fused.layout, rx.fused.wire) == ("mxu", "f32")
    assert s["tracked_prns"] == js["tracked_prns"] == [5, 9]
    assert s["blocks"] == js["blocks"] == N_BLOCKS
    # the spans ran: fewer track-stage calls than blocks
    assert s["stage_timing"]["track"]["calls"] < N_BLOCKS
    jch, ch = _channels(js), _channels(s)
    for prn in (5, 9):
        assert abs(ch[prn]["epochs"] - jch[prn]["epochs"]) <= 1
        d = abs(ch[prn]["last_doppler_hz"] - jch[prn]["last_doppler_hz"])
        print(f"\nPRN {prn} [{'pipelined' if pipelined else 'sync'}]: "
              f"epochs {ch[prn]['epochs']} vs {jch[prn]['epochs']}, "
              f"last Doppler port - JAX = {d} Hz")
        assert d < 1.0
        assert ch[prn]["locked_fraction"] > 0.95


@pytest.mark.parametrize("track_kw", [
    {}, dict(fused_layout="mxu", telemetry_wire="slim2"),
    dict(fused_layout="direct", telemetry_wire="slim")],
    ids=["auto", "mxu-slim2", "direct-slim"])
def test_span_paths_match_single_block(track_kw):
    """Synchronous and pipelined spans against the single-block run of
    the same receiver: the same tracked set and epoch counts, Doppler
    within 1 Hz (the CPU's auto layout is direct with the f32 wire)."""
    runs = {}
    for mode, kw in (("single", {}), ("sync", dict(scan_blocks=4)),
                     ("pipelined", dict(scan_blocks=4,
                                        span_pipeline=True))):
        rx = _port(**track_kw)
        runs[mode] = rx.run(max_blocks=N_BLOCKS, **kw)
    if not track_kw:
        assert (rx.fused.layout, rx.fused.wire) == ("direct", "f32")
    ref = _channels(runs["single"])
    for mode in ("sync", "pipelined"):
        s = runs[mode]
        assert s["tracked_prns"] == runs["single"]["tracked_prns"] == [5, 9]
        assert s["stage_timing"]["track"]["calls"] < N_BLOCKS
        for prn, c in _channels(s).items():
            assert abs(c["epochs"] - ref[prn]["epochs"]) <= (
                1 if mode == "pipelined" else 0)
            assert abs(c["last_doppler_hz"]
                       - ref[prn]["last_doppler_hz"]) < 1.0


def test_span_window_framing_and_device_window_load():
    """_advance_span_window hands the tracker [window tail | fresh
    blocks] and leaves the window at the new frontier; the device window
    takes tensors as they are and checks shapes."""
    rx = _port()
    for _ in range(3):
        assert rx.step()
    tail = rx.window.re[rx.block:].copy()
    g0 = rx.window.global_start
    rng = np.random.default_rng(1)
    blocks = [(rng.normal(size=rx.block).astype(np.float32),
               rng.normal(size=rx.block).astype(np.float32))
              for _ in range(2)]
    sre, sim, g = rx._advance_span_window(blocks)
    assert g == g0
    assert sre.shape == (rx.history + 2 * rx.block,)
    np.testing.assert_array_equal(sre[:rx.history], tail)
    np.testing.assert_array_equal(sre[-rx.block:], blocks[1][0])
    np.testing.assert_array_equal(rx.window.re,
                                  sre[-(rx.history + rx.block):])
    assert rx.window.global_start == g0 + 2 * rx.block
    win = DeviceStreamWindow(8, 4, "cpu")
    x = torch.arange(12, dtype=torch.float32)
    win.load(x, x + 1)
    assert win.re is x or torch.equal(win.re, x)
    with pytest.raises(ValueError, match="shape"):
        win.load(x[:5], x[:5])
