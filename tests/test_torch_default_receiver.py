"""The port's receiver in the JAX package's default configuration (the
scanned tracker, ``correlator="shift"``) and its IF-capture
configuration, against the JAX receiver on the CPU: tests/test_pipeline.py's
scene, the end-of-stream block count, the dropout and reacquisition, the
int8 IF capture through the front end, the fused path's partial last
block, ``scan_blocks > 1`` with a non-fused correlator, and checkpoint
resume.

Each comparison: the same acquisition events (PRN, handoff sample), the
same tracked PRNs, equal per-PRN epoch counts and the last Doppler within
1 Hz (measured margins printed with ``-s``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.config import ReceiverConfig as JReceiverConfig  # noqa: E402
from gnss_sdr_tpu.config import RfConfig as JRfConfig  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.receiver import ArraySource as JArraySource  # noqa: E402
from gnss_sdr_tpu.receiver import FileSource as JFileSource  # noqa: E402
from gnss_sdr_tpu.receiver import Receiver as JReceiver  # noqa: E402

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    SatelliteScenario, synthesize, synthesize_real_if_int8)
from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5  # noqa: E402
from gnss_sdr_tpu_torch.receiver import (  # noqa: E402
    ArraySource, FileSource, Receiver)
from gnss_sdr_tpu_torch.utils import checkpoint  # noqa: E402

FS = 4_096_000.0
TRUTH = [(3, -2800.0, 101.5, 0.30), (14, 1200.0, 512.0, 0.25),
         (21, 4500.0, 900.25, 0.28), (30, -500.0, 33.0, 0.22)]
PORT = dict(ReceiverConfig=ReceiverConfig, RfConfig=RfConfig,
            AcqConfig=AcqConfig, TrackConfig=TrackConfig)
JAXP = dict(ReceiverConfig=JReceiverConfig, RfConfig=JRfConfig,
            AcqConfig=JAcqConfig, TrackConfig=JTrackConfig)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, fs=FS, block_ms=20, n_channels=8, track_kw=None, rf_kw=None,
         acq_kw=None):
    rf = {"freq_if_hz": 0.0, "output_sample_rate_hz": fs, **(rf_kw or {})}
    return mod["ReceiverConfig"](
        rf=mod["RfConfig"](**rf),
        acq=mod["AcqConfig"](**(acq_kw or {})),
        track=mod["TrackConfig"](n_channels=n_channels, **(track_kw or {})),
        block_ms=block_ms)


def _pair(samples, fs=FS, run_kw=None, **cfg_kw):
    """The JAX and the port receiver on the same samples (CPU)."""
    jrx = JReceiver(_cfg(JAXP, fs, **cfg_kw), JArraySource(samples, fs))
    rx = Receiver(_cfg(PORT, fs, **cfg_kw), ArraySource(samples, fs),
                  device="cpu")
    return jrx, jrx.run(**(run_kw or {})), rx, rx.run(**(run_kw or {}))


def assert_same_run(jrx, js, rx, s):
    """The comparison of the module docstring; returns the largest
    |Doppler difference| (Hz)."""
    assert [(c.prn, c.sample_local_index) for _, c in rx.acq_events] == \
        [(c.prn, c.sample_local_index) for _, c in jrx.acq_events]
    assert s["tracked_prns"] == js["tracked_prns"]
    assert s["blocks"] == js["blocks"]
    jch = sorted(js["channels"], key=lambda c: (c["prn"], c["epochs"]))
    ch = sorted(s["channels"], key=lambda c: (c["prn"], c["epochs"]))
    assert [(c["prn"], c["epochs"]) for c in ch] == \
        [(c["prn"], c["epochs"]) for c in jch]
    worst = 0.0
    for a, b in zip(ch, jch):
        if b["last_doppler_hz"] is not None:
            worst = max(worst, abs(a["last_doppler_hz"]
                                   - b["last_doppler_hz"]))
    print(f"\nlast Doppler, port - JAX: <= {worst:.6f} Hz")
    assert worst < 1.0
    return worst


@pytest.fixture(scope="module")
def pipeline_scene():
    """tests/test_pipeline.py's scene: 4 satellites at 4.096 MHz, 0.5 s."""
    sats = [dict(prn=p, doppler_hz=d, code_phase_chips=c, amplitude=a)
            for p, d, c, a in TRUTH]
    sig = synthesize([SatelliteScenario(**k) for k in sats], int(0.5 * FS),
                     FS, noise_std=1.0, seed=7)
    return _pair(sig, acq_kw=dict(non_coherent_ms=10))


def test_default_config_matches_jax(pipeline_scene):
    jrx, js, rx, s = pipeline_scene
    assert rx.cfg.track.correlator == "shift" and rx.fused is None
    assert s["tracked_prns"] == [3, 14, 21, 30]
    assert_same_run(jrx, js, rx, s)
    truth = {p: d for p, d, *_ in TRUTH}
    for t in rx.telemetry.all_traces():
        assert abs(np.mean(t.carr_freq[-50:]) - truth[t.prn]) < 5.0
        assert len(t.i_p) >= 100


def test_eos_gives_three_blocks():
    """50 ms at 20 ms blocks: 2 full and 1 zero-padded partial block."""
    jrx, js, rx, s = _pair(np.zeros(int(0.05 * FS), np.complex64))
    assert s["blocks"] == js["blocks"] == 3


def test_dropout_and_reacquire():
    sats = [dict(prn=9, doppler_hz=1000.0, amplitude=0.3)]
    n_on = int(0.3 * FS)
    on = synthesize([SatelliteScenario(**k) for k in sats], n_on, FS,
                    noise_std=1.0, seed=1)
    off = synthesize([], int(0.2 * FS), FS, noise_std=0.005, seed=2)
    on2 = synthesize([SatelliteScenario(**k) for k in sats], n_on, FS,
                     noise_std=1.0, seed=3, start_sample=n_on)
    jrx, js, rx, s = _pair(np.concatenate([on, off, on2]),
                           acq_kw=dict(non_coherent_ms=10))
    assert_same_run(jrx, js, rx, s)
    assert set(rx.active) == {9}
    assert len([t for t in rx.telemetry.all_traces() if t.prn == 9]) == 2


def test_if_capture_mix_decimate_track(tmp_path):
    """int8 real samples at 16.368 MHz with a 4.092 MHz IF, DC removal,
    mixed to baseband and decimated 4x: tracked as the JAX receiver
    tracks it (tests/test_pipeline.py::TestFrontEndIntegration)."""
    fs_in, f_if, m = 16_368_000.0, 4_092_000.0, 4
    raw = synthesize_real_if_int8(
        [SatelliteScenario(prn=23, doppler_hz=-1800.0,
                           code_phase_chips=250.0, amplitude=0.22)],
        int(0.35 * fs_in), fs_in, f_if, noise_std=1.0, scale=25.0)
    path = os.path.join(tmp_path, "cap.bin")
    with open(path, "wb") as f:
        f.write(raw.tobytes())
    kw = dict(rf_kw=dict(freq_if_hz=f_if, enable_dc_removal=True,
                         enable_mixing=True, decimation=m),
              n_channels=4)
    jsrc, src = JFileSource(path, fs_in), FileSource(path, fs_in)
    jrx = JReceiver(_cfg(JAXP, fs_in / m, **kw), jsrc)
    rx = Receiver(_cfg(PORT, fs_in / m, **kw), src, device="cpu")
    js, s = jrx.run(), rx.run()
    jsrc.close()
    src.close()
    assert rx.fs == fs_in / m and rx.f_if == 0.0
    assert s["tracked_prns"] == [23]
    assert s["channels"][0]["locked_fraction"] > 0.95
    assert_same_run(jrx, js, rx, s)
    # the front end's carried mixer phase equals the JAX package's
    assert int(rx._fe_phase) == int(np.asarray(jrx._fe_phase))


def test_fused_partial_tail_is_tracked():
    """A fused receiver's partial last block goes through the scanned
    tracker (slice correlator), as in the JAX package: 6 full blocks of
    20 ms and one of 7 ms."""
    sats = [dict(prn=5, doppler_hz=1210.0, amplitude=0.4),
            dict(prn=9, doppler_hz=-640.0, amplitude=0.4)]
    fs = 2_046_000.0
    sig = synthesize([SatelliteScenario(**k) for k in sats],
                     int(0.127 * fs), fs, noise_std=1.0, seed=11)
    # the mxu layout: the JAX package's direct layout takes ~45 s in
    # Pallas interpret mode here
    jrx, js, rx, s = _pair(sig, fs=fs, n_channels=4,
                           track_kw=dict(correlator="fused",
                                         fused_layout="mxu"))
    assert rx.fused is not None and s["blocks"] == 7
    assert_same_run(jrx, js, rx, s)
    # the tail's epochs were processed: epochs start inside it
    for prn in (5, 9):
        gs = rx.telemetry.traces[rx.active[prn]].global_sample
        assert gs[-1] >= 6 * 20 * 2046


@pytest.mark.parametrize("correlator", ["shift", "pallas"])
def test_scan_blocks_with_scanned_correlator_runs_single_blocks(
        pipeline_scene, correlator):
    """run(scan_blocks=4) takes spans only with the fused tracker on mxu
    or direct (JAX pipeline.py:885-886): a scanned-correlator receiver
    runs single blocks, the same run as run()."""
    jrx, js, _, _ = pipeline_scene
    sats = [dict(prn=p, doppler_hz=d, code_phase_chips=c, amplitude=a)
            for p, d, c, a in TRUTH]
    sig = synthesize([SatelliteScenario(**k) for k in sats], int(0.5 * FS),
                     FS, noise_std=1.0, seed=7)
    rx = Receiver(_cfg(PORT, track_kw=dict(correlator=correlator),
                       acq_kw=dict(steady_threshold=2, non_coherent_ms=10)),
                  ArraySource(sig, FS), device="cpu")
    b5.reset_launch_count()
    s = rx.run(max_blocks=25, scan_blocks=4)
    assert s["stage_timing"]["track"]["calls"] == s["blocks"] == 25
    assert b5.launch_count == 0              # the CPU takes the plain version
    assert s["tracked_prns"] == js["tracked_prns"]
    if correlator == "shift":
        jch = {c["prn"]: c["epochs"] for c in js["channels"]}
        assert {c["prn"]: c["epochs"] for c in s["channels"]} == jch


def test_checkpoint_resume_is_deterministic(tmp_path):
    """tests/test_checkpoint.py: a receiver restored at block 10 continues
    the stream exactly as the uninterrupted one."""
    fs = 2_048_000.0
    sats = [SatelliteScenario(prn=2, doppler_hz=1500.0, amplitude=0.3),
            SatelliteScenario(prn=17, doppler_hz=-2400.0, amplitude=0.25,
                              code_phase_chips=300.0)]
    stream = synthesize(sats, int(0.6 * fs), fs, noise_std=1.0, seed=8)

    def make_rx(samples):
        return Receiver(_cfg(PORT, fs, n_channels=4), ArraySource(samples, fs),
                        device="cpu")

    rx_full = make_rx(stream)
    rx_full.run(max_blocks=25)
    rx_a = make_rx(stream)
    rx_a.run(max_blocks=10)
    ckpt = str(tmp_path / "rx.ckpt")
    checkpoint.save(rx_a, ckpt)
    rx_b = make_rx(stream[checkpoint.consumed_samples(rx_a):])
    checkpoint.restore(rx_b, ckpt)
    rx_b.run(max_blocks=15)
    assert set(rx_b.active) == set(rx_full.active) == {2, 17}
    for t_full, t_res in zip(
            sorted(rx_full.telemetry.all_traces(), key=lambda t: t.prn),
            sorted(rx_b.telemetry.all_traces(), key=lambda t: t.prn)):
        assert t_full.prn == t_res.prn and len(t_full.i_p) == len(t_res.i_p)
        np.testing.assert_array_equal(t_full.i_p, t_res.i_p)
        np.testing.assert_array_equal(t_full.carr_freq, t_res.carr_freq)
        np.testing.assert_array_equal(t_full.global_sample,
                                      t_res.global_sample)
    with open(tmp_path / "bad.ckpt", "wb") as f:
        import pickle
        pickle.dump({"version": 999}, f)
    with pytest.raises(ValueError, match="version"):
        checkpoint.restore(make_rx(stream), str(tmp_path / "bad.ckpt"))
