"""The PyTorch port's single-block receiver against the JAX receiver on
the CPU, the nav processors on shared telemetry, the import boundary and
the device rule."""
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu import ReceiverConfig as JReceiverConfig  # noqa: E402
from gnss_sdr_tpu import RfConfig as JRfConfig  # noqa: E402
from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import SatelliteScenario as JSat  # noqa: E402
from gnss_sdr_tpu.nav import encode_frames  # noqa: E402
from gnss_sdr_tpu.receiver import NavProcessor as JNavProcessor  # noqa: E402
from gnss_sdr_tpu.receiver import Receiver as JReceiver  # noqa: E402
from gnss_sdr_tpu.receiver import SyntheticSource as JSyntheticSource  # noqa: E402

from gnss_sdr_tpu_torch import (  # noqa: E402
    AcqConfig, ParallelConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch.models import SatelliteScenario  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402
from gnss_sdr_tpu_torch.receiver import (  # noqa: E402
    NavProcessor, Receiver, SyntheticSource)
from gnss_sdr_tpu_torch.receiver.tracking import EpochTelemetry  # noqa: E402

FS = 2_046_000.0
SATS = [dict(prn=5, doppler_hz=1210.0, amplitude=0.4),
        dict(prn=9, doppler_hz=-640.0, amplitude=0.4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs: the suite runs
    test files in parallel worker processes, and PyTorch's default of a
    thread per core oversubscribes the machine (timing-sensitive tests
    in other workers starve). Multi-threaded CPU sin/cos also differ
    from the single-threaded, ulp-accurate ones in some processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(mod, track_kw=None, **kw):
    return mod["ReceiverConfig"](
        rf=mod["RfConfig"](freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=mod["AcqConfig"](),
        track=mod["TrackConfig"](n_channels=4, correlator="fused",
                                 **(track_kw or {})),
        block_ms=20, **kw)


PORT = dict(ReceiverConfig=ReceiverConfig, RfConfig=RfConfig,
            AcqConfig=AcqConfig, TrackConfig=TrackConfig)
JAXP = dict(ReceiverConfig=JReceiverConfig, RfConfig=JRfConfig,
            AcqConfig=JAcqConfig, TrackConfig=JTrackConfig)


@pytest.fixture(scope="module")
def both_receivers():
    """The TestMxuReceiver scene (tests/test_mxu_kernel.py): PRNs 5 and
    9, 4 channels, 20 ms blocks, 0.5 s, through both receivers."""
    n = int(0.5 * FS)
    jrx = JReceiver(
        _cfg(JAXP, dict(fused_layout="mxu")),
        JSyntheticSource([JSat(**s) for s in SATS], FS, noise_std=1.0,
                         seed=11, total_samples=n))
    rx = Receiver(
        _cfg(PORT, dict(fused_layout="mxu")),
        SyntheticSource([SatelliteScenario(**s) for s in SATS], FS,
                        noise_std=1.0, seed=11, total_samples=n),
        device="cpu")
    fused.reset_launch_count()
    return jrx, jrx.run(), rx, rx.run()


class TestReceiverParity:
    def test_tracked_and_acquired_equal(self, both_receivers):
        jrx, js, rx, s = both_receivers
        assert rx.fused.layout == jrx.fused.layout == "mxu"
        assert s["tracked_prns"] == js["tracked_prns"] == [5, 9]
        assert [(c.prn, c.sample_local_index) for _, c in rx.acq_events] \
            == [(c.prn, c.sample_local_index) for _, c in jrx.acq_events]
        assert s["blocks"] == js["blocks"] == 25
        # CPU tensors take the plain version: no kernel launches
        assert fused.launch_count == 0

    def test_channels_epochs_and_doppler(self, both_receivers):
        _, js, _, s = both_receivers
        jch = {c["prn"]: c for c in js["channels"]}
        ch = {c["prn"]: c for c in s["channels"]}
        truth = {5: 1210.0, 9: -640.0}
        for prn in (5, 9):
            assert ch[prn]["epochs"] == jch[prn]["epochs"]
            # 1 Hz bound; measured margin on this scene: 0.0 Hz (the
            # same f32 loop arithmetic; the CPU sin/cos or an f32 sum
            # order could still flip a bf16 rounding of the mix)
            margin = abs(ch[prn]["last_doppler_hz"]
                         - jch[prn]["last_doppler_hz"])
            print(f"\nPRN {prn}: last Doppler port - JAX = {margin} Hz")
            assert margin < 1.0
            assert abs(ch[prn]["last_doppler_hz"] - truth[prn]) < 40.0

    def test_run_honours_max_blocks_and_stages(self, both_receivers):
        _, _, rx, s = both_receivers
        assert set(s["stage_timing"]) >= {"ingest", "acquire", "track",
                                          "nav"}
        assert rx.run(max_blocks=3)["blocks"] == 25   # stream exhausted


def _lnav_telemetry(n_blocks=16, t=1000, seed=2):
    """Prompt-I telemetry carrying encoded LNAV frames (20 ms bits),
    as [T, C=2] EpochTelemetry blocks."""
    rng = np.random.default_rng(seed)
    frames = [(sf, 100 + i, rng.integers(0, 2, (8, 24)).astype(np.uint8))
              for i, sf in enumerate([1, 2, 3, 4, 5, 1, 2, 3])]
    bits = np.concatenate([rng.choice([-1, 1], 13), encode_frames(frames)])
    symbols = np.repeat(bits, 20).astype(np.float32)[:n_blocks * t]
    i_p = 200.0 * symbols + rng.normal(0, 20.0, symbols.size)
    blocks = []
    for b in range(n_blocks):
        ip = np.stack([i_p[b * t:(b + 1) * t], -i_p[b * t:(b + 1) * t]], 1)
        e = (b * t + np.arange(t))[:, None].repeat(2, 1).astype(np.int32)
        zeros = np.zeros((t, 2), np.float32)
        blocks.append(EpochTelemetry(
            processed=np.ones((t, 2), bool), i_e=zeros, q_e=zeros,
            i_p=ip.astype(np.float32), q_p=zeros, i_l=zeros, q_l=zeros,
            power=ip.astype(np.float32) ** 2, locked=np.ones((t, 2), bool),
            lost_event=np.zeros((t, 2), bool), pll_err=zeros,
            dll_err=zeros, carr_freq=zeros + 1000.0, code_rate=zeros,
            start_offset=(np.arange(t)[:, None] * 2046 + 5000).repeat(
                2, 1).astype(np.int32),
            epoch_index=e, chip_phase=zeros + 0.25))
    return blocks


def test_nav_processors_same_status():
    a = NavProcessor(FS)
    b = JNavProcessor(FS)
    for proc in (a, b):
        proc.open_channel(0, 5)
        proc.open_channel(1, 9)
    for k, telem in enumerate(_lnav_telemetry()):
        a.feed_block(telem, k * 1_000_000)
        b.feed_block(telem, k * 1_000_000)
    assert a.status() == b.status()
    assert all(v["frame_locked"] for v in a.status().values())


def test_non_gps_nav_chain_raises():
    """The non-GPS nav chains are ported (ROADMAP A16): a NavProcessor of
    each signal opens its channel on the chain the JAX package builds;
    only a signal with no chain raises, as there."""
    for signal in ("galileo_e1b", "galileo_e1c", "beidou_b1i",
                   "glonass_l1of"):
        a = NavProcessor(FS, signal=signal)
        b = JNavProcessor(FS, signal=signal)
        a.open_channel(0, 3)
        b.open_channel(0, 3)
        assert type(a.channels[0].chain).__name__ == \
            type(b.channels[0].chain).__name__
        assert a.status() == b.status()
    with pytest.raises(KeyError, match="no nav decode chain"):
        NavProcessor(FS, signal="gps_l5").open_channel(0, 3)


def test_import_boundary():
    """The port imports neither JAX nor the JAX package, and importing any
    of its modules (the CLI, I/O, presets and plots among them) pulls in
    no matplotlib and runs nothing; ``python -m gnss_sdr_tpu_torch
    --help`` starts without a card."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import gnss_sdr_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        want = {"cli", "__main__", "presets", "io.native", "io.devices",
                "utils.view", "utils.live", "utils.host", "nav.filter",
                "nav.rinex", "nav.rinex_obs", "nav.download",
                "parallel.sharding", "parallel.distributed",
                "parallel.dryrun"}
        missing = {w for w in want if pkg.__name__ + "." + w not in names}
        assert not missing, missing
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith(("jax.", "jaxlib"))
                     or n == "gnss_sdr_tpu" or n.startswith("gnss_sdr_tpu.")
                     or n == "matplotlib" or n.startswith("matplotlib."))
        assert not bad, bad
        import torch
        assert not torch.distributed.is_initialized()
        print("ok", len([n for n in sys.modules
                         if n.startswith("gnss_sdr_tpu_torch")]))
    """)
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    out = subprocess.run([sys.executable, "-m", "gnss_sdr_tpu_torch",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage: gnss_sdr_tpu_torch")
    assert "--cpu" in out.stdout and "--rinex-obs" in out.stdout


def test_receiver_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    src = SyntheticSource([SatelliteScenario(prn=1)], FS,
                          total_samples=int(0.1 * FS))
    with pytest.raises(RuntimeError, match="CUDA"):
        Receiver(_cfg(PORT), src)


@pytest.mark.parametrize("kw,item", [
    (dict(acq_kw=dict(engine="conv"),
          track_kw=dict(correlator="fused", fused_layout="mxu")), "A11"),
    (dict(par_kw=dict(channel_axis=2)), "A14"),
    (dict(acq_kw=dict(signal="galileo_e1b")), "A16"),
], ids=["kw0-A11", "kw1-A14", "kw2-A16"])
def test_unported_receiver_options_raise(kw, item):
    """Each item is ported, so each case builds the receiver. A16 (the
    non-GPS signals): Galileo E1B with the JAX package's surrogate-code
    warning and ``code_status``. A11 (the conv engine): with the fused
    tracker on mxu it arms the in-scan search, as tests/test_span_acq.py
    checks the JAX receiver. A14 (the mesh): on the CPU the receiver
    builds with ``rx.mesh`` set, two logical shards of the CPU device."""
    src = SyntheticSource([SatelliteScenario(prn=1)], FS,
                          total_samples=int(0.1 * FS))
    cfg = ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
        acq=AcqConfig(**kw.get("acq_kw", {})),
        track=TrackConfig(n_channels=4, **kw.get("track_kw", {})),
        parallel=ParallelConfig(**kw.get("par_kw", {})), block_ms=20)
    if item == "A16":
        with pytest.warns(UserWarning, match="SURROGATE"):
            rx = Receiver(cfg, src, device="cpu")
        assert rx.spec.name == "galileo_e1b"
        assert rx.summary()["code_status"] == {"surrogate_codes": True}
        return
    if item == "A11":
        rx = Receiver(cfg, src, device="cpu")
        assert rx.engine.engine == "conv"
        assert rx._span_acq, "conv engine + fused layout must arm " \
            "the in-scan search"
        assert rx.fused.span_extra is not None
        return
    rx = Receiver(cfg, src, device="cpu")
    assert rx.mesh.shape == {"time": 1, "channel": 2}
    assert rx.mesh.devices.tolist() == [[torch.device("cpu")] * 2]
    assert rx.fused is None                 # the scanned tracker, sharded
