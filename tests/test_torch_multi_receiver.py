"""Slice 10 (ROADMAP A16) on the CPU: the port's multi-constellation
receiver (``receiver/multi.py``) and the non-GPS signals through its
``Receiver``, against the JAX package.

  * ``TeeSource``: every branch sees the stream the JAX tee hands out,
    sample for sample; the end of stream reaches every branch; a branch
    that lags past ``max_skew`` raises in both;
  * every signal of ``presets.py`` builds a port ``Receiver`` on the CPU
    (Galileo with the surrogate-code warning and ``code_status``), and
    ``MultiConstellationReceiver(presets.ladder4_multi_constellation(),
    src, device="cpu")`` runs single blocks and spans;
  * tests/test_multi_constellation.py's scene (GPS, Galileo E1B, GLONASS
    FDMA and BeiDou over one 0.5 s stream at 8.184 MHz, one or two
    channels per branch) through both packages' multi receivers: the
    tracked PRNs per system equal, each Doppler within 40 Hz (the JAX
    suite's bound) of the JAX run's and of the truth;
  * tests/test_pvt_multi_constellation.py's mixed fix (ten satellites of
    four systems, 1.2 s at 4.092 MHz, time anchors injected as there)
    through the port, held to that test's bounds: the fix within 100 m,
    the per-system clock biases within 300 m of their mean;
  * the fine Doppler of BeiDou's acquisition on ladder 4's mixed scene
    (ROADMAP C16): the JAX FFT engine squares away every satellite's
    code and hands all four satellites one Doppler; the port's search
    despreads first and holds each within 25 Hz of its truth; the
    port's squaring fine search (``pcps._fine_doppler_despread``) against
    the JAX package's ``fine_doppler_conv`` on the same samples, codes,
    code phases and coarse carriers, BeiDou and Galileo: the same n_sub
    in both packages, each estimate within one step of the line search
    (2 * span / 128) of the JAX one.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from gnss_sdr_tpu.config import AcqConfig as JAcq  # noqa: E402
from gnss_sdr_tpu.config import ReceiverConfig as JCfg  # noqa: E402
from gnss_sdr_tpu.config import RfConfig as JRf  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrack  # noqa: E402
from gnss_sdr_tpu.receiver import ArraySource as JArraySource  # noqa: E402
from gnss_sdr_tpu.receiver import MultiConstellationReceiver as JMulti  # noqa: E402
from gnss_sdr_tpu.receiver import TeeSource as JTee  # noqa: E402
from gnss_sdr_tpu.models.constellation import get_signal as j_get_signal  # noqa: E402
from gnss_sdr_tpu.ops import pcps as j_pcps  # noqa: E402
from gnss_sdr_tpu.receiver.acquisition import AcquisitionEngine as JEngine  # noqa: E402

from gnss_sdr_tpu_torch import presets  # noqa: E402
from gnss_sdr_tpu_torch import models  # noqa: E402
from gnss_sdr_tpu_torch.config import (  # noqa: E402
    AcqConfig, ReceiverConfig, RfConfig, TrackConfig)
from gnss_sdr_tpu_torch.models.constellation import get_signal  # noqa: E402
from gnss_sdr_tpu_torch.nav.ephemeris import Ephemeris  # noqa: E402
from gnss_sdr_tpu_torch.nav.glonass_nav import GlonassEphemeris  # noqa: E402
from gnss_sdr_tpu_torch.ops import pcps  # noqa: E402
from gnss_sdr_tpu_torch.receiver import (  # noqa: E402
    ArraySource, MultiConstellationReceiver, Receiver, TeeSource)
from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine  # noqa: E402
from gnss_sdr_tpu_torch.receiver.navproc import TimeAnchor  # noqa: E402

DOPPLER_TOL_HZ = 40.0
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- TeeSource -------------------------------------------------------------

def _drain(tee_cls, source_cls, data, sizes):
    tee = tee_cls(source_cls(data, 1e6), len(sizes))
    branches = [tee.branch(i) for i in range(len(sizes))]
    got = [[] for _ in sizes]
    while True:
        live = False
        for i, (b, n) in enumerate(zip(branches, sizes)):
            x = b.read(n)
            if x is not None:
                got[i].append(x)
                live = True
        if not live:
            return [np.concatenate(g) for g in got]


def test_tee_branches_see_the_jax_tees_stream():
    data = (np.arange(10_000) + 1j * np.arange(10_000)[::-1]).astype(
        np.complex64)
    sizes = (3000, 5000, 777)
    port = _drain(TeeSource, ArraySource, data, sizes)
    jax_side = _drain(JTee, JArraySource, data, sizes)
    for a, b in zip(port, jax_side):
        np.testing.assert_array_equal(a, data)
        np.testing.assert_array_equal(a, b)


def test_tee_end_of_stream_reaches_every_branch():
    tee = TeeSource(ArraySource(np.zeros(100, np.complex64), 1e6), 2)
    a, b = tee.branch(0), tee.branch(1)
    assert a.read(100).size == 100 and a.read(10) is None
    assert b.read(60).size == 60 and b.read(60).size == 40
    assert b.read(1) is None


@pytest.mark.parametrize("tee_cls,src_cls", [(TeeSource, ArraySource),
                                             (JTee, JArraySource)],
                         ids=["port", "jax"])
def test_tee_lag_past_max_skew_raises(tee_cls, src_cls):
    tee = tee_cls(src_cls(np.zeros(1000, np.complex64), 1e6), 2,
                  max_skew=300)
    a = tee.branch(0)
    with pytest.raises(RuntimeError, match="lags"):
        a.read(400)


# --- every signal through the port's Receiver ------------------------------

def _preset_configs():
    out = {}
    for name in ("ladder1_single_sat_capture", "ladder2_eight_channel",
                 "ladder5_full_pipeline"):
        out[name] = getattr(presets, name)()
    for name in ("ladder3_galileo", "ladder4_multi_constellation"):
        for sig, cfg in getattr(presets, name)().items():
            out[f"{name}.{sig}"] = cfg
    return out


PRESETS = _preset_configs()


@pytest.mark.parametrize("name", list(PRESETS))
def test_every_preset_signal_builds_a_receiver_on_cpu(name):
    cfg = PRESETS[name]
    fs_in = cfg.rf.output_sample_rate_hz * max(1, cfg.rf.decimation)
    src = ArraySource(np.zeros(1000, np.complex64), fs_in)
    if cfg.acq.signal.startswith("galileo_e1"):
        with pytest.warns(UserWarning, match="SURROGATE"):
            rx = Receiver(cfg, src, device=CPU)
        assert rx.summary()["code_status"] == {"surrogate_codes": True}
    else:
        rx = Receiver(cfg, src, device=CPU)
        assert "code_status" not in rx.summary()
    assert rx.device.type == "cpu" and rx.spec.name == cfg.acq.signal
    assert rx.nav.signal == cfg.acq.signal


def _multi_scene(models_mod, seconds=0.5):
    """tests/test_multi_constellation.py's satellites: GPS 4 and 29,
    Galileo 11, GLONASS FDMA channel +2, BeiDou 27."""
    sat = models_mod.SatelliteScenario
    return [
        sat(prn=4, doppler_hz=2100.0, amplitude=0.22,
            signal=models_mod.GPS_L1CA),
        sat(prn=29, doppler_hz=-3600.0, amplitude=0.2,
            code_phase_chips=400.0, signal=models_mod.GPS_L1CA),
        sat(prn=11, doppler_hz=1500.0, amplitude=0.17,
            signal=models_mod.GALILEO_E1B),
        sat(prn=1, doppler_hz=2 * 562_500.0 - 1200.0, amplitude=0.3,
            signal=models_mod.GLONASS_L1OF),
        sat(prn=27, doppler_hz=-900.0, amplitude=0.3,
            signal=models_mod.BEIDOU_B1I),
    ]


FS_MULTI = 8_184_000.0
MULTI_TRUTH = {"gps_l1ca": {4: 2100.0, 29: -3600.0},
               "galileo_e1b": {11: 1500.0},
               "glonass_l1of": {10: 2 * 562_500.0 - 1200.0},
               "beidou_b1i": {27: -900.0}}
MULTI_CHANNELS = {"gps_l1ca": 2, "galileo_e1b": 1, "glonass_l1of": 1,
                  "beidou_b1i": 1}


def _multi_configs(acq_cls, cfg_cls, rf_cls, track_cls):
    acq = {"gps_l1ca": {},
           "galileo_e1b": dict(n_prn=36, non_coherent_ms=16,
                               detection_threshold=12.0),
           "glonass_l1of": dict(n_prn=14, fdma_spacing_hz=562_500.0,
                                fdma_channels=tuple(range(-7, 7))),
           "beidou_b1i": dict(n_prn=37, detection_threshold=10.0)}
    return {sig: cfg_cls(
        rf=rf_cls(freq_if_hz=0.0, output_sample_rate_hz=FS_MULTI),
        acq=acq_cls(signal=sig, **acq[sig]),
        track=track_cls(signal=sig, n_channels=MULTI_CHANNELS[sig]),
        block_ms=20) for sig in MULTI_CHANNELS}


def _dopplers(summary):
    return {sig: {c["prn"]: c["last_doppler_hz"] for c in out["channels"]}
            for sig, out in summary.items()}


def test_multi_receiver_matches_jax_on_the_four_system_scene():
    sig = models.synthesize(_multi_scene(models), int(0.5 * FS_MULTI),
                            FS_MULTI, noise_std=1.0, seed=13)
    port = MultiConstellationReceiver(
        _multi_configs(AcqConfig, ReceiverConfig, RfConfig, TrackConfig),
        ArraySource(sig, FS_MULTI), device=CPU)
    jax_rx = JMulti(_multi_configs(JAcq, JCfg, JRf, JTrack),
                    JArraySource(sig, FS_MULTI))
    out_p, out_j = port.run(), jax_rx.run()
    dp, dj = _dopplers(out_p), _dopplers(out_j)
    for system, truth in MULTI_TRUTH.items():
        assert out_p[system]["tracked_prns"] == sorted(truth), system
        assert out_j[system]["tracked_prns"] == sorted(truth), system
        for prn, want in truth.items():
            assert abs(dp[system][prn] - dj[system][prn]) < DOPPLER_TOL_HZ
            assert abs(dp[system][prn] - want) < DOPPLER_TOL_HZ
    assert out_p["galileo_e1b"]["code_status"] == \
        out_j["galileo_e1b"]["code_status"]
    assert all(rx.device.type == "cpu" for rx in port.receivers.values())


def test_ladder4_preset_runs_on_cpu_single_blocks_and_spans():
    """MultiConstellationReceiver over presets.ladder4_multi_constellation
    on the CPU, the fused tracker on every branch (the direct layout, and
    seg for Galileo's 5-epoch blocks at wp 33,152): single blocks, then
    whole spans through step_scan."""
    sig = models.synthesize(_multi_scene(models), int(0.2 * FS_MULTI),
                            FS_MULTI, noise_std=1.0, seed=13)
    cfgs = {k: dataclasses.replace(c, track=dataclasses.replace(
        c.track, correlator="fused"))
        for k, c in presets.ladder4_multi_constellation().items()}
    mrx = MultiConstellationReceiver(cfgs, ArraySource(sig, FS_MULTI),
                                     device=CPU)
    assert {k: rx.fused.layout for k, rx in mrx.receivers.items()} == {
        "gps_l1ca": "direct", "galileo_e1b": "seg", "beidou_b1i": "direct",
        "glonass_l1of": "direct"}
    assert mrx.receivers["galileo_e1b"].fused.wp == 33152
    out = mrx.run(max_blocks=4)
    assert all(v["blocks"] == 4 for v in out.values())
    assert mrx.step_scan(2)
    out = mrx.run(max_blocks=4, scan_blocks=2)
    assert all(v["blocks"] == 10 for v in out.values())
    assert out["gps_l1ca"]["tracked_prns"] == [4, 29]
    assert out["beidou_b1i"]["tracked_prns"] == [27]


def test_multi_receiver_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    src = ArraySource(np.zeros(1000, np.complex64), FS_MULTI)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiConstellationReceiver(presets.ladder3_galileo(), src)


# --- the mixed fix of tests/test_pvt_multi_constellation.py ----------------

def test_mixed_constellation_fix_through_the_port():
    """The capstone scene of tests/test_pvt_multi_constellation.py through
    the port's receivers on the CPU (each branch with as many channels as
    it has satellites), the JAX test's anchors and ephemerides injected
    the same way (built with the JAX test's helpers, converted field for
    field), held to its bounds."""
    from tests import test_pvt_multi_constellation as jt

    plan = [
        ("gps_l1ca", 3, 26_560e3, (40.0, 55.0), "gps", 737.0),
        ("gps_l1ca", 17, 26_560e3, (160.0, 35.0), "gps", -1291.0),
        ("gps_l1ca", 28, 26_560e3, (300.0, 75.0), "gps", 2143.0),
        ("galileo_e1b", 11, 29_600e3, (250.0, 60.0), "galileo", 941.0),
        ("galileo_e1b", 24, 29_600e3, (310.0, 30.0), "galileo", -1823.0),
        ("beidou_b1i", 8, 27_906e3, (80.0, 70.0), "beidou", 457.0),
        ("beidou_b1i", 21, 27_906e3, (200.0, 25.0), "beidou", 1531.0),
        ("beidou_b1i", 30, 27_906e3, (140.0, 50.0), "beidou", -659.0),
        ("glonass_l1of", 7, 25_508e3, (120.0, 45.0), "glonass", 1097.0),
        ("glonass_l1of", 11, 25_508e3, (0.0, 50.0), "glonass", -353.0),
    ]
    fs, cc = jt.FS, jt.CC
    scen, truth = [], {}
    for sig_name, prn, radius, (az, el), system, dop in plan:
        spec = get_signal(sig_name)
        pos = jt._sat_pos_at(az, el, radius)
        if system == "glonass":
            j_eph = jt._glonass_ephemeris(prn, pos)
            eph = GlonassEphemeris(**dataclasses.asdict(j_eph))
            t_ref = jt.T_REF % 86400.0
        else:
            j_eph = jt._kepler_ephemeris(prn, system, pos, radius)
            eph = Ephemeris(**dataclasses.asdict(j_eph))
            t_ref = jt.T_REF
        t_tx0 = t_ref - jt._light_time(pos)
        cp0 = (t_tx0 % spec.code_period_s) * spec.code_rate_hz
        if system == "glonass":
            dop += list(range(-7, 7))[prn - 1] * 562_500.0
        scen.append(models.SatelliteScenario(
            prn=prn, doppler_hz=dop, code_phase_chips=cp0, amplitude=0.3,
            signal=spec))
        truth[(sig_name, prn)] = dict(eph=eph, t_tx0=t_tx0, cp0=cp0,
                                      spec=spec, pos=pos, radius=radius)
    acq = {"gps_l1ca": dict(detection_threshold=20.0),
           "galileo_e1b": dict(n_prn=36, non_coherent_ms=16,
                               detection_threshold=40.0),
           "beidou_b1i": dict(n_prn=37, detection_threshold=40.0),
           "glonass_l1of": dict(n_prn=14, fdma_spacing_hz=562_500.0,
                                fdma_channels=tuple(range(-7, 7)),
                                detection_threshold=20.0)}
    n_ch = {"gps_l1ca": 3, "galileo_e1b": 2, "beidou_b1i": 3,
            "glonass_l1of": 2}
    configs = {s: ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
        acq=AcqConfig(signal=s, **acq[s]),
        track=TrackConfig(signal=s, n_channels=n_ch[s]), block_ms=20)
        for s in acq}
    sig = models.synthesize(scen, int(1.2 * fs), fs, noise_std=1.0, seed=41)
    mrx = MultiConstellationReceiver(configs, ArraySource(sig, fs),
                                     device=CPU)
    mrx.run()
    for name, rx in mrx.receivers.items():
        assert sorted(rx.active) == sorted(p for (n, p) in truth
                                           if n == name), name
        for prn, ch in rx.active.items():
            t = truth[(name, prn)]
            trace = [tr for tr in rx.telemetry.all_traces()
                     if tr.prn == prn][0]
            g0 = int(trace.global_sample[0])
            spec = t["spec"]
            cp_g0 = (t["cp0"] + spec.code_rate_hz / fs * g0) \
                % spec.code_length_chips
            half = spec.code_length_chips / 2
            rx.nav.channels[ch].anchor = TimeAnchor(
                epoch=int(trace.epoch_index[0]), global_sample=g0,
                tow_s=t["t_tx0"] + g0 / fs,
                chip_phase=cp_g0 if cp_g0 < half
                else cp_g0 - spec.code_length_chips)
            rx.nav.ephemerides[prn] = t["eph"]
    sig_of = {"gps": "gps_l1ca", "galileo": "galileo_e1b",
              "beidou": "beidou_b1i"}
    obs = mrx.observables()
    assert obs is not None and len(obs["prns"]) == 10
    assert set(obs["systems"]) == {"gps", "galileo", "beidou", "glonass"}
    for prn, system, tx in zip(obs["prns"], obs["systems"],
                               obs["transmit_times_s"]):
        if system == "glonass":
            continue
        t = truth[(sig_of[system], prn)]
        j_eph = jt._kepler_ephemeris(prn, system, t["pos"], t["radius"],
                                     t_oe=tx)
        mrx.receivers[sig_of[system]].nav.ephemerides[prn] = Ephemeris(
            **dataclasses.asdict(j_eph))
    sol = mrx.compute_pvt()
    assert sol is not None
    err = np.linalg.norm(sol.position_ecef_m - jt.RX_TRUE)
    assert err < 100.0, f"mixed-constellation fix error {err:.1f} m"
    b = dict(sol.clock_bias_by_system_m)
    assert set(b) == {"gps", "galileo", "beidou", "glonass"}
    b["glonass"] -= 432_000.0 * cc
    biases = np.array(list(b.values()))
    assert np.all(np.abs(biases - biases.mean()) < 300.0), b


# --- ROADMAP C16: the squaring fine Doppler --------------------------------

def test_beidou_fine_doppler_despreads_unlike_the_jax_fft_engine():
    sats = chip_smoke.mixed_sats(models)
    truth = chip_smoke.mixed_truth(sats)["beidou_b1i"]
    cfg = chip_smoke.mixed_configs()["beidou_b1i"]
    spec = get_signal("beidou_b1i")
    port = AcquisitionEngine(cfg.acq, spec, chip_smoke.WIDE_FS, device=CPU)
    x = models.synthesize(sats, port.samples_needed, chip_smoke.WIDE_FS,
                          noise_std=1.0, seed=7)
    got = {c.prn: c.carrier_freq_hz for c in port.search(x)}
    assert set(got) == set(truth)
    for prn, want in truth.items():
        assert abs(got[prn] - want) < 25.0, (prn, got[prn], want)
    j_eng = JEngine(JAcq(signal="beidou_b1i", n_prn=37,
                         detection_threshold=10.0),
                    j_get_signal("beidou_b1i"),
                    chip_smoke.WIDE_FS, 0.0)
    j_got = {c.prn: float(c.carrier_freq_hz) for c in j_eng.search(x)}
    # the fault: one line for all (truths -500, 0, 250 and -250 Hz)
    assert len(set(j_got.values())) == 1, j_got


@pytest.mark.parametrize("system", ["beidou_b1i", "galileo_e1b"])
def test_squaring_fine_doppler_equals_jax_fine_doppler_conv(system):
    sats = chip_smoke.mixed_sats(models)
    truth = chip_smoke.mixed_truth(sats)[system]
    acq = chip_smoke.mixed_configs()[system].acq
    spec = get_signal(system)
    fs = chip_smoke.WIDE_FS
    # the coarse verdicts (fine search off) feed both fine searches
    port = AcquisitionEngine(dataclasses.replace(acq, fine_doppler=False),
                             spec, fs, device=CPU)
    j_eng = JEngine(JAcq(**dataclasses.asdict(acq)), j_get_signal(system),
                    fs, 0.0)
    assert port._fine_squaring and j_eng._fine_squaring
    assert port._fine_n_sub == j_eng._fine_n_sub > 1
    x = models.synthesize(sats, port.samples_needed, fs, noise_std=1.0,
                          seed=7)
    coarse = {c.prn: c for c in port.search(x)}
    assert set(coarse) == set(truth)
    prns = sorted(truth)
    n_int = acq.non_coherent_ms // spec.code_period_ms
    xs = np.asarray(x[:n_int * port.n_fft], np.complex64)
    rows = port.code_samples[[p - 1 for p in prns]]
    cp = np.array([coarse[p].code_phase_samples for p in prns], np.int32)
    f0 = np.array([coarse[p].carrier_freq_hz for p in prns], np.float32)
    got = pcps.fine_doppler(
        torch.from_numpy(xs), torch.from_numpy(rows), torch.from_numpy(cp),
        torch.from_numpy(f0), fs_hz=fs, n_int=n_int,
        window_hz=acq.doppler_step_hz, squaring=True,
        n_sub=port._fine_n_sub).numpy()
    want = np.asarray(j_pcps.fine_doppler_conv(
        jnp.asarray(xs.real), jnp.asarray(xs.imag), jnp.asarray(rows),
        jnp.asarray(cp), jnp.asarray(f0), fs_hz=fs, n_int=n_int,
        window_hz=float(acq.doppler_step_hz), squaring=True,
        n_sub=j_eng._fine_n_sub))
    span = min(2.0 * acq.doppler_step_hz, 0.45 * fs / port.n_fft)
    assert np.all(np.abs(got - want) <= 2.0 * span / 128), (got, want)
    for prn, g in zip(prns, got):
        assert abs(g - truth[prn]) < 25.0, (prn, g, truth[prn])
