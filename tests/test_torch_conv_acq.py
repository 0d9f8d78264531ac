"""The conv acquisition engine of the PyTorch port (``ops/pcps.py``'s
conv half and ``AcquisitionEngine(engine="conv")``) against the JAX
package's on the CPU, on the same inputs made with numpy: the power
cube within 1e-3 of its maximum (bf16 products, f32 sums in another
order), detections and integer code phases exact, grid frequencies
exact, the fine Doppler within one line-search step; the engine's
search on GPS L1 C/A and on BeiDou B1I at ladder 4's 8.184 MHz; and
GLONASS FDMA through the conv engine held to the FFT engine's
detections (ROADMAP C4: the port mixes each FDMA channel out before the
coarse decimation, which otherwise attenuates it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.models.constellation import get_signal as j_signal  # noqa: E402
from gnss_sdr_tpu.ops import pcps as j_pcps  # noqa: E402
from gnss_sdr_tpu.receiver import acquisition as j_acq  # noqa: E402

from gnss_sdr_tpu_torch import models  # noqa: E402
from gnss_sdr_tpu_torch.config import AcqConfig  # noqa: E402
from gnss_sdr_tpu_torch.models.constellation import get_signal  # noqa: E402
from gnss_sdr_tpu_torch.ops import pcps  # noqa: E402
from gnss_sdr_tpu_torch.receiver import acquisition  # noqa: E402

FS = 2_046_000.0
N_INT = 4
P = 6
GRID = (np.arange(-5, 6) * 500.0).astype(np.float32)
FINE_STEPS = 129
WINDOW_HZ = 500.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    """(n_int + 1) code periods of GPS L1 C/A at 2.046 MHz: PRN 3 strong,
    PRN 5 weak, noise 1.0; the first P replicas and their boxcar halves."""
    spec = get_signal("gps_l1ca")
    n = spec.samples_per_code(FS)
    sats = [models.SatelliteScenario(prn=3, doppler_hz=730.0, amplitude=0.5,
                                     code_phase_chips=100.0),
            models.SatelliteScenario(prn=5, doppler_hz=-1210.0,
                                     amplitude=0.25, code_phase_chips=611.3)]
    x = models.synthesize(sats, (N_INT + 1) * n, FS, noise_std=1.0, seed=3)
    codes = np.stack([spec.sample_code(p, spec.code_rate_hz, FS)
                      for p in range(1, P + 1)]).astype(np.float32)
    return dict(re=x.real.astype(np.float32), im=x.imag.astype(np.float32),
                codes=codes,
                coarse=codes.reshape(P, n // 2, 2).mean(-1), n=n)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _line_step(squaring=False, n_sub=1, n=2046):
    """The fine search's offset step: its span over n_steps - 1."""
    if squaring and n_sub > 1:
        span = min(2.0 * WINDOW_HZ, 0.45 * FS / n)
    else:
        span = 2.0 * WINDOW_HZ if squaring else WINDOW_HZ
    return 2.0 * span / (FINE_STEPS - 1)


@pytest.mark.parametrize("offset", [0, 777])
def test_power_cube_matches_jax(scene, offset):
    """pcps_power_conv against the JAX conv cube, within 1e-3 of its
    maximum (bf16 operands, f32 sums in another order)."""
    want = np.asarray(j_pcps.pcps_power_conv(
        scene["re"], scene["im"], scene["codes"], GRID, fs_hz=FS,
        n_int=N_INT, sample_offset=offset))
    got = pcps.pcps_power_conv(*_t(scene["re"], scene["im"], scene["codes"],
                                   GRID), fs_hz=FS, n_int=N_INT,
                               sample_offset=offset).numpy()
    assert got.shape == want.shape == (P, GRID.size, scene["n"])
    assert np.abs(got - want).max() <= 1e-3 * want.max()


def test_decimation_lags_and_detector_match_jax(scene):
    """decimate_mean, refine_lags and detect_real against the JAX ones:
    the decimated samples to an ulp, the refined lags and the detector's
    picks exact, the powers within 1e-3."""
    re, im = scene["re"], scene["im"]
    jr, ji = j_pcps.decimate_mean(re, im, 2)
    tr, ti = pcps.decimate_mean(*_t(re, im), 2)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-6,
                               atol=1e-7)
    lags = np.array([200, 1222, 5, 2040, 700, 1], np.int32)
    freqs = np.array([730.0, -1210.0, 0.0, 250.0, -500.0, 90.0], np.float32)
    jl, jp = j_pcps.refine_lags(re, im, scene["codes"], lags, freqs,
                                fs_hz=FS, n_int=N_INT, half_width=2)
    tl, tp = pcps.refine_lags(*_t(re, im, scene["codes"], lags, freqs),
                              fs_hz=FS, n_int=N_INT, half_width=2)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-3)
    cube = np.asarray(j_pcps.pcps_power_conv(
        re, im, scene["codes"], GRID, fs_hz=FS, n_int=N_INT))
    jd = j_pcps.detect_real(cube, GRID, 3.0)
    td = pcps.detect_real(*_t(cube, GRID), 3.0)
    for f in ("detected", "code_phase_samples", "carrier_freq_hz"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)), f)
    np.testing.assert_allclose(td.ratio.numpy(), np.asarray(jd.ratio),
                               rtol=1e-5)


@pytest.mark.parametrize("decim,rows,fine", [
    (1, "identity", False), (2, "identity", True), (1, "bucket8", True),
    (2, "bucket8", False)])
def test_acquire_conv_matches_jax(scene, decim, rows, fine):
    """The whole conv acquisition, with decim 1 and 2 and an 8-row sel
    bucket (rows 3, 1, 5 and five zero rows): detections and code phases
    of the detected rows exact, the grid frequencies exact (fine=False),
    the fine Doppler within one line-search step, the ratio within
    1e-3."""
    sel = np.eye(P, dtype=np.float32)
    if rows == "bucket8":
        sel = np.zeros((8, P), np.float32)
        for i, p in enumerate((3, 1, 5)):
            sel[i, p - 1] = 1.0
    kw = dict(fs_hz=FS, n_int=N_INT, decim=decim, threshold=3.0, fine=fine,
              fine_window_hz=WINDOW_HZ)
    want = j_pcps.acquire_conv(scene["re"], scene["im"], scene["codes"],
                               scene["coarse"], sel, GRID, **kw)
    got = pcps.acquire_conv(*_t(scene["re"], scene["im"], scene["codes"],
                                scene["coarse"], sel, GRID), **kw)
    det = np.asarray(want.detected)
    np.testing.assert_array_equal(got.detected.numpy(), det)
    assert det[:3].all() if rows == "bucket8" else det[[2, 4]].all()
    np.testing.assert_array_equal(got.code_phase_samples.numpy()[det],
                                  np.asarray(want.code_phase_samples)[det])
    f_got = got.carrier_freq_hz.numpy()[det]
    f_want = np.asarray(want.carrier_freq_hz)[det]
    if fine:
        assert np.abs(f_got - f_want).max() <= _line_step()
    else:
        np.testing.assert_array_equal(f_got, f_want)
    np.testing.assert_allclose(got.ratio.numpy(), np.asarray(want.ratio),
                               rtol=1e-3)
    if rows == "bucket8":
        assert not det[3:].any()


@pytest.mark.parametrize("squaring,n_sub", [(False, 1), (True, 1),
                                            (True, 3)])
def test_fine_doppler_conv_matches_jax(scene, squaring, n_sub):
    """fine_doppler_conv (the arithmetic it shares with the FFT engine's
    squaring search) against the JAX one on the two satellites' rows, at
    their acquired code phases, from coarse carriers off by up to half a
    bin: within one line-search step. Squared without sub-periods, the
    line search cannot tell offsets 1 / (2 T_period) = 500 Hz apart (the
    JAX function's alias hazard: their line powers are equal), so there
    the two are compared modulo 500 Hz."""
    coarse = j_pcps.acquire_conv(
        scene["re"], scene["im"], scene["codes"], scene["coarse"],
        np.eye(P, dtype=np.float32), GRID, fs_hz=FS, n_int=N_INT, decim=2,
        threshold=3.0, fine=False)
    rows = [2, 4]                                 # PRNs 3 and 5
    assert np.asarray(coarse.detected)[rows].all()
    codes = scene["codes"][rows]
    cp = np.asarray(coarse.code_phase_samples)[rows]
    f0 = np.array([730.0 + 240.0, -1210.0 - 180.0], np.float32)
    kw = dict(fs_hz=FS, n_int=N_INT, window_hz=WINDOW_HZ,
              squaring=squaring, n_sub=n_sub)
    want = np.asarray(j_pcps.fine_doppler_conv(
        scene["re"], scene["im"], codes, cp, f0, **kw))
    got = pcps.fine_doppler_conv(*_t(scene["re"], scene["im"], codes, cp,
                                     f0), **kw).numpy()
    d = got - want
    if squaring and n_sub == 1:
        d = (d + 250.0) % 500.0 - 250.0
    assert np.abs(d).max() <= _line_step(squaring, n_sub)
    if not squaring or n_sub > 1:
        assert np.abs(got - [730.0, -1210.0]).max() < 20.0


def _engines(signal, fs, **acq_kw):
    cfg = dict(engine="conv", **acq_kw)
    return (acquisition.AcquisitionEngine(AcqConfig(signal=signal, **cfg),
                                          get_signal(signal), fs,
                                          device="cpu"),
            j_acq.AcquisitionEngine(JAcqConfig(signal=signal, **cfg),
                                    j_signal(signal), fs))


@pytest.mark.parametrize("signal,fs,sats,acq_kw", [
    ("gps_l1ca", FS, [(4, 1830.0, 0.35), (11, -2330.0, 0.3)], {}),
    ("beidou_b1i", 8_184_000.0, [(6, 1250.0, 0.3), (12, -750.0, 0.3)],
     dict(n_prn=14, doppler_span_hz=4000.0, non_coherent_ms=4)),
], ids=["gps_l1ca_2046k", "beidou_b1i_8184k"])
def test_engine_search_matches_jax(signal, fs, sats, acq_kw):
    """AcquisitionEngine(engine="conv").search against the JAX conv
    engine on the same chunk: the same candidates in the same order, code
    phases and boundary indices exact, carriers within one line-search
    step, ratios within 1e-3; and a restricted candidate list (the 8-row
    bucket) finds the same for its PRNs."""
    a, b = _engines(signal, fs, **acq_kw)
    assert a.decim == b.decim and a.samples_needed == b.samples_needed
    spec = get_signal(signal)
    scene = [models.SatelliteScenario(prn=p, doppler_hz=d, amplitude=amp,
                                      code_phase_chips=37.0 * p,
                                      signal=spec) for p, d, amp in sats]
    x = models.synthesize(scene, a.samples_needed, fs, noise_std=1.0,
                          seed=5)
    chunk = (x.real.astype(np.float32), x.imag.astype(np.float32))
    step = _line_step(a._fine_squaring, a._fine_n_sub, a.n_fft)
    for allowed in (None, {sats[1][0], 1, 2}):
        ca = a.search(chunk, window_offset=100, allowed_prns=allowed)
        cb = b.search(chunk, window_offset=100, allowed_prns=allowed)
        want = [p for p, _, _ in sats if allowed is None or p in allowed]
        assert [c.prn for c in ca] == [c.prn for c in cb]
        assert set(want) <= {c.prn for c in ca}
        for u, v in zip(ca, cb):
            assert u.code_phase_samples == v.code_phase_samples
            assert u.sample_local_index == v.sample_local_index
            assert abs(u.carrier_freq_hz - v.carrier_freq_hz) <= step
            assert u.ratio == pytest.approx(v.ratio, rel=1e-3)


def test_glonass_fdma_conv_finds_the_fft_engines_satellites():
    """GLONASS L1OF at 8.184 MHz, FDMA channels +4 and -7 (bench.py's
    mixed row's AcqConfig): the conv engine reports the FFT engine's
    pseudo-PRNs with their code phases and carriers within one fine step
    (ROADMAP C4: without mixing each channel out before the decimation
    by 8, these channels sit near the boxcar's nulls and nothing is
    found)."""
    fs, spacing = 8_184_000.0, 562_500.0
    sat = models.SatelliteScenario
    scene = [sat(prn=1, doppler_hz=4 * spacing + 700.0, amplitude=0.3,
                 signal=models.GLONASS_L1OF),
             sat(prn=2, doppler_hz=-7 * spacing - 900.0, amplitude=0.3,
                 signal=models.GLONASS_L1OF)]
    cfg = AcqConfig(signal="glonass_l1of", n_prn=14, fdma_spacing_hz=spacing,
                    fdma_channels=tuple(range(-7, 7)), non_coherent_ms=4)
    spec = get_signal("glonass_l1of")
    conv, fft = (acquisition.AcquisitionEngine(
        dataclasses.replace(cfg, engine=e), spec, fs, device="cpu")
        for e in ("conv", "fft"))
    assert conv.decim == 8
    x = models.synthesize(scene, conv.samples_needed, fs, noise_std=1.0,
                          seed=7)
    cc = conv.search((x.real.astype(np.float32), x.imag.astype(np.float32)))
    cf = fft.search(x[:fft.samples_needed])
    assert sorted(c.prn for c in cf) == [1, 12]       # channels -7, +4
    assert [c.prn for c in cc] == [c.prn for c in cf]
    step = _line_step(conv._fine_squaring, conv._fine_n_sub, conv.n_fft)
    for u, v in zip(cc, cf):
        assert u.code_phase_samples == v.code_phase_samples
        assert abs(u.carrier_freq_hz - v.carrier_freq_hz) <= step + 1.0
        assert u.ratio > 2 * cfg.detection_threshold
