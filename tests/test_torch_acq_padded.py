"""The port's power-of-two (pad_fft) PCPS path against the JAX package's,
on the CPU: the padded replica FFTs, the power cube, pcps_search and the
acquisition engine, and the presets that select it. Inputs come from
numpy with fixed seeds and go to both sides."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gnss_sdr_tpu import presets as j_presets  # noqa: E402
from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
from gnss_sdr_tpu.ops import pcps as j_pcps  # noqa: E402
from gnss_sdr_tpu.receiver import acquisition as j_acq  # noqa: E402

from gnss_sdr_tpu_torch import presets  # noqa: E402
from gnss_sdr_tpu_torch.config import AcqConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops import pcps  # noqa: E402
from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver, acquisition  # noqa: E402

FS = 2_046_000.0
CPU = "cpu"
N0 = GPS_L1CA.samples_per_code(FS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread: the suite runs test files in parallel
    worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n):
    sats = [dict(prn=4, doppler_hz=1750.0, code_phase_chips=211.3,
                 amplitude=0.35),
            dict(prn=11, doppler_hz=-3125.0, code_phase_chips=870.0,
                 amplitude=0.3)]
    return synthesize([SatelliteScenario(**k) for k in sats], n, FS,
                      noise_std=1.0, seed=9)


def test_next_pow2_and_replica_ffts():
    assert pcps._next_pow2(2 * N0) == j_pcps._next_pow2(2 * N0) == 4096
    a = pcps.code_replica_ffts_padded(GPS_L1CA, FS, 6).numpy()
    b = np.asarray(j_pcps.code_replica_ffts_padded(J_GPS, FS, 6))
    assert a.shape == (6, 4096)
    # both: numpy's float64 FFT rounded once to complex64
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("coherent", [1, 2])
def test_pcps_power_padded(coherent):
    n_int = 4
    x = _scene((n_int + 1) * N0)
    grid = pcps.doppler_grid(2000.0, 500.0) + np.float32(1750.0)
    pa = pcps.pcps_power_padded(
        torch.from_numpy(x), pcps.code_replica_ffts_padded(GPS_L1CA, FS, 5),
        torch.from_numpy(grid), fs_hz=FS, n_int=n_int, n_fft=N0,
        coherent=coherent).numpy()
    pb = np.asarray(j_pcps.pcps_power_padded(
        jnp.asarray(x), j_pcps.code_replica_ffts_padded(J_GPS, FS, 5),
        jnp.asarray(grid), fs_hz=FS, n_int=n_int, n_fft=N0,
        coherent=coherent))
    assert pa.shape == pb.shape == (5, grid.size, N0)
    # FFT summation order differs: relative to the cube's largest power
    assert np.abs(pa - pb).max() / pb.max() < 1e-4


def test_pcps_search_padded():
    n_int, n_prn = 10, 12
    x = _scene((n_int + 1) * N0)
    grid = pcps.doppler_grid(14_000.0, 500.0)
    ra = pcps.pcps_search(
        torch.from_numpy(x), pcps.code_replica_ffts_padded(GPS_L1CA, FS, n_prn),
        torch.from_numpy(grid), fs_hz=FS, n_int=n_int, pad_fft=True,
        n_fft=N0)
    rb = j_pcps.pcps_search(
        jnp.asarray(x), j_pcps.code_replica_ffts_padded(J_GPS, FS, n_prn),
        jnp.asarray(grid), fs_hz=FS, n_int=n_int, pad_fft=True, n_fft=N0)
    det = ra.detected.numpy()
    np.testing.assert_array_equal(det, np.asarray(rb.detected))
    assert sorted(np.where(det)[0] + 1) == [4, 11]
    np.testing.assert_array_equal(ra.code_phase_samples.numpy()[det],
                                  np.asarray(rb.code_phase_samples)[det])
    np.testing.assert_array_equal(ra.carrier_freq_hz.numpy()[det],
                                  np.asarray(rb.carrier_freq_hz)[det])
    np.testing.assert_allclose(ra.ratio.numpy(), np.asarray(rb.ratio),
                               rtol=1e-3)
    with pytest.raises(ValueError, match="n_fft"):
        pcps.pcps_search(torch.from_numpy(x), ra.ratio, torch.from_numpy(grid),
                         fs_hz=FS, n_int=n_int, pad_fft=True)
    with pytest.raises(ValueError, match="pad_fft needs"):
        pcps.pcps_search(torch.from_numpy(x[:-1]),
                         pcps.code_replica_ffts_padded(GPS_L1CA, FS, 2),
                         torch.from_numpy(grid), fs_hz=FS, n_int=n_int,
                         pad_fft=True, n_fft=N0)


@pytest.mark.parametrize("fs,kw", [
    (FS, dict(n_prn=12)),
    (4_092_000.0, dict(n_prn=12, coherent_ms=2)),
])
def test_engine_pad_fft_same_candidates(fs, kw):
    spec = GPS_L1CA
    ea = acquisition.AcquisitionEngine(AcqConfig(pad_fft=True, **kw), spec,
                                       fs, device=CPU)
    eb = j_acq.AcquisitionEngine(JAcqConfig(pad_fft=True, **kw), J_GPS, fs)
    n0 = spec.samples_per_code(fs)
    assert ea.samples_needed == eb.samples_needed == 11 * n0
    sats = [SatelliteScenario(prn=4, doppler_hz=1750.0, code_phase_chips=211.3,
                              amplitude=0.35),
            SatelliteScenario(prn=11, doppler_hz=-3125.0,
                              code_phase_chips=870.0, amplitude=0.3)]
    x = synthesize(sats, ea.samples_needed, fs, noise_std=1.0, seed=5)
    re = np.real(x).astype(np.float32)
    im = np.imag(x).astype(np.float32)
    ca = ea.search((re, im), window_offset=100)
    cb = eb.search((re, im), window_offset=100)
    # ranked by ratio
    assert [c.prn for c in ca] == [c.prn for c in cb]
    assert sorted(c.prn for c in ca) == [4, 11]
    for a, b in zip(ca, cb):
        assert a.code_phase_samples == b.code_phase_samples
        assert a.sample_local_index == b.sample_local_index
        assert abs(a.carrier_freq_hz - b.carrier_freq_hz) < 0.5
        assert a.ratio == pytest.approx(b.ratio, rel=1e-3)


def _fields(cfg):
    """A config as nested plain values (the two packages' dataclasses are
    different classes with the same fields)."""
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", [
    "ladder1_single_sat_capture", "ladder2_eight_channel", "ladder3_galileo",
    "ladder4_multi_constellation", "ladder5_full_pipeline"])
def test_presets_equal(name):
    a = getattr(presets, name)()
    b = getattr(j_presets, name)()
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert _fields(a[k]) == _fields(b[k])
    else:
        assert _fields(a) == _fields(b)


def test_receiver_runs_ladder2():
    """Ladder 2 (pad_fft, 4.092 MHz, 8 channels) through the port's
    Receiver on the CPU; ladder 3's Galileo branch builds there too."""
    cfg = presets.ladder2_eight_channel()
    fs = cfg.rf.output_sample_rate_hz
    sats = [SatelliteScenario(prn=4, doppler_hz=1750.0, code_phase_chips=211.3,
                              amplitude=0.35).with_code_doppler(),
            SatelliteScenario(prn=11, doppler_hz=-3125.0,
                              code_phase_chips=870.0,
                              amplitude=0.3).with_code_doppler()]
    x = synthesize(sats, int(0.3 * fs), fs, noise_std=1.0, seed=3)
    rx = Receiver(cfg, ArraySource(x, fs), device=CPU)
    assert rx.engine.samples_needed == 11 * GPS_L1CA.samples_per_code(fs)
    out = rx.run()
    assert out["tracked_prns"] == [4, 11]
    for ch in out["channels"]:
        want = 1750.0 if ch["prn"] == 4 else -3125.0
        assert abs(ch["last_doppler_hz"] - want) < 40.0
    # ladder 3's Galileo branch builds too since A16
    gal = presets.ladder3_galileo()["galileo_e1b"]
    with pytest.warns(UserWarning, match="SURROGATE"):
        rx = Receiver(gal, ArraySource(x, gal.rf.output_sample_rate_hz),
                      device=CPU)
    assert rx.spec.name == "galileo_e1b" and rx.device.type == "cpu"
