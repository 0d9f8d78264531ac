"""Parity of the PyTorch port's models and ops with the JAX package, on
the CPU: code tables, the synthetic scene, the u32 NCO, the replica bank
gather and the FFT acquisition engine. Inputs come from numpy with fixed
seeds and go to both sides."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gnss_sdr_tpu.config import AcqConfig as JAcqConfig  # noqa: E402
from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
from gnss_sdr_tpu.models import constellation as j_constellation  # noqa: E402
from gnss_sdr_tpu.models import SatelliteScenario as JSat  # noqa: E402
from gnss_sdr_tpu.models import synthesize as j_synthesize  # noqa: E402
from gnss_sdr_tpu.ops import nco as j_nco  # noqa: E402
from gnss_sdr_tpu.ops import pcps as j_pcps  # noqa: E402
from gnss_sdr_tpu.ops.pallas import track_block_fused as j_fused  # noqa: E402
from gnss_sdr_tpu.receiver import acquisition as j_acq  # noqa: E402
from gnss_sdr_tpu.receiver import tracking as j_trk  # noqa: E402

from gnss_sdr_tpu_torch.config import AcqConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    BEIDOU_B1I, GALILEO_E1B, GLONASS_L1OF, GPS_L1CA, SatelliteScenario,
    synthesize)
from gnss_sdr_tpu_torch.models import constellation  # noqa: E402
from gnss_sdr_tpu_torch.ops import nco, pcps  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402
from gnss_sdr_tpu_torch.receiver import acquisition, tracking  # noqa: E402

FS = 2_046_000.0
CPU = "cpu"


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


class TestModels:
    @pytest.mark.parametrize("name", ["gps_l1ca", "galileo_e1b",
                                      "beidou_b1i", "glonass_l1of"])
    def test_code_tables_equal(self, name):
        # exact: the same integer code generators in both packages
        a = constellation.get_signal(name).code_table()
        b = j_constellation.get_signal(name).code_table()
        np.testing.assert_array_equal(a, b)

    def test_sampled_code_table_equal(self):
        # exact: the same numpy sampling and tiling
        params = j_trk.TrackParams.create(
            JTrackConfig(), J_GPS, FS)
        a = tracking.make_sampled_code_table(GPS_L1CA, FS, 8,
                                             window=params.window)
        b = np.asarray(j_trk.make_sampled_code_table(J_GPS, FS, 8,
                                                     window=params.window))
        np.testing.assert_array_equal(a, b)

    def test_code_replica_ffts_equal(self):
        # exact: both take numpy's f64 FFT rounded once to complex64
        a = pcps.code_replica_ffts(GPS_L1CA, FS, 6, device=CPU).numpy()
        b = np.asarray(j_pcps.code_replica_ffts(J_GPS, FS, 6))
        np.testing.assert_array_equal(a, b)

    def test_synthesize_equal(self):
        # exact: the same float64 numpy oracle with the same seed
        kw = [dict(prn=3, doppler_hz=1234.5, code_phase_chips=100.25,
                   amplitude=0.7),
              dict(prn=17, doppler_hz=-2200.0, carrier_phase_rad=0.4)]
        a = synthesize([SatelliteScenario(**k) for k in kw], 50_000, FS,
                       noise_std=0.8, seed=21, start_sample=777)
        b = j_synthesize([JSat(**k) for k in kw], 50_000, FS,
                         noise_std=0.8, seed=21, start_sample=777)
        np.testing.assert_array_equal(a, b)

    def test_signal_registry_complete(self):
        for spec in (GPS_L1CA, GALILEO_E1B, BEIDOU_B1I, GLONASS_L1OF):
            assert spec.samples_per_code(FS) > 0


class TestNco:
    def test_freq_to_step_bit_exact(self):
        # exact u32: the same f32 division, floor and half-even round
        rng = np.random.default_rng(5)
        freqs = np.concatenate([
            rng.uniform(-5e6, 5e6, 2000),
            [0.0, FS / 2, -FS / 2, FS - 1e-3, 1e-7, -1e-7, 3 * FS + 0.5],
        ]).astype(np.float32)
        a = nco.freq_to_step(torch.from_numpy(freqs), FS).numpy()
        b = np.asarray(j_nco.freq_to_step(jnp.asarray(freqs), FS))
        np.testing.assert_array_equal(a.astype(np.uint32), b)

    def test_phase_ramp_and_advance_wrap_bit_exact(self):
        # exact u32 across the 2^32 wrap: int64 masked to 32 bits
        acc = np.array([0, 1, 2**32 - 1, 2**32 - 5000, 123456789],
                       np.uint32)
        step = np.array([2**31 + 7, 2**32 - 1, 12345, 999_999_937, 1],
                        np.uint32)
        a = nco.phase_ramp(torch.from_numpy(acc.astype(np.int64)),
                           torch.from_numpy(step.astype(np.int64)), 4096)
        b = np.asarray(j_nco.phase_ramp(jnp.asarray(acc), jnp.asarray(step),
                                        4096))
        np.testing.assert_array_equal(a.numpy().astype(np.uint32), b)
        n = np.array([0, 1, 2046, 2**31 - 1, 77777], np.int32)
        a2 = nco.advance(torch.from_numpy(acc.astype(np.int64)),
                         torch.from_numpy(step.astype(np.int64)),
                         torch.from_numpy(n.astype(np.int64)))
        b2 = np.asarray(j_nco.advance(jnp.asarray(acc), jnp.asarray(step),
                                      jnp.asarray(n)))
        np.testing.assert_array_equal(a2.numpy().astype(np.uint32), b2)
        # the f32 phase conversion agrees too (two ulp-accurate f32
        # sin/cos implementations)
        c_a, s_a = nco.cis(a)
        c_b, s_b = j_nco.cis(jnp.asarray(b))
        np.testing.assert_allclose(c_a.numpy(), np.asarray(c_b), atol=2e-6)
        np.testing.assert_allclose(s_a.numpy(), np.asarray(s_b), atol=2e-6)


class TestReplicas:
    @pytest.mark.parametrize("n_drift", [5, 8, 9])
    def test_build_replicas_equal(self, n_drift):
        # exact: an index gather of the same table at the same anchors
        n0, wp, el_shift = 2046, 2560, 1
        params = j_trk.TrackParams.create(
            JTrackConfig(), J_GPS, FS)
        codes = tracking.make_sampled_code_table(GPS_L1CA, FS, 6,
                                                 window=params.window)
        rng = np.random.default_rng(n_drift)
        anchor = np.array([0, n0 - 1, 5, 1000, n0 + 3, -2], np.int32)
        lane = rng.integers(0, 128, 6).astype(np.int32)
        a = fused.build_replicas(torch.from_numpy(codes), el_shift, n0, wp,
                                 n_drift, anchor, lane_shift=lane).numpy()
        b = np.asarray(j_fused.build_replicas(
            jnp.asarray(codes), None, None, el_shift, n0, wp,
            n_drift=n_drift, anchor=jnp.asarray(anchor),
            lane_shift=jnp.asarray(lane)))
        np.testing.assert_array_equal(a, b)


def _two_sat_scene(n):
    sats = [dict(prn=4, doppler_hz=1750.0, code_phase_chips=211.3,
                 amplitude=0.35),
            dict(prn=11, doppler_hz=-3125.0, code_phase_chips=870.0,
                 amplitude=0.3)]
    return synthesize([SatelliteScenario(**k) for k in sats], n, FS,
                      noise_std=1.0, seed=9)


class TestAcquisition:
    def test_pcps_search_and_fine_doppler(self):
        n_int, n_prn = 10, 12
        n0 = GPS_L1CA.samples_per_code(FS)
        x = _two_sat_scene(n_int * n0)
        grid = pcps.doppler_grid(14_000.0, 500.0)
        codes_np = np.stack([GPS_L1CA.sample_code(p, GPS_L1CA.code_rate_hz,
                                                  FS)
                             for p in range(1, n_prn + 1)]).astype(np.float32)
        ra = pcps.pcps_search(
            torch.from_numpy(x), pcps.code_replica_ffts(GPS_L1CA, FS, n_prn),
            torch.from_numpy(grid), fs_hz=FS, n_int=n_int, threshold=7.0)
        rb = j_pcps.pcps_search(
            jnp.asarray(x), j_pcps.code_replica_ffts(J_GPS, FS, n_prn),
            jnp.asarray(grid), fs_hz=FS, n_int=n_int, threshold=7.0)
        det_a, det_b = ra.detected.numpy(), np.asarray(rb.detected)
        np.testing.assert_array_equal(det_a, det_b)
        assert np.where(det_a)[0].tolist() == [3, 10]
        np.testing.assert_array_equal(ra.code_phase_samples.numpy()[det_a],
                                      np.asarray(rb.code_phase_samples)[det_b])
        np.testing.assert_array_equal(ra.carrier_freq_hz.numpy()[det_a],
                                      np.asarray(rb.carrier_freq_hz)[det_b])
        # FFT summation order differs between cuFFT/pocketfft and XLA
        np.testing.assert_allclose(ra.ratio.numpy(), np.asarray(rb.ratio),
                                   rtol=1e-3)
        fa = pcps.fine_doppler(
            torch.from_numpy(x), torch.from_numpy(codes_np),
            ra.code_phase_samples, ra.carrier_freq_hz, fs_hz=FS,
            n_int=n_int).numpy()
        fb = np.asarray(j_pcps.fine_doppler(
            jnp.asarray(x), jnp.asarray(codes_np), rb.code_phase_samples,
            rb.carrier_freq_hz, fs_hz=FS, n_int=n_int))
        # one fine bin is fs / (8 * n_int * N) = 12.5 Hz; the argmax may
        # not move, the f32 frequency grid may differ by an ulp
        assert np.abs(fa[det_a] - fb[det_b]).max() < 0.5

    @pytest.mark.parametrize("coherent,hyp", [(1, 1), (2, 2)])
    def test_pcps_power_grouping(self, coherent, hyp):
        n_int, n0 = 4, GPS_L1CA.samples_per_code(FS)
        x = _two_sat_scene(n_int * n0)
        grid = pcps.doppler_grid(2000.0, 500.0) + np.float32(1750.0)
        pa = pcps.pcps_power(
            torch.from_numpy(x), pcps.code_replica_ffts(GPS_L1CA, FS, 5),
            torch.from_numpy(grid), fs_hz=FS, n_int=n_int,
            coherent=coherent, bit_edge_hypotheses=hyp).numpy()
        pb = np.asarray(j_pcps.pcps_power(
            jnp.asarray(x), j_pcps.code_replica_ffts(J_GPS, FS, 5),
            jnp.asarray(grid), fs_hz=FS, n_int=n_int, coherent=coherent,
            bit_edge_hypotheses=hyp))
        # FFT summation order: relative to the cube's peak
        assert np.abs(pa - pb).max() / pb.max() < 1e-4
        assert pcps.coherent_group_count(n_int, coherent, hyp) == \
            j_pcps.coherent_group_count(n_int, coherent, hyp)
        assert pcps.peak_avg_threshold(7.0, n_groups=2, n_cells=1e5,
                                       hypotheses=hyp) == \
            j_pcps.peak_avg_threshold(7.0, n_groups=2, n_cells=1e5,
                                      hypotheses=hyp)

    def test_engine_search_same_candidates(self):
        cfg_kw = dict(n_prn=12)
        ea = acquisition.AcquisitionEngine(AcqConfig(**cfg_kw), GPS_L1CA, FS,
                                           device=CPU)
        eb = j_acq.AcquisitionEngine(JAcqConfig(**cfg_kw), J_GPS, FS)
        x = _two_sat_scene(ea.samples_needed)
        re = np.real(x).astype(np.float32)
        im = np.imag(x).astype(np.float32)
        ca = ea.search((re, im), window_offset=100)
        cb = eb.search((re, im), window_offset=100)
        assert [c.prn for c in ca] == [c.prn for c in cb] == [4, 11]
        for a, b in zip(ca, cb):
            assert a.code_phase_samples == b.code_phase_samples
            assert a.sample_local_index == b.sample_local_index
            assert abs(a.carrier_freq_hz - b.carrier_freq_hz) < 0.5
            assert a.ratio == pytest.approx(b.ratio, rel=1e-3)

    def test_unported_engines_raise(self):
        """The conv engine (ROADMAP A11) is ported: it builds, with the
        JAX engine's grid, decimation, replicas, threshold, fine-search
        settings and window length; ``auto`` stays the FFT engine, and an
        unknown engine or a detector the conv engine lacks still
        raises."""
        cfg_kw = dict(engine="conv", coherent_ms=2, bit_edge_hypotheses=2)
        a = acquisition.AcquisitionEngine(AcqConfig(**cfg_kw), GPS_L1CA, FS,
                                          device=CPU)
        b = j_acq.AcquisitionEngine(JAcqConfig(**cfg_kw), J_GPS, FS)
        assert (a.engine, b.engine) == ("conv", "conv")
        np.testing.assert_array_equal(a.grid, b.grid)
        assert a.decim == b.decim == 2
        np.testing.assert_array_equal(a._codes_coarse_dev.numpy(),
                                      np.asarray(b._codes_coarse_dev))
        n_int = AcqConfig().non_coherent_ms
        assert a._default_threshold(n_int, a.grid) == \
            b._default_threshold(n_int, b.grid) > AcqConfig().detection_threshold
        assert (a._fine_squaring, a._fine_n_sub) == \
            (b._fine_squaring, b._fine_n_sub)
        assert a.samples_needed == b.samples_needed == (n_int + 1) * 2046
        assert acquisition.AcquisitionEngine(
            AcqConfig(), GPS_L1CA, FS, device=CPU).engine == "fft"
        with pytest.raises(ValueError, match="peak_avg"):
            acquisition.AcquisitionEngine(
                AcqConfig(engine="conv", detector="two_peak"), GPS_L1CA, FS,
                device=CPU)
        with pytest.raises(ValueError, match="unknown acquisition engine"):
            acquisition.AcquisitionEngine(AcqConfig(engine="dft"), GPS_L1CA,
                                          FS, device=CPU)

    def test_scheduler_matches(self):
        a = acquisition.SearchScheduler(AcqConfig())
        b = j_acq.SearchScheduler(JAcqConfig())
        for tracked, now in ((0, 0.0), (1, 600.0), (5, 900.0), (7, 3000.0)):
            a.update_mode(tracked)
            b.update_mode(tracked)
            assert a.mode.value == b.mode.value
            assert a.due(now) == b.due(now)
            assert a.candidates({1, 2}) == b.candidates({1, 2})
            a.mark_run(now)
            b.mark_run(now)
