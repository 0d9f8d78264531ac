"""The port's digital front end (ops/frontend.py) against the JAX
package's on the CPU, on tests/test_frontend.py's cases: the DC tracker
against the serial IIR and across blocks, the decimator's tone and alias
rejection, the IF-to-baseband chain, mixer phase continuity, pulse
blanking and AGC.

Tolerances: the mixer's carried uint32 phase EQUAL to the JAX package's;
conditioned samples within 1e-4 of the JAX output's largest |value|
(the DC scan and the FIR sum in other orders, and CPU sin/cos differ by
ulps); the carried biases and AGC gain rtol 1e-5 (atol 1e-6).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu.ops import frontend as jfe  # noqa: E402

from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops import frontend as fe  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _close(name, got, ref, tol=1e-4):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    rel = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                               1e-30)
    print(f"\n{name}: {rel:.3e} of the max |value|")
    assert rel < tol, (name, rel)


class TestDcRemoval:
    def test_matches_serial_iir_and_jax(self):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(5000) + 3.7).astype(np.float32)
        alpha = 0.001
        out, _, bias_end, _ = fe.dc_offset_scan(_t(x), _t(x * 0), alpha)
        bias = 0.0
        ref = np.empty_like(x)
        for i, v in enumerate(x):
            bias = (1 - alpha) * bias + alpha * v
            ref[i] = v - bias
        np.testing.assert_allclose(out.numpy(), ref, atol=2e-3)
        assert float(bias_end) == pytest.approx(bias, abs=2e-3)
        jout, _, jb, _ = jfe.dc_offset_scan(x, x * 0, alpha)
        _close("dc scan", out.numpy(), jout)
        assert float(bias_end) == pytest.approx(float(jb), rel=1e-5)

    def test_state_carries_across_blocks(self):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal(4000) + 1.5).astype(np.float32)
        full, _, _, _ = fe.dc_offset_scan(_t(x), _t(x * 0), 0.01)
        a, _, br, bi = fe.dc_offset_scan(_t(x[:2000]), _t(x[:2000] * 0), 0.01)
        b, _, _, _ = fe.dc_offset_scan(_t(x[2000:]), _t(x[2000:] * 0), 0.01,
                                       br, bi)
        np.testing.assert_allclose(torch.cat([a, b]).numpy(), full.numpy(),
                                   atol=1e-4)

    def test_underflowing_slope_stays_finite(self):
        """(1-a)^n reaches 0 inside a long block: no NaN, DC removed."""
        x = np.full(200_000, 5.0, np.float32)
        out, _, b, _ = fe.dc_offset_scan(_t(x), _t(x * 0), 0.01, 2.0, 0.0)
        assert torch.isfinite(out).all()
        assert abs(float(out[-1])) < 1e-3
        assert float(b) == pytest.approx(5.0, abs=1e-4)


class TestDecimation:
    @pytest.mark.parametrize("f0,in_band", [(100_000.0, True),
                                            (1_900_000.0, False)])
    def test_tone_and_alias_against_jax(self, f0, in_band):
        fs, m = 8_192_000.0, 4
        t = np.arange(65536) / fs
        re = np.cos(2 * np.pi * f0 * t).astype(np.float32)
        im = np.sin(2 * np.pi * f0 * t).astype(np.float32)
        taps = fe.design_lowpass_fir(64, 0.8 / m)
        np.testing.assert_array_equal(taps, jfe.design_lowpass_fir(64, 0.8 / m))
        dre, dim = fe.polyphase_decimate(_t(re), _t(im), taps, m)
        jre, jim = jfe.polyphase_decimate(re, im, taps, m)
        assert dre.shape[0] == re.size // m
        power = float(np.mean(dre.numpy() ** 2 + dim.numpy() ** 2))
        if in_band:
            _close("decimated tone re", dre.numpy(), jre)
            _close("decimated tone im", dim.numpy(), jim)
            assert power == pytest.approx(1.0, abs=0.1)
        else:
            # > 30 dB rejection, as the JAX package's test
            assert power < 1e-3
            np.testing.assert_allclose(dre.numpy(), np.asarray(jre),
                                       atol=1e-5)


class TestConditionChain:
    def test_if_to_baseband_with_decimation(self):
        """A 16.368 MHz capture at a 4.092 MHz IF, mixed and decimated 4x
        with DC removal: equal to the JAX chain, and the code still
        correlates at the output rate."""
        fs_in, m, f_if, doppler = 16_368_000.0, 4, 4_092_000.0, 1500.0
        n = 16368 * 4
        sig = synthesize([SatelliteScenario(prn=4, doppler_hz=doppler)],
                         n, fs_in, f_if_hz=f_if)
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)
        kw = dict(fs_hz=fs_in, decimation=m, enable_dc=True)
        ore, oim, acc, br, bi, _ = fe.condition_block(
            _t(re), _t(im), np.float32(f_if), np.uint32(0), np.float32(0),
            np.float32(0), **kw)
        jre, jim, jacc, jbr, jbi, _ = jfe.condition_block(
            re, im, np.float32(f_if), np.uint32(0), np.float32(0),
            np.float32(0), **kw)
        assert int(acc) == int(jacc)
        _close("IF chain re", ore.numpy(), jre)
        _close("IF chain im", oim.numpy(), jim)
        for a, b in ((br, jbr), (bi, jbi)):
            assert float(a) == pytest.approx(float(b), rel=1e-5, abs=1e-6)
        fs_out = fs_in / m
        out = ore.numpy() + 1j * oim.numpy()
        n_out = int(fs_out / 1000)
        rep = GPS_L1CA.sample_code(4, 1.023e6, fs_out).astype(np.float32)
        lo = np.exp(-2j * np.pi * doppler / fs_out * np.arange(n_out))
        seg = out[n_out:2 * n_out] * lo
        corr = np.abs(np.fft.ifft(np.fft.fft(seg) * np.conj(np.fft.fft(rep))))
        assert corr.max() / corr.mean() > 10.0

    def test_mixer_phase_continuity(self):
        fs, f_if, n = 2_048_000.0, 300_000.0, 4096
        i = np.arange(2 * n)
        tone_re = np.cos(2 * np.pi * f_if / fs * i).astype(np.float32)
        tone_im = np.sin(2 * np.pi * f_if / fs * i).astype(np.float32)
        kw = dict(fs_hz=fs, enable_dc=False)
        r1, _, acc, br, bi, _ = fe.condition_block(
            _t(tone_re[:n]), _t(tone_im[:n]), np.float32(f_if),
            np.uint32(0), np.float32(0), np.float32(0), **kw)
        r2, _, acc2, _, _, _ = fe.condition_block(
            _t(tone_re[n:]), _t(tone_im[n:]), np.float32(f_if), acc, br, bi,
            **kw)
        _, _, jacc, _, _, _ = jfe.condition_block(
            tone_re[:n], tone_im[:n], np.float32(f_if), np.uint32(0),
            np.float32(0), np.float32(0), **kw)
        _, _, jacc2, _, _, _ = jfe.condition_block(
            tone_re[n:], tone_im[n:], np.float32(f_if), jacc,
            np.float32(0), np.float32(0), **kw)
        assert (int(acc), int(acc2)) == (int(jacc), int(jacc2))
        out = torch.cat([r1, r2]).numpy()
        assert np.abs(out - 1.0).max() < 1e-3


class TestBlankingAndAgc:
    def test_blanking_and_agc_against_jax(self):
        fs = 2_048_000.0
        n = GPS_L1CA.samples_per_code(fs)
        sig = 50.0 * synthesize(
            [SatelliteScenario(prn=8, doppler_hz=1000.0, amplitude=0.2)],
            10 * n, fs, noise_std=1.0, seed=5)
        rng = np.random.default_rng(1)
        idx = rng.choice(sig.size, sig.size // 100, replace=False)
        sig[idx] += 5000.0 * np.exp(1j * rng.random(idx.size) * 6.28)
        re = np.real(sig).astype(np.float32)
        im = np.imag(sig).astype(np.float32)
        bre, bim, frac = fe.pulse_blank(_t(re), _t(im), 5.0)
        jbre, jbim, jfrac = jfe.pulse_blank(re, im, 5.0)
        np.testing.assert_array_equal(bre.numpy() == 0, np.asarray(jbre) == 0)
        assert 0.005 < float(frac) < 0.05
        assert float(frac) == pytest.approx(float(jfrac), rel=1e-6)
        kw = dict(fs_hz=fs, enable_dc=True, enable_mix=False,
                  blank_sigma=5.0, enable_agc=True)
        out = fe.condition_block(_t(re), _t(im), np.float32(0), np.uint32(0),
                                 np.float32(0), np.float32(0),
                                 np.float32(1.0), **kw)
        jout = jfe.condition_block(re, im, np.float32(0), np.uint32(0),
                                   np.float32(0), np.float32(0),
                                   np.float32(1.0), **kw)
        _close("blank+agc+dc re", out[0].numpy(), jout[0])
        _close("blank+agc+dc im", out[1].numpy(), jout[1])
        for k in (3, 4, 5):
            assert float(out[k]) == pytest.approx(float(jout[k]), rel=1e-5,
                                                  abs=1e-6)
        # one block of the 50x-hot input: the gain moves a tenth of the
        # way toward 1 / rms
        assert 0.9 < float(out[5]) < 0.91
