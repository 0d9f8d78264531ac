"""The port's E/P/L correlators (ops/correlator.py) and kernel B5's
wrapper (ops/cuda/epl_correlator.py, its plain version on CPU tensors)
against the JAX package on the CPU: the vmapped XLA correlators and
``epl_correlate_pallas`` in Pallas interpret mode, on
tests/test_pallas.py's inputs, a Galileo E1B (BOC, two samples per chip)
case and the epoch mask; bad arguments raise.

Tolerance: each of the six sums within 1e-4 of its column's largest
|value| (CPU sin/cos of the two frameworks differ by ulps; the chip
indices, formed with the same fused multiply-add, agree exactly).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from gnss_sdr_tpu.ops import correlator as jcorr  # noqa: E402
from gnss_sdr_tpu.ops import nco as jnco  # noqa: E402
from gnss_sdr_tpu.ops.pallas.epl_correlator import (  # noqa: E402
    epl_correlate_pallas as j_pallas)

from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GALILEO_E1B, GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops import correlator as corr  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

FS = 2_048_000.0
W = 2056
SHIFT = 1
FIELDS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_inputs(n_ch=4, seed=0):
    """tests/test_pallas.py's inputs (numpy)."""
    rng = np.random.default_rng(seed)
    sig = synthesize(
        [SatelliteScenario(prn=p + 1, doppler_hz=500.0 * p,
                           code_phase_chips=10.0 * p) for p in range(n_ch)],
        W, FS, noise_std=1.0, seed=seed)
    re = np.tile(np.real(sig).astype(np.float32), (n_ch, 1))
    im = np.tile(np.imag(sig).astype(np.float32), (n_ch, 1))
    n_valid = np.full(n_ch, 2048, np.int32)
    carr_acc = rng.integers(0, 2**32, n_ch, dtype=np.uint32)
    carr_step = np.asarray(jnco.freq_to_step(
        np.float32(1000.0) * np.arange(n_ch, dtype=np.float32), FS))
    chip_int = rng.integers(0, 1023, n_ch).astype(np.int32)
    chip_frac = rng.random(n_ch).astype(np.float32)
    cps = np.full(n_ch, 1.023e6 / FS, np.float32)
    codes = np.stack([GPS_L1CA.code_table()[p].astype(np.float32)
                      for p in range(n_ch)])
    return re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac, cps, \
        codes


def to_port(args):
    """The port's types: u32 accumulators as int64."""
    out = []
    for a in args:
        a = np.asarray(a)
        out.append(torch.from_numpy(
            a.astype(np.int64) if a.dtype == np.uint32 else a.copy()))
    return tuple(out)


def assert_sums_close(got, ref, tol=1e-4):
    worst = 0.0
    for f in FIELDS:
        a = np.asarray(getattr(got, f), np.float64)
        b = np.asarray(getattr(ref, f), np.float64)
        rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        assert rel < tol, (f, rel)
        worst = max(worst, rel)
    print(f"\nsums: <= {worst:.3e} of the column max")
    return worst


@pytest.mark.parametrize("interp", [False, True])
def test_shift_and_b5_match_jax(interp):
    args = make_inputs()
    ref = jax.vmap(functools.partial(
        jcorr.epl_correlate_one_shift, shift=SHIFT, oversample=1,
        interp=interp))(*args)
    pal = j_pallas(*args, shift=SHIFT, oversample=1, interp=interp,
                   interpret=True)
    got = corr.epl_correlate_one_shift(*to_port(args), shift=SHIFT,
                                       interp=interp)
    b5.reset_launch_count()
    got_b5 = b5.epl_correlate_pallas(*to_port(args), shift=SHIFT,
                                     interp=interp)
    assert b5.launch_count == 0           # CPU tensors: the plain version
    assert_sums_close(got, ref)
    assert_sums_close(got_b5, pal)
    for f in FIELDS:                       # the wrapper IS the plain version
        assert torch.equal(getattr(got_b5, f), getattr(got, f))


def test_exact_matches_jax():
    args = make_inputs(seed=3)
    ref = jcorr.epl_correlate_batch(*args, el_space=0.5)
    assert_sums_close(corr.epl_correlate_batch(*to_port(args), el_space=0.5),
                      ref)
    assert corr.epl_correlate is corr.epl_correlate_one


def test_slice_matches_jax():
    args = list(make_inputs(seed=4))
    n0 = GPS_L1CA.samples_per_code(FS)
    table = trk.make_sampled_code_table(GPS_L1CA, FS, 4, window=W)
    args[8] = table
    ref = jax.vmap(functools.partial(jcorr.epl_correlate_one_slice,
                                     shift=SHIFT, n0=n0))(*args)
    got = corr.epl_correlate_one_slice(*to_port(args), shift=SHIFT, n0=n0)
    assert_sums_close(got, ref)


@pytest.mark.parametrize("interp", [False, True])
def test_boc_oversample(interp):
    """Galileo E1B at 8.184 MHz, subcarrier baked in at two samples per
    chip, shift 4: B5's plain version against the Pallas kernel, and
    (nearest-chip replica) the aligned noiseless prompt ~ W."""
    n_ch, fs, w = 2, 8_184_000.0, 1024
    sig = synthesize([SatelliteScenario(prn=1, signal=GALILEO_E1B)], w, fs)
    re = np.tile(np.real(sig).astype(np.float32), (n_ch, 1))
    im = np.tile(np.imag(sig).astype(np.float32), (n_ch, 1))
    codes = trk.make_code_table(GALILEO_E1B, n_ch)
    args = (re, im, np.full(n_ch, w, np.int32), np.zeros(n_ch, np.uint32),
            np.zeros(n_ch, np.uint32), np.zeros(n_ch, np.int32),
            np.zeros(n_ch, np.float32), np.full(n_ch, 1.023e6 / fs,
                                                np.float32), codes)
    pal = j_pallas(*args, shift=4, oversample=2, interp=interp,
                   interpret=True)
    got = b5.epl_correlate_pallas(*to_port(args), shift=4, oversample=2,
                                  interp=interp)
    assert_sums_close(got, pal)
    if not interp:
        assert float(got.i_p[0]) > 0.9 * w


def test_mask_respected():
    args = list(make_inputs(n_ch=2, seed=1))
    full = b5.epl_correlate_pallas(*to_port(args), shift=SHIFT)
    args[2] = np.array([1024, 2048], np.int32)
    half = b5.epl_correlate_pallas(*to_port(args), shift=SHIFT)
    assert not np.allclose(full.i_p[0].numpy(), half.i_p[0].numpy())
    assert float(full.i_p[1]) == float(half.i_p[1])
    assert_sums_close(half, j_pallas(*args, shift=SHIFT, interpret=True))


def test_make_code_table_matches_jax():
    from gnss_sdr_tpu.models import GALILEO_E1B as J_E1B
    from gnss_sdr_tpu.models import GPS_L1CA as J_GPS
    from gnss_sdr_tpu.receiver.tracking import make_code_table as j_table

    for spec, jspec in ((GPS_L1CA, J_GPS), (GALILEO_E1B, J_E1B)):
        np.testing.assert_array_equal(trk.make_code_table(spec, 3),
                                      np.asarray(j_table(jspec, 3)))


@pytest.mark.parametrize("k,bad,err", [
    (3, lambda x: x.to(torch.int32), TypeError),            # carr_acc dtype
    (2, lambda x: x[:1], ValueError),                       # n_valid shape
    (0, lambda x: torch.cat([x, x], 1)[:, ::2], ValueError),  # not contiguous
    (8, lambda x: x.to(torch.float64), TypeError),          # codes dtype
    (0, lambda x: x.numpy(), TypeError),                    # not a tensor
])
def test_bad_arguments_raise(k, bad, err):
    args = list(to_port(make_inputs(n_ch=2)))
    args[k] = bad(args[k])
    with pytest.raises(err):
        b5.epl_correlate_pallas(*args, shift=SHIFT)
