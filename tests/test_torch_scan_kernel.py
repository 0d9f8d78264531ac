"""Kernel B7's host side on the CPU (ops/cuda/track_block_scan.py: the
scanned tracker's block of epochs in one launch; the kernel itself runs
only on the card, tests/test_torch_cuda.py holds it to the op loop there):

  * the dispatch: which correlators reach B7's wrapper from the tracker,
    which device reaches its launcher (faked here) and which its plain
    version, the op loop, bit for bit;
  * the wrapper's argument checks;
  * the host-side parameter pack: the f32 constants equal to what
    ``epoch_step``'s ops round its Python constants to, and the integers;
  * the cluster size and the shared memory a block takes;
  * chip_smoke.scan_chain_check (B7's multi-epoch launch against its
    chained one-epoch launches on the card) on the plain version, and
    that it finds a fault.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu_torch.config import TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GALILEO_E1B, GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops import nco  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_scan as b7  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

import chip_smoke  # noqa: E402

FS = 2_046_000.0
N0 = GPS_L1CA.samples_per_code(FS)
N_EPOCHS = 6


def _ledger(c=3):
    """PRN 3 and PRN 8 started on their code boundaries, the rest idle."""
    st = trk.init_state(c)
    st = trk.start_channel(st, 0, 2, 1200.0, 0, GPS_L1CA.code_rate_hz)
    return trk.start_channel(st, 1, 7, -700.0, 0, GPS_L1CA.code_rate_hz)


def _inputs(correlator="shift", c=3, **cfg_kw):
    """Two satellites tracked from their code boundaries and an idle
    channel, 8 code periods of stream: (params, codes, ins, re, im)."""
    sig = synthesize([SatelliteScenario(prn=3, doppler_hz=1200.0),
                      SatelliteScenario(prn=8, doppler_hz=-700.0)],
                     8 * N0, FS, noise_std=0.5, seed=2)
    params = trk.TrackParams.create(
        TrackConfig(n_channels=c, correlator=correlator, **cfg_kw),
        GPS_L1CA, FS)
    st = _ledger(c)
    if correlator in ("slice", "fused"):
        table = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                            window=params.window)
    else:
        table = trk.make_code_table(GPS_L1CA, 32)
    codes = torch.from_numpy(table[np.maximum(st.prn_idx, 0)])
    ins = torch.from_numpy(trk._pack_inputs(st, sig.size))
    re = torch.from_numpy(np.real(sig).astype(np.float32))
    im = torch.from_numpy(np.imag(sig).astype(np.float32))
    return params, codes, ins, re, im


@pytest.mark.parametrize("correlator", trk.CORRELATORS)
def test_tracker_reaches_b7_for_shift_and_pallas_only(monkeypatch,
                                                      correlator):
    """The tracker's block goes through B7's wrapper with the correlators
    whose sums B7 computes; on the CPU the wrapper runs the op loop,
    equal bit for bit to the op loop called directly, and never reaches
    the launcher."""
    reached, launched = [], []
    wrapper = b7.track_block_scan

    def spy(*args):
        reached.append(args[0].correlator)
        return wrapper(*args)

    monkeypatch.setattr(b7, "track_block_scan", spy)
    monkeypatch.setattr(b7, "_launch", lambda *a: launched.append(a))
    params, codes, ins, re, im = _inputs(correlator)
    got = trk._run_epochs(params, codes, ins, re, im, N_EPOCHS)
    assert reached == ([correlator] if correlator in ("shift", "pallas")
                       else [])
    assert not launched
    want = trk.run_epoch_ops(params, codes, ins, re, im, N_EPOCHS)
    assert torch.equal(got, want)
    _, tl = trk.unpack_block(got, 3, N_EPOCHS)
    assert tl.processed[:, :2].all() and not tl.processed[:, 2].any()


@pytest.mark.parametrize("cfg_kw", [
    {}, dict(lock_mode="costas", carrier_aiding=True, interp_code=True)])
def test_chain_check_holds_on_the_plain_version(cfg_kw):
    """chip_smoke.scan_chain_check, which holds B7's multi-epoch launch to
    its chained one-epoch launches on the card, on the CPU, where the
    wrapper runs the op loop: one call of N_EPOCHS epochs equals
    N_EPOCHS chained one-epoch calls bit for bit, the ledger carried
    between them in its int32 bits, a full block and a tail alike."""
    params, codes, ins, re, im = _inputs(**cfg_kw)
    for limit in (re.shape[0], 3 * N0 + N0 // 2):
        chip_smoke.scan_chain_check(torch, params, codes, _ledger(), re, im,
                                    N_EPOCHS, limit, "plain")


@pytest.mark.parametrize("where", ["telemetry", "end state"])
def test_chain_check_finds_a_multi_epoch_fault(monkeypatch, where):
    """A multi-epoch launch that differs from the chain in one bit, in the
    telemetry of epoch 3 or in the end state, fails the check, which names
    the first epoch differing or the end state."""
    params, codes, ins, re, im = _inputs()
    wrapper = b7.track_block_scan
    c = codes.shape[0]

    def faulty(*args):
        out = wrapper(*args)
        if args[-1] > 1:
            k = (13 * c + 9 * N_EPOCHS * c + 3 * c if where == "telemetry"
                 else 5 * c)
            out[k] ^= 1
        return out

    monkeypatch.setattr(b7, "track_block_scan", faulty)
    with pytest.raises(AssertionError, match=(
            "first epoch differing', 3" if where == "telemetry"
            else "end state")):
        chip_smoke.scan_chain_check(torch, params, codes, _ledger(), re, im,
                                    N_EPOCHS, re.shape[0], "plain")


def test_b7_wrapper_launches_on_the_card_and_never_the_plain(monkeypatch):
    """CUDA tensors reach the launcher (faked, the device faked by the
    argument check) and never the op loop; an unknown device raises."""
    params, codes, ins, re, im = _inputs()
    launched, plain = [], []
    monkeypatch.setattr(b7, "_launch", lambda *a: launched.append(a) or "k")
    monkeypatch.setattr(trk, "run_epoch_ops", lambda *a: plain.append(a))
    monkeypatch.setattr(b7, "_check_args",
                        lambda *a: torch.device("cuda", 0))
    assert b7.track_block_scan(params, codes, ins, re, im, N_EPOCHS) == "k"
    assert len(launched) == 1 and launched[0][-1] == N_EPOCHS and not plain
    monkeypatch.setattr(b7, "_check_args", lambda *a: torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        b7.track_block_scan(params, codes, ins, re, im, N_EPOCHS)
    assert len(launched) == 1 and not plain


def _bad_args():
    """(name, callable that turns good arguments into bad ones, error)."""
    def swap(i, fn):
        def make(args):
            args = list(args)
            args[i] = fn(args[i])
            return args
        return make

    return [
        ("exact correlator", swap(0, lambda p: dataclasses.replace(
            p, correlator="exact")), (ValueError, "correlator")),
        ("ins int64", swap(2, lambda t: t.long()), (TypeError, "ins")),
        ("ins for another C", swap(2, lambda t: t[:-2].contiguous()),
         (ValueError, "13")),
        ("re float64", swap(3, lambda t: t.double()), (TypeError, "block_re")),
        ("re 2-D", swap(3, lambda t: t.view(2, -1)), (ValueError, "[N]")),
        ("im shorter", swap(4, lambda t: t[:-1].contiguous()),
         (ValueError, "[N]")),
        ("codes 1-D", swap(1, lambda t: t[0].contiguous()),
         (ValueError, "codes")),
        ("no channels", swap(1, lambda t: t[:0]), (ValueError, "C >= 1")),
        ("codes strided", swap(1, lambda t: t[:, ::2]),
         (ValueError, "contiguous")),
        ("codes on another device", swap(1, lambda t: t.to("meta")),
         (ValueError, "codes is on")),
        ("block shorter than the window", lambda a: [
            a[0], a[1], a[2], a[3][:a[0].window - 1].contiguous(),
            a[4][:a[0].window - 1].contiguous(), a[5]],
         (ValueError, "window")),
        ("no epochs", swap(5, lambda n: 0), (ValueError, "n_epochs")),
        ("window past shared memory", lambda a: [
            dataclasses.replace(a[0], window=500_000), a[1], a[2],
            torch.zeros(600_000), torch.zeros(600_000), a[5]],
         (ValueError, "shared memory")),
    ]


@pytest.mark.parametrize("name,make,err", _bad_args(),
                         ids=[b[0] for b in _bad_args()])
def test_b7_wrapper_rejects_what_it_does_not_take(name, make, err):
    params, codes, ins, re, im = _inputs()
    args = make([params, codes, ins, re, im, N_EPOCHS])
    exc, match = err
    with pytest.raises(exc, match=match.replace("[", r"\[").replace(
            "]", r"\]")):
        b7.track_block_scan(*args)


def _f32_times(x: float) -> float:
    """What an f32 tensor op makes of the Python float x (as epoch_step's
    products with its loop-filter gains)."""
    return float(torch.ones((), dtype=torch.float32) * x)


@pytest.mark.parametrize("signal,fs,cfg_kw", [
    (GPS_L1CA, 2_048_000.0, {}),
    (GPS_L1CA, 2_046_000.0, dict(lock_mode="costas", carrier_aiding=True,
                                 pll_bandwidth_hz=15.0, dll_damping=1.0)),
    (GALILEO_E1B, 8_184_000.0, dict(interp_code=True)),
], ids=["rtlsdr", "costas_aiding", "e1b_8184k"])
def test_parameter_pack_equals_epoch_step_constants(signal, fs, cfg_kw):
    p = trk.TrackParams.create(TrackConfig(**cfg_kw), signal, fs,
                               if_freq_hz=1250.5)
    k = b7.scan_constants(p)
    assert tuple(k) == b7.CONSTS
    assert k["inv_fs"] == nco.inv_f32(p.fs_hz)
    # torch.full_like(code_rate, fs_l) holds the code period exactly
    assert float(torch.full((), k["fs_l"], dtype=torch.float32)) == \
        k["fs_l"] == float(np.float32(fs) * np.float32(p.code_length))
    # carr_freq - if_freq_hz
    assert float(torch.zeros((), dtype=torch.float32) - p.if_freq_hz) == \
        -k["if_freq"]
    assert k["aiding_scale"] == float(np.float32(p.aiding_scale))
    for name, x in (("pll_k1", p.dt / p.pll_tau1),
                    ("pll_k2", p.pll_tau2 / p.pll_tau1),
                    ("dll_k1", p.dt / p.dll_tau1),
                    ("dll_k2", p.dll_tau2 / p.dll_tau1)):
        assert k[name] == _f32_times(x), name
    # the thresholds compare as f32: the value itself is not above them,
    # the next f32 is
    for name, x in (("lock_threshold", p.lock_threshold),
                    ("costas_threshold", p.costas_lock_threshold)):
        at = torch.tensor(k[name], dtype=torch.float32)
        up = torch.nextafter(at, torch.tensor(np.inf, dtype=torch.float32))
        assert not bool(at > x) and bool(up > x), name
    s = b7.scan_statics(p, 9999, 777, 101)
    assert tuple(s) == b7.STATICS
    assert s == {"n_block": 9999, "window": p.window, "n_code": 777,
                 "shift": p.el_shift, "oversample": p.oversample,
                 "interp": int(p.interp_code),
                 "costas": int(p.lock_mode == "costas"),
                 "aiding": int(p.carrier_aiding),
                 "code_length": p.code_length,
                 "max_lost": p.max_lost_epochs, "n_epochs": 101}


def test_cluster_size_follows_b5_rule():
    """8 blocks a channel up to 33 channels on 132 SMs (the rtlsdr
    default's 15, the main path's 32 and a mesh's 16 and 8 alike, whose
    sums then agree bit for bit), fewer past that, the largest that fits
    on the card otherwise, None where none does."""
    all_fit = dict.fromkeys(b7.CLUSTER_SIZES, True)
    got = {c: b7.pick_cluster(all_fit, c, 132)
           for c in (1, 8, 15, 16, 32, 34, 67, 133)}
    assert got == {1: 8, 8: 8, 15: 8, 16: 8, 32: 8, 34: 4, 67: 2, 133: 1}
    assert b7.pick_cluster({8: False, 4: True, 2: True}, 15, 132) == 4
    assert b7.pick_cluster({8: False, 4: False, 2: False, 1: False}, 15,
                           132) is None


def test_lane_parts_cover_the_window_and_fit_shared_memory():
    """Each block's lane part at the rtlsdr default's window (2056), the
    main path's (2054) and Galileo's at 8.184 MHz (32,744 lanes, a
    8184-float code row): the parts cover the window, and a block's code
    row and two slots fit in its shared memory at cluster 8."""
    for w, n_code in ((2056, 1023), (2054, 1023), (8192, 1023),
                      (32_744, 8184)):
        for cs in b7.CLUSTER_SIZES:
            part = b7.lane_part(w, cs)
            assert (cs - 1) * part < w <= cs * part
        assert b7.smem_bytes(n_code, w, 8) <= b7.SMEM_BYTES
