"""The per-epoch fused layouts of the PyTorch port against the JAX
package, on the CPU: the plain PyTorch versions of B4a
(``track_block_fused``, windows), B4b (``track_block_fused_seg``) with
B4c (``gather_segments``) and B6 (``track_block_fused_resident``), and
their glue (``slice_windows``, ``build_replicas_shared``), against the
Pallas kernels in interpret mode and the XLA glue on identical streams,
replicas and state. The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from gnss_sdr_tpu.ops.pallas import track_block_fused as j_fused  # noqa: E402

from gnss_sdr_tpu_torch.config import TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402
from gnss_sdr_tpu_torch.receiver import fused_runner as fr  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

T = 20
C = 6
N_DRIFT = 5
EL_SHIFT = 1
EL_PAD = EL_SHIFT + (N_DRIFT - 1) // 2
LIVE = 5                            # channel 5 tracks an absent PRN

# name: (feed, fs, cfg) - n0 2046 and 2048, power and Costas, interp on and
# off, carrier aiding once; every case has the dying channel (the power
# threshold sits between the live channels' prompt power, ~1e6, and the
# noise's, ~4e2)
CASES = {
    "windows_2046_power": ("windows", 2_046_000.0,
                           dict(lock_threshold=5e4, max_lost_epochs=7)),
    "windows_2048_costas_interp": ("windows", 2_048_000.0, dict(
        lock_mode="costas", interp_code=True, max_lost_epochs=7)),
    "seg_2046_power_interp_aided": ("seg", 2_046_000.0, dict(
        interp_code=True, carrier_aiding=True, lock_threshold=5e4,
        max_lost_epochs=7)),
    "seg_2048_costas": ("seg", 2_048_000.0, dict(
        lock_mode="costas", max_lost_epochs=7)),
    "resident_2046_power": ("resident", 2_046_000.0,
                            dict(lock_threshold=5e4, max_lost_epochs=7)),
    "resident_2048_costas_interp": ("resident", 2_048_000.0, dict(
        lock_mode="costas", interp_code=True, max_lost_epochs=7)),
}
EXACT = [7, 12, 13, 15, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(feed, fs, cfg_kw):
    """Numpy inputs of one block: a 6-channel scene with every channel's
    code period starting at an offset off the 128 grid (channel 5's PRN
    absent, so it dies), the state matrix as the layout's glue builds it,
    the code rows and the statics."""
    n0 = GPS_L1CA.samples_per_code(fs)
    cfg = TrackConfig(n_channels=C, correlator="fused", **cfg_kw)
    params = trk.TrackParams.create(cfg, GPS_L1CA, fs)
    rate = GPS_L1CA.code_rate_hz
    offsets = np.array([37 + 331 * c for c in range(C)], np.int64)
    if feed != "resident":
        offsets += n0                       # >= el_pad, room for the preroll
    dopplers = [1200.0 - 410.0 * c for c in range(C)]
    sats = [SatelliteScenario(
        prn=c + 1, doppler_hz=dopplers[c], amplitude=0.5,
        code_phase_chips=(-offsets[c] * rate / fs) % 1023)
        for c in range(LIVE)]
    n = (T + 4) * n0 + 4096
    sig = synthesize(sats, n, fs, noise_std=0.3, seed=8)
    codes = trk.make_sampled_code_table(GPS_L1CA, fs, C + 1,
                                        window=params.window)
    rows = codes[[0, 1, 2, 3, 4, C]]        # channel 5: PRN 7, absent
    mat = np.zeros((C, fused.N_FIELDS), np.float32)
    mat[:, 0] = dopplers
    mat[:, 3] = rate
    mat[:, 7] = 1.0
    mat[:, 11] = 1.0
    p1, p2, d1, d2 = fused.loop_filter_consts(cfg)
    kw = dict(n0=n0, fs=fs, code_len=1023.0,
              lock_threshold=cfg.lock_threshold,
              max_lost=cfg.max_lost_epochs, pll_c1=p1, pll_c2=p2,
              dll_c1=d1, dll_c2=d2, el_shift=EL_SHIFT,
              aiding_scale=(params.aiding_scale if cfg.carrier_aiding
                            else 0.0),
              if_freq=0.0, lock_mode=cfg.lock_mode,
              costas_thr=cfg.costas_lock_threshold, interp=cfg.interp_code)
    return dict(re=np.real(sig).astype(np.float32),
                im=np.imag(sig).astype(np.float32), offsets=offsets,
                mat=mat, rows=rows, kw=kw, n0=n0, window=params.window)


def _both(feed, fs, cfg_kw):
    """(JAX telemetry [T, C, 17] and state, port telemetry and state, the
    glue arrays of both sides) for one case."""
    x = _inputs(feed, fs, cfg_kw)
    n0, kw, mat = x["n0"], x["kw"], x["mat"].copy()
    re_t, im_t = torch.from_numpy(x["re"]), torch.from_numpy(x["im"])
    re_j, im_j = jnp.asarray(x["re"]), jnp.asarray(x["im"])
    zeros = np.zeros(C, np.int32)
    glue = []
    if feed == "resident":
        wp = ((2 * n0 + 256 + 127) // 128) * 128
        need = 3 * n0 + wp + 2 * EL_PAD
        codes4x = np.tile(x["rows"][:, :n0], (1, -(-need // n0)))[:, :need]
        cp = np.zeros(C, np.float32)
        cps = np.full(C, np.float32(1.023e6) / np.float32(x["kw"]["fs"]),
                      np.float32)
        mat[:, 9] = x["offsets"]
        reps_j = j_fused.build_replicas_shared(
            jnp.asarray(codes4x), jnp.asarray(cp), jnp.asarray(cps),
            jnp.asarray(x["offsets"].astype(np.int32)), EL_SHIFT, n0, wp,
            n_drift=N_DRIFT)
        reps_t = fused.build_replicas_shared(
            torch.from_numpy(codes4x), cp, cps, x["offsets"], EL_SHIFT, n0,
            wp, n_drift=N_DRIFT)
        glue.append((np.asarray(reps_j), reps_t))
        tj, sj = j_fused.track_block_fused_resident(
            re_j, im_j, reps_j, jnp.asarray(mat), t_epochs=T, k_epochs=8,
            wp=wp, interpret=True, **kw)
        tt, st = fused.track_block_fused_resident(
            re_t, im_t, reps_t, torch.from_numpy(mat), t_epochs=T,
            k_epochs=8, wp=wp, **kw)
    elif feed == "windows":
        wp = ((x["window"] + 63 + 127) // 128) * 128
        off32 = x["offsets"].astype(np.int32)
        wre_j, wim_j = j_fused.slice_windows(re_j, im_j, jnp.asarray(off32),
                                             T, n0, wp, EL_PAD)
        wre_t, wim_t = fused.slice_windows(re_t, im_t, x["offsets"], T, n0,
                                           wp, EL_PAD)
        reps_j = j_fused.build_replicas(
            jnp.asarray(x["rows"]), None, None, EL_SHIFT, n0, wp,
            n_drift=N_DRIFT, anchor=jnp.asarray(zeros))
        reps_t = fused.build_replicas(torch.from_numpy(x["rows"]), EL_SHIFT,
                                      n0, wp, N_DRIFT, zeros)
        glue += [(np.asarray(wre_j), wre_t), (np.asarray(wim_j), wim_t),
                 (np.asarray(reps_j), reps_t)]
        tj, sj = j_fused.track_block_fused(wre_j, wim_j, reps_j,
                                           jnp.asarray(mat), interpret=True,
                                           **kw)
        tt, st = fused.track_block_fused(wre_t, wim_t, reps_t,
                                         torch.from_numpy(mat), **kw)
    else:
        wp = ((x["window"] + 256 + 63 + 127) // 128) * 128
        l_seg = fused.seg_length(T, n0, wp)
        assert l_seg == j_fused.seg_length(T, n0, wp)
        a_c = (((x["offsets"] - EL_PAD) // 128) * 128).astype(np.int32)
        mat[:, 9] = x["offsets"] - a_c
        rem_c0 = (x["offsets"] - a_c - EL_PAD).astype(np.int32)
        sre_j, sim_j = j_fused.gather_segments(re_j, im_j, jnp.asarray(a_c),
                                               l_seg, interpret=True)
        sre_t, sim_t = fused.gather_segments(re_t, im_t,
                                             torch.from_numpy(a_c), l_seg)
        reps_j = j_fused.build_replicas(
            jnp.asarray(x["rows"]), None, None, EL_SHIFT, n0, wp,
            n_drift=N_DRIFT, anchor=jnp.asarray(zeros),
            lane_shift=jnp.asarray(rem_c0))
        reps_t = fused.build_replicas(torch.from_numpy(x["rows"]), EL_SHIFT,
                                      n0, wp, N_DRIFT, zeros,
                                      lane_shift=rem_c0)
        glue += [(np.asarray(sre_j), sre_t), (np.asarray(sim_j), sim_t),
                 (np.asarray(reps_j), reps_t)]
        tj, sj = j_fused.track_block_fused_seg(
            sre_j, sim_j, reps_j, jnp.asarray(mat), t_epochs=T, wp=wp,
            interpret=True, **kw)
        tt, st = fused.track_block_fused_seg(
            sre_t, sim_t, reps_t, torch.from_numpy(mat), t_epochs=T, wp=wp,
            **kw)
    return (np.asarray(tj)[:, :, :ep.N_TELEM], np.asarray(sj),
            tt.numpy(), st.numpy(), glue)


@pytest.fixture(scope="module")
def runs():
    """Every case through both packages once (the JAX side in interpret
    mode), shared by the tests below."""
    before = chip_smoke._launch_counts()
    out = {name: _both(*case) for name, case in CASES.items()}
    # CPU tensors run the plain versions, which never count
    assert chip_smoke._launch_counts() == before
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_pallas_interpret(runs, case):
    tj, sj, tt, st, glue = runs[case]
    assert tt.shape == (T, C, ep.N_TELEM)
    # the glue (windows, segments, replica rows): bit for bit
    for a, b in glue:
        np.testing.assert_array_equal(b.numpy(), a)
    # telemetry: flags and integers exact, the rest within the tolerance
    # of the JAX suite's layout parity (tests/test_fused_kernel.py:201-204)
    for k in EXACT:
        np.testing.assert_array_equal(tt[..., k], tj[..., k], err_msg=str(k))
    for k in range(ep.N_TELEM):
        np.testing.assert_allclose(
            tt[..., k], tj[..., k], rtol=2e-5,
            atol=2e-4 * max(1.0, float(np.abs(tj[..., k]).max())),
            err_msg=f"telemetry col {k}")
    # the state's ledger exact: drift, chip_res, lost count, active
    np.testing.assert_array_equal(st[:, [4, 6, 7, 8]], sj[:, [4, 6, 7, 8]])
    np.testing.assert_allclose(st[:, :12], sj[:, :12], rtol=1e-4, atol=1e-3)
    # the live channels lock; the absent PRN's channel dies in the block
    assert tt[:, :LIVE, 7].mean() > 0.9
    assert st[LIVE, 7] == 0.0 and tt[:, LIVE, 15].sum() == 1.0


@pytest.mark.parametrize("feed,piece", [("windows", 5), ("seg", 5),
                                        ("resident", 10)])
def test_reference_in_pieces_matches_whole_block(feed, piece):
    """The open-loop pieces chip_smoke.py holds the kernels to: the plain
    version run piece by piece (``first_epoch``; B6 with the block's
    chunk) from its own state equals the whole block; B6 held to B4a on
    the same stream within the JAX suite's tolerances."""
    inp = chip_smoke.epoch_inputs(torch, feed, {}, device="cpu",
                                  block_ms=15 if feed == "seg" else 20)
    tk, sk, err = chip_smoke.epoch_open_loop(torch, feed, inp["args"],
                                             inp["kw"], piece=piece)
    assert err["corr_max_abs"] == 0.0 and err["state"] == 0.0
    assert bool(sk[:24, 7].all()) and not bool(sk[24:, 7].any())
    if feed == "resident":
        worst = chip_smoke.resident_vs_windows(torch, inp, piece=piece)
        assert worst[0] < 1e-5


def test_resident_chunk_and_seg_length():
    assert [ep.resident_chunk(t, 8) for t in (500, 40, 24, 7, 3)] == \
        [5, 8, 8, 7, 3]
    for t, n0, wp in ((125, 2046, 2432), (20, 2048, 2432), (7, 4092, 4608)):
        assert ep.seg_length(t, n0, wp) == j_fused.seg_length(t, n0, wp)
    assert ep.seg_length(125, 2046, 2432) == 256_128


def _small(feed):
    return chip_smoke.epoch_inputs(torch, feed, {}, device="cpu",
                                   block_ms=15 if feed == "seg" else 20)


@pytest.mark.parametrize("check", ["gather_unaligned", "gather_short",
                                   "seg_short", "resident_short",
                                   "windows_offsets"])
def test_read_bounds_raise(check):
    """Every read bound is checked on the host before a launch (the JAX
    glue clamps or leaves it to its caller)."""
    if check.startswith("gather") or check == "seg_short":
        inp = _small("seg")
        (sre, sim, starts, l_seg), g_kw = inp["gather"]
        if check == "seg_short":
            with pytest.raises(ValueError, match="out of bounds"):
                fused.track_block_fused_seg(*inp["args"], **dict(
                    inp["kw"], t_epochs=inp["kw"]["t_epochs"] + 2))
            return
        bad = starts.clone()
        bad[0] = (bad[0] + 64 if check == "gather_unaligned"
                  else (sre.shape[0] - l_seg + 128) // 128 * 128)
        with pytest.raises(ValueError, match="out of bounds or unaligned"):
            fused.gather_segments(sre, sim, bad, l_seg)
    elif check == "resident_short":
        inp = _small("resident")
        sre, sim, reps, st = inp["args"]
        n = inp["kw"]["t_epochs"] * inp["kw"]["n0"] + inp["kw"]["wp"] - 1
        with pytest.raises(ValueError, match="T\\*n0 \\+ wp"):
            fused.track_block_fused_resident(sre[:n], sim[:n], reps, st,
                                             **inp["kw"])
    else:
        x = torch.zeros(10 * 2046)
        with pytest.raises(ValueError, match="out of bounds"):
            fused.slice_windows(x, x, [2], 8, 2046, 2176, EL_PAD)
        with pytest.raises(ValueError, match="out of bounds"):
            fused.slice_windows(x, x, [100], 9, 2046, 2176, EL_PAD)


def test_wp_above_16384_raises_naming_c6():
    """The JAX _epoch_core breaks above 128 carrier A factors (ROADMAP
    C6: Galileo E1B at 8.184 MHz on seg, wp 33152). The port lifted its
    limit to MAX_WP = 49,152 (the widest window whose prompt row and trig
    factors fit in shared memory; tests/test_torch_wide_windows.py holds
    the plain version past 128 factors to a float64 oracle): a window of
    129 factors runs through the wrappers and FusedTracker builds on seg,
    windows and direct at 16.368 MHz (wp 16,768-16,896); above MAX_WP the
    wrappers and FusedTracker still raise naming C6."""
    wp = 128 * 129
    st = torch.zeros((2, fused.N_FIELDS))
    st[:, 3] = 1.023e6
    reps = torch.zeros((2, N_DRIFT, wp))
    seg = torch.zeros((2, fused.seg_length(1, 8184, wp)))
    tel, _ = fused.track_block_fused_seg(seg, seg, reps, st, t_epochs=1,
                                         n0=8184, wp=wp, fs=8_184_000.0)
    assert tel.shape == (1, 2, 17)
    win = torch.zeros((1, 2, wp))
    tel, _ = fused.track_block_fused(win, win, reps, st, n0=8184,
                                     fs=8_184_000.0)
    assert tel.shape == (1, 2, 17)
    big = fused.MAX_WP + 128
    assert fused.MAX_WP == 49152
    with pytest.raises(ValueError, match="C6"):
        fused.track_block_fused_seg(
            torch.zeros((2, big)), torch.zeros((2, big)),
            torch.zeros((2, N_DRIFT, big)), st, t_epochs=1, n0=8184, wp=big,
            fs=8_184_000.0)
    with pytest.raises(ValueError, match="C6"):
        fused.track_block_fused(
            torch.zeros((1, 2, big)), torch.zeros((1, 2, big)),
            torch.zeros((2, N_DRIFT, big)), st, n0=8184, fs=8_184_000.0)
    for fs, ok in ((16_368_000.0, True), (49_104_000.0, False)):
        cfg = TrackConfig(n_channels=2, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, fs)
        n0 = GPS_L1CA.samples_per_code(fs)
        codes = trk.make_sampled_code_table(GPS_L1CA, fs, 2,
                                            window=params.window)
        for layout in ("seg", "windows", "direct"):
            if ok:
                ft = fr.FusedTracker(params, cfg, GPS_L1CA, fs, codes, 15,
                                     4 * 20 * n0, layout=layout,
                                     device="cpu")
                assert 16384 < ft.wp <= fused.MAX_WP
                continue
            with pytest.raises(ValueError, match="C6"):
                fr.FusedTracker(params, cfg, GPS_L1CA, fs, codes, 15,
                                4 * 20 * n0, layout=layout, device="cpu")