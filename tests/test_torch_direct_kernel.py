"""Kernel B3 (direct fused tracking) and B1's lean telemetry mode of the
PyTorch port against the JAX package, on the CPU: the port's plain
PyTorch versions against the Pallas kernels in interpret mode on
identical stream, starts, replicas and state; FusedTracker.run_block on
the direct layout over several blocks from the same ledger. The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
from gnss_sdr_tpu.ops.pallas import track_block_fused as j_fused  # noqa: E402
from gnss_sdr_tpu.receiver import fused_runner as j_fr  # noqa: E402
from gnss_sdr_tpu.receiver import tracking as j_trk  # noqa: E402

from gnss_sdr_tpu_torch.config import TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, synthesize)
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402
from gnss_sdr_tpu_torch.receiver import fused_runner as fr  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

FS = 2_046_000.0
N0 = GPS_L1CA.samples_per_code(FS)
T = 20
HISTORY = 2 * N0 + 4096
DOPPLERS = [800.0, -950.0, 0.0]
OFFSETS = [N0, N0 + 77, 0]          # channel 1 off the 128 grid
ACTIVE = [1, 1, 0]                  # channel 2 idle: the inactive path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(n, seed=4):
    sats = [SatelliteScenario(
        prn=c + 1, doppler_hz=DOPPLERS[c], amplitude=0.5,
        code_phase_chips=(-OFFSETS[c] * GPS_L1CA.code_rate_hz / FS) % 1023)
        for c in range(2)]
    sig = synthesize(sats, n, FS, noise_std=0.2, seed=seed)
    return (np.real(sig).astype(np.float32),
            np.imag(sig).astype(np.float32))


def _direct_inputs(cfg_kw, k_epochs):
    """Stream, starts, f32 replica rows, state matrix and statics for a
    3-channel direct-layout block built as FusedTracker.run_block builds
    them."""
    cfg = JTrackConfig(n_channels=3, correlator="fused", **cfg_kw)
    params = j_trk.TrackParams.create(cfg, J_GPS, FS)
    el_shift = params.el_shift
    el_pad = el_shift + (fr.N_DRIFT - 1) // 2
    wp = ((params.window + 384 + 63 + 127) // 128) * 128
    sre, sim = _scene(HISTORY + T * N0)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 3,
                                        window=params.window)
    mat = np.zeros((3, fused.N_FIELDS), np.float32)
    a_c = np.zeros(3, np.int32)
    for c in range(3):
        mat[c, 0], mat[c, 3] = DOPPLERS[c], GPS_L1CA.code_rate_hz
        mat[c, 7], mat[c, 11] = ACTIVE[c], 1.0
        if ACTIVE[c]:
            a_c[c] = ((OFFSETS[c] - el_pad) // 128) * 128
            mat[c, 9] = OFFSETS[c] - a_c[c]
        else:
            mat[c, 9] = el_pad
    lane = (mat[:, 9] - el_pad).astype(np.int32)
    reps = fused.build_replicas(torch.from_numpy(codes), el_shift, N0, wp,
                                fr.N_DRIFT, np.zeros(3, np.int32),
                                lane_shift=lane).numpy()
    p1, p2, d1, d2 = fused.loop_filter_consts(cfg)
    kw = dict(t_epochs=T, k_epochs=k_epochs, n0=N0, wp=wp, fs=FS,
              code_len=1023.0, lock_threshold=cfg.lock_threshold,
              max_lost=cfg.max_lost_epochs, pll_c1=p1, pll_c2=p2,
              dll_c1=d1, dll_c2=d2, el_shift=el_shift,
              aiding_scale=(params.aiding_scale if cfg.carrier_aiding
                            else 0.0),
              if_freq=0.0, lock_mode=cfg.lock_mode,
              costas_thr=cfg.costas_lock_threshold, interp=cfg.interp_code)
    return sre, sim, a_c, reps, mat, kw


def _torch_args(sre, sim, a_c, reps, mat):
    return tuple(torch.from_numpy(x) for x in (sre, sim, a_c, reps, mat))


# K=2 keeps the interpret-mode compile short (its body unrolls 2K
# epochs); the receiver's K=10 is held by TestRunBlockDirect
CASES = {
    "power": {},
    "costas": dict(lock_mode="costas"),
    "interp": dict(interp_code=True),
    "carrier_aiding": dict(carrier_aiding=True),
    "forced_death": dict(lock_threshold=1e12, max_lost_epochs=7),
}


class TestDirectPlainVsJax:
    @pytest.mark.parametrize("case", list(CASES))
    def test_plain_matches_pallas_interpret(self, case):
        sre, sim, a_c, reps, mat, kw = _direct_inputs(CASES[case], 2)
        tj, sj = j_fused.track_block_fused_direct(
            jnp.asarray(sre), jnp.asarray(sim), jnp.asarray(a_c),
            jnp.asarray(reps), jnp.asarray(mat), interpret=True, **kw)
        tj = np.asarray(tj)[:, :, :fused.N_TELEM_DIRECT]
        sj = np.asarray(sj)
        before = fused.direct_launch_count
        tt, st = fused.track_block_fused_direct(
            *_torch_args(sre, sim, a_c, reps, mat), **kw)
        # a CPU tensor runs the plain version, which never counts
        assert fused.direct_launch_count == before
        assert tt.shape == (T, 3, fused.N_TELEM_DIRECT)
        # tolerances (chip_smoke.compare): exact flags and integers;
        # correlator/discriminator columns within 1e-3 of the column max
        # (f32 sums in another order); rates rtol 1e-4 above a 1 mHz
        # floor; state rtol 1e-4
        margins = chip_smoke.compare(tt, st, tj, sj)
        print(f"\nmargins [{case}]: corr cols {margins['bf16_cols']:.2e} "
              f"of col max, rate cols {margins['rate_cols']:.2e} and "
              f"state {margins['state']:.2e} of tolerance")
        if case == "forced_death":
            ev = tt.numpy()[:, :, 15]
            assert ev[:, :2].sum(axis=0).tolist() == [1, 1]
            assert np.argmax(ev[:, :2], axis=0).tolist() == [6, 6]
        else:
            assert tt.numpy()[:, :2, 7].mean() > 0.95
            # the exact per-epoch ledger: drift and chip_res bit for bit
            np.testing.assert_array_equal(st.numpy()[:, [4, 8]],
                                          sj[:, [4, 8]])

    def test_reference_entry_matches_wrapper_on_cpu(self):
        sre, sim, a_c, reps, mat, kw = _direct_inputs({}, 10)
        args = _torch_args(sre, sim, a_c, reps, mat)
        ta, sa = fused.track_block_fused_direct(*args, **kw)
        tb, sb = fused.track_block_fused_direct_reference(*args, **kw)
        assert torch.equal(ta, tb) and torch.equal(sa, sb)

    def test_reference_in_pieces_matches_whole_block(self):
        sre, sim, a_c, reps, mat, kw = _direct_inputs({}, 5)
        args = _torch_args(sre, sim, a_c, reps, mat)
        tw, sw = fused.track_block_fused_direct_reference(*args, **kw)
        k2 = 2 * kw["k_epochs"]
        st, pieces = args[4], []
        for e0 in range(0, T, k2):
            tl, st = fused.track_block_fused_direct_reference(
                *args[:4], st, **dict(kw, t_epochs=k2),
                first_superstep=e0 // kw["k_epochs"])
            pieces.append(tl)
        assert torch.equal(torch.cat(pieces), tw) and torch.equal(st, sw)

    def test_bad_arguments_raise(self):
        sre, sim, a_c, reps, mat, kw = _direct_inputs({}, 10)
        args = list(_torch_args(sre, sim, a_c, reps, mat))
        with pytest.raises(ValueError, match="divisible"):
            fused.track_block_fused_direct(*args, **dict(kw, t_epochs=T + 2))
        with pytest.raises(TypeError, match="float32"):
            fused.track_block_fused_direct(
                *args[:3], args[3].to(torch.bfloat16), args[4], **kw)
        far = torch.full_like(args[2], len(sre) - 1000)
        with pytest.raises(ValueError, match="out of bounds"):
            fused.track_block_fused_direct(args[0], args[1], far, *args[3:],
                                           **kw)
        # a static bound stands in for the starts; it is checked against
        # the stream and, on the host, against the starts themselves
        with pytest.raises(ValueError, match="out of bounds"):
            fused.track_block_fused_direct(*args, **dict(
                kw, starts_bound=len(sre)))
        with pytest.raises(ValueError, match="break their bound"):
            fused.track_block_fused_direct(*args, **dict(
                kw, starts_bound=int(a_c.max()) - 1))
        with pytest.raises(ValueError, match="not both"):
            fused.track_block_fused_direct(*args, **dict(
                kw, starts_bound=int(a_c.max()), starts_host=a_c))


# ---------------------------------------------------------------------------
# B1's lean telemetry mode
# ---------------------------------------------------------------------------

def _mxu_inputs(cfg_kw):
    cfg = JTrackConfig(n_channels=3, correlator="fused", **cfg_kw)
    params = j_trk.TrackParams.create(cfg, J_GPS, FS)
    k = fused.choose_k(T, 2 if cfg.lock_mode == "costas" else 8)
    el_shift = params.el_shift
    rows = fused.mxu_rows(fr.N_DRIFT, el_shift)
    el_pad = el_shift + (rows - 1) // 2
    wp = ((params.window + 384 + 2 * el_shift + 63 + 127) // 128) * 128
    sre, sim = _scene(HISTORY + T * N0)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 3,
                                        window=params.window)
    mat = np.zeros((3, fused.N_FIELDS), np.float32)
    a_c = np.zeros(3, np.int32)
    for c in range(3):
        mat[c, 0], mat[c, 3] = DOPPLERS[c], GPS_L1CA.code_rate_hz
        mat[c, 7], mat[c, 11] = ACTIVE[c], 1.0
        a_c[c] = ((OFFSETS[c] - el_pad) // 128) * 128 if ACTIVE[c] else 0
        mat[c, 9] = OFFSETS[c] - a_c[c] if ACTIVE[c] else el_pad
    lane = (mat[:, 9] - el_pad).astype(np.int32)
    reps = fused.build_replicas(torch.from_numpy(codes), el_shift, N0, wp,
                                rows, np.zeros(3, np.int32),
                                lane_shift=lane).to(torch.bfloat16)
    p1, p2, d1, d2 = fused.loop_filter_consts(cfg)
    kw = dict(t_epochs=T, k_epochs=k, n0=N0, wp=wp, fs=FS,
              lock_threshold=cfg.lock_threshold,
              max_lost=cfg.max_lost_epochs, pll_c1=p1, pll_c2=p2,
              dll_c1=d1, dll_c2=d2, el_shift=el_shift,
              lock_mode=cfg.lock_mode, costas_thr=cfg.costas_lock_threshold)
    return sre, sim, a_c, reps, mat, kw


class TestLeanMode:
    @pytest.mark.parametrize("lock_mode", ["power", "costas"])
    def test_lean_matches_full_and_jax_lean(self, lock_mode):
        sre, sim, a_c, reps, mat, kw = _mxu_inputs(dict(lock_mode=lock_mode))
        args = (torch.from_numpy(sre), torch.from_numpy(sim),
                torch.from_numpy(a_c), reps, torch.from_numpy(mat))
        tf, sf = fused.track_block_fused_mxu(*args, **kw)
        tl, sl = fused.track_block_fused_mxu(*args, telem_mode="lean", **kw)
        # the same arithmetic: the end state bit for bit
        assert torch.equal(sl, sf)
        k = kw["k_epochs"]
        assert torch.equal(tl[..., 2:4], tf[..., 2:4])
        assert torch.equal(tl[..., 16], tf[..., 16] + 2.0 * tf[..., 7]
                           + 4.0 * tf[..., 15])
        assert torch.equal(tl[::k, :, 17:21], tf[::k, :, 17:21])
        stride = k if lock_mode == "costas" else 2 * k
        diag = [0, 1, 4, 5, 8, 9]
        assert torch.equal(tl[::stride][..., diag], tf[::stride][..., diag])
        n_stored = (2 + 1) * T * 3 + 4 * (T // k) * 3 \
            + 6 * (T // stride) * 3
        assert int((tl != 0).sum()) <= n_stored
        # ... and the JAX kernel's lean telemetry, as the slim2 wire reads
        # it (the JAX kernel's transpose rounds through bf16 on a TPU;
        # on the CPU it is exact)
        tj, sj = j_fused.track_block_fused_mxu(
            jnp.asarray(sre), jnp.asarray(sim), jnp.asarray(a_c),
            jnp.asarray(reps.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(mat), interpret=True, telem_mode="lean", **kw)
        tj = np.asarray(tj)[:, :, :fused.N_TELEM]
        tn = tl.numpy()
        np.testing.assert_array_equal(tn[..., 16], tj[..., 16])
        np.testing.assert_array_equal(tn[::k, :, 20], tj[::k, :, 20])
        for cols, rows in (([2, 3], slice(None)), (diag, slice(None, None,
                                                               stride))):
            a, b = tn[rows][..., cols], tj[rows][..., cols]
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
        np.testing.assert_allclose(sl.numpy()[:, :12], np.asarray(sj)[:, :12],
                                   rtol=1e-4, atol=1e-3)

    def test_unknown_telem_mode_raises(self):
        sre, sim, a_c, reps, mat, kw = _mxu_inputs({})
        args = (torch.from_numpy(sre), torch.from_numpy(sim),
                torch.from_numpy(a_c), reps, torch.from_numpy(mat))
        with pytest.raises(ValueError, match="telem_mode"):
            fused.track_block_fused_mxu(*args, telem_mode="slim", **kw)


# ---------------------------------------------------------------------------
# FusedTracker.run_block on the direct layout over several blocks
# ---------------------------------------------------------------------------

C_RB = 2


def _run_both_direct(b_blocks=3, **cfg_kw):
    block = T * N0
    sre, sim = _scene(HISTORY + b_blocks * block, seed=6)
    jcfg = JTrackConfig(n_channels=C_RB, correlator="fused", **cfg_kw)
    cfg = TrackConfig(n_channels=C_RB, correlator="fused", **cfg_kw)
    jparams = j_trk.TrackParams.create(jcfg, J_GPS, FS)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                        window=params.window)
    jft = j_fr.FusedTracker(jparams, jcfg, J_GPS, FS, jnp.asarray(codes),
                            T, HISTORY + block, layout="direct")
    ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, T,
                         HISTORY + block, layout="direct", device="cpu")
    assert (ft.wp, ft.n_rows, ft.k_epochs, ft.max_offset, ft.wire_stride) \
        == (jft.wp, jft.n_rows, jft.k_epochs, jft.max_offset,
            jft.wire_stride) == (ft.wp, 5, 10, ft.max_offset, 5)
    jst = j_trk.init_state(C_RB)
    for ch in range(C_RB):
        jst = j_trk.start_channel(jst, ch, ch, DOPPLERS[ch], OFFSETS[ch],
                                  J_GPS.code_rate_hz)
    st = trk.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()})
    rows = codes[:C_RB]
    out = []
    for b in range(b_blocks):
        w = slice(b * block, b * block + HISTORY + block)
        jst, jtl = jft.run_block(jst, jnp.asarray(sre[w]),
                                 jnp.asarray(sim[w]), jnp.asarray(rows))
        st, tl = ft.run_block(st, sre[w], sim[w], torch.from_numpy(rows))
        out.append((jtl, tl))
        jst = j_trk.rebase(jst, block)
        st = trk.rebase(st, block)
    return jst, st, out


class TestRunBlockDirect:
    def test_run_block_three_blocks(self):
        jst, st, out = _run_both_direct()
        for f in ("offset", "epochs", "active", "chip_int"):
            np.testing.assert_array_equal(getattr(st, f),
                                          np.asarray(getattr(jst, f)), f)
        for jtl, tl in out:
            for f in ("processed", "start_offset", "epoch_index", "locked"):
                np.testing.assert_array_equal(getattr(tl, f),
                                              np.asarray(getattr(jtl, f)), f)
            for f in ("i_p", "q_p", "i_e", "q_l"):
                x, y = np.asarray(getattr(jtl, f)), getattr(tl, f)
                assert np.abs(x - y).max() <= 1e-3 * np.abs(x).max(), f
            np.testing.assert_allclose(tl.chip_phase,
                                       np.asarray(jtl.chip_phase),
                                       atol=2e-4)
        np.testing.assert_allclose(st.carr_freq, np.asarray(jst.carr_freq),
                                   rtol=1e-4)
        np.testing.assert_allclose(st.code_rate, np.asarray(jst.code_rate),
                                   rtol=1e-6)
        assert np.all(st.active)

    def test_direct_geometry_at_the_operating_point(self):
        # 500 ms blocks: K = 10 (T % 2K == 0, K <= 16), 5 f32 rows
        cfg = TrackConfig(n_channels=2, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
        codes = trk.make_sampled_code_table(GPS_L1CA, FS, 2,
                                            window=params.window)
        ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, 500,
                             HISTORY + 500 * N0, layout="direct",
                             wire="slim2", device="cpu")
        assert (ft.k_epochs, ft.n_rows, ft.wp, ft.wire) == \
            (10, 5, 2560, "slim")
