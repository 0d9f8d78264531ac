"""Kernel B1 (mxu fused tracking) of the PyTorch port against the JAX
package, on the CPU: the port's plain PyTorch version against the JAX
Pallas kernel in interpret mode on identical stream, starts, bf16
replicas and state; FusedTracker.run_block over several blocks from the
same ledger; the construction errors. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
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
    """One PyTorch intra-op thread while this module runs: the suite runs
    test files in parallel worker processes, and PyTorch's default of a
    thread per core oversubscribes the machine (timing-sensitive tests
    in other workers starve). Multi-threaded CPU sin/cos also differ
    from the single-threaded, ulp-accurate ones in some processes."""
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


def _kernel_inputs(cfg_kw):
    """Stream, starts, f32 replica bank, state matrix and statics for a
    3-channel block built as FusedTracker.run_block builds them."""
    cfg = JTrackConfig(n_channels=3, correlator="fused", **cfg_kw)
    params = j_trk.TrackParams.create(cfg, J_GPS, FS)
    k = fused.choose_k(T, 2 if cfg.lock_mode == "costas" else 8)
    el_shift = params.el_shift
    rows = fused.mxu_rows(5, el_shift)
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
        if ACTIVE[c]:
            a_c[c] = ((OFFSETS[c] - el_pad) // 128) * 128
            mat[c, 9] = OFFSETS[c] - a_c[c]
        else:
            mat[c, 9] = el_pad
        mat[c, 12] = a_c[c]
    lane = (mat[:, 9] - el_pad).astype(np.int32)
    reps = fused.build_replicas(torch.from_numpy(codes), el_shift, N0, wp,
                                rows, np.zeros(3, np.int32),
                                lane_shift=lane).numpy()
    p1, p2, d1, d2 = fused.loop_filter_consts(cfg)
    kw = dict(t_epochs=T, k_epochs=k, n0=N0, wp=wp, fs=FS, code_len=1023.0,
              lock_threshold=cfg.lock_threshold,
              max_lost=cfg.max_lost_epochs, pll_c1=p1, pll_c2=p2,
              dll_c1=d1, dll_c2=d2, el_shift=el_shift,
              aiding_scale=(params.aiding_scale if cfg.carrier_aiding
                            else 0.0),
              if_freq=0.0, lock_mode=cfg.lock_mode,
              costas_thr=cfg.costas_lock_threshold, interp=cfg.interp_code)
    return sre, sim, a_c, reps, mat, kw


def _torch_args(sre, sim, a_c, reps, mat):
    return (torch.from_numpy(sre), torch.from_numpy(sim),
            torch.from_numpy(a_c), torch.from_numpy(reps).to(torch.bfloat16),
            torch.from_numpy(mat))


CASES = {
    "power_k5": {},
    "costas_k2": dict(lock_mode="costas"),
    "interp": dict(interp_code=True),
    "carrier_aiding": dict(carrier_aiding=True),
    "death_3": dict(lock_threshold=1e12, max_lost_epochs=3),
    "death_7": dict(lock_threshold=1e12, max_lost_epochs=7),
}


class TestKernelPlainVsJax:
    @pytest.mark.parametrize("case", list(CASES))
    def test_plain_matches_pallas_interpret(self, case):
        sre, sim, a_c, reps, mat, kw = _kernel_inputs(CASES[case])
        tj, sj = j_fused.track_block_fused_mxu(
            jnp.asarray(sre), jnp.asarray(sim), jnp.asarray(a_c),
            jnp.asarray(reps).astype(jnp.bfloat16), jnp.asarray(mat),
            interpret=True, **kw)
        tj = np.asarray(tj)[:, :, :fused.N_TELEM]
        sj = np.asarray(sj)
        before = fused.launch_count
        tt, st = fused.track_block_fused_mxu(
            *_torch_args(sre, sim, a_c, reps, mat), **kw)
        # a CPU tensor runs the plain version, which never counts
        assert fused.launch_count == before
        assert tt.shape == (T, 3, fused.N_TELEM)
        # tolerances (chip_smoke.compare): exact flags and integers;
        # correlator/discriminator columns within 1e-3 of the column max
        # (bf16 rounding of the mixed window, f32 sums in another order);
        # rates rtol 1e-4 above a 1 mHz floor; state rtol 1e-4
        margins = chip_smoke.compare(tt, st, tj, sj)
        print(f"\nmargins [{case}]: bf16 cols {margins['bf16_cols']:.2e} "
              f"of col max, rate cols {margins['rate_cols']:.2e} and "
              f"state {margins['state']:.2e} of tolerance")
        if case.startswith("death"):
            # everyone active dies exactly when lost crosses max_lost
            n = CASES[case]["max_lost_epochs"]
            ev = tt.numpy()[:, :, 15]
            assert ev[:, :2].sum(axis=0).tolist() == [1, 1]
            assert np.argmax(ev[:, :2], axis=0).tolist() == [n - 1] * 2
        elif case != "costas_k2":
            assert tt.numpy()[:, :2, 7].mean() > 0.95

    def test_reference_entry_matches_wrapper_on_cpu(self):
        sre, sim, a_c, reps, mat, kw = _kernel_inputs({})
        args = _torch_args(sre, sim, a_c, reps, mat)
        ta, sa = fused.track_block_fused_mxu(*args, **kw)
        tb, sb = fused.track_block_fused_mxu_reference(*args, **kw)
        assert torch.equal(ta, tb) and torch.equal(sa, sb)

    def test_reference_in_pieces_matches_whole_block(self):
        # first_superstep: the block's supersteps run piece by piece, each
        # from the previous piece's state, give the whole block exactly
        sre, sim, a_c, reps, mat, kw = _kernel_inputs({})
        args = _torch_args(sre, sim, a_c, reps, mat)
        tw, sw = fused.track_block_fused_mxu_reference(*args, **kw)
        k2 = 2 * kw["k_epochs"]
        st, pieces = args[4], []
        for e0 in range(0, T, k2):
            tl, st = fused.track_block_fused_mxu_reference(
                *args[:4], st, **dict(kw, t_epochs=k2),
                first_superstep=e0 // kw["k_epochs"])
            pieces.append(tl)
        assert torch.equal(torch.cat(pieces), tw) and torch.equal(st, sw)

    def test_bad_arguments_raise(self):
        sre, sim, a_c, reps, mat, kw = _kernel_inputs({})
        args = list(_torch_args(sre, sim, a_c, reps, mat))
        bad = dict(kw, t_epochs=T + 2)
        with pytest.raises(ValueError, match="divisible"):
            fused.track_block_fused_mxu(*args, **bad)
        with pytest.raises(TypeError, match="bfloat16"):
            fused.track_block_fused_mxu(*args[:3], args[3].float(), args[4],
                                        **kw)
        far = torch.full_like(args[2], len(sre) - 1000)
        with pytest.raises(ValueError, match="out of bounds"):
            fused.track_block_fused_mxu(args[0], args[1], far, *args[3:],
                                        **kw)
        # the host copy of the starts, where given, is what is checked
        with pytest.raises(ValueError, match="out of bounds"):
            fused.track_block_fused_mxu(*args, **dict(
                kw, starts_host=far.numpy()))
        with pytest.raises(ValueError, match="starts_host"):
            fused.track_block_fused_mxu(*args, **dict(
                kw, starts_host=a_c[:2]))
        # a piece that starts late in the block reads further
        with pytest.raises(ValueError, match="out of bounds"):
            fused.track_block_fused_mxu_reference(
                *args, **dict(kw, t_epochs=10), first_superstep=T)


# ---------------------------------------------------------------------------
# FusedTracker.run_block over several blocks from one ledger
# ---------------------------------------------------------------------------

C_RB = 2


def _aligned_jax_state():
    st = j_trk.init_state(C_RB)
    for ch in range(C_RB):
        st = j_trk.start_channel(st, ch, ch, DOPPLERS[ch], OFFSETS[ch],
                                 J_GPS.code_rate_hz)
    return st


def _run_both(b_blocks=4, **cfg_kw):
    block = T * N0
    sre, sim = _scene(HISTORY + b_blocks * block, seed=6)
    jcfg = JTrackConfig(n_channels=C_RB, correlator="fused", **cfg_kw)
    cfg = TrackConfig(n_channels=C_RB, correlator="fused", **cfg_kw)
    jparams = j_trk.TrackParams.create(jcfg, J_GPS, FS)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                        window=params.window)
    jft = j_fr.FusedTracker(jparams, jcfg, J_GPS, FS, jnp.asarray(codes),
                            T, HISTORY + block, layout="mxu")
    ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, T,
                         HISTORY + block, layout="mxu", device="cpu")
    assert (ft.wp, ft.n_rows, ft.k_epochs, ft.max_offset) == \
        (jft.wp, jft.n_rows, jft.k_epochs, jft.max_offset)
    jst = _aligned_jax_state()
    st = trk.state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()})
    assert st.carr_acc.dtype == np.uint32
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


class TestRunBlock:
    @pytest.mark.parametrize("cfg_kw", [{}, dict(lock_mode="costas")],
                             ids=["power", "costas"])
    def test_run_block_four_blocks(self, cfg_kw):
        jst, st, out = _run_both(**cfg_kw)
        # integer bookkeeping: exact
        for f in ("offset", "epochs", "active"):
            np.testing.assert_array_equal(getattr(st, f),
                                          np.asarray(getattr(jst, f)), f)
        for jtl, tl in out:
            np.testing.assert_array_equal(tl.processed,
                                          np.asarray(jtl.processed))
            np.testing.assert_array_equal(tl.start_offset,
                                          np.asarray(jtl.start_offset))
        # f32 loop state after four re-anchored blocks
        np.testing.assert_allclose(st.carr_freq, np.asarray(jst.carr_freq),
                                   rtol=1e-4)
        np.testing.assert_allclose(st.code_rate, np.asarray(jst.code_rate),
                                   rtol=1e-4)
        assert np.all(st.active)


class TestConstruction:
    def _ft(self, t_epochs=T, buf_len=HISTORY + T * N0, **cfg_kw):
        cfg = TrackConfig(n_channels=2, correlator="fused", **cfg_kw)
        params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
        codes = trk.make_sampled_code_table(GPS_L1CA, FS, 4,
                                            window=params.window)
        return fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, t_epochs,
                               buf_len, device="cpu")

    def test_geometry_resolves(self):
        ft = self._ft()
        assert (ft.k_epochs, ft.n_rows, ft.wp % 128) == (5, 8, 0)

    def test_odd_block_ms_resolves_to_seg(self):
        # no superstep pairing on mxu or direct: seg (B4b fed by B4c), as
        # the JAX package resolves it
        ft = self._ft(t_epochs=7)
        assert (ft.layout, ft.k_epochs, ft.n_rows) == ("seg", None, 5)
        assert ft.l_seg == fused.seg_length(7, N0, ft.wp)

    def test_short_buffer_raises(self):
        with pytest.raises(ValueError, match="buffer too short"):
            self._ft(buf_len=T * N0)

    def test_short_code_table_raises(self):
        ft = self._ft()
        short = torch.zeros((2, 2 * N0 + ft.wp - 2))
        with pytest.raises(ValueError, match="too short"):
            fused.build_replicas(short, 1, N0, ft.wp, 8,
                                 np.zeros(2, np.int32))

    @pytest.mark.parametrize("kw,item", [(dict(mesh_channels=3), "A14")],
                             ids=["kw0-A14"])
    def test_unported_options_raise(self, kw, item):
        """A14 (the mesh) is ported: a mesh whose channel axis does not
        divide the channels raises ValueError, as in the JAX package."""
        from gnss_sdr_tpu_torch import parallel

        cfg = TrackConfig(n_channels=2, correlator="fused")
        params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
        codes = trk.make_sampled_code_table(GPS_L1CA, FS, 4)
        n = kw["mesh_channels"]
        mesh = parallel.make_mesh(1, n, devices=["cpu"] * n)
        with pytest.raises(ValueError, match="divisible"):
            fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, T,
                            HISTORY + T * N0, device="cpu", mesh=mesh)
