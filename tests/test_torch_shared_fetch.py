"""Kernel B2 (the mxu layout's shared-fetch window feed,
``FusedTracker(shared_fetch=True)``) of the PyTorch port on the CPU: its
plain version against the JAX Pallas kernel (``spread_cap > 0``) in
interpret mode and against the port's plain B1 on the same samples, the
shared path's run_block and run_blocks against the JAX package's and
against the port's own non-shared path, a channel deferred by the cap,
the scan's [C + 1] starts and the shared read bound (ROADMAP C3), the
cap's resolution by layout, and the wrapper's checks. The CUDA kernel is
held to B1 and to this plain version on the card by
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
BLOCK = T * N0
HISTORY = 2 * N0 + 4096
CAP = ((N0 + 512 + 127) // 128) * 128          # 2560 at 2.046 MHz
C = 3                                          # channel 2 idle
B = 2
OFFSETS = [N0 + 53, N0 + 150]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(offsets, n, seed=4):
    """One satellite per offset, its code boundary at that sample, so the
    channels started there track and the two packages' ulps stay ulps."""
    sats = [SatelliteScenario(
        prn=c + 1, doppler_hz=800.0 + 150.0 * c, amplitude=0.5,
        code_phase_chips=(-off * GPS_L1CA.code_rate_hz / FS) % 1023)
        for c, off in enumerate(offsets)]
    sig = synthesize(sats, n, FS, noise_std=0.2, seed=seed)
    return (np.real(sig).astype(np.float32),
            np.imag(sig).astype(np.float32))


def _start(mod, gps, offsets=OFFSETS, c=C):
    st = mod.init_state(c)
    for ch, off in enumerate(offsets):
        st = mod.start_channel(st, ch, ch, 800.0 + 150.0 * ch, off,
                               gps.code_rate_hz)
    return st


def _cfgs(**cfg_kw):
    jcfg = JTrackConfig(n_channels=C, correlator="fused", **cfg_kw)
    cfg = TrackConfig(n_channels=C, correlator="fused", **cfg_kw)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                        window=params.window)
    return jcfg, cfg, params, codes


def _port(shared=True, wire="f32", t_epochs=T, layout="mxu", **cfg_kw):
    _, cfg, params, codes = _cfgs(**cfg_kw)
    return fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, t_epochs,
                           HISTORY + t_epochs * N0, layout=layout, wire=wire,
                           shared_fetch=shared, device="cpu")


def _jax(shared=True, t_epochs=T, layout="mxu"):
    jcfg, _, _, codes = _cfgs()
    return j_fr.FusedTracker(j_trk.TrackParams.create(jcfg, J_GPS, FS), jcfg,
                             J_GPS, FS, jnp.asarray(codes), t_epochs,
                             HISTORY + t_epochs * N0, layout=layout,
                             shared_fetch=shared)


def _rows():
    return _cfgs()[3][np.arange(C)]


def _assert_telems_close(ref, got):
    """tests/test_torch_scan.py's tolerances: integer fields and flags
    exact, correlators and rates within 2e-3 of their scale, chip phase
    within 2e-4 chips."""
    for b, (a, s) in enumerate(zip(ref, got)):
        for f in ("processed", "start_offset", "epoch_index", "locked",
                  "lost_event"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(s, f), err_msg=f"{b} {f}")
        for f in ("i_p", "q_p", "i_e", "q_l", "carr_freq", "code_rate"):
            x, y = np.asarray(getattr(a, f)), getattr(s, f)
            scale = max(1.0, np.abs(x).max())
            assert np.abs(x - y).max() / scale < 2e-3, f"block {b} {f}"
        d = np.abs(np.asarray(a.chip_phase, np.float64) - s.chip_phase)
        assert np.minimum(d, 1023.0 - d).max() < 2e-4, f"block {b} chip"


def _assert_ledgers_close(ref, got):
    for f in ("active", "offset", "epochs", "chip_int"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_allclose(got.carr_freq, np.asarray(ref.carr_freq),
                               rtol=1e-4)
    np.testing.assert_allclose(got.code_rate, np.asarray(ref.code_rate),
                               rtol=1e-6)
    df = (got.chip_frac_u32.astype(np.float64)
          - np.asarray(ref.chip_frac_u32).astype(np.float64)) / 2**32
    assert np.abs(df).max() < 1e-3


@pytest.fixture(scope="module")
def jax_tracker():
    """One JAX shared-fetch tracker for the module: its scan compiles once
    (per instance), and every run here has the same shapes."""
    return _jax()


# ---------------------------------------------------------------------------
# the kernel: plain B2 against the Pallas kernel and against plain B1
# ---------------------------------------------------------------------------

BASE = 2048
DC = [0, CAP // 2, CAP]                 # channels 0-2; channel 3 idle


def _kernel_inputs(cfg_kw):
    """One block's B2 arguments for 4 channels (the last idle) whose
    windows start at base + 0, base + CAP / 2 and base + CAP, each on its
    satellite's code boundary, with the [C + 1] starts (the base last),
    bf16 bank and state matrix as FusedTracker builds them."""
    cfg = JTrackConfig(n_channels=4, correlator="fused", **cfg_kw)
    params = j_trk.TrackParams.create(cfg, J_GPS, FS)
    k = fused.choose_k(T, 2 if cfg.lock_mode == "costas" else 8)
    el_shift = params.el_shift
    rows = fused.mxu_rows(5, el_shift)
    el_pad = el_shift + (rows - 1) // 2
    wp = ((params.window + 384 + 2 * el_shift + 63 + 127) // 128) * 128
    a_c = np.array([BASE + d for d in DC] + [BASE, BASE], np.int32)
    offsets = [int(a_c[c]) + el_pad + 40 * c + 3 for c in range(3)]
    sre, sim = _signal(offsets, HISTORY + BLOCK)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 4, window=params.window)
    mat = np.zeros((4, fused.N_FIELDS), np.float32)
    for c in range(4):
        mat[c, 0], mat[c, 3] = 800.0 + 150.0 * c, GPS_L1CA.code_rate_hz
        mat[c, 7], mat[c, 11] = float(c < 3), 1.0
        mat[c, 9] = offsets[c] - a_c[c] if c < 3 else el_pad
        mat[c, 12] = a_c[c]
    lane = (mat[:, 9] - el_pad).astype(np.int32)
    reps = fused.build_replicas(torch.from_numpy(codes), el_shift, N0, wp,
                                rows, np.zeros(4, np.int32),
                                lane_shift=lane).numpy()
    p1, p2, d1, d2 = fused.loop_filter_consts(cfg)
    kw = dict(t_epochs=T, k_epochs=k, n0=N0, wp=wp, fs=FS, code_len=1023.0,
              lock_threshold=cfg.lock_threshold,
              max_lost=cfg.max_lost_epochs, pll_c1=p1, pll_c2=p2,
              dll_c1=d1, dll_c2=d2, el_shift=el_shift, aiding_scale=0.0,
              if_freq=0.0, lock_mode=cfg.lock_mode,
              costas_thr=cfg.costas_lock_threshold, interp=cfg.interp_code)
    args = (torch.from_numpy(sre), torch.from_numpy(sim),
            torch.from_numpy(a_c), torch.from_numpy(reps).to(torch.bfloat16),
            torch.from_numpy(mat))
    return args, kw


class TestKernel:
    @pytest.mark.parametrize("cfg_kw", [{}, dict(lock_mode="costas")],
                             ids=["power", "costas"])
    def test_plain_matches_pallas_interpret(self, cfg_kw):
        """dc at 0, CAP / 2 and CAP: the plain B2 against the Pallas
        kernel with spread_cap > 0, within chip_smoke.compare's
        tolerances (exact flags and integers, bf16 columns 1e-3 of the
        column max, rates rtol 1e-4 above 1 mHz, state rtol 1e-4)."""
        args, kw = _kernel_inputs(cfg_kw)
        sre, sim, starts, reps, mat = args
        tj, sj = j_fused.track_block_fused_mxu(
            jnp.asarray(sre.numpy()), jnp.asarray(sim.numpy()),
            jnp.asarray(starts.numpy()),
            jnp.asarray(reps.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(mat.numpy()), interpret=True, spread_cap=CAP, **kw)
        before = (fused.launch_count, fused.shared_launch_count)
        tt, st = fused.track_block_fused_mxu(*args, spread_cap=CAP, **kw)
        # a CPU tensor runs the plain version, which never counts
        assert (fused.launch_count, fused.shared_launch_count) == before
        margins = chip_smoke.compare(
            tt, st, np.asarray(tj)[:, :, :fused.N_TELEM], np.asarray(sj))
        print(f"\nmargins [{kw['lock_mode']}]: bf16 cols "
              f"{margins['bf16_cols']:.2e} of col max, rate cols "
              f"{margins['rate_cols']:.2e} and state {margins['state']:.2e} "
              "of tolerance")
        assert tt.numpy()[:, :3, 16].all() and not tt.numpy()[:, 3, 16].any()
        if kw["lock_mode"] == "power":
            assert tt.numpy()[:, :3, 7].mean() > 0.95

    @pytest.mark.parametrize("telem_mode", ["full", "lean"])
    def test_plain_equals_plain_b1(self, telem_mode):
        """Only where the samples are read from differs: B2 on [C + 1]
        starts equals B1 on starts[:C] bit for bit, and a piece started
        mid-block reads the same slice offsets."""
        args, kw = _kernel_inputs({})
        kw = dict(kw, telem_mode=telem_mode)
        t2, s2 = fused.track_block_fused_mxu(*args, spread_cap=CAP, **kw)
        t1, s1 = fused.track_block_fused_mxu(
            args[0], args[1], args[2][:4].contiguous(), *args[3:], **kw)
        assert torch.equal(t2, t1) and torch.equal(s2, s1)
        k2 = 2 * kw["k_epochs"]
        tp, sp = fused.track_block_fused_mxu_reference(
            *args[:4], s1, **dict(kw, t_epochs=k2, spread_cap=CAP),
            first_superstep=2)
        tq, sq = fused.track_block_fused_mxu_reference(
            args[0], args[1], args[2][:4].contiguous(), args[3], s1,
            **dict(kw, t_epochs=k2), first_superstep=2)
        assert torch.equal(tp, tq) and torch.equal(sp, sq)

    def test_wrapper_checks_raise(self):
        """Every B2 argument check raises before any launch, the clamped
        base's overrun included (ROADMAP C3)."""
        args, kw = _kernel_inputs({})
        sre, sim, starts, reps, mat = args

        def call(st=starts, cap=CAP, stream=(sre, sim), **extra):
            return fused.track_block_fused_mxu(
                *stream, st, reps, mat, spread_cap=cap, **dict(kw, **extra))

        def shifted(i, d):
            s = starts.clone()
            s[i] += d
            return s

        with pytest.raises(ValueError, match="128-multiple"):
            call(cap=CAP + 64)
        with pytest.raises(ValueError, match=r"\[C \+ 1\]"):
            call(st=starts[:4].contiguous())
        with pytest.raises(ValueError, match="128-sample steps"):
            call(st=shifted(1, 64))             # dc off the 128 grid
        with pytest.raises(ValueError, match="128-sample steps"):
            call(st=shifted(2, 128))            # dc > spread_cap
        with pytest.raises(ValueError, match="128-sample steps"):
            call(st=shifted(4, 128))            # a channel below the base
        with pytest.raises(ValueError, match="128-multiple >= 0"):
            call(st=starts - 64)                # base off the 128 grid
        with pytest.raises(ValueError, match="starts_host"):
            call(starts_host=starts.numpy()[:4])
        # the clamped base: every window starts below spread_cap, so
        # base = 0 and the slice reads CAP past its own base; a stream
        # that holds every channel's windows (B1 runs on it) is too
        # short for the slice
        span = fused.direct_span(kw["k_epochs"], N0, kw["wp"])
        last = ((T - kw["k_epochs"]) * N0 // 128) * 128
        low = torch.tensor([0, 256, 1024, 0, 0], dtype=torch.int32)
        n = 1024 + last + span
        short = (sre[:n].contiguous(), sim[:n].contiguous())
        fused.track_block_fused_mxu(*short, low[:4].contiguous(), reps, mat,
                                    **kw)
        with pytest.raises(ValueError, match="C3"):
            call(st=low, stream=short)
        # from a static bound (the scan): max(bound, spread_cap) + the
        # last superstep's reach, here with bound < spread_cap
        with pytest.raises(ValueError, match="C3"):
            call(st=low, stream=short, starts_bound=1024)
        # the slice's bound holds exactly at the stream's end
        fused.track_block_fused_mxu(
            sre[:CAP + last + span].contiguous(),
            sim[:CAP + last + span].contiguous(), low, reps, mat,
            spread_cap=CAP, **kw)


# ---------------------------------------------------------------------------
# the path: FusedTracker(shared_fetch=True)
# ---------------------------------------------------------------------------

def _run_port(ft, st, sre, sim, n_blocks=B):
    """run_block + rebase over ``n_blocks`` windows of the stream."""
    rows, tels = torch.from_numpy(_rows()), []
    for b in range(n_blocks):
        w = slice(b * BLOCK, b * BLOCK + HISTORY + BLOCK)
        st, tl = ft.run_block(st, sre[w], sim[w], rows)
        tels.append(tl)
        st = trk.rebase(st, BLOCK)
    return st, tels


def _assert_equal(a, b):
    """Two ledgers or two lists of EpochTelemetry, field by field, bit
    for bit."""
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
        return
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


class TestPath:
    def test_matches_jax_shared_fetch(self, jax_tracker):
        """run_block and run_blocks with shared_fetch=True against the
        JAX package's over two blocks (test_torch_scan's tolerances)."""
        sre, sim = _signal(OFFSETS, HISTORY + B * BLOCK)
        jft, ft = jax_tracker, _port()
        assert (ft.spread_cap, ft.k_epochs, ft.max_offset) == \
            (jft.spread_cap, jft.k_epochs, jft.max_offset) == \
            (CAP, 5, jft.max_offset)
        rows = _rows()
        jst, jtel = _start(j_trk, J_GPS), []
        for b in range(B):
            w = slice(b * BLOCK, b * BLOCK + HISTORY + BLOCK)
            jst, tl = jft.run_block(jst, jnp.asarray(sre[w]),
                                    jnp.asarray(sim[w]), jnp.asarray(rows))
            jtel.append(tl)
            jst = j_trk.rebase(jst, BLOCK)
        st, tel = _run_port(ft, _start(trk, GPS_L1CA), sre, sim)
        _assert_telems_close(jtel, tel)
        _assert_ledgers_close(jst, st)
        jst_s, jtel_s = jft.run_blocks(_start(j_trk, J_GPS), jnp.asarray(sre),
                                       jnp.asarray(sim), jnp.asarray(rows), B)
        st_s, tel_s = ft.run_blocks(_start(trk, GPS_L1CA), sre, sim,
                                    torch.from_numpy(rows), B)
        _assert_telems_close(jtel_s, tel_s)
        _assert_ledgers_close(jst_s, st_s)
        assert tel[0].processed[:, :2].all() and \
            not tel[0].processed[:, 2].any()

    @pytest.mark.parametrize("wire", ["f32", "slim2"])
    def test_equals_non_shared(self, wire):
        """The shared path against the port's B1 path, bit for bit: every
        block's telemetry and the ledger, single blocks and the scan (the
        span's downloaded arrays too)."""
        sre, sim = _signal(OFFSETS, HISTORY + 3 * BLOCK)
        rows = torch.from_numpy(_rows())
        out = {}
        for shared in (False, True):
            ft = _port(shared=shared, wire=wire)
            blk = _run_port(ft, _start(trk, GPS_L1CA), sre, sim, 3)
            h = ft.submit_span(_start(trk, GPS_L1CA), sre, sim, rows, 3,
                               with_ledger=True)
            out[shared] = blk, h.ys.fetch(), ft.run_blocks(
                _start(trk, GPS_L1CA), sre, sim, rows, 3)
        (blk_a, arr_a, scan_a), (blk_b, arr_b, scan_b) = out[False], out[True]
        _assert_equal(blk_a[0], blk_b[0])
        _assert_equal(blk_a[1], blk_b[1])
        _assert_equal(scan_a[0], scan_b[0])
        _assert_equal(scan_a[1], scan_b[1])
        assert len(arr_a) == len(arr_b)
        for x, y in zip(arr_a, arr_b):
            np.testing.assert_array_equal(x, y)

    def test_channel_past_the_cap_defers(self, jax_tracker):
        """A channel whose window starts more than spread_cap below the
        highest one is deferred, in both packages, on the host path and
        in the scan: nothing processed, its state passed through. In the
        port it stays deferred while the far channel sits at its handoff
        offset, and its epochs count signal time (ROADMAP C1): the handoff
        sample plus epochs code periods is where its offset stands."""
        ft = _port()
        offsets = [N0 + 53, ft.max_offset - 7]
        sre, sim = _signal(offsets, HISTORY + B * BLOCK, seed=9)
        rows = _rows()
        jst, jtl = jax_tracker.run_block(
            _start(j_trk, J_GPS, offsets), jnp.asarray(sre[:HISTORY + BLOCK]),
            jnp.asarray(sim[:HISTORY + BLOCK]), jnp.asarray(rows))
        _, jtel_s = jax_tracker.run_blocks(
            _start(j_trk, J_GPS, offsets), jnp.asarray(sre),
            jnp.asarray(sim), jnp.asarray(rows), B)
        st_b, tel_b = _run_port(ft, _start(trk, GPS_L1CA, offsets), sre, sim)
        st_s, tel_s = ft.run_blocks(_start(trk, GPS_L1CA, offsets), sre, sim,
                                    torch.from_numpy(rows), B)
        for tl in (jtl, jtel_s[0], tel_b[0], tel_s[0]):
            processed = np.asarray(tl.processed)
            assert not processed[:, 0].any() and processed[:, 1].all()
        assert int(np.asarray(jst.epochs)[0]) == 0
        assert int(np.asarray(jst.offset)[0]) == offsets[0]
        st0 = _start(trk, GPS_L1CA, offsets)
        for f in ("active", "offset", "epochs", "chip_int"):
            np.testing.assert_array_equal(getattr(st_b, f),
                                          getattr(st_s, f), f)
        for f in ("chip_frac_u32", "carr_acc", "carr_freq", "code_rate",
                  "lost_count", "lock_ema"):
            for st in (st_b, st_s):
                assert getattr(st, f)[0] == getattr(st0, f)[0], f
        for tl in tel_b + tel_s:
            assert not tl.processed[:, 0].any()
        assert bool(st_s.active[0]) and int(st_s.epochs[0]) > 0
        assert offsets[0] + int(st_s.epochs[0]) * N0 == \
            B * BLOCK + int(st_s.offset[0])

    def test_scan_starts_within_cap_and_shared_bound(self, monkeypatch):
        """Every [C + 1] starts vector the scan computes on the device:
        each channel's offset from the base a 128-multiple in
        [0, spread_cap], the base >= 0, and the slice inside the stream,
        by the values and by the static bound the wrapper checks; both a
        clamped base (every window below spread_cap) and one above 0."""
        ft = _port()
        seen = []
        kernel = ft._kernel

        def spy(stream_re, stream_im, starts, *args, starts_bound, **kw):
            seen.append((starts.clone(), starts_bound, stream_re.shape[0]))
            return kernel(stream_re, stream_im, starts, *args,
                          starts_bound=starts_bound, **kw)

        monkeypatch.setattr(ft, "_kernel", spy)
        rows = torch.from_numpy(_rows())
        span = fused.direct_span(ft.k_epochs, N0, ft.wp)
        last = ((T - ft.k_epochs) * N0 // 128) * 128
        bases = []
        for offsets in ([ft.el_pad + 1, N0 + 300],
                        [ft.max_offset - CAP + 200, ft.max_offset]):
            sre, sim = _signal(offsets, HISTORY + B * BLOCK)
            seen.clear()
            ft.run_blocks(_start(trk, GPS_L1CA, offsets), sre, sim, rows, B)
            bases.append(int(seen[0][0][C]))
            assert len(seen) == B
            for b, (starts, bound, n) in enumerate(seen):
                s = starts.numpy().astype(np.int64)
                assert s.shape == (C + 1,) and s[C] >= 0 and s[C] % 128 == 0
                dc = s[:C] - s[C]
                assert (dc >= 0).all() and (dc <= CAP).all()
                assert (dc % 128 == 0).all()
                assert s[C] + CAP + last + span <= n
                assert max(bound, CAP) + last + span <= n
        # block 0: the clamped base of the first scene, a raised one in
        # the second
        assert bases[0] == 0 and bases[1] > 0
        with pytest.raises(ValueError, match="span stream too short"):
            ft.run_blocks(_start(trk, GPS_L1CA), sre[:-N0], sim[:-N0], rows,
                          B)


@pytest.mark.parametrize("layout,t_epochs,cap", [
    ("mxu", T, CAP), ("direct", T, 0), ("seg", T, 0), ("windows", T, 0),
    ("mxu", 7, 0)])
def test_spread_cap_resolves_by_layout(layout, t_epochs, cap):
    """spread_cap is the JAX package's: (n0 + 512) rounded up to 128 on
    mxu, 0 on the other layouts and where an odd epoch count falls off
    mxu (to seg); without shared_fetch 0 everywhere."""
    ft = _port(layout=layout, t_epochs=t_epochs)
    jft = _jax(layout=layout, t_epochs=t_epochs)
    assert ft.spread_cap == jft.spread_cap == cap
    assert ft.layout == jft.layout
    assert ("spread_cap" in ft._kernel_kw) == (cap > 0)
    assert _port(shared=False, layout=layout, t_epochs=t_epochs
                 ).spread_cap == 0


@pytest.mark.parametrize("c,sizes", [
    (32, (2, 4, 8)), (24, (2, 3, 4, 6, 8)), (9, (3,)), (31, (1,)), (1, (1,))])
def test_cluster_sizes_smallest_divisor_first(c, sizes):
    """B2's cluster sizes in the order the wrapper tries them: the
    divisors of C from 2 to 8, smallest first (a grid of C blocks is a
    whole number of clusters); 1 where C has none."""
    assert fused.shared_cluster_sizes(c) == sizes


def test_costas_channel_lost_near_ninety_degrees_as_in_jax():
    """chip_smoke's Costas spread case (the scene's ledger moved by whole
    code periods, seed 6): channel 15 starts 4.2 degrees from the Costas
    loop's +-90 degree point, its first correction rotates the phase
    across it, the lock drops and the channel is lost at epoch 22, in
    the plain B2 and in the JAX Pallas kernel (interpret mode) alike,
    held to chip_smoke.compare's tolerances (PERF.md section 7). That
    channel alone, 32 epochs."""
    _, args, kw = chip_smoke.full_width_inputs(
        torch, "cpu", dict(lock_mode="costas"), shared_fetch=True,
        spread_seed=6)
    c, host = 15, kw["starts_host"]
    starts = torch.tensor([host[c], host[-1]], dtype=torch.int32)
    sub = (args[0], args[1], starts, args[3][c:c + 1].contiguous(),
           args[4][c:c + 1].contiguous())
    kw = {k: v for k, v in kw.items() if k != "starts_host"}
    kw["t_epochs"] = 32
    tt, st = fused.track_block_fused_mxu(*sub, **kw)
    tj, sj = j_fused.track_block_fused_mxu(
        *(jnp.asarray(x.numpy()) for x in sub[:3]),
        jnp.asarray(sub[3].float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(sub[4].numpy()), interpret=True, **kw)
    tj, sj = np.asarray(tj)[:, :, :fused.N_TELEM], np.asarray(sj)
    chip_smoke.compare(tt, st, tj, sj)
    for t, s in ((tt.numpy(), st.numpy()), (tj, sj)):
        assert s[0, 7] == 0.0 and int(np.argmax(t[:, 0, 15])) == 22
        assert (t[:3, 0, 8] * t[1:4, 0, 8] < 0).all()   # the swings
