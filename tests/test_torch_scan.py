"""The port's multi-block scan (FusedTracker.run_blocks and the span
API) on the CPU: against the JAX package's run_blocks on the direct and
mxu layouts and the f32 and slim2 wires, against the port's own per-block
path, the slim2 wire's exact ledger replay, the device handoffs, the
static read bound of the scan's kernel launches, and the meaning of a
deferred channel's epoch count (ROADMAP C1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gnss_sdr_tpu.config import TrackConfig as JTrackConfig  # noqa: E402
from gnss_sdr_tpu.models import GPS_L1CA as J_GPS  # noqa: E402
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
C, T, B = 3, 20, 4
BLOCK = T * N0
HISTORY = 2 * N0 + 4096
OFFSETS = [N0 + 53 + 97 * c for c in range(C)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signal(n_blocks=B, seed=4):
    """C satellites, each channel started on its satellite's code
    boundary: the closed loops track, so the two packages' ulps stay
    ulps (on a misaligned start the mxu loops chase noise and amplify
    them)."""
    sats = [SatelliteScenario(
        prn=c + 1, doppler_hz=800.0 + 150.0 * c, amplitude=0.5,
        code_phase_chips=(-OFFSETS[c] * GPS_L1CA.code_rate_hz / FS) % 1023)
        for c in range(C)]
    sig = synthesize(sats, HISTORY + n_blocks * BLOCK, FS, noise_std=0.2,
                     seed=seed)
    return (np.real(sig).astype(np.float32),
            np.imag(sig).astype(np.float32))


def _start(mod, gps, offsets=OFFSETS):
    st = mod.init_state(len(offsets))
    for ch, off in enumerate(offsets):
        st = mod.start_channel(st, ch, ch, 800.0 + 150.0 * ch, off,
                               gps.code_rate_hz)
    return st


def _trackers(layout, wire, c=C, **cfg_kw):
    jcfg = JTrackConfig(n_channels=c, correlator="fused", **cfg_kw)
    cfg = TrackConfig(n_channels=c, correlator="fused", **cfg_kw)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                        window=params.window)
    jft = j_fr.FusedTracker(j_trk.TrackParams.create(jcfg, J_GPS, FS), jcfg,
                            J_GPS, FS, jnp.asarray(codes), T,
                            HISTORY + BLOCK, layout=layout, wire=wire)
    ft = fr.FusedTracker(params, cfg, GPS_L1CA, FS, codes, T,
                         HISTORY + BLOCK, layout=layout, wire=wire,
                         device="cpu")
    return jft, ft, codes[np.arange(c) % 32]


def _assert_telems_close(ref, got, exact=("processed", "start_offset",
                                          "epoch_index")):
    """tests/test_fused_scan.py's tolerances: integer fields exact,
    correlators and rates within 2e-3 of their scale, chip phase within
    2e-4 chips."""
    for b, (a, s) in enumerate(zip(ref, got)):
        for f in exact:
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


class TestRunBlocksVsJax:
    @pytest.mark.parametrize("layout,wire", [
        ("direct", "f32"), ("mxu", "f32"), ("mxu", "slim2")])
    def test_matches_jax_run_blocks(self, layout, wire):
        sre, sim = _signal()
        jft, ft, rows = _trackers(layout, wire)
        assert (ft.layout, ft.wire, ft.k_epochs) == \
            (jft.layout, jft.wire, jft.k_epochs)
        jst, jtel = jft.run_blocks(_start(j_trk, J_GPS), jnp.asarray(sre),
                                   jnp.asarray(sim), jnp.asarray(rows), B)
        st, tel = ft.run_blocks(_start(trk, GPS_L1CA), sre, sim,
                                torch.from_numpy(rows), B)
        assert len(tel) == B
        _assert_telems_close(jtel, tel, exact=(
            "processed", "start_offset", "epoch_index", "locked",
            "lost_event"))
        _assert_ledgers_close(jst, st)


class TestRunBlocksVsRunBlock:
    @pytest.mark.parametrize("layout", ["direct", "mxu"])
    def test_matches_per_block_path(self, layout):
        """The scan against the port's own run_block + rebase loop (the
        JAX package's TestRunBlocks.test_matches_per_block_path)."""
        sre, sim = _signal()
        _, ft, rows = _trackers(layout, "f32")
        st_ref, tel_ref = _start(trk, GPS_L1CA), []
        for b in range(B):
            w = slice(b * BLOCK, b * BLOCK + HISTORY + BLOCK)
            st_ref, tl = ft.run_block(st_ref, sre[w], sim[w],
                                      torch.from_numpy(rows))
            tel_ref.append(tl)
            st_ref = trk.rebase(st_ref, BLOCK)
        st, tel = ft.run_blocks(_start(trk, GPS_L1CA), sre, sim,
                                torch.from_numpy(rows), B)
        _assert_telems_close(tel_ref, tel)
        _assert_ledgers_close(st_ref, st)

    def test_chained_spans_match_one_span(self):
        """Two chained submits of 2 blocks (the second from the first's
        device ledger) against the 4-block span. The windows' 128-sample
        grid is anchored at each span's start (2 blocks are not a
        multiple of 128 samples), so the mix differs by ulps: the scan
        tolerances, integer fields exact."""
        sre, sim = _signal()
        _, ft, rows = _trackers("mxu", "slim2")
        codes = torch.from_numpy(rows)
        st_one, tel_one = ft.run_blocks(_start(trk, GPS_L1CA), sre, sim,
                                        codes, B)
        h1 = ft.submit_span(_start(trk, GPS_L1CA), sre[:HISTORY + 2 * BLOCK],
                            sim[:HISTORY + 2 * BLOCK], codes, 2)
        h2 = ft.submit_span(h1.led, sre[2 * BLOCK:], sim[2 * BLOCK:], codes, 2)
        tel_two = ft.collect_span(h1) + ft.collect_span(h2)
        st_two = ft.absorb_led(_start(trk, GPS_L1CA), h2.led)
        for a, s in zip(tel_one[:2], tel_two[:2]):   # the same span start
            for f in a._fields:
                np.testing.assert_array_equal(getattr(a, f), getattr(s, f), f)
        _assert_telems_close(tel_one, tel_two, exact=(
            "processed", "start_offset", "epoch_index", "locked",
            "lost_event"))
        _assert_ledgers_close(st_one, st_two)


# ---------------------------------------------------------------------------
# the telemetry wires (tests/test_wire2.py's claims, on the port's own
# f32 and slim2 runs)
# ---------------------------------------------------------------------------

def _run_wires(layout="mxu", wires=("f32", "slim2"), **cfg_kw):
    sre, sim = _signal(n_blocks=3)
    outs = {}
    for wire in wires:
        _, ft, rows = _trackers(layout, wire, **cfg_kw)
        assert ft.wire == wire
        outs[wire] = ft.run_blocks(_start(trk, GPS_L1CA), sre, sim,
                                   torch.from_numpy(rows), 3) + (ft,)
    return outs


class TestWires:
    @pytest.mark.parametrize("cfg_kw", [{}, dict(carrier_aiding=True)],
                             ids=["plain", "aiding"])
    def test_slim2_ledger_fields_exact(self, cfg_kw):
        outs = _run_wires(**cfg_kw)
        for b, (a, s) in enumerate(zip(outs["f32"][1], outs["slim2"][1])):
            for f in ("processed", "locked", "lost_event", "epoch_index",
                      "start_offset"):
                np.testing.assert_array_equal(getattr(a, f), getattr(s, f),
                                              err_msg=f"block {b} {f}")
            d = np.abs(a.chip_phase.astype(np.float64) - s.chip_phase)
            assert np.minimum(d, 1023.0 - d).max() < 1e-4, f"block {b}"

    def test_slim2_prompt_bf16_and_held_rates(self):
        outs = _run_wires()
        ft = outs["slim2"][2]
        k = ft.k_epochs
        for a, s in zip(outs["f32"][1], outs["slim2"][1]):
            for f in ("i_p", "q_p"):
                x, y = getattr(a, f), getattr(s, f)
                assert (np.abs(x - y) / np.maximum(np.abs(x), 1.0)).max() \
                    < 2 ** -7.5, f
            # the held-rate trace repeats the state at superstep entry,
            # the filtered value after the previous superstep's last epoch
            np.testing.assert_array_equal(s.carr_freq[k::k],
                                          a.carr_freq[k - 1:-1:k])
            np.testing.assert_array_equal(s.code_rate[k::k],
                                          a.code_rate[k - 1:-1:k])

    def test_slim2_final_state_identical(self):
        outs = _run_wires()
        for f in outs["f32"][0]._fields:
            np.testing.assert_array_equal(getattr(outs["f32"][0], f),
                                          getattr(outs["slim2"][0], f), f)

    def test_slim_wire_on_direct(self):
        outs = _run_wires(layout="direct", wires=("f32", "slim"))
        for a, s in zip(outs["f32"][1], outs["slim"][1]):
            for f in ("processed", "locked", "lost_event", "epoch_index",
                      "start_offset", "chip_phase"):
                np.testing.assert_array_equal(getattr(a, f), getattr(s, f), f)
            s_ = outs["slim"][2].wire_stride
            np.testing.assert_array_equal(s.carr_freq[::s_], a.carr_freq[::s_])
            assert (np.abs(a.i_p - s.i_p)
                    / np.maximum(np.abs(a.i_p), 1.0)).max() < 2 ** -7.5
        for f in outs["f32"][0]._fields:
            np.testing.assert_array_equal(getattr(outs["f32"][0], f),
                                          getattr(outs["slim"][0], f), f)


# ---------------------------------------------------------------------------
# device handoffs, the read bound, and a deferred channel (C1)
# ---------------------------------------------------------------------------

def test_apply_handoffs_device_matches_jax():
    rng = np.random.default_rng(7)
    c = 6
    led = (rng.integers(0, 2, c).astype(np.float32),
           rng.integers(-500, 5000, c).astype(np.int32),
           rng.integers(0, 900, c).astype(np.int32),
           rng.integers(0, 1023, c).astype(np.int32),
           rng.random(c).astype(np.float32),
           rng.normal(size=(c, 7)).astype(np.float32))
    channels, freqs, offs = [4, 1, 5], [1234.5, -777.25, 3.0], [2100, 2050,
                                                                4000]
    ch = np.full(8, -1, np.int32)
    fq = np.zeros(8, np.float32)
    of = np.zeros(8, np.int32)
    ch[:3], fq[:3], of[:3] = channels, freqs, offs
    j_out = j_fr._apply_handoffs(tuple(jnp.asarray(x) for x in led),
                                 jnp.asarray(ch), jnp.asarray(fq),
                                 jnp.asarray(of),
                                 nominal_rate=float(GPS_L1CA.code_rate_hz))
    _, ft, _ = _trackers("mxu", "f32", c=c)
    out = ft.apply_handoffs_device(tuple(torch.from_numpy(x) for x in led),
                                   channels, freqs, offs)
    for a, b in zip(j_out, out):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)


def test_scan_starts_within_their_static_bound(monkeypatch):
    """Every start the scan computes on the device lies in [0, bound],
    the bound the wrapper checks the read against; a channel started
    at max_offset is the worst case the eligibility rule allows."""
    sre, sim = _signal()
    _, ft, rows = _trackers("direct", "f32")
    seen = []
    kernel = ft._kernel

    def spy(stream_re, stream_im, starts, *args, starts_bound, **kw):
        seen.append((starts.clone(), starts_bound))
        return kernel(stream_re, stream_im, starts, *args,
                      starts_bound=starts_bound, **kw)

    monkeypatch.setattr(ft, "_kernel", spy)
    offsets = [ft.el_pad + 1, N0 + 300, ft.max_offset]
    ft.run_blocks(_start(trk, GPS_L1CA, offsets), sre, sim,
                  torch.from_numpy(rows), B)
    assert len(seen) == B
    span = fused.direct_span(ft.k_epochs, N0, ft.wp)
    last = ((T - ft.k_epochs) * N0 // 128) * 128
    for b, (starts, bound) in enumerate(seen):
        assert bound == b * BLOCK + ft.max_offset - ft.el_pad
        assert int(starts.min()) >= 0 and int(starts.max()) <= bound
        assert bound + last + span <= len(sre)
    # the channel at max_offset reads within 128 samples of the bound
    assert seen[0][1] - int(seen[0][0][2]) < 128
    with pytest.raises(ValueError, match="span stream too short"):
        ft.run_blocks(_start(trk, GPS_L1CA), sre[:-N0], sim[:-N0],
                      torch.from_numpy(rows), B)


def test_deferred_channel_epochs_count_signal_time():
    """tests/test_fused_scan.py's deferral scene: channel 1 starts past
    max_offset, defers block 0, and its offset rebases behind window 1.
    Both port paths walk it forward whole code periods to the first past
    the preroll and count each in ``epochs``, so every processed epoch's
    index is its distance from the handoff sample in code periods."""
    c_ch, b_blocks = 2, 3
    sig = synthesize([SatelliteScenario(prn=1, doppler_hz=900.0),
                      SatelliteScenario(prn=2, doppler_hz=1100.0)],
                     HISTORY + b_blocks * BLOCK, FS, noise_std=0.2, seed=9)
    sre = np.real(sig).astype(np.float32)
    sim = np.imag(sig).astype(np.float32)
    _, ft, rows = _trackers("direct", "f32", c=c_ch)
    handoff = int(ft.max_offset) + 5

    def start():
        st = trk.init_state(c_ch)
        st = trk.start_channel(st, 0, 0, 900.0, N0 + 11,
                               GPS_L1CA.code_rate_hz)
        return trk.start_channel(st, 1, 1, 1100.0, handoff,
                                 GPS_L1CA.code_rate_hz)

    codes = torch.from_numpy(rows)
    st_scan, tel_scan = ft.run_blocks(start(), sre, sim, codes, b_blocks)
    st_blk, tel_blk = start(), []
    for b in range(b_blocks):
        w = slice(b * BLOCK, b * BLOCK + HISTORY + BLOCK)
        st_blk, tl = ft.run_block(st_blk, sre[w], sim[w], codes)
        tel_blk.append(tl)
        st_blk = trk.rebase(st_blk, BLOCK)
    for tel in (tel_scan, tel_blk):
        assert not tel[0].processed[:, 1].any()     # deferred
        assert tel[1].processed[:, 1].all()         # caught up
        assert tel[2].processed[:, 1].all()
        assert tel[0].processed[:, 0].all()
        for b in (1, 2):
            # signal time: the epoch start, in stream samples, less the
            # handoff sample, is epoch_index code periods (n_t = n0 here)
            start_abs = b * BLOCK + tel[b].start_offset[:, 1].astype(np.int64)
            np.testing.assert_array_equal(
                start_abs - handoff,
                tel[b].epoch_index[:, 1].astype(np.int64) * N0)
    for f in ("active", "offset", "epochs", "chip_int"):
        np.testing.assert_array_equal(getattr(st_scan, f),
                                      getattr(st_blk, f), f)
    skipped = -((ft.max_offset + 5 - BLOCK - ft.el_pad) // N0)
    assert int(st_scan.epochs[1]) == skipped + (b_blocks - 1) * T
    assert int(st_scan.epochs[0]) == b_blocks * T
    assert bool(st_scan.active[0]) and bool(st_scan.active[1])
