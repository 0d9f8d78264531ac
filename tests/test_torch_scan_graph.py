"""The scanned tracker's device program (receiver/tracking.py: the packed
inputs with the limit as a 0-d tensor, the fixed input buffers of a
block's CUDA graph, its key) and kernel B5's block-reading entry point
(ops/cuda/epl_correlator.py: ``epl_correlate_block``, its plain version
on CPU tensors, and the chip-index rule the kernel uses instead of a
modulo), on the CPU.

  * The block entry's plain version equals the [C, W] entry bit for bit
    on the same windows, and the JAX package's ``epl_correlate_pallas`` in
    Pallas interpret mode within 1e-4 of each sum's column max (CPU
    sin/cos of the two frameworks differ by ulps), at the tracker's own
    window for GPS L1 C/A at 2.046 MHz, interp off and on, and Galileo
    E1B at 8.184 MHz.
  * ``wrap_code_index`` equals ``torch.remainder`` on chip ramps that
    cross both ends of the code row, the late replica included.
  * The device-input form (the ledger and limit in one packed tensor,
    copied into a graph's fixed buffers and run eagerly) equals the
    eager loop with a Python-int limit bit for bit, for the four
    correlators, on a full block and a ``valid_len`` tail block through
    the same buffers and key.
  * A launch counts where it runs: eagerly at the call, from a CUDA graph
    at each replay (ops/cuda/launches.py, with the graph faked).
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gnss_sdr_tpu.ops.pallas.epl_correlator import (  # noqa: E402
    epl_correlate_pallas as j_pallas)

from gnss_sdr_tpu_torch.config import TrackConfig  # noqa: E402
from gnss_sdr_tpu_torch.models import (  # noqa: E402
    GPS_L1CA, SatelliteScenario, get_signal, synthesize)
from gnss_sdr_tpu_torch.ops import correlator as corr  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import launches  # noqa: E402
from gnss_sdr_tpu_torch.receiver import tracking as trk  # noqa: E402

FIELDS = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")
B5_CASES = {
    # name: (signal, fs, interp)
    "gps_2046k": ("gps_l1ca", 2_046_000.0, False),
    "gps_2046k_interp": ("gps_l1ca", 2_046_000.0, True),
    "e1b_8184k": ("galileo_e1b", 8_184_000.0, False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b5_case(signal, fs, seed=0, c=4):
    """A block of three windows' length with c channels' windows in it
    (one at each end of the block), the tracker's window and shift for
    ``signal`` at ``fs``, random u32 phases, chip phases near the nominal
    rate, and the masks n0, a partial one, none and an idle channel's
    saturated one. Returns (numpy block re/im, numpy per-channel args,
    statics)."""
    spec = get_signal(signal)
    params = trk.TrackParams.create(TrackConfig(), spec, fs)
    w, n0 = params.window, spec.samples_per_code(fs)
    n = 3 * w
    rng = np.random.default_rng(seed)
    sig = synthesize([SatelliteScenario(
        prn=p + 1, signal=spec, doppler_hz=400.0 * p,
        code_phase_chips=37.0 * p) for p in range(c)], n, fs,
        noise_std=1.0, seed=seed)
    starts = rng.integers(0, n - w + 1, c).astype(np.int32)
    starts[0], starts[-1] = 0, n - w
    n_valid = np.array([n0, n0 - 37, 0, 2 ** 31 - 1], np.int32)[:c]
    carr_acc = rng.integers(0, 2 ** 32, c, dtype=np.uint32)
    carr_step = rng.integers(0, 2 ** 32, c, dtype=np.uint32)
    chip_int = rng.integers(0, spec.code_length_chips, c).astype(np.int32)
    chip_frac = rng.random(c).astype(np.float32)
    cps = (spec.code_rate_hz * (1.0 + 1e-4 * rng.standard_normal(c))
           / fs).astype(np.float32)
    codes = trk.make_code_table(spec, c)
    per_channel = (n_valid, carr_acc, carr_step, chip_int, chip_frac, cps,
                   codes)
    statics = dict(window=w, shift=params.el_shift,
                   oversample=params.oversample)
    return (np.real(sig).astype(np.float32), np.imag(sig).astype(np.float32),
            starts, per_channel, statics)


def _port(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


@pytest.mark.parametrize("case", list(B5_CASES))
def test_block_entry_matches_windows_entry_and_jax(case):
    signal, fs, interp = B5_CASES[case]
    re, im, starts, per_channel, st = _b5_case(signal, fs, seed=len(case))
    w = st["window"]
    idx = starts[:, None].astype(np.int64) + np.arange(w)
    win_re, win_im = re[idx], im[idx]
    kw = dict(shift=st["shift"], oversample=st["oversample"], interp=interp)
    b5.reset_launch_count()
    got = b5.epl_correlate_block(
        _port(re), _port(im), _port(starts), *map(_port, per_channel),
        window=w, **kw)
    windows = b5.epl_correlate_pallas(_port(win_re), _port(win_im),
                                      *map(_port, per_channel), **kw)
    assert b5.launch_count == 0           # CPU tensors: the plain version
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(windows, f)), f
    ref = j_pallas(win_re, win_im, *per_channel, interpret=True, **kw)
    worst = 0.0
    for f in FIELDS:
        a = getattr(got, f).double().numpy()
        b = np.asarray(getattr(ref, f), np.float64)
        rel = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        assert rel < 1e-4, (f, rel)
        worst = max(worst, rel)
    # the masked-out channel sums nothing; the others carry their windows
    assert all(float(getattr(got, f)[2]) == 0.0 for f in FIELDS)
    print(f"\n{case}: W={w}, block entry vs JAX interpret <= {worst:.3e}")


def _ramp_floors(base_chip, frac, cps, os, w, shift):
    """The plain version's chip ramp floors over j in [-shift, W + shift)
    (ops/correlator.py), for one channel."""
    j = torch.arange(w + 2 * shift, dtype=torch.float32) - float(shift)
    cp = corr.fma(j, torch.tensor(cps, dtype=torch.float32),
                  torch.tensor(frac, dtype=torch.float32))
    return torch.floor(cp * float(os))


@pytest.mark.parametrize("signal,fs", [("gps_l1ca", 2_046_000.0),
                                       ("galileo_e1b", 8_184_000.0)])
def test_wrap_code_index_matches_remainder(signal, fs):
    spec = get_signal(signal)
    params = trk.TrackParams.create(TrackConfig(), spec, fs)
    n_code = spec.code_length_chips * params.oversample
    w, shift = params.window, params.el_shift
    seen = {"neg": False, "over": False, "over2": False}
    for chip_int in (0, 1, spec.code_length_chips // 2,
                     spec.code_length_chips - 1):
        for frac, rate in ((0.0, 1.0), (0.999, 1.0 + 2e-3),
                           (0.5, 1.0 - 2e-3)):
            cps = float(np.float32(spec.code_rate_hz * rate / fs))
            fl = _ramp_floors(chip_int, frac, cps, params.oversample, w,
                              shift)
            base = torch.full_like(fl, chip_int * params.oversample,
                                   dtype=torch.int64)
            raw = base + fl.to(torch.int64)
            seen["neg"] |= bool((raw < 0).any())
            seen["over"] |= bool((raw >= n_code).any())
            seen["over2"] |= bool((raw >= 2 * n_code).any())
            assert torch.equal(b5.wrap_code_index(base, fl, n_code),
                               torch.remainder(raw, n_code))
    # the ramps cross the row's start (the late replica) and its end, once
    # and (base near the end, a ramp over a period) twice
    assert all(seen.values()), seen
    # a corrupt ledger (a ramp far past the range, NaN) stays in the row
    wild = torch.tensor([-1e9, -5.0 * n_code, 7.0 * n_code, 1e12,
                         float("nan")])
    got = b5.wrap_code_index(torch.full((5,), n_code - 1), wild, n_code)
    assert bool(((got >= 0) & (got < n_code)).all())


def test_cluster_size_keeps_two_blocks_per_sm():
    """B5's blocks per channel: 8 at the receiver's 32 channels on the
    H100's 132 SMs (the fastest size there, PERF.md), fewer as the
    channels grow, 1 where they alone fill two blocks per SM."""
    got = {c: b5.cluster_size(c, 132) for c in (1, 32, 33, 34, 66, 67,
                                               132, 133)}
    assert got == {1: 8, 32: 8, 33: 8, 34: 4, 66: 4, 67: 2, 132: 2, 133: 1}


def test_block_entry_rejects_windows_outside_the_block():
    re, im, starts, per_channel, st = _b5_case("gps_l1ca", 2_046_000.0)
    n, w = re.shape[0], st["window"]
    args = (_port(re), _port(im))
    kw = dict(window=w, shift=st["shift"])
    for bad in (n - w + 1, -1):
        s = starts.copy()
        s[1] = bad
        with pytest.raises(ValueError, match="out of bounds"):
            b5.epl_correlate_block(*args, _port(s), *map(_port, per_channel),
                                   **kw)
    with pytest.raises(ValueError, match="out of bounds"):
        b5.epl_correlate_block(*args, _port(starts), *map(_port, per_channel),
                               max_start=n - w + 1, **kw)
    with pytest.raises(ValueError, match="window"):
        b5.epl_correlate_block(*args, _port(starts), *map(_port, per_channel),
                               window=n + 1, shift=st["shift"])
    with pytest.raises(TypeError, match="start"):
        b5.epl_correlate_block(*args, _port(starts).long(),
                               *map(_port, per_channel), **kw)


# -- the scanned tracker's device program ----------------------------------

FS = 4_096_000.0
N0 = GPS_L1CA.samples_per_code(FS)
N_EPOCHS = 40
TAIL = 30 * N0 + 100


def _scene(correlator, c=4):
    """Three satellites tracked from their code boundaries, an idle
    channel and one deferred past the block (tests/test_torch_scan_
    tracking.py's power scene)."""
    n = 48 * N0
    sats = [SatelliteScenario(prn=2, doppler_hz=3000.0),
            SatelliteScenario(prn=5, doppler_hz=-1500.0,
                              code_phase_chips=0.25),
            SatelliteScenario(prn=7, doppler_hz=700.0)]
    sig = synthesize(sats, n, FS, noise_std=0.3, seed=5)
    cfg = TrackConfig(n_channels=c, correlator=correlator)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    st = trk.init_state(c)
    for ch, prn, f, off in ((0, 2, 2950.0, 0), (2, 5, -1500.0, 0),
                            (3, 7, 700.0, n - N0)):
        st = trk.start_channel(st, ch, prn - 1, f, off,
                               GPS_L1CA.code_rate_hz)
    if correlator == "slice":
        table = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                            window=params.window)
    else:
        table = trk.make_code_table(GPS_L1CA, 32)
    codes = torch.from_numpy(table[np.maximum(st.prn_idx, 0)])
    re = torch.from_numpy(np.real(sig).astype(np.float32))
    im = torch.from_numpy(np.imag(sig).astype(np.float32))
    return params, codes, st, re, im


def _eager_loop(params, codes, state, re, im, n_epochs, valid_len):
    """The block as track_block_device ran it before its graph: the
    ledger as [13, C] tensors and the limit a Python int."""
    c = state.active.shape[0]
    packed = torch.from_numpy(trk._pack_inputs(state, 0)[:-1].copy())
    st = trk._device_state(packed.view(-1, c))
    limit = re.shape[0] if valid_len is None else min(re.shape[0],
                                                      valid_len)
    rows = []
    for _ in range(n_epochs):
        st, tl = trk.epoch_step(params, codes, st, re, im, limit)
        rows.append(tl)
    state_bits = torch.stack([trk._bits32(x) for x in st])
    telem_bits = torch.stack([
        trk._bits32(torch.stack([getattr(r, f) for r in rows]))
        for f in trk.EpochTelemetry._fields])
    return torch.cat([state_bits.reshape(-1), telem_bits.reshape(-1)])


@pytest.mark.parametrize("correlator", ["shift", "exact", "slice", "pallas"])
def test_device_input_form_equals_eager_loop(correlator):
    params, codes, st, re, im = _scene(correlator)
    # one key, one set of fixed buffers, for the full and the tail block
    g = trk._BlockGraph(trk.graph_key(params, codes, st, re, N_EPOCHS))
    for valid_len in (None, TAIL):
        want = _eager_loop(params, codes, st, re, im, N_EPOCHS, valid_len)
        limit = re.shape[0] if valid_len is None else valid_len
        g.load(torch.from_numpy(trk._pack_inputs(st, limit)), re, im, codes)
        got = g.eager()
        assert torch.equal(got, want), valid_len
        assert torch.equal(trk.track_block_device(
            params, codes, st, re, im, N_EPOCHS, valid_len), want)
        _, tl = trk.unpack_block(got, 4, N_EPOCHS)
        if valid_len is None:
            assert tl.processed[:, 0].all() and tl.locked[:, 0].all()
            assert not tl.processed[:, 1].any()          # idle
            assert not tl.processed[:, 3].any()          # deferred
        else:
            # the tail stops the processing early
            assert 0 < tl.processed[:, 0].sum() < N_EPOCHS


def test_graph_key_changes_with_static_shapes_only():
    params, codes, st, re, im = _scene("pallas")
    key = trk.graph_key(params, codes, st, re, N_EPOCHS)
    st5 = trk.init_state(5)
    codes5 = torch.cat([codes, codes[:1]])
    differ = {
        "n_epochs": trk.graph_key(params, codes, st, re, N_EPOCHS + 1),
        "channels": trk.graph_key(params, codes5, st5, re, N_EPOCHS),
        "block length": trk.graph_key(params, codes, st, re[:-1], N_EPOCHS),
        "codes width": trk.graph_key(params, codes[:, :-1], st, re,
                                     N_EPOCHS),
        "params": trk.graph_key(
            trk.TrackParams.create(TrackConfig(n_channels=4,
                                               correlator="shift"),
                                   GPS_L1CA, FS), codes, st, re, N_EPOCHS),
    }
    for name, k in differ.items():
        assert k != key, name
    # a new state of the same shape, and new block and code values,
    # replay one graph (valid_len is no argument of the key at all)
    same = trk.graph_key(params, codes * -1.0, trk.start_channel(
        st, 1, 9, 100.0, 5, GPS_L1CA.code_rate_hz), re + 1.0, N_EPOCHS)
    assert same == key and hash(same) == hash(key)
    # the packed inputs: 13 ledger rows and the limit
    ins = trk._pack_inputs(st, TAIL)
    assert ins.shape == (13 * 4 + 1,) and ins[-1] == TAIL


def test_launch_counts_follow_graph_replays(monkeypatch):
    """launches.record counts an eager launch in its module's int; inside
    Graph.capture it files the launch under the graph instead, and each
    replay adds the graph's launches. A launch captured outside a
    launches.Graph raises. (The CUDA graph is faked: no card here.)"""
    capturing = [False]
    replays = []

    class FakeGraph:
        def replay(self):
            replays.append(1)

    @contextlib.contextmanager
    def fake_capture(graph, **kwargs):
        assert isinstance(graph, FakeGraph)
        capturing[0] = True
        try:
            yield
        finally:
            capturing[0] = False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(b5, "launch_count", 0)
    launches.record(b5.__name__, "launch_count")
    assert b5.launch_count == 1
    g = launches.Graph()
    with g.capture(capture_error_mode="thread_local"):
        for _ in range(3):
            launches.record(b5.__name__, "launch_count")
    assert b5.launch_count == 1              # captured, not run yet
    g.replay()
    g.replay()
    assert b5.launch_count == 7 and len(replays) == 2
    capturing[0] = True
    with pytest.raises(RuntimeError, match="outside"):
        launches.record(b5.__name__, "launch_count")
    assert b5.launch_count == 7
