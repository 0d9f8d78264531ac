"""The window copy and the mix's lane arithmetic of the per-epoch kernels
of the PyTorch port (B4a, B4b, B6 and B3 over csrc/epoch_core.cuh), on
the CPU. The mirrors in chip_smoke (``epoch_window_origin`` and
``epoch_stage_span``: where stage_window copies an epoch's window from;
``epoch_lane_range``: mask_lanes; ``epoch_wrap`` and
``epoch_rolled_lanes``: the mix's prompt indices) are held to the plain
versions: the span holds every sample the plain version reads for each
epoch, from a 16-byte-aligned origin never below 0, at each start
residue mod 4, up to the wrapper's read bound; the integer lane range is
the float mask; the wrap without ``%`` is ``%``. The kernels themselves
are held to the plain versions at these edges on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 15).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import (  # noqa: E402
    epoch_bytes, epoch_lane_range, epoch_rolled_lanes, epoch_stage_span,
    epoch_window_origin, epoch_wrap)
from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

N0 = 2046                           # 2.046 MHz GPS L1 C/A
N_DRIFT = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _index(*shape):
    """Samples equal to their flat index (exact in int64)."""
    return torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)


def _assert_span_holds(read, origin, wp):
    """The window the plain version reads (flat indices) is the staged
    span after its offset, sample for sample; the span starts on a
    4-sample multiple, at most 3 below the window and never below 0, and
    ends where the window does."""
    first, length, offset = epoch_stage_span(origin, wp)
    assert first >= 0 and first % 4 == 0 and 0 <= offset <= 3
    assert first + offset == origin and first + length == origin + wp
    assert torch.equal(read, first + offset + torch.arange(wp))


def _zeros_state(c, wp):
    return (torch.zeros((c, N_DRIFT, wp)), torch.zeros((c, ep.N_FIELDS)))


def test_windows_span_is_each_row():
    """B4a: epoch t of channel c reads row [t, c] of the [T, C, wp]
    windows (track_block_fused_reference's windows_re[t]): the span is
    the row, at residue 0."""
    t_all, c_all, wp = 6, 3, 2176
    win = _index(t_all, c_all, wp)
    for t in range(t_all):
        for c in range(c_all):
            origin = epoch_window_origin("windows", t, n0=N0, wp=wp, c=c,
                                         c_channels=c_all)
            assert origin % 4 == 0
            _assert_span_holds(win[t, c], origin, wp)


@pytest.mark.parametrize("residue", range(4))
def test_seg_span_holds_every_window_read(residue):
    """B4b on segments cut where the last window ends and widened by
    ``residue`` columns, so row c's windows start at residue c*residue
    mod 4: every epoch's window (the plain version's seg[:, a:a + wp] at
    _seg_start) lies in its span; the last row's last span ends at the
    last window's end, and the wrapper's read bound passes segments that
    end there and refuses one a sample shorter."""
    t_all, c_all, wp = 9, 4, 2432
    need = ep._seg_start(t_all - 1, N0)[0] + wp
    l_seg = need + residue
    seg = _index(c_all, l_seg)
    seen = set()
    for t in range(t_all):
        a, _ = ep._seg_start(t, N0)
        for c in range(c_all):
            origin = epoch_window_origin("seg", t, n0=N0, wp=wp, c=c,
                                         l_seg=l_seg)
            seen.add(origin % 4)
            _assert_span_holds(seg[c, a:a + wp], origin, wp)
    assert seen == {c * residue % 4 for c in range(c_all)}
    first, length, _ = epoch_stage_span(
        epoch_window_origin("seg", t_all - 1, n0=N0, wp=wp, c=c_all - 1,
                            l_seg=l_seg), wp)
    assert first + length == (c_all - 1) * l_seg + need
    reps, st = _zeros_state(c_all, wp)
    for length_ok, cols in ((True, need), (False, need - 1)):
        x = torch.zeros((c_all, cols))
        if length_ok:
            ep._check_seg(x, x, reps, st, t_epochs=t_all, n0=N0, wp=wp,
                          lock_mode="power")
        else:
            with pytest.raises(ValueError, match="out of bounds"):
                ep._check_seg(x, x, reps, st, t_epochs=t_all, n0=N0, wp=wp,
                              lock_mode="power")


@pytest.mark.parametrize("n0,k", [(2046, 5), (2047, 5), (2046, 8),
                                  (2045, 3)])
def test_resident_span_holds_every_window_read(n0, k):
    """B6 on a stream cut at the wrapper's read bound T*n0 + wp: every
    epoch's window (the plain version's block[a:a + wp] at
    _resident_start) lies in its span, inside the stream; the chunk
    origins i*k*n0 give residues 0 and 2 at n0 = 2046 with odd k (the
    main path's), all four where k*n0 is odd."""
    t_all = 4 * k
    wp = ((2 * n0 + 256 + 127) // 128) * 128
    bound = t_all * n0 + wp
    stream = _index(bound)
    seen = set()
    for t in range(t_all):
        a, _ = ep._resident_start(t, k, n0)
        origin = epoch_window_origin("resident", t, n0=n0, wp=wp, k_chunk=k)
        seen.add(origin % 4)
        _assert_span_holds(stream[a:a + wp], origin, wp)
        assert origin + wp <= bound
    want = {i * k * n0 % 4 for i in range(t_all // k)}
    assert seen == want
    if (n0, k) == (2046, 5):
        assert seen == {0, 2}
    if (k * n0) % 2:
        assert seen == {0, 1, 2, 3}
    reps, st = _zeros_state(1, wp)
    x = torch.zeros(bound)
    ep._check_resident(x, x, reps, st, t_epochs=t_all, n0=n0, wp=wp,
                       lock_mode="power")
    with pytest.raises(ValueError, match="out of bounds"):
        ep._check_resident(x[:-1], x[:-1], reps, st, t_epochs=t_all, n0=n0,
                           wp=wp, lock_mode="power")


@pytest.mark.parametrize("residue", range(4))
def test_direct_span_holds_every_window_read(residue):
    """B3 with starts at each residue mod 4, the highest at the last
    valid start (its last window ends at the stream's last sample):
    every epoch's window (the plain version's superstep window at
    a_e = floor(e*n0/128)*128) lies in its span; the highest start's
    last span ends at the stream's end, and the wrapper's read bound
    refuses a stream a sample shorter."""
    k, t_all, wp = 10, 20, 2560
    span = fused.direct_span(k, N0, wp)
    last = ((t_all - k) * N0 // 128) * 128
    hi = 3000 + 128 * 9 + residue
    starts = torch.tensor([1000 + residue, hi], dtype=torch.int32)
    length = hi + last + span
    stream = _index(length)
    for j in range(t_all // k):
        win, _ = fused._superstep_windows(stream, stream, starts, j,
                                          k_epochs=k, n0=N0, wp=wp)
        for e in range(k):
            a_e = (e * N0 // 128) * 128
            for c in range(2):
                origin = epoch_window_origin(
                    "direct", j * k + e, n0=N0, wp=wp,
                    start=int(starts[c]), k_epochs=k)
                assert origin % 4 == residue
                _assert_span_holds(win[c, a_e:a_e + wp], origin, wp)
    first, n, _ = epoch_stage_span(origin, wp)
    assert first + n == length
    reps = torch.zeros((2, N_DRIFT, wp))
    st = torch.zeros((2, fused.N_FIELDS))
    kw = dict(t_epochs=t_all, k_epochs=k, n0=N0, wp=wp, lock_mode="power",
              replica_dtype=torch.float32)
    x = torch.zeros(length)
    fused._check_args(x, x, starts, reps, st, **kw)
    with pytest.raises(ValueError, match="out of bounds"):
        fused._check_args(x[:-1], x[:-1], starts, reps, st, **kw)


def test_stage_span_floor_never_below_zero():
    """The 4-sample floor of any origin >= 0 is >= 0, at most 3 below it;
    on integer tensors the same as on ints."""
    origins = torch.arange(0, 64, dtype=torch.int64)
    first, length, offset = epoch_stage_span(origins, 256)
    assert bool((first >= 0).all()) and bool((first % 4 == 0).all())
    assert bool((origins - first <= 3).all())
    for i, o in enumerate(origins.tolist()):
        assert (int(first[i]), int(length[i]), int(offset[i])) == \
            epoch_stage_span(o, 256)


@pytest.mark.parametrize("wp", [128, 2432])
def test_lane_range_equals_float_mask(wp):
    """[l0, l1) of epoch_lane_range is the set of lanes l in [0, wp) with
    start_lane <= l < start_lane + n_t in f32 (the plain version's mask),
    at its edges: starts below 0, at 0, inside, at wp - 1, wp and past
    it; whole and fractional starts; n_t 0 to past wp; NaN."""
    lanes = np.arange(wp, dtype=np.float32)
    starts = [-3000.0, -2.0, -1.0, -0.5, 0.0, 0.25, 1.0, 3.5, 127.0, 128.0,
              wp - 2046.0, wp - 1.5, wp - 1.0, float(wp), wp + 5.0]
    for sl in starts:
        for n_t in (0.0, 1.0, 2.0, 2046.0, 2047.0, float(wp), 5000.0):
            s32 = np.float32(sl)
            end = np.float32(s32 + np.float32(n_t))
            want = np.nonzero((lanes >= s32) & (lanes < end))[0]
            l0, l1 = epoch_lane_range(sl, n_t, wp)
            assert np.array_equal(np.arange(l0, max(l0, l1)), want), \
                (sl, n_t)
    assert epoch_lane_range(float("nan"), 2046.0, wp)[1] == 0


@pytest.mark.parametrize("wp", [128, 2176, 4352])
def test_wrap_without_modulo_equals_modulo(wp):
    """epoch_wrap over (-wp, 2wp) equals % wp, and the mix's three
    prompt indices equal (l - rem +- el) % wp for every lane, with rolls
    up to 255 (the direct feed's rem_e + rem_j) and el up to wp - 1."""
    x = np.arange(-wp + 1, 2 * wp)
    assert np.array_equal(epoch_wrap(x, wp), x % wp)
    lanes = np.arange(wp)
    for rem in (0, 1, 127, 128, 255):
        for el in (0, 1, 2, wp // 2, wp - 1):
            ie, ip, il = epoch_rolled_lanes(lanes, rem, el, wp)
            assert np.array_equal(ip, (lanes - rem) % wp)
            assert np.array_equal(ie, (lanes - rem + el) % wp)
            assert np.array_equal(il, (lanes - rem - el) % wp)


@pytest.mark.parametrize("feed", ["windows", "seg", "resident"])
def test_epoch_bytes_counts_what_the_outputs_need(feed):
    """chip_smoke.epoch_bytes, the bytes phase 16 bounds B4a, B4b and B6
    by: the lanes inside each active epoch's mask (telemetry col 12 where
    col 16 is set) at 8 bytes where each channel has windows of its own,
    the whole stream where every channel reads one; then the active
    channels' replica rows, the state in and out and the telemetry."""
    t, c, wp, n = 3, 4, 256, 1000
    telem = torch.zeros((t, c, ep.N_TELEM))
    telem[..., 12] = 200.0
    telem[:2, 1, 16] = 1.0              # channel 1 active in two epochs
    telem[:, 3, 16] = 1.0               # channel 3 in all three
    reps, st = _zeros_state(c, wp)
    stream = torch.zeros(n)
    win = 2 * n * 4 if feed == "resident" else 5 * 200 * 8
    rest = (2 * N_DRIFT * wp + 2 * c * ep.N_FIELDS + t * c * ep.N_TELEM) * 4
    assert epoch_bytes(feed, (stream, stream, reps, st), telem, st) == (
        win + rest)
