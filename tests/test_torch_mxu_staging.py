"""The window copy of kernels B1 and B2 (mxu fused tracking) of the
PyTorch port, on the CPU: the span the kernel stages into shared memory
for a superstep (``chip_smoke.prefetch_span``, the mirror of the
kernel's stage_window and stage_slice) holds every sample the plain
version's windows read, from a 16-byte-aligned origin, and the host read
bound refuses a stream that ends before that span does. The kernel
itself is held to the plain version at these edges on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 3 and 18).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import prefetch_span  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

N0 = 2046                           # 2.046 MHz GPS L1 C/A
K = 5
WP = 2560
T = 20
CAP = 2560                          # B2's spread_cap at 2.046 MHz
LAST = ((T - K) * N0 // 128) * 128  # off_j of the block's last superstep
SPAN = fused.direct_span(K, N0, WP)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _index_stream(n):
    """A stream whose samples are their own indices (exact in f32)."""
    x = torch.arange(n, dtype=torch.float32)
    return x, x


def _check(starts, length, **kw):
    """The wrappers' host checks of a launch on ``starts`` (B2: the
    base last), without launching."""
    c = len(starts) - (1 if kw.get("spread_cap") else 0)
    sre, sim = _index_stream(length)
    fused._check_args(
        sre, sim, torch.tensor(starts, dtype=torch.int32),
        torch.zeros((c, 8, WP), dtype=torch.bfloat16),
        torch.zeros((c, fused.N_FIELDS)), t_epochs=T, k_epochs=K, n0=N0,
        wp=WP, lock_mode="power", **kw)


@pytest.mark.parametrize("residue", range(4))
def test_staged_span_holds_every_window_read(residue):
    """Starts at each residue mod 4, the highest at the last valid start
    (its last window ends at the stream's last sample), across every
    superstep: each sample _superstep_windows reads lies in
    [origin + offset, origin + length), the origin a 4-sample multiple
    at most 3 below the window, the span ending where the window does."""
    length = 3000 + 128 * 9 + residue + LAST + SPAN
    starts = torch.tensor([1000 + residue, 3000 + 128 * 9 + residue],
                          dtype=torch.int32)
    sre, sim = _index_stream(length)
    assert int(starts.max()) + LAST + SPAN == length
    for j in range(T // K):
        win, _ = fused._superstep_windows(sre, sim, starts, j, k_epochs=K,
                                          n0=N0, wp=WP)
        origin, n, offset = prefetch_span(starts.to(torch.int64), j,
                                                K, N0, WP)
        assert bool((origin % 4 == 0).all()) and bool((origin >= 0).all())
        assert bool((offset == residue).all())
        lo, hi = origin + offset, origin + n
        got = win.to(torch.int64)
        assert bool((got >= lo[:, None]).all()) and \
            bool((got < hi[:, None]).all())
        # the window is the span after the offset, sample for sample
        assert torch.equal(got, lo[:, None] + torch.arange(SPAN))
    assert int((origin + n).max()) == length


def test_shared_slice_holds_every_window_read():
    """B2: every channel's window of every superstep lies in the slice
    prefetch_span gives for the base with spread_cap (offset 0: the base
    and its superstep offsets are 128-multiples), the highest window at
    the slice's end."""
    base = 128 * 7
    starts = torch.tensor([base, base + 128 * 3, base + CAP, base],
                          dtype=torch.int32)
    length = base + CAP + LAST + SPAN
    sre, sim = _index_stream(length)
    for j in range(T // K):
        win, _ = fused._superstep_windows(sre, sim, starts, j, k_epochs=K,
                                          n0=N0, wp=WP, spread_cap=CAP)
        origin, n, offset = prefetch_span(base, j, K, N0, WP, CAP)
        assert offset == 0 and origin % 128 == 0
        got = win.to(torch.int64)
        assert int(got.min()) >= origin and int(got.max()) < origin + n
    assert origin + n == length


@pytest.mark.parametrize("residue", range(4))
def test_read_bound_ends_with_the_staged_span(residue):
    """The host check passes a stream that ends where the highest start's
    staged span ends and refuses one a sample shorter, from host starts
    and from starts_bound (the scan's static bound)."""
    hi = 3000 + residue
    starts = [1000 + residue, hi]
    origin, n, _ = prefetch_span(hi, T // K - 1, K, N0, WP)
    end = origin + n
    _check(starts, end)
    _check(starts, end, starts_bound=hi)
    with pytest.raises(ValueError, match="out of bounds"):
        _check(starts, end - 1)
    with pytest.raises(ValueError, match="out of bounds"):
        _check(starts, end - 1, starts_bound=hi)


def test_shared_read_bound_ends_with_the_slice():
    """B2's slice bound (ROADMAP C3) ends where the last superstep's
    slice does, from host starts and from starts_bound."""
    base = 128 * 7
    origin, n, _ = prefetch_span(base, T // K - 1, K, N0, WP, CAP)
    end = origin + n
    # every window ends below the slice's end: the slice bound decides
    starts = [base + 128, base, base]
    _check(starts, end, spread_cap=CAP)
    with pytest.raises(ValueError, match="C3"):
        _check(starts, end - 1, spread_cap=CAP)
    # the guard's base below the highest start by the cap
    bound = base + CAP
    with pytest.raises(ValueError, match="out of bounds"):
        _check([bound, bound, base], end - 1, spread_cap=CAP,
               starts_bound=bound)
    _check([bound, bound, base], end, spread_cap=CAP, starts_bound=bound)


def test_prefetch_span_takes_tensors():
    """prefetch_span on an integer tensor of starts equals it on each
    start (the kernel's starts are tensors)."""
    starts = np.array([0, 1, 2, 3, 4097, 128 * 40 + 3])
    for j in (0, 1, T // K - 1):
        o, n, off = prefetch_span(torch.from_numpy(starts), j, K, N0,
                                        WP)
        for i, s in enumerate(starts):
            assert (int(o[i]), int(n[i]), int(off[i])) == \
                prefetch_span(int(s), j, K, N0, WP)
