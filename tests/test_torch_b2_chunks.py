"""Kernel B2 (the shared fetch) in lane clusters, on the CPU. There the
wrapper launches B1's lane kernel (csrc/track_block_mxu.cu
track_block_mxu_lanes) on starts[:C]. The samples it mixes for B2's
starts (``chip_smoke.b2_chunk_reads``) are exactly the plain version's
window reads, per epoch and lane part, and lie inside the shared read
bound the wrapper checks (``_check_shared``, ROADMAP C3), at ladder 4's
shapes and at a narrow width where a small shared-memory budget makes
``mxu_smem_plan`` pick the lane clusters. B2's plain version is held to
the JAX B2 (Pallas ``spread_cap > 0``, interpret mode) at that narrow
width. The CUDA launch is held to B1 at the same cluster size bit for
bit on the card (tests/test_torch_cuda.py, chip_smoke.py phases 28-30).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from gnss_sdr_tpu.ops.pallas import track_block_fused as j_fused  # noqa: E402

from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

# (n0, wp, R, K, T, spread_cap, shared-memory budget): ladder 4's GPS and
# Galileo E1B shapes at 8.184 MHz (96 ms blocks) under the card's budget,
# and 2.046 MHz GPS under a budget small enough for lane chunks
SHAPES = {
    "gps_8184k": (8184, 8704, 13, 8, 96, 8704, fused.SMEM_BLOCK),
    "galileo_8184k": (32736, 33280, 9, 6, 24, 33280, fused.SMEM_BLOCK),
    "narrow_2046k": (2046, 2560, 8, 5, 20, 2560, 100_000),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plan(shape):
    n0, wp, rows, k, _, cap, smem = SHAPES[shape]
    return fused.mxu_smem_plan(wp, rows, k, smem=smem)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_b2_takes_b1s_plan_and_mixes_chunks_from_global_memory(shape):
    """B2 takes B1's plan, which puts these shapes in lane clusters,
    where B2 runs B1's lane kernel (a block's mix reads its staged window
    rows, or global memory where they do not fit): lane parts of whole
    128-lane groups, one per block of the cluster, evened out (widths
    differ by at most 128), covering [0, wp) once, each option's bank,
    tile and partial sums within the budget; 2.046 MHz at the card's
    budget stays whole-width, where B2 multicasts its slice."""
    n0, wp, rows, k, _, cap, smem = SHAPES[shape]
    plan = _plan(shape)
    assert plan["layout"] == "cluster"
    for opt in plan["options"]:
        l0s, widths = zip(*opt["parts"])
        assert all(w % 128 == 0 and w > 0 for w in widths)
        assert l0s == tuple(np.cumsum((0,) + widths[:-1]))
        assert sum(widths) == wp and max(widths) - min(widths) <= 128
        assert opt["bytes"] <= smem - fused.MXU_LANES_STATIC_SMEM
    assert fused.mxu_smem_plan(2560, 9, 5)["layout"] == "whole"


@pytest.mark.parametrize("shape", list(SHAPES))
def test_chunk_reads_are_the_plain_windows_within_the_shared_bound(shape):
    """For a base and channel offsets dc across the cap (0, a middle one,
    the cap), every superstep and epoch: each chunk's reads lie in the
    epoch's window, the chunks together read each of the window's wp
    samples once (the plain version's reads, _superstep_windows on an
    index stream), at every roll residue the epochs give; the highest
    read is below the read bound the wrapper checks for the slices, which
    holds a stream that ends there and refuses one a sample shorter."""
    n0, wp, rows, k, t, cap, _ = SHAPES[shape]
    plan = _plan(shape)
    base = 128 * 5
    dcs = [0, 128 * (cap // 256), cap]
    starts = torch.tensor([base + d for d in dcs] + [base],
                          dtype=torch.int32)
    last = ((t - k) * n0 // 128) * 128
    span = fused.direct_span(k, n0, wp)
    length = base + cap + last + span
    idx = torch.arange(length, dtype=torch.float32)
    shifts, top = set(), 0
    for j in range(t // k):
        win, _ = fused._superstep_windows(idx, idx, starts, j, k_epochs=k,
                                          n0=n0, wp=wp, spread_cap=cap)
        win = win.to(torch.int64).numpy()
        for c, dc in enumerate(dcs):
            for e in range(k):
                a_e = (e * n0 // 128) * 128
                want = win[c, a_e:a_e + wp]
                got = [chip_smoke.b2_chunk_reads(
                    base, dc, j, e, np.arange(l0, l0 + w), k_epochs=k,
                    n0=n0, wp=wp) for l0, w in plan["parts"]]
                for g in got:
                    assert g.min() >= want[0] and g.max() <= want[-1]
                allg = np.sort(np.concatenate(got))
                np.testing.assert_array_equal(allg, want)
                top = max(top, int(allg[-1]))
                kk = j * k * n0
                shifts.add((e * n0 - a_e + kk - (kk // 128) * 128) % 4)
    assert top < length
    # even rolls (n0 even): the mix's paired 8-byte loads
    assert shifts <= {0, 2} and 0 in shifts

    def check(n, dc_starts):
        fused._check_args(
            idx[:n], idx[:n], dc_starts,
            torch.zeros((3, rows, wp), dtype=torch.bfloat16),
            torch.zeros((3, fused.N_FIELDS)), t_epochs=t, k_epochs=k, n0=n0,
            wp=wp, lock_mode="power", spread_cap=cap)

    # a channel at the cap: its own windows end where the slices do
    check(length, starts)
    with pytest.raises(ValueError, match="out of bounds"):
        check(length - 1, starts)
    # every channel below the cap: the slices' bound alone decides
    below = starts.clone()
    below[2] = base
    check(length, below)
    with pytest.raises(ValueError, match="C3"):
        check(length - 1, below)


def test_plain_b2_matches_jax_b2_at_a_chunked_width():
    """At the narrow shape, where the small budget puts B2 in lane chunks
    on the card: the plain B2 against the Pallas B2 in interpret mode
    (dc at 0, CAP / 2 and CAP over a raised base; one channel idle): the
    bf16 correlations within 2^-7 of their column maximum, flags and
    integer columns equal, and chip_smoke.compare's tolerances (state
    rtol 1e-4)."""
    n0, wp, rows, k, t, cap, smem = SHAPES["narrow_2046k"]
    assert _plan("narrow_2046k")["layout"] == "cluster"
    from tests.test_torch_shared_fetch import _kernel_inputs

    args, kw = _kernel_inputs({})
    assert (kw["n0"], kw["wp"], kw["k_epochs"], kw["t_epochs"]) == \
        (n0, wp, k, t) and args[3].shape[1] == rows
    sre, sim, starts, reps, mat = args
    tj, sj = j_fused.track_block_fused_mxu(
        jnp.asarray(sre.numpy()), jnp.asarray(sim.numpy()),
        jnp.asarray(starts.numpy()),
        jnp.asarray(reps.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(mat.numpy()), interpret=True, spread_cap=cap, **kw)
    tt, st = fused.track_block_fused_mxu(*args, spread_cap=cap, **kw)
    tj = np.asarray(tj)[:, :, :fused.N_TELEM]
    tt, st, sj = tt.numpy(), st.numpy(), np.asarray(sj)
    for col in chip_smoke.EXACT_COLS:
        np.testing.assert_array_equal(tt[..., col], tj[..., col])
    for col in chip_smoke.CORR_COLS:
        scale = max(float(np.abs(tj[..., col]).max()), 1e-30)
        assert float(np.abs(tt[..., col] - tj[..., col]).max()) \
            <= 2.0 ** -7 * scale, col
    # the state within rtol 1e-4 (chip_smoke.compare: the rates with a
    # 1 mHz floor, the carrier phase circular, the loop-filter memories,
    # discriminators of bf16 correlations, within 1e-3 of their max)
    chip_smoke.compare(tt, st, tj, sj)
    assert tt[:, :3, 16].all() and not tt[:, 3, 16].any()
