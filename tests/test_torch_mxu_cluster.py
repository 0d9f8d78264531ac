"""Kernel B1 (and B2) in lane clusters, on the CPU: one channel over a
thread-block cluster of cs blocks, block r holding lane part r's bank
rows for every superstep (csrc/track_block_mxu.cu
track_block_mxu_lanes). The CUDA kernel runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 24-30); here:

  * the plan (``mxu_smem_plan``) at ladder 4's shapes and at GLONASS's
    1.023 MHz window: the parts cover [0, wp) once in whole 128-lane
    groups and every option fits in a block's shared memory; at the
    mixed row's channel counts the first option's C x cs blocks fit on
    the card's 132 SMs; "whole" exactly where the plan before the lane
    clusters said so (tools/b1_chunked.py); every width that plan took is
    taken, and one group past its own limit raises naming C15;
  * the sum order: the contraction summed per lane part and the parts
    added in rank order (the plain version's ``lane_parts``) against the
    plain version, superstep by superstep from a common state, within
    2^-7 of each correlation column's maximum and chip_smoke.compare's
    tolerances (state rtol 1e-4);
  * the staged window rows (``chip_smoke.lane_row_samples``, the
    kernel's stage_rows_windows): every sample a block's mix reads is at
    its row position, every staged sample lies in the epoch's window or
    its 16-byte floor, and the bulk copies start 16-byte aligned.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "b1_chunked", Path(__file__).resolve().parents[1] / "tools"
    / "b1_chunked.py")
b1_chunked = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(b1_chunked)

# (wp, R, K): the mixed row's 96 ms shapes (power lock, and Costas's K
# 2), ladder 4's 20 ms shapes, and GLONASS at 1.023 MHz (R 21)
SHAPES = sorted(
    {(wp, r, k) for wp, r, k96 in chip_smoke.WIDE_MXU_SHAPES.values()
     for k in (k96, 2)}
    | set(chip_smoke.LADDER4_MXU_SHAPES.values())
    | {(1536, 21, 5), (1536, 21, 2)})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("wp,rows,k", SHAPES)
def test_cluster_parts_cover_the_window_and_fit(wp, rows, k):
    plan = fused.mxu_smem_plan(wp, rows, k)
    assert plan["layout"] == "cluster" and plan["options"]
    assert plan["cs"] == plan["options"][0]["cs"]
    for opt in plan["options"]:
        assert opt["bytes"] + fused.MXU_LANES_STATIC_SMEM <= \
            fused.SMEM_BLOCK
        assert opt["bytes"] == fused.lane_cluster_bytes(
            wp, rows, k, opt["cs"], opt["warps"], opt["sub"],
            opt["staged"])
        lanes = np.zeros(wp, np.int64)
        for l0, w in opt["parts"]:
            assert l0 % 128 == 0 and w % 128 == 0 and w > 0
            lanes[l0:l0 + w] += 1
        assert (lanes == 1).all()
        assert len(opt["parts"]) == opt["cs"] <= 16
        # 8 warps where the window rows are staged, else 16
        assert opt["warps"] == (8 if opt["staged"] else 16)
        # the bank resident: the sub-chunk is the widest part
        if opt["resident"]:
            assert opt["sub"] == max(w for _, w in opt["parts"])
        else:
            assert not opt["staged"] and opt["sub"] % 128 == 0
    # the ladder-4 shapes keep their banks resident at the first size
    assert plan["resident"]


def test_cluster_blocks_fit_on_the_card_at_the_mixed_row():
    for system, c in chip_smoke.MIXED_CHANNELS.items():
        for shape in (chip_smoke.WIDE_MXU_SHAPES[system],
                      chip_smoke.LADDER4_MXU_SHAPES.get(system)):
            if shape is None:
                continue
            plan = fused.mxu_smem_plan(*shape, c_channels=c)
            assert c * plan["cs"] <= fused.H100_SMS, (system, plan["cs"])
    # more channels than the card holds clusters of 8: smaller first
    plan = fused.mxu_smem_plan(8704, 13, 8, c_channels=32)
    assert 32 * plan["cs"] <= fused.H100_SMS
    assert [o["cs"] for o in plan["options"]][-2:] == [16, 8]


def test_whole_where_it_was_and_every_old_width_taken():
    for k in range(1, 9):
        for rows in (1, 5, 8, 9, 13, 16, 17, 21, 24):
            for wp in range(128, 12_289, 128):
                old = b1_chunked.old_layout(wp, rows, k)
                new = fused.mxu_smem_plan(wp, rows, k)["layout"]
                assert (new == "whole") == (old == "whole"), (wp, rows, k)
            old_max = b1_chunked.chunk_plan(128, rows, k)["max_wp"]
            plan = fused.mxu_smem_plan(old_max, rows, k)
            assert plan["max_wp"] >= old_max
            assert plan["layout"] == "cluster"
            with pytest.raises(ValueError, match="C15"):
                fused.mxu_smem_plan(plan["max_wp"] + 128, rows, k)


@pytest.mark.parametrize("system,block_ms", [("gps_l1ca", 20),
                                             ("galileo_e1b", 96)])
def test_rank_order_sums_match_the_plain_version(system, block_ms):
    """The lane clusters' sum order in plain PyTorch: per part, then the
    parts in rank order (at every cluster size the plan offers), each
    pair of supersteps from the plain version's own state."""
    inp = chip_smoke.wide_inputs(torch, "cpu", system, {},
                                 block_ms=block_ms)
    args, kw = inp["args"], inp["kw"]
    sre, sim, starts, reps, st = args
    k, wp = kw["k_epochs"], kw["wp"]
    plan = fused.mxu_smem_plan(wp, reps.shape[1], k)
    kw = {n: v for n, v in kw.items() if n != "t_epochs"}
    for j in range(0, inp["ft"].t_epochs // k, 2):
        tr, sr = fused.track_block_fused_mxu_reference(
            sre, sim, starts, reps, st, t_epochs=2 * k, first_superstep=j,
            **kw)
        for opt in plan["options"]:
            tp, sp = fused.track_block_fused_mxu_reference(
                sre, sim, starts, reps, st, t_epochs=2 * k,
                first_superstep=j, lane_parts=opt["parts"], **kw)
            chip_smoke.compare(tp, sp, tr, sr)
            for col in chip_smoke.CORR_COLS:
                scale = max(float(tr[..., col].abs().max()), 1e-30)
                assert float((tp[..., col] - tr[..., col]).abs().max()) \
                    <= 2.0 ** -7 * scale, (j, opt["cs"], col)
        st = sr
    assert (st[:inp["n_sats"], 7] > 0.5).all()


@pytest.mark.parametrize("wp,rows,k", [(8704, 13, 8), (33280, 9, 6),
                                       (1536, 21, 5)])
def test_staged_window_rows_hold_what_the_mix_reads(wp, rows, k):
    n0 = {8704: 8184, 33280: 32736, 1536: 1023}[wp]
    plan = fused.mxu_smem_plan(wp, rows, k)
    opts = [o for o in plan["options"] if o["staged"]]
    assert opts
    for opt in opts:
        for r, (l0, w) in enumerate(opt["parts"]):
            for start in (128 * 7, 128 * 7 + 1, 128 * 7 + 2, 128 * 7 + 3):
                for j in range(3):
                    for e in range(k):
                        samples, o, b1, bulk = chip_smoke.lane_row_samples(
                            start, j, e, l0, w, k_epochs=k, n0=n0, wp=wp)
                        g0 = start + (j * k * n0 // 128) * 128
                        ws = g0 + (e * n0 // 128) * 128
                        assert o == start % 4
                        # the row fits the kernel's pitch
                        widest = max(x for _, x in opt["parts"])
                        assert len(samples) <= widest + 260
                        # in the window or its 16-byte floor
                        assert samples.min() >= ws - o
                        assert samples.max() < ws + wp
                        # the bulk copies, one before the wrap (b1) and
                        # one after: 4-sample aligned in the row and in
                        # the stream, whole 16-byte groups
                        pos = np.arange(len(samples))
                        for side in (pos < b1, pos >= b1):
                            run = np.flatnonzero(bulk & side)
                            if not len(run):
                                continue
                            a, b = run[0], run[-1] + 1
                            assert len(run) == b - a
                            assert a % 4 == 0 and b % 4 == 0
                            assert samples[a] % 4 == 0
                            assert (np.diff(samples[a:b]) == 1).all()
                        assert (~bulk).sum() <= 7
                        # the mix: lane l reads m = l + shift wrapped at
                        # row position l + shift - l0 + o
                        kk = j * k * n0
                        shift = (e * n0 - (e * n0 // 128) * 128
                                 + kk - (kk // 128) * 128)
                        lanes = np.arange(l0, l0 + w)
                        mu = lanes + shift
                        m = np.where(mu >= wp, mu - wp, mu)
                        np.testing.assert_array_equal(
                            samples[mu - l0 + o], ws + m)
