"""The per-epoch kernels (B4a, B4b, B6 and B3 over csrc/epoch_core.cuh)
in lane clusters, on the CPU: past the widths one block holds, one channel
runs over a thread-block cluster of cs blocks, block r holding lane part
r's replica rows with the prompt roll's halo and staging its part of each
window (epoch::run_block_lanes). The CUDA kernel runs only on the card
(chip_smoke.py phases 24-25, tests/test_torch_cuda.py); here:

  * the plan (``epoch_smem_plan``): one block a channel at every 2.046
    MHz shape of chip_smoke.epoch_inputs and B3's, the lane clusters at
    Galileo E1B's 8.184 MHz widths (wp 33,152 and 33,280), each option's
    bytes within a block's 232,448, its parts covering [0, wp) once, and
    at 4 and 8 channels the size ``launch_order`` takes first, given the
    clusters the H100 reports it holds at once, with C x cs blocks within
    its 132 SMs;
  * the halo (``chip_smoke.epoch_part_rows`` / ``epoch_part_reads``, the
    kernel's stage_part_rows and mix_part): every prompt index a part's
    mix reads, for every roll the seg and direct feeds give and el up to
    16, is at its position in the block's rows, the wrap at rank 0 and at
    the last rank included, and the rows' bulk copies are 16-byte runs;
  * the window parts (``chip_smoke.epoch_stage_span`` with a part): the
    staged span of each part lies in [origin - 3, origin + wp), starts
    16-byte aligned and holds every sample the plain version reads there;
  * the sum order: the plain versions' ``lane_parts`` (each correlation
    summed per part, then the parts in rank order: a per-part order, not
    the kernel's, which adds within each warp, then across the ranks for
    each warp, then over the warps) against the plain versions at
    wp 33,152 (B4b, epoch by epoch) and 33,280 (B3, by pairs of
    supersteps, as chip_smoke holds the kernel) from a common state:
    the six correlations within 1e-4 of their column max,
    chip_smoke.compare's tolerances on the rest (state rtol 1e-4);
  * JAX parity at a width the JAX ``_epoch_core`` takes (GPS seg at 8.184
    MHz, wp 8,576, a cluster layout): the plain version with each
    option's parts against ``track_block_fused_seg`` in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from gnss_sdr_tpu.ops.pallas import track_block_fused as j_fused  # noqa: E402

from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

SMEM = 232_448
WIDE = (chip_smoke.WIDE_SEG_WP, chip_smoke.WIDE_DIRECT_WP)
N_DRIFT = 5
EL_SHIFTS = (1, 2, 4, 16)
CORR_RTOL = 1e-4            # of each correlation column's max
EXACT = [7, 12, 13, 15, 16]
# the lane clusters the H100 holds at once for the per-epoch kernels at
# Galileo E1B's wide shapes, one block an SM (cudaOccupancyMaxActiveClusters
# as chip_smoke.py phase 25 prints it), and the card's SMs
H100_ACTIVE = {16: 7, 8: 15, 4: 30, 2: 66}
H100_SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    test files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _covers_once(parts, wp):
    lanes = np.zeros(wp, np.int64)
    for l0, w in parts:
        assert l0 % 128 == 0 and w % 128 == 0 and w > 0
        lanes[l0:l0 + w] += 1
    return bool((lanes == 1).all())


@pytest.mark.parametrize("feed", ["windows", "seg", "resident", "direct"])
def test_plan_keeps_one_block_at_the_main_path(feed):
    if feed == "direct":
        _, args, kw = chip_smoke.full_width_inputs(
            torch, "cpu", {}, block_ms=20, layout="direct")
    else:
        inp = chip_smoke.epoch_inputs(torch, feed, {}, device="cpu",
                                      block_ms=15 if feed == "seg" else 20)
        args, kw = inp["args"], inp["kw"]
    wp, rows, el, _ = chip_smoke._epoch_shape(feed, args, kw)
    assert wp == {"windows": 2176, "seg": 2432, "resident": 4352,
                  "direct": 2560}[feed]
    plan = ep.epoch_smem_plan(wp, rows, el_shift=el)
    assert plan["layout"] == "single" and plan["cs"] == 0
    assert plan["bytes"] == ep.single_bytes(wp, rows) <= SMEM
    assert plan["parts"] == [(0, wp)] and not plan["options"]


def test_plan_takes_lane_clusters_past_one_block():
    # one block holds the rows and two slots to wp 5,760 at 5 rows
    assert ep.epoch_smem_plan(5760, N_DRIFT)["layout"] == "single"
    assert ep.epoch_smem_plan(5888, N_DRIFT)["layout"] == "cluster"
    for wp in WIDE:
        for el in EL_SHIFTS:
            plan = ep.epoch_smem_plan(wp, N_DRIFT, el_shift=el)
            assert plan["layout"] == "cluster"
            assert [o["cs"] for o in plan["options"]] == [16, 8]
            assert plan["cs"] == plan["options"][0]["cs"]
            for opt in plan["options"]:
                assert opt["bytes"] <= SMEM
                assert opt["bytes"] == ep.epoch_cluster_bytes(
                    wp, N_DRIFT, opt["cs"], el)
                assert len(opt["parts"]) == opt["cs"]
                assert opt["parts"] == fused.lane_parts(wp, opt["cs"])
                assert _covers_once(opt["parts"], wp)
                assert opt["halo"] == ep.lane_halo(el)
            # the wrapper's first size: the largest of which the card
            # holds C clusters at once (16 at the mixed row's 4 channels,
            # 8 at the preset's 8 and at 9), its C x cs blocks on the SMs
            for c, want in ((4, 16), (8, 8), (9, 8)):
                first = ep.launch_order(
                    plan["options"], c, lambda o: H100_ACTIVE[o["cs"]])[0]
                assert first["cs"] == want
                assert c * first["cs"] <= H100_SMS
    # every width up to MAX_WP takes a layout, 8 rows included
    for wp in range(128, ep.MAX_WP + 1, 128):
        for rows in (5, 8):
            plan = ep.epoch_smem_plan(wp, rows, el_shift=16)
            assert plan["bytes"] <= SMEM and _covers_once(
                plan["parts"], wp)


def _feed_rolls(n0, t_epochs, k_epochs):
    """The prompt rolls of the seg feed (t*n0 mod 128) and the direct feed
    (rem_e + rem_j of superstep j, epoch e) over a block."""
    seg = {t * n0 % 128 for t in range(t_epochs)}
    direct = {e * n0 % 128 + (j * k_epochs * n0) % 128
              for j in range(t_epochs // k_epochs) for e in range(k_epochs)}
    return seg | direct


@pytest.mark.parametrize("wp", WIDE + (8576,))
def test_halo_holds_every_prompt_index_the_mix_reads(wp):
    rolls = _feed_rolls(32736, 24, 12) | _feed_rolls(8184, 25, 5) \
        | {0, 1, 127, 128, 254, 255}
    assert max(rolls) <= 255
    for el in EL_SHIFTS:
        plan = ep.epoch_smem_plan(wp, N_DRIFT, el_shift=el)
        for opt in plan["options"]:
            for rank, (a, w) in enumerate(opt["parts"]):
                idx, runs = chip_smoke.epoch_part_rows(a, w, wp, el)
                before, after = ep.lane_halo(el)
                assert len(idx) == before + w + after <= wp
                # the bulk copies: 16-byte runs of the row, in order;
                # two where the range wraps (rank 0's tail first, the
                # last rank's head last)
                assert np.array_equal(np.concatenate(
                    [np.arange(s0, s0 + n) for s0, n in runs]), idx)
                assert all(s0 % 4 == 0 and n % 4 == 0 and n > 0
                           for s0, n in runs)
                wraps = rank in (0, opt["cs"] - 1)
                assert len(runs) == (2 if wraps else 1), (rank, runs)
                lanes = np.arange(a, a + w)
                for rem in rolls:
                    got = chip_smoke.epoch_part_reads(lanes, a, rem, el)
                    want = chip_smoke.epoch_rolled_lanes(lanes, rem, el, wp)
                    for pos, ref in zip(got, want):
                        assert pos.min() >= 0 and pos.max() < len(idx)
                        np.testing.assert_array_equal(idx[pos], ref)


@pytest.mark.parametrize("feed", ["seg", "direct"])
@pytest.mark.parametrize("residue", range(4))
def test_window_parts_hold_what_the_mix_reads(feed, residue):
    """Each part's staged span of every epoch's window, at each residue
    of the origin mod 4 (seg row 3 of segments widened by ``residue``
    columns: 3 * residue mod 4; B3's start), against the window the plain
    version reads (flat sample indices)."""
    wp = chip_smoke.WIDE_SEG_WP if feed == "seg" else \
        chip_smoke.WIDE_DIRECT_WP
    n0, k, t_all = (32736, 12, 24)
    want = residue
    if feed == "seg":
        t_all = 5
        l_seg = ep.seg_length(t_all, n0, wp) + residue
        row = 3
        want = row * residue % 4
        stream = np.arange((row + 1) * l_seg)
    else:
        start = 128 * 7 + residue
        stream = np.arange(start + fused.direct_span(k, n0, wp) + t_all * n0)
    for opt in ep.epoch_smem_plan(wp, N_DRIFT)["options"]:
        for t in range(t_all):
            if feed == "seg":
                origin = chip_smoke.epoch_window_origin(
                    "seg", t, n0=n0, wp=wp, c=row, l_seg=l_seg)
                a_t = (t * n0 // 128) * 128
                window = stream[row * l_seg + a_t:row * l_seg + a_t + wp]
            else:
                origin = chip_smoke.epoch_window_origin(
                    "direct", t, n0=n0, wp=wp, start=start, k_epochs=k)
                j, e = divmod(t, k)
                pos = (start + (j * k * n0 // 128) * 128
                       + (e * n0 // 128) * 128)
                window = stream[pos:pos + wp]
            assert origin % 4 == want
            for a, w in opt["parts"]:
                first, length, off = chip_smoke.epoch_stage_span(
                    origin, wp, (a, w))
                assert first % 4 == 0 and off == want
                assert origin - 3 <= first and first + length <= origin + wp
                span = stream[first:first + length]
                assert len(span) == length == w + off
                np.testing.assert_array_equal(span[off:off + w],
                                              window[a:a + w])
    # one block a channel: the whole window, as before
    assert chip_smoke.epoch_stage_span(9, 2432) == (8, 2433, 1)


def _piece(kind, args, kw, st, t, parts):
    """The plain version of ``kind`` from ``st``: B4b's epoch t, B3's
    pair of supersteps from epoch t (its plain version's piece)."""
    if kind == "seg":
        return fused.track_block_fused_seg_reference(
            *args[:3], st, **dict(kw, t_epochs=1, first_epoch=t),
            lane_parts=parts)
    k = kw["k_epochs"]
    return fused.track_block_fused_direct_reference(
        *args[:4], st, **dict(kw, t_epochs=2 * k, first_superstep=t // k),
        lane_parts=parts)


@pytest.mark.parametrize("kind", ["seg", "direct"])
def test_rank_order_sums_match_the_plain_version(kind):
    inp = chip_smoke.epoch_wide_inputs(torch, kind, {}, 4, device="cpu")
    args, kw = inp["args"], inp["kw"]
    wp, rows, el, st = chip_smoke._epoch_shape(kind, args, kw)
    assert wp == (chip_smoke.WIDE_SEG_WP if kind == "seg"
                  else chip_smoke.WIDE_DIRECT_WP)
    plan = ep.epoch_smem_plan(wp, rows, el_shift=el)
    step = 1 if kind == "seg" else 2 * kw["k_epochs"]
    for t in range(0, kw["t_epochs"], step):
        tr, sr = _piece(kind, args, kw, st, t, None)
        for opt in plan["options"]:
            tp, sp = _piece(kind, args, kw, st, t, opt["parts"])
            chip_smoke.compare(tp, sp, tr, sr)
            for col in chip_smoke.CORR_COLS:
                scale = max(float(tr[..., col].abs().max()), 1e-30)
                assert float((tp[..., col] - tr[..., col]).abs().max()) \
                    <= CORR_RTOL * scale, (t, opt["cs"], col)
        st = sr
    assert (st[:inp["n_sats"], 7] > 0.5).all()


def test_parted_plain_matches_pallas_seg_interpret():
    """GPS L1 C/A on seg at 8.184 MHz (5 epochs, 2 channels): wp 8,576,
    where the JAX _epoch_core still works (<= 16,384) and the port runs
    lane clusters; the plain version with each option's parts against the
    Pallas seg kernel in interpret mode, with the tolerances of
    tests/test_torch_epoch_kernels.py."""
    inp = chip_smoke.wide_inputs(torch, "cpu", "gps_l1ca", {}, layout="seg",
                                 block_ms=5, n_channels=2)
    ft, (seg_re, seg_im, reps, mat), kw = inp["ft"], inp["args"], inp["kw"]
    assert (ft.layout, ft.wp, ft.t_epochs) == ("seg", 8576, 5)
    plan = ep.epoch_smem_plan(ft.wp, reps.shape[1],
                              el_shift=kw["el_shift"])
    assert plan["layout"] == "cluster" and plan["options"]
    jkw = dict(kw)
    tj, sj = j_fused.track_block_fused_seg(
        *(jnp.asarray(x.numpy()) for x in (seg_re, seg_im, reps, mat)),
        interpret=True, **jkw)
    tj = np.asarray(tj)[:, :, :ep.N_TELEM]
    sj = np.asarray(sj)
    for opt in plan["options"]:
        tt, st = fused.track_block_fused_seg_reference(
            seg_re, seg_im, reps, mat, lane_parts=opt["parts"], **kw)
        tt, st = tt.numpy(), st.numpy()
        for k in EXACT:
            np.testing.assert_array_equal(tt[..., k], tj[..., k],
                                          err_msg=str(k))
        for k in range(ep.N_TELEM):
            np.testing.assert_allclose(
                tt[..., k], tj[..., k], rtol=2e-5,
                atol=2e-4 * max(1.0, float(np.abs(tj[..., k]).max())),
                err_msg=f"telemetry col {k}, cs {opt['cs']}")
        np.testing.assert_array_equal(st[:, [4, 6, 7, 8]],
                                      sj[:, [4, 6, 7, 8]])
        np.testing.assert_allclose(st[:, :12], sj[:, :12], rtol=1e-4,
                                   atol=1e-3)
        assert tt[:, :inp["n_sats"], 7].mean() > 0.9
