"""Slice 10's wide windows on the CPU (ROADMAP C15 and C6): every system
of ladder 4 at 8.184 MHz.

  * B1's plain version at Galileo E1B's wp 33,280 (R 9, K 6, 2 channels,
    one pair of supersteps) against the JAX mxu kernel in interpret mode,
    with the tolerances of tests/test_mxu_kernel.py:91-111 as
    chip_smoke.compare states them: flags and integers exact, the bf16
    columns within 1e-3 of their column max, rates rtol 1e-4 above a 1
    mHz floor, state rtol 1e-4;
  * the per-epoch plain version (B4b's, which B3, B4a and B6 share) at wp
    16,768 (Galileo at 4.092 MHz) and 33,152 (8.184 MHz), past the JAX
    _epoch_core's 128 carrier A factors, epoch by epoch against a float64
    numpy oracle that computes each lane's carrier phase directly: the
    six correlations within 1e-4 of their column max (f32 trig factors
    and sums against float64);
  * the kernels' shared-memory plans (``mxu_smem_plan`` and
    ``epoch_smem_plan``, which the launchers run as given): every
    ladder-4 shape fits in the 232,448 bytes a block may have, B1's lane chunks cover [0, wp) exactly once, more than 16
    bank rows take lane chunks even where one chunk covers wp, and the
    widths above each plan raise naming C15 / C6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from gnss_sdr_tpu.ops.pallas import track_block_fused as j_fused  # noqa: E402

from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep  # noqa: E402
from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

ORACLE_RTOL = 1e-4          # of each correlation column's max


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch intra-op thread while this module runs (the suite runs
    files in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_b1_plain_matches_pallas_interpret_at_e1b_width():
    inp = chip_smoke.wide_inputs(torch, "cpu", "galileo_e1b", {},
                                 block_ms=48, n_channels=2)
    ft, args, kw = inp["ft"], inp["args"], inp["kw"]
    assert (ft.wp, ft.n_rows, kw["k_epochs"], kw["t_epochs"]) == (
        33280, 9, 6, 12)
    sre, sim, starts, reps, mat = args
    jkw = {k: v for k, v in kw.items()
           if k not in ("telem_mode", "starts_host", "starts_bound",
                        "spread_cap")}
    tj, sj = j_fused.track_block_fused_mxu(
        jnp.asarray(sre.numpy()), jnp.asarray(sim.numpy()),
        jnp.asarray(starts.numpy()),
        jnp.asarray(reps.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(mat.numpy()), interpret=True, **jkw)
    tt, st = fused.track_block_fused_mxu(*args, **kw)
    margins = chip_smoke.compare(
        tt, st, np.asarray(tj)[:, :, :fused.N_TELEM], np.asarray(sj))
    assert margins["bf16_cols"] < 1e-3
    assert tt.numpy()[:, :, 7].mean() > 0.95       # both channels locked
    assert (st.numpy()[:, 7] > 0.5).all()


def _oracle_epoch(seg_re, seg_im, reps, st, *, t, n0, wp, fs, code_len,
                  el_shift):
    """Epoch t of the seg feed for every channel in float64: the window at
    lane T128 = floor(t*n0/128)*128 of each segment, the mask [start_lane,
    start_lane + n_t), each lane's carrier phase carr_phase + (l -
    start_lane) * step taken directly, the prompt row selected by the
    drift, rolled right by rem, early and late its +- el_shift rolls.
    Returns [C, 6] (i_e, q_e, i_p, q_p, i_l, q_l)."""
    st = st.astype(np.float64)
    n_drift = reps.shape[1]
    half = (n_drift - 1) // 2
    t128 = (t * n0 // 128) * 128
    rem = t * n0 - t128
    out = np.zeros((st.shape[0], 6))
    lane = np.arange(wp, dtype=np.float64)
    for c in range(st.shape[0]):
        carr_freq, carr_phase, code_rate = st[c, 0], st[c, 1], st[c, 3]
        chip_res, drift, frac0 = st[c, 4], st[c, 8], st[c, 10]
        # the rounding the kernel's integer bookkeeping needs, in f32
        f = np.float32
        dc = f(code_rate) * (f(1.0) / f(fs))
        n_t = float(np.round(f(fs) * f(code_len) / f(code_rate)))
        start_lane = float(f(f(st[c, 9]) + f(drift)) + f(rem))
        mask = (lane >= start_lane) & (lane < start_lane + n_t)
        theta = 2 * np.pi * (carr_phase + (lane - start_lane)
                             * (carr_freq / fs))
        x = (seg_re[c, t128:t128 + wp].astype(np.float64)
             + 1j * seg_im[c, t128:t128 + wp].astype(np.float64))
        mixed = x * np.exp(-1j * theta) * mask
        q = float(f(f(chip_res) + f(frac0)) / dc)
        shift = drift - np.floor(q)
        row = [d for d in range(n_drift) if shift == d - half]
        prompt = (reps[c, row[0]].astype(np.float64) if row
                  else np.zeros(wp))
        prompt = np.roll(prompt, rem)
        for k, ref in enumerate((np.roll(prompt, -el_shift), prompt,
                                 np.roll(prompt, el_shift))):
            v = np.sum(mixed * ref)
            out[c, 2 * k], out[c, 2 * k + 1] = v.real, v.imag
    return out


@pytest.mark.parametrize("fs,wp", [(4_092_000.0, 16768),
                                   (8_184_000.0, 33152)],
                         ids=["wp16768", "wp33152"])
def test_epoch_plain_matches_float64_oracle_past_128_a_factors(fs, wp):
    inp = chip_smoke.wide_inputs(torch, "cpu", "galileo_e1b", {},
                                 layout="seg", block_ms=20, fs=fs,
                                 n_channels=2)
    ft, (seg_re, seg_im, reps, st), kw = inp["ft"], inp["args"], inp["kw"]
    assert (ft.layout, ft.wp, ft.t_epochs) == ("seg", wp, 5)
    assert wp // 128 > 128          # the JAX _epoch_core's iota ends there
    for t in range(ft.t_epochs):
        tel, st_next = fused.track_block_fused_seg_reference(
            seg_re, seg_im, reps, st, **dict(kw, t_epochs=1, first_epoch=t))
        want = _oracle_epoch(seg_re.numpy(), seg_im.numpy(), reps.numpy(),
                             st.numpy(), t=t, n0=kw["n0"], wp=wp, fs=fs,
                             code_len=kw["code_len"],
                             el_shift=kw["el_shift"])
        got = tel[0, :, :6].double().numpy()
        scale = np.abs(want).max(axis=0)
        assert (np.abs(got - want) <= ORACLE_RTOL * scale).all(), (
            t, np.abs(got - want).max(axis=0) / scale)
        st = st_next
    assert (st.numpy()[:inp["n_sats"], 7] > 0.5).all()


# B1's shapes on ladder 4's paths: the mixed row's 96 ms blocks (power
# lock; Costas caps K at 2) and the presets' 20 ms blocks (K 5)
LADDER4_MXU = sorted({
    (wp, rows, k)
    for wp, rows, k96 in chip_smoke.WIDE_MXU_SHAPES.values()
    for k in (k96, 2, 5)})


@pytest.mark.parametrize("wp,rows,k", LADDER4_MXU)
def test_mxu_plan_fits_and_chunks_cover_the_window(wp, rows, k):
    # the lane clusters: every size the plan offers fits, its lane parts
    # (whole 128-lane groups, one per block) cover [0, wp) once
    plan = fused.mxu_smem_plan(wp, rows, k)
    assert plan["layout"] == "cluster"
    for opt in plan["options"]:
        assert opt["bytes"] + fused.MXU_LANES_STATIC_SMEM <= 232_448
        assert len(opt["parts"]) == opt["cs"]
        lanes = np.zeros(wp, np.int64)
        for l0, width in opt["parts"]:
            assert l0 % 128 == 0 and width % 128 == 0 and width > 0
            assert width <= opt["sub"] or not opt["resident"]
            lanes[l0:l0 + width] += 1
        assert (lanes == 1).all()          # [0, wp) once
    assert wp <= plan["max_wp"]


def test_mxu_plan_keeps_the_main_path_whole_and_raises_past_its_width():
    # the 2.046 MHz main path (and 4.092 MHz GPS) keep the whole-width
    # layout, whose time must not move
    for wp, rows, k in ((2560, 8, 5), (4608, 9, 5), (2560, 8, 2)):
        assert fused.mxu_smem_plan(wp, rows, k)["layout"] == "whole"
    widest = fused.mxu_smem_plan(33280, 9, 6)["max_wp"]
    assert fused.mxu_smem_plan(widest, 9, 6)["layout"] == "cluster"
    with pytest.raises(ValueError, match="C15"):
        fused.mxu_smem_plan(widest + 128, 9, 6)


@pytest.mark.parametrize("wp,rows,k", [(1536, 21, 5), (1536, 21, 2),
                                       (2048, 17, 5)])
def test_mxu_plan_chunks_rows_above_16_even_where_one_chunk_covers(
        wp, rows, k):
    # the whole-width kernel holds 16 bank rows: above that the plan is
    # the lane clusters even where the whole window would fit (GLONASS
    # at 1.023 MHz with 4-chip early-late spacing: wp 1536, R 21), which
    # the launcher runs as given: each part's bank resident, its window
    # rows staged
    plan = fused.mxu_smem_plan(wp, rows, k)
    assert plan["layout"] == "cluster"
    assert plan["resident"] and plan["staged"]
    assert sum(w for _, w in plan["parts"]) == wp
    assert plan["bytes"] + fused.MXU_LANES_STATIC_SMEM <= 232_448


@pytest.mark.parametrize("wp", [16768, 16896, 33152, 33280, ep.MAX_WP])
def test_epoch_plan_fits_past_one_slot(wp):
    plan = ep.epoch_smem_plan(wp, 5)
    assert plan["bytes"] <= 232_448
    # past one block's replica rows and two window slots: one channel
    # over a thread-block cluster, each size the plan offers fitting
    assert plan["layout"] == "cluster" and plan["options"]
    for opt in plan["options"]:
        assert opt["bytes"] <= 232_448
        assert sum(w for _, w in opt["parts"]) == wp


def test_epoch_plan_keeps_the_main_path_and_raises_past_max_wp():
    assert ep.epoch_smem_plan(2432, 5) == {
        "layout": "single", "cs": 0, "parts": [(0, 2432)], "halo": (0, 0),
        "bytes": 4 * (4 + 5 * 2432 + 4 * 2436 + 2432 + 256 + 38 + 48),
        "options": []}
    with pytest.raises(ValueError, match="C6"):
        ep.epoch_smem_plan(ep.MAX_WP + 128, 5)
