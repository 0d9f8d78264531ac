"""Tests of the PyTorch port that need an NVIDIA GPU and nvcc: the CUDA
kernel against its plain PyTorch version on the card, and the receiver
through the kernel. They skip where there is no card. This file imports
no JAX, so on a machine without it run:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused  # noqa: E402

VARIANTS = {
    "power": {},
    "costas": dict(lock_mode="costas"),
    "interp": dict(interp_code=True),
    "carrier_aiding": dict(carrier_aiding=True),
    "forced_death": dict(lock_threshold=1e12, max_lost_epochs=7),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel_matches_plain_on_card(card, variant):
    """32 channels (24 tracking, 8 idle), 20 ms blocks: the kernel and
    its plain version agree within the CPU kernel test's tolerances,
    held open loop (each pair of supersteps from the kernel's state);
    the plain version never counts a launch."""
    ft, args, kw = chip_smoke.full_width_inputs(torch, card,
                                                VARIANTS[variant],
                                                block_ms=20)
    before = fused.launch_count
    tk, sk, _ = chip_smoke.open_loop_compare(torch, args, kw)
    assert fused.launch_count == before + 20 // (2 * kw["k_epochs"])
    active = sk[:, 7].cpu().numpy()
    if variant == "forced_death":
        assert not active.any()
    else:
        assert active[:24].all() and not active[24:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("fs,cfg_kw,rows", [
    (2_046_000.0, dict(early_late_chips=1.0), 9),
    (2_046_000.0, dict(early_late_chips=2.0), 13),
    (4_092_000.0, {}, 9)], ids=["el1", "el2", "4mhz"])
def test_kernel_wide_geometry_matches_plain_on_card(card, monkeypatch, fs,
                                                    cfg_kw, rows):
    """A replica bank of more than 8 rows (the contraction's second
    n-tile, its rows past R padded) and windows too wide to stage in
    shared memory beside the bank and the tile (B2's slice at 13 rows;
    4.092 MHz, wp 4608, for B1 and B2: the mix reads global memory):
    B1 against the plain version open loop, B2 equal to B1 bit for bit
    on the tracker's own inputs."""
    monkeypatch.setattr(chip_smoke, "FS", fs)
    ft, args, kw = chip_smoke.full_width_inputs(torch, card, cfg_kw,
                                                block_ms=20)
    assert ft.n_rows == rows
    chip_smoke.open_loop_compare(torch, args, kw)
    _, s_args, s_kw = chip_smoke.full_width_inputs(
        torch, card, cfg_kw, block_ms=20, shared_fetch=True)
    assert chip_smoke.b2_equals_b1(torch, s_args, s_kw) == (1, 1)


@pytest.mark.cuda
def test_kernel_at_alignment_edges_on_card(card):
    """32 channels, 20 ms blocks, the windows' starts moved to each
    residue mod 4 and the stream cut where the highest start's last
    window ends (chip_smoke.edge_case): the window copy's unaligned head
    and its plain-load tail; against the plain version open loop, and
    equal bit for bit to the run on the unmoved stream."""
    _, args, kw = chip_smoke.full_width_inputs(torch, card, {}, block_ms=20)
    chip_smoke.edge_check(torch, args, kw)


@pytest.mark.cuda
def test_bad_launch_arguments_raise_on_card(card):
    ft, args, kw = chip_smoke.full_width_inputs(torch, card, {}, block_ms=20)
    far = torch.full_like(args[2], args[0].shape[0] - 100)
    with pytest.raises(ValueError, match="out of bounds"):
        fused.track_block_fused_mxu(*args, **dict(
            kw, starts_host=far.cpu().numpy()))
    with pytest.raises(ValueError, match="starts_host"):
        fused.track_block_fused_mxu(*args, **dict(kw, starts_host=None))
    with pytest.raises(ValueError, match="state_in"):
        fused.track_block_fused_mxu(*args[:4], args[4].cpu(), **kw)


@pytest.mark.cuda
def test_receiver_runs_through_kernel(card):
    """1.5 s of the 24-satellite scene at 500 ms blocks: every PRN
    tracked within 40 Hz, one launch per block."""
    assert chip_smoke.phase_receiver(torch, device="cuda", n_blocks=3) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_direct_kernel_matches_plain_on_card(card, variant):
    """Kernel B3 against its plain version, 32 channels, 20 ms blocks
    (K=10), open loop, within the CPU kernel test's tolerances."""
    ft, args, kw = chip_smoke.full_width_inputs(
        torch, card, VARIANTS[variant], block_ms=20, layout="direct")
    before = fused.direct_launch_count
    tk, sk, _ = chip_smoke.open_loop_compare(torch, args, kw,
                                             layout="direct")
    assert fused.direct_launch_count == before + 20 // (2 * kw["k_epochs"])
    active = sk[:, 7].cpu().numpy()
    if variant == "forced_death":
        assert not active.any()
    else:
        assert active[:24].all() and not active[24:].any()


@pytest.mark.cuda
def test_lean_mode_matches_full_on_card(card):
    """B1's lean telemetry: the stored columns and the end state equal
    the full mode's bit for bit, the rest zero (full width)."""
    chip_smoke.phase_lean_check(torch)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,pipelined", [("auto", True),
                                              ("direct", False)])
def test_steady_receiver_on_card(card, layout, pipelined):
    """3 s of the 24-satellite scene: single blocks until the search
    scheduler turns steady (during block 1), then one 4-block span; every
    PRN tracked within 40 Hz, one launch per block; then two chained
    spans queued with the sync debug mode at "error"."""
    sats, sig = chip_smoke._scene(3.0)
    rx, summary, launches = chip_smoke._run_receiver(
        torch, sats, sig, "test", layout=layout, scan_blocks=4,
        span_pipeline=pipelined)
    name = ("track_block_fused_mxu" if rx.fused.layout == "mxu"
            else "track_block_fused_direct")
    assert launches[name] == 6 and sum(launches.values()) == 6
    assert summary["stage_timing"]["track"]["calls"] < 6
    chip_smoke._submit_without_sync(torch, rx, sig, n_span=2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(chip_smoke.B5_CASES))
def test_b5_matches_plain_on_card(card, case):
    """Kernel B5 against its plain version (the port's shift correlator)
    at full width, idle and partial masks: each sum within 1e-4 of its
    column's max; one launch counted per call, none for the plain."""
    from gnss_sdr_tpu_torch.ops import correlator as corr
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    signal, fs, interp = chip_smoke.B5_CASES[case]
    for idle in (8, 0):
        (args,), st = chip_smoke.b5_inputs(torch, signal, fs, idle=idle)
        kw = dict(shift=st["shift"], oversample=st["oversample"],
                  interp=interp)
        before = b5.launch_count
        got = b5.epl_correlate_pallas(*args, **kw)
        ref = corr.epl_correlate_one_shift(*args, **kw)
        torch.cuda.synchronize()
        assert b5.launch_count == before + 1
        for a, b in zip(got, ref):
            assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_b5_bad_arguments_raise_on_card(card):
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    (args,), st = chip_smoke.b5_inputs(torch, "gps_l1ca", chip_smoke.FS)
    kw = dict(shift=st["shift"])
    with pytest.raises(ValueError, match="codes"):
        b5.epl_correlate_pallas(*args[:8], args[8].cpu(), **kw)
    with pytest.raises(TypeError, match="carr_acc"):
        b5.epl_correlate_pallas(*args[:3], args[3].to(torch.int32),
                                *args[4:], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(chip_smoke.B5_CASES))
def test_b5_block_entry_equals_windows_entry_on_card(card, case):
    """The block-reading entry (windows at each channel's start in a
    shuffled block) equal to the [C, W] entry bit for bit, idle and
    partial masks; one launch counted per call."""
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    signal, fs, interp = chip_smoke.B5_CASES[case]
    for idle in (8, 0):
        (args,), st = chip_smoke.b5_inputs(torch, signal, fs, idle=idle)
        kw = dict(shift=st["shift"], oversample=st["oversample"],
                  interp=interp)
        block_re, block_im, starts, max_start = chip_smoke.b5_block_form(
            torch, args, seed=idle)
        before = b5.launch_count
        got = b5.epl_correlate_block(block_re, block_im, starts, *args[2:],
                                     window=st["window"], **kw)
        ref = b5.epl_correlate_pallas(*args, **kw)
        torch.cuda.synchronize()
        assert b5.launch_count == before + 2
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_b5_window_past_block_raises_on_card(card):
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    (args,), st = chip_smoke.b5_inputs(torch, "gps_l1ca", chip_smoke.FS)
    block_re, block_im, starts, max_start = chip_smoke.b5_block_form(
        torch, args)
    kw = dict(window=st["window"], shift=st["shift"])
    before = b5.launch_count
    past = starts.clone()
    past[3] = max_start + 1
    with pytest.raises(ValueError, match="out of bounds"):
        b5.epl_correlate_block(block_re, block_im, past, *args[2:], **kw)
    past[3] = -1
    with pytest.raises(ValueError, match="out of bounds"):
        b5.epl_correlate_block(block_re, block_im, past, *args[2:], **kw)
    with pytest.raises(ValueError, match="out of bounds"):
        b5.epl_correlate_block(block_re, block_im, starts, *args[2:],
                               max_start=max_start + 1, **kw)
    assert b5.launch_count == before


@pytest.mark.cuda
@pytest.mark.parametrize("correlator", ["shift", "pallas"])
def test_scan_graph_equals_eager_on_card(card, correlator):
    """The scanned tracker's CUDA graph against its eager launch, bit for
    bit in the [13, C] state and the 17 telemetry fields, over 3 blocks
    and a 200 ms tail block on the same graph; the calls after the
    warm-up and the capture run with the sync debug mode at "error";
    B7's launches counted from the replays, one a block."""
    sats, sig = chip_smoke._scene(2.5)
    assert chip_smoke.scan_graph_vs_eager(torch, correlator, sats,
                                          sig) == 4


@pytest.mark.cuda
def test_scan_receiver_on_card(card):
    """1.5 s of the 24-satellite scene through the scanned tracker with
    correlator="pallas" (on its CUDA graph): every PRN tracked within 40
    Hz, B7 launched once a block (counted from the replays), no other
    kernel."""
    sats, sig = chip_smoke._scene(1.5)
    rx, summary, launches = chip_smoke._run_receiver(
        torch, sats, sig, "test", correlator="pallas")
    chip_smoke._expect_launches(launches, track_block_scan=3)


# kernel B7: the scanned tracker's block of epochs in one launch, held to
# its plain version (the op loop, run_epoch_ops) on the same card. The
# sums run in another order than the op loop's, so they are held within
# chip_smoke.SCAN_SUM_TOL of their column's max and the discriminators of
# processed channels within SCAN_DISC_TOL; the integer ledger, the flags,
# the starts and the epoch counts come before the sums and are exact.

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(chip_smoke.SCAN_CASES))
def test_b7_matches_op_loop_open_loop_on_card(card, case):
    """Every epoch of one block run by B7 and by the op loop with
    n_epochs=1 from the op loop's ledger (chip_smoke.scan_compare), and
    B7's one launch of the block's epochs equal bit for bit to its own
    chained one-epoch launches (chip_smoke.scan_chain_check: the
    prefetch, the second window slot and the parity slot); B7 counted
    once a launch, the op loop never."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_scan as b7

    _, c, block_ms, _ = chip_smoke.SCAN_CASES[case]
    before = b7.launch_count
    worst, processed = chip_smoke.scan_open_loop(torch, case)
    assert b7.launch_count == before + 2 * (block_ms + 1) + 1
    assert processed > 0
    print(case, worst)


@pytest.mark.cuda
def test_b7_tail_block_open_loop_on_card(card):
    """A stream's last block, two thirds valid: B7 against the op loop
    open loop, the processing stopping where the valid samples do."""
    worst, processed = chip_smoke.scan_open_loop(torch, "shift", tail=True)
    assert 0 < processed < 12 * 101


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(chip_smoke.SCAN_CASES))
def test_b7_closed_loop_on_card(card, case):
    """B7 on its CUDA graph and the op loop over 12 blocks (100 ms, and
    500 ms at the main path's 32 channels), each from its own ledger:
    flags, starts and epoch counts equal, the carrier within the
    benchmark's loop_gap_hz limit (10 Hz) of the op loop on the card; at
    32 channels and 500 ms the op loop runs on the CPU too, and each
    channel is held to the nearer of the two
    (chip_smoke.SCAN_CLOSED_ON_CPU: over 501 epochs the plain versions
    part themselves where a negative Doppler's carrier step, in grains
    of 256 counts, falls on either side of a grain's edge)."""
    gap = chip_smoke.scan_closed_loop(torch, case)
    assert gap["carr_freq_hz_held"] <= chip_smoke.SCAN_LOOP_GAP_HZ
    if case not in chip_smoke.SCAN_CLOSED_ON_CPU:
        assert gap["carr_freq_hz"] <= chip_smoke.SCAN_LOOP_GAP_HZ
    if case == "death":
        assert gap["lost_events"] == 12


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["shift", "c32_500ms", "gps_8184k"])
def test_b7_graph_equals_eager_launch_on_card(card, case):
    """B7 through track_block_device: each replay equal to its eager
    launch bit for bit, two eager launches equal, one launch a replay,
    a tail block on the same graph key (chip_smoke.scan_graph_check)."""
    assert chip_smoke.scan_graph_check(torch, case) == 4


@pytest.mark.cuda
def test_b7_bad_arguments_raise_on_card(card):
    """The wrapper's checks on the card: inputs on two devices, a ledger
    for another C, and the exact correlator, which B7 does not compute."""
    import dataclasses

    from gnss_sdr_tpu_torch.ops.cuda import track_block_scan as b7
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    params, codes, st, sig, block, t = chip_smoke.scan_scene("c1")
    re, im = chip_smoke.scan_block(torch, sig, 0, block)
    codes = torch.from_numpy(codes).cuda()
    ins = torch.from_numpy(trk._pack_inputs(st, re.shape[0])).cuda()
    before = b7.launch_count
    with pytest.raises(ValueError, match="ins is on"):
        b7.track_block_scan(params, codes, ins.cpu(), re, im, t)
    with pytest.raises(ValueError, match="13"):
        b7.track_block_scan(params, codes, ins[1:].contiguous(), re, im, t)
    with pytest.raises(ValueError, match="correlator"):
        b7.track_block_scan(dataclasses.replace(params, correlator="exact"),
                            codes, ins, re, im, t)
    assert b7.launch_count == before


# the per-epoch layouts: B4a (windows), B4b (seg) with B4c, B6 (resident)

@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("feed", ["windows", "seg", "resident"])
def test_epoch_kernel_matches_plain_on_card(card, feed, variant):
    """B4a and B6 at 20 ms blocks, B4b at 15 (an odd epoch count), 32
    channels: each kernel against its plain version open loop (pieces of
    10 epochs, seg 5, from the kernel's state) within the CPU kernel
    tests' tolerances; B6 also against B4a, kernel to kernel."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    inp = chip_smoke.epoch_inputs(torch, feed, VARIANTS[variant],
                                  device=card,
                                  block_ms=15 if feed == "seg" else 20)
    count = {"windows": "windows_launch_count", "seg": "seg_launch_count",
             "resident": "resident_launch_count"}[feed]
    before = getattr(ep, count)
    tk, sk, _ = chip_smoke.epoch_open_loop(
        torch, feed, inp["args"], inp["kw"], piece=5 if feed == "seg" else 10)
    torch.cuda.synchronize()
    assert getattr(ep, count) > before
    active = sk[:, 7].cpu().numpy()
    if variant == "forced_death":
        assert not active.any()
    else:
        assert active[:24].all() and not active[24:].any()
    if feed == "resident":
        chip_smoke.resident_vs_windows(torch, inp, piece=10)


@pytest.mark.cuda
def test_gather_segments_matches_plain_on_card(card):
    """B4c bit for bit against its plain version, on an aligned stream
    (16-byte copies) and on one 4 bytes off (4-byte copies); one launch
    counted per call, none for the plain."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    inp = chip_smoke.epoch_inputs(torch, "seg", {}, device=card, block_ms=15)
    (sre, sim, starts, l_seg), g_kw = inp["gather"]
    for shift in (0, 1):
        re, im = sre[shift:], sim[shift:]
        before = ep.gather_launch_count
        got = fused.gather_segments(re, im, starts, l_seg, **g_kw)
        ref = fused.gather_segments_reference(re, im, starts, l_seg, **g_kw)
        torch.cuda.synchronize()
        assert ep.gather_launch_count == before + 1
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
def test_epoch_read_bounds_raise_on_card(card):
    """A launch past its read bound raises before it launches."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    seg = chip_smoke.epoch_inputs(torch, "seg", {}, device=card, block_ms=15)
    (sre, sim, starts, l_seg), g_kw = seg["gather"]
    res = chip_smoke.epoch_inputs(torch, "resident", {}, device=card,
                                  block_ms=20)
    before = chip_smoke._launch_counts()
    far = g_kw["starts_host"].copy()
    far[0] = (sre.shape[0] - l_seg + 128) // 128 * 128
    with pytest.raises(ValueError, match="out of bounds"):
        fused.gather_segments(sre, sim, starts, l_seg, starts_host=far)
    with pytest.raises(ValueError, match="starts_host|host copy"):
        fused.gather_segments(sre, sim, starts, l_seg)
    with pytest.raises(ValueError, match="out of bounds"):
        fused.track_block_fused_seg(*seg["args"], **dict(
            seg["kw"], t_epochs=seg["kw"]["t_epochs"] + 2))
    with pytest.raises(ValueError, match="out of bounds"):
        fused.track_block_fused_resident(*res["args"], **dict(
            res["kw"], t_epochs=res["kw"]["t_epochs"] + 20))
    assert chip_smoke._launch_counts() == before
    assert ep.MAX_WP == 49152


@pytest.mark.cuda
def test_epoch_kernel_widest_window_on_card(card):
    """B4b at the widest window the port takes (wp = MAX_WP = 49,152,
    ROADMAP C6: past the JAX kernel's 128 carrier A factors and past one
    block's shared memory, so the channel runs over a cluster of 16
    blocks), against its plain version, epoch by epoch, on random
    segments and replicas; one lane group wider raises naming C6."""
    n0, wp, t_epochs, c = 8184, fused.MAX_WP, 4, 2
    assert wp == 49152
    gen = torch.Generator(device=card).manual_seed(5)
    l_seg = fused.seg_length(t_epochs, n0, wp)
    seg = [torch.randn((c, l_seg), generator=gen, device=card)
           for _ in range(2)]
    reps = torch.sign(torch.randn((c, 5, wp), generator=gen, device=card))
    st = torch.zeros((c, fused.N_FIELDS), device=card)
    st[:, 0], st[:, 3], st[:, 7], st[:, 11] = 800.0, 1.023e6, 1.0, 1.0
    st[:, 9] = torch.tensor([3.0, 100.0], device=card)
    kw = dict(t_epochs=t_epochs, n0=n0, wp=wp, fs=8_184_000.0)
    # within chip_smoke.compare's tolerances, epoch by epoch
    chip_smoke.epoch_open_loop(torch, "seg", (*seg, reps, st), kw, piece=1)
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="C6"):
        fused.track_block_fused_seg(
            *seg, torch.zeros((c, 5, wp + 128), device=card), st,
            **dict(kw, wp=wp + 128))


@pytest.mark.cuda
def test_epoch_lane_clusters_match_plain_on_card(card):
    """The per-epoch core in lane clusters (chip_smoke.wide_epoch_check):
    B4b and B3 at Galileo E1B's 8.184 MHz widths at every cluster size the
    plan offers, 4 and 8 channels, power and Costas, B4a and B6 once at
    GPS's, each against its plain version open loop, every launch
    counted and every rank's final state equal to rank 0's; the size the
    wrapper takes is one of which the card holds the C clusters at once,
    its C x cs blocks within the card's SMs."""
    worst = chip_smoke.wide_epoch_check(torch)
    assert set(worst) == {"seg", "direct", "windows", "resident"}


@pytest.mark.cuda
def test_epoch_cluster_refused_raises_on_card(card):
    """A cluster size the launcher refuses (32 blocks) raises naming C6
    and launches nothing: no other size, no single block, no plain
    version takes its place."""
    inp = chip_smoke.epoch_wide_inputs(torch, "seg", {}, 4, device=card)
    before = chip_smoke._launch_counts()
    with chip_smoke.epoch_layout(32), pytest.raises(RuntimeError,
                                                    match="C6"):
        fused.track_block_fused_seg(*inp["args"], **inp["kw"])
    assert chip_smoke._launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("lock", sorted(chip_smoke.WIDE_VARIANTS))
@pytest.mark.parametrize("system", ["glonass_l1of", "galileo_e1b",
                                    "gps_l1ca", "beidou_b1i"])
def test_b1_lane_chunks_match_plain_at_8184k_on_card(card, system, lock):
    """B1 in lane clusters (ROADMAP C15) at a ladder-4 shape, 96 ms
    blocks at 8.184 MHz (GPS wp 8704 at R 13, BeiDou R 9, GLONASS R 21,
    K 8; Galileo E1B wp 33,280 at R 9 and K 6; Costas K 2), at every
    cluster size the plan can choose: against its plain version open
    loop, lean equal to full bit for bit, every satellite's channel
    still tracking."""
    inp = chip_smoke.wide_inputs(torch, card, system,
                                 chip_smoke.WIDE_VARIANTS[lock])
    args, kw = inp["args"], inp["kw"]
    wp, rows, k = chip_smoke.WIDE_MXU_SHAPES[system]
    k = k if lock == "power" else 2
    assert (inp["ft"].wp, inp["ft"].n_rows, kw["k_epochs"]) == (wp, rows, k)
    plan = fused.mxu_smem_plan(wp, rows, k, c_channels=args[4].shape[0])
    assert plan["layout"] == "cluster" and plan["resident"]
    for opt in plan["options"]:
        with chip_smoke.lane_layout(fused, opt["cs"]):
            before = fused.launch_count
            tk, sk, _ = chip_smoke.open_loop_compare(torch, args, kw)
            assert fused.launch_count == before + kw["t_epochs"] // (2 * k)
            tl, sl = fused.track_block_fused_mxu(
                *args, **dict(kw, telem_mode="lean"))
        chip_smoke.lean_equals_full(torch, tk, sk, tl, sl, k,
                                    costas=lock == "costas")
        active = sk[:, 7].cpu().numpy()
        assert active[:inp["n_sats"]].all()
        assert not active[inp["n_sats"]:].any()


@pytest.mark.cuda
def test_b1_lane_clusters_in_waves_on_card(card):
    """More clusters than the card holds at once (32 BeiDou channels in
    clusters of 8: 256 blocks on 132 SMs, so they run in waves) equal,
    channel for channel and bit for bit, two launches of 16 channels
    that fit (128 blocks): a cluster's sums do not depend on the others."""
    inp = chip_smoke.wide_inputs(torch, card, "beidou_b1i", {},
                                 n_channels=32)
    (sre, sim, starts, reps, st), kw = inp["args"], inp["kw"]
    host = np.asarray(kw["starts_host"])
    with chip_smoke.lane_layout(fused, 8):
        plan = fused.mxu_smem_plan(kw["wp"], reps.shape[1],
                                   kw["k_epochs"], c_channels=32)
        assert plan["cs"] * 32 > fused.H100_SMS
        t_all, s_all = fused.track_block_fused_mxu(sre, sim, starts, reps,
                                                   st, **kw)
        halves = [fused.track_block_fused_mxu(
            sre, sim, starts[h].contiguous(), reps[h].contiguous(),
            st[h].contiguous(), **dict(kw, starts_host=host[h]))
            for h in (slice(0, 16), slice(16, 32))]
    torch.cuda.synchronize()
    assert torch.equal(t_all, torch.cat([t for t, _ in halves], dim=1))
    assert torch.equal(s_all, torch.cat([s for _, s in halves], dim=0))
    assert (s_all[:inp["n_sats"], 7] > 0.5).all()


@pytest.mark.cuda
def test_b1_streamed_lane_clusters_on_card(card):
    """A window far wider than any receiver path's (wp 98,304 at R 16,
    K 5, random inputs): each block's part too wide for its bank rows to
    stay resident, so they are streamed in sub-chunks every superstep;
    against the plain version open loop."""
    args, kw = chip_smoke.streamed_case(torch, card)
    plan = fused.mxu_smem_plan(kw["wp"], args[3].shape[1], kw["k_epochs"],
                               c_channels=args[4].shape[0])
    assert plan["layout"] == "cluster" and not plan["resident"]
    chip_smoke.open_loop_compare(torch, args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("lock", sorted(chip_smoke.WIDE_VARIANTS))
def test_b1_one_lane_chunk_above_16_rows_on_card(card, lock):
    """More than 16 bank rows on a narrow window (GLONASS at 1.023 MHz
    with 4-chip early-late spacing: wp 1536, R 21): the lane clusters at
    every size the plan offers, against the plain version open loop,
    lean equal to full."""
    cfg_kw = dict(chip_smoke.WIDE_VARIANTS[lock],
                  early_late_chips=chip_smoke.ONE_CHUNK_EL)
    inp = chip_smoke.wide_inputs(torch, card, "glonass_l1of", cfg_kw,
                                 block_ms=20, fs=chip_smoke.ONE_CHUNK_FS,
                                 n_channels=2)
    args, kw = inp["args"], inp["kw"]
    k = kw["k_epochs"]
    assert (inp["ft"].wp, inp["ft"].n_rows) == (1536, 21)
    plan = fused.mxu_smem_plan(1536, 21, k, c_channels=2)
    assert plan["layout"] == "cluster"
    for opt in plan["options"]:
        with chip_smoke.lane_layout(fused, opt["cs"]):
            tk, sk, _ = chip_smoke.open_loop_compare(torch, args, kw)
            tl, sl = fused.track_block_fused_mxu(
                *args, **dict(kw, telem_mode="lean"))
        chip_smoke.lean_equals_full(torch, tk, sk, tl, sl, k,
                                    costas=lock == "costas")


@pytest.mark.cuda
@pytest.mark.parametrize("system", ["gps_l1ca", "galileo_e1b"])
def test_b2_equals_b1_in_lane_clusters_on_card(card, system):
    """B2 (the shared fetch) at a ladder-4 width: there the wrapper
    launches B1's lane kernel on starts[:C], so at every cluster size the
    plan offers it equals B1 bit for bit, full and lean, one launch
    each."""
    inp = chip_smoke.wide_inputs(torch, card, system, {},
                                 shared_fetch=True)
    args, kw = inp["args"], inp["kw"]
    assert kw["spread_cap"] == chip_smoke.WIDE_SPREAD_CAP[system]
    reps = args[3]
    plan = fused.mxu_smem_plan(kw["wp"], reps.shape[1], kw["k_epochs"])
    assert plan["layout"] == "cluster"
    for opt in plan["options"]:
        with chip_smoke.lane_layout(fused, opt["cs"]):
            for mode in ("full", "lean"):
                assert chip_smoke.b2_equals_b1(
                    torch, args, dict(kw, telem_mode=mode)) == (1, 1)


@pytest.mark.cuda
def test_b4b_at_galileo_seg_width_on_card(card):
    """B4c and B4b at Galileo E1B's seg width at 8.184 MHz (wp 33,152, 20
    ms blocks of 5 epochs): B4c equal to its plain version bit for bit,
    B4b against its plain version epoch by epoch, both channels still
    tracking."""
    inp = chip_smoke.wide_inputs(torch, card, "galileo_e1b", {},
                                 layout="seg", block_ms=20)
    assert (inp["ft"].wp, inp["ft"].t_epochs) == (33152, 5)
    g_args, g_kw = inp["gather"]
    got = fused.gather_segments(*g_args, **g_kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], inp["args"][0])
    assert torch.equal(got[1], inp["args"][1])
    _, sk, _ = chip_smoke.epoch_open_loop(torch, "seg", inp["args"],
                                          inp["kw"], piece=1)
    active = sk[:, 7].cpu().numpy()
    assert active[:inp["n_sats"]].all()


@pytest.mark.cuda
def test_epoch_kernels_at_alignment_edges_on_card(card):
    """The window copy of the per-epoch kernels at its alignment edges
    (chip_smoke.epoch_edge_check), 32 channels, 20 ms blocks (B4b 15):
    B3 with every start at each residue mod 4 and the stream cut where
    the last window ends; B4b on segments cut at the last window and
    widened so their rows start at every residue; B6 on the stream cut at
    its read bound (chunks at residues 0 and 2, their last samples by
    cp.async): each against its plain version open loop and equal bit for
    bit to the unmoved run. B4a's rows are whole windows (residue 0,
    test_epoch_kernel_matches_plain_on_card). A base pointer off 16 bytes
    raises on all four, launching nothing."""
    worst = chip_smoke.epoch_edge_check(torch, device=card, seg_ms=15,
                                        long_ms=20, piece=10)
    torch.cuda.synchronize()
    assert set(worst) == {"direct", "seg", "resident"}


@pytest.mark.cuda
@pytest.mark.parametrize("wp", [6144, 12288])
def test_epoch_kernel_wide_window_layouts_on_card(card, wp):
    """B4b and B3 past the widths one block holds (the replica rows and
    two window slots, to wp 5,760 at 5 rows): at wp 6144 and 12288 each
    channel runs in lane clusters (the plan's first size), against their
    plain versions epoch by epoch on random inputs, at start residues 0-3
    (the window parts' last 0-3 samples by cp.async)."""
    n0, t_epochs, c = 3069, 6, 4
    gen = torch.Generator(device=card).manual_seed(7)
    l_seg = fused.seg_length(t_epochs, n0, wp) + 3
    seg = [torch.randn((c, l_seg), generator=gen, device=card)
           for _ in range(2)]
    reps = torch.sign(torch.randn((c, 5, wp), generator=gen, device=card))
    st = torch.zeros((c, fused.N_FIELDS), device=card)
    st[:, 0], st[:, 3], st[:, 7], st[:, 11] = 600.0, 1.023e6, 1.0, 1.0
    st[:, 9] = torch.tensor([3.0, 40.0, 100.0, 7.0], device=card)
    kw = dict(t_epochs=t_epochs, n0=n0, wp=wp, fs=3_069_000.0)
    chip_smoke.epoch_open_loop(torch, "seg", (*seg, reps, st), kw, piece=1)
    stream = [torch.randn(20 * wp, generator=gen, device=card)
              for _ in range(2)]
    starts_host = np.array([0, 129, 258, 387], dtype=np.int32)
    args = (*stream, torch.from_numpy(starts_host).to(card), reps, st)
    kw = dict(t_epochs=2, k_epochs=1, n0=n0, wp=wp, fs=3_069_000.0,
              starts_host=starts_host)
    chip_smoke.open_loop_compare(torch, args, kw, layout="direct")
    torch.cuda.synchronize()


# the shared fetch: B2 (FusedTracker(shared_fetch=True))

@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["power", "costas", "forced_death"])
def test_shared_kernel_matches_plain_and_b1_on_card(card, variant):
    """B2 at 32 channels, 20 ms blocks, with the base clamped at 0 and
    with random starts across [base, base + spread_cap] (the tracker's
    own inputs, chip_smoke.shared_cases): against its plain version open
    loop in full and lean telemetry, and against B1 kernel to kernel,
    bit for bit, on those and on starts off the channels' codes
    (chip_smoke.offcode_case)."""
    cases = chip_smoke.shared_cases(torch, card, VARIANTS[variant],
                                    block_ms=20)
    for name, (c_args, c_kw) in cases.items():
        for mode in ("full", "lean"):
            m_kw = dict(c_kw, telem_mode=mode)
            before = fused.shared_launch_count
            chip_smoke.open_loop_compare(torch, c_args, m_kw)
            assert fused.shared_launch_count > before
            assert chip_smoke.b2_equals_b1(torch, c_args, m_kw) == (1, 1)
    o_args, o_kw = chip_smoke.offcode_case(*cases["clamped"], seed=1)
    for mode in ("full", "lean"):
        assert chip_smoke.b2_equals_b1(
            torch, o_args, dict(o_kw, telem_mode=mode)) == (1, 1)


@pytest.mark.cuda
def test_shared_cluster_size_falls_back_on_card(card, monkeypatch):
    """A cluster size the card cannot run (16, above the portable 8) is
    refused before any launch and the next size is launched; with no
    size that runs the wrapper raises. A slice that does not fit in a
    block beside the bank and the tile (spread_cap 8192: 18,816 samples,
    147 KB) runs with the windows read from global memory, equal to B1.
    A bank and tile that no block can hold whole (R = 16, wp = 8192) run
    B1 in lane clusters since ROADMAP C15 (one launch); a window wider
    than the lane clusters take (``mxu_smem_plan``'s widest) raises
    naming C15 before any launch."""
    _, args, kw = chip_smoke.full_width_inputs(torch, card, {}, block_ms=20,
                                               shared_fetch=True)
    b1_args, b1_kw = chip_smoke.b1_of(args, kw)
    t1, s1 = fused.track_block_fused_mxu(*b1_args, **b1_kw)
    monkeypatch.setattr(fused, "shared_cluster_sizes", lambda c: (16, 2))
    before = fused.shared_launch_count
    t2, s2 = fused.track_block_fused_mxu(*args, **kw)
    assert fused.shared_launch_count == before + 1
    assert torch.equal(t2, t1) and torch.equal(s2, s1)
    monkeypatch.setattr(fused, "shared_cluster_sizes", lambda c: (16,))
    with pytest.raises(RuntimeError, match="no cluster of 16"):
        fused.track_block_fused_mxu(*args, **kw)
    assert fused.shared_launch_count == before + 1
    monkeypatch.setattr(fused, "shared_cluster_sizes", lambda c: (2,))
    t3, s3 = fused.track_block_fused_mxu(*args, **dict(kw, spread_cap=8192))
    assert torch.equal(t3, t1) and torch.equal(s3, s1)
    c, n0 = 2, kw["n0"]
    widest = fused.mxu_smem_plan(8192, 16, 5)["max_wp"]
    for wp, launched in ((8192, 1), (widest + 128, 0)):
        n = fused.direct_span(5, n0, wp) + (5 * n0 // 128) * 128
        before = fused.launch_count
        call = lambda: fused.track_block_fused_mxu(  # noqa: E731
            torch.zeros(n, device=card), torch.zeros(n, device=card),
            torch.zeros(c, dtype=torch.int32, device=card),
            torch.zeros((c, 16, wp), dtype=torch.bfloat16, device=card),
            torch.zeros((c, fused.N_FIELDS), device=card), t_epochs=10,
            k_epochs=5, n0=n0, wp=wp, fs=chip_smoke.FS,
            starts_host=np.zeros(c, np.int32))
        if launched:
            telem, _ = call()
            torch.cuda.synchronize()
            assert telem.shape == (10, c, fused.N_TELEM)
        else:
            with pytest.raises(ValueError, match="C15"):
                call()
        assert fused.launch_count == before + launched


@pytest.mark.cuda
def test_shared_bounds_raise_on_card(card):
    """B2's checks raise before any launch: a window off the slice, no
    host copy of the starts, and the clamped base's slice past the end
    of a stream that holds every channel's windows (ROADMAP C3)."""
    ft, args, kw = chip_smoke.full_width_inputs(torch, card, {}, block_ms=20,
                                                shared_fetch=True)
    sre, sim, starts, reps, mat = args
    host = kw["starts_host"]
    c, cap = mat.shape[0], kw["spread_cap"]
    span = chip_smoke.direct_span_of(kw)
    last = ((kw["t_epochs"] - kw["k_epochs"]) * kw["n0"] // 128) * 128
    before = chip_smoke._launch_counts()
    off = host.copy()
    off[0] = cap + 128
    with pytest.raises(ValueError, match="128-sample steps"):
        fused.track_block_fused_mxu(*args, **dict(kw, starts_host=off))
    with pytest.raises(ValueError, match="starts_host"):
        fused.track_block_fused_mxu(*args, **dict(kw, starts_host=None))
    n = int(host[:c].max()) + last + span
    assert n < cap + last + span                # the base is clamped
    with pytest.raises(ValueError, match="C3"):
        fused.track_block_fused_mxu(sre[:n].contiguous(),
                                    sim[:n].contiguous(), *args[2:], **kw)
    with pytest.raises(ValueError, match="C3"):
        fused.track_block_fused_mxu(
            sre[:n].contiguous(), sim[:n].contiguous(), *args[2:],
            **dict(kw, starts_host=None, starts_bound=int(host.max())))
    assert chip_smoke._launch_counts() == before


@pytest.mark.cuda
def test_shared_tracker_equals_b1_tracker_on_card(card):
    """FusedTracker(shared_fetch=True) over 3 blocks of the 24-satellite
    scene, single blocks and one 3-block span on the slim2 wire: every
    downloaded array and the final ledger equal shared_fetch=False's bit
    for bit; B2 once per block, B1 never."""
    assert chip_smoke.phase_shared_path(torch, seconds=2.0, span=3) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["f32", "int8"])
def test_device_sources_on_card_equal_cpu(card, store):
    """DeviceArraySource and StreamingDeviceSource on the card hand out
    tensors on the card, equal bit for bit to the same sources on the
    CPU (the int8 scale is computed on the host either way); a short
    last read stays short; close() ends the feeder."""
    from gnss_sdr_tpu_torch.receiver import (
        ArraySource, DeviceArraySource, StreamingDeviceSource)

    rng = np.random.default_rng(4)
    x = (rng.standard_normal(50_000) + 1j * rng.standard_normal(50_000)
         ).astype(np.complex64)
    n = 12_000
    for make in (lambda d: DeviceArraySource(x, 1e6, store=store, device=d),
                 lambda d: StreamingDeviceSource(ArraySource(x, 1e6),
                                                 store=store, device=d)):
        gpu, cpu = make(card), make("cpu")
        try:
            while True:
                a, b = gpu.read(n), cpu.read(n)
                if a is None or b is None:
                    assert a is None and b is None
                    break
                assert a[0].is_cuda and a[0].dtype == torch.float32
                for u, v in zip(a, b):
                    assert torch.equal(u.cpu(), v)
        finally:
            for s in (gpu, cpu):
                if hasattr(s, "close"):
                    s.close()
    assert b is None


@pytest.mark.cuda
def test_pull_block_makes_no_host_copy_on_card(card):
    """chip_smoke's profiler check (phase 22) in a fresh process: a block
    pulled from each device source makes no device-to-host copy."""
    copies, tries = chip_smoke.pull_copies_fresh()
    assert copies == {"device_f32": 0, "device_int8": 0,
                      "streaming_int8": 0}, (copies, tries)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["mxu", "direct"])
def test_mesh_fused_step_equals_unsharded_on_card(card, layout):
    """The fused step on 2 and 4 channel shards of the card
    (parallel.shard_fused_step; 32 channels, 20 ms blocks): telemetry and
    state equal to the unsharded kernel's bit for bit, the kernel
    launched once per shard."""
    from gnss_sdr_tpu_torch import parallel

    ft, args, kw = chip_smoke.full_width_inputs(torch, card, {},
                                                block_ms=20, layout=layout)
    count = "launch_count" if layout == "mxu" else "direct_launch_count"
    ref = ft._kernel(*args, **kw)
    for n in (2, 4):
        before = getattr(fused, count)
        tl, st = parallel.shard_fused_step(chip_smoke.card_mesh(torch, n),
                                           ft._kernel)(*args, **kw)
        assert getattr(fused, count) == before + n
        assert torch.equal(tl, ref[0]) and torch.equal(st, ref[1])


@pytest.mark.cuda
def test_mesh_searches_on_card(card):
    """chip_smoke.py phase 35: the time- and PRN-sharded searches at full
    width equal one pcps_search."""
    out = chip_smoke.phase_mesh_acquisition(torch)
    assert len(out) == len(chip_smoke.MESH_SEARCHES)


@pytest.mark.cuda
def test_mesh_processes_on_card(card, tmp_path):
    """Two gloo processes, each with 2 shards of the card: the
    all-reduced time-sharded search equals each rank's own search."""
    results = chip_smoke.dist_run_workers(str(tmp_path), device="cuda:0")
    assert [r["device"] for r in results] == ["cuda:0", "cuda:0"]
    chip_smoke.dist_check(results)


@pytest.mark.cuda
def test_dryrun_multichip_on_card(card):
    from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip

    assert dryrun_multichip(4)["device"] == "cuda"


@pytest.fixture
def cards():
    """A host of 4 cards or more (a mesh of one shard per card)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    return torch.cuda.device_count()


@pytest.mark.cuda
def test_mesh_fused_over_cards(cards):
    """chip_smoke.py phase 33 with one shard on each of 2 and 4 cards:
    every layout's downloads and ledger equal to the unsharded tracker
    on cuda:0 bit for bit, each kernel launched blocks x shards times."""
    out = chip_smoke.phase_mesh_fused(torch, mesh_devices="cards")
    assert set(out["launches"]["mxu, single-block"]) == {1, 2, 4}


@pytest.mark.cuda
def test_mesh_receiver_over_cards(cards):
    """chip_smoke.py phase 34 with one shard on each of 2 and 4 cards:
    the scanned receiver's blocks replay each card's own CUDA graph (B5
    counted from the replays, shards x the unsharded count), and the
    telemetry equals the unsharded receiver's; a ParallelConfig mesh
    takes the visible cards."""
    from gnss_sdr_tpu_torch import ParallelConfig, ReceiverConfig, \
        RfConfig, TrackConfig
    from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver

    out = chip_smoke.phase_mesh_receiver(torch, mesh_devices="cards")
    assert set(out["launches"]["scanned, pallas"]) == {1, 2, 4}
    rx = Receiver(ReceiverConfig(
        rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=chip_smoke.FS),
        track=TrackConfig(n_channels=chip_smoke.N_CHANNELS),
        parallel=ParallelConfig(channel_axis=4),
        block_ms=chip_smoke.BLOCK_MS),
        ArraySource(np.zeros(2046, np.complex64), chip_smoke.FS))
    assert rx.mesh.devices.reshape(-1).tolist() == \
        [torch.device("cuda", i) for i in range(4)]


@pytest.mark.cuda
def test_mesh_searches_over_cards(cards):
    """chip_smoke.py phase 35 with one shard on each card."""
    out = chip_smoke.phase_mesh_acquisition(torch, mesh_devices="cards")
    assert len(out) == len(chip_smoke.MESH_SEARCHES)


@pytest.mark.cuda
def test_mesh_processes_nccl_over_cards(cards, tmp_path):
    """Four ranks as torchrun starts them (LOCAL_RANK, LOCAL_WORLD_SIZE),
    one card each: initialize_from_env picks NCCL and makes the rank's
    card current, global_mesh gives each rank its own card, and the
    time-sharded search's cube is all-reduced over NCCL."""
    results = chip_smoke.dist_run_workers(str(tmp_path), device="cards",
                                          n_procs=4, shards=1)
    assert [r["device"] for r in results] == [f"cuda:{i}" for i in range(4)]
    chip_smoke.dist_check(results, backend="nccl")
