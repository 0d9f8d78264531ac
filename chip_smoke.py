#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gnss_sdr_tpu_torch) on one NVIDIA
GPU:

  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: every CUDA source under gnss_sdr_tpu_torch/csrc/, and B1's
     earlier lane-chunk source under tools/ (timed in 25), one nvcc
     each, in parallel (sm_90a);
  3. each kernel against its plain PyTorch version on the card, at the
     full width the receiver gives it (32 channels, 500 ms blocks at
     2.046 MHz, 24 satellites tracked and 8 channels idle), in the
     power-lock, Costas-lock and forced-death variants, open loop: the
     plain version runs every pair of supersteps from the kernel's own
     state at its start; then the alignment edges of the window copy
     (power lock): the same windows with every start moved to each
     residue mod 4 and the stream cut where the last window ends, each
     against the plain version open loop and equal to the unmoved run
     bit for bit;
  4. the kernel's time per block (CUDA events around each launch, the
     launches queued back to back, median of 30 passes with a fresh
     state each and the L2 flushed), the plain version's time and the
     least time the card could take for the same work; the kernel's
     registers and stack per instantiation (ptxas);
  5. the end-to-end receiver, ``Receiver(cfg, source).run()``, on a
     24-satellite scene: every PRN tracked within 40 Hz, and the
     kernel's launch count equal to the number of blocks;
  6. kernel B3 (direct layout) against its plain version at full width
     (T=500, K=10, 5 f32 replica rows), open loop, in the power, Costas
     and forced-death variants;
  7. B1's lean telemetry mode against its full mode on the same inputs:
     the stored columns and the end state bit for bit;
  8. B3's time per block, its plain version's and its bound, as 4;
  9. the steady-state receiver, ``run(scan_blocks=k)``, on the
     24-satellite scene: (a) 10 s, 8-block spans, pipelined, the auto
     layout and wire (mxu, slim2); (b) the same, synchronous spans,
     against a single-block run of the same scene (epochs equal per
     PRN, every PRN's Doppler over the last block, the mean of its
     last 500 epochs, within 1 Hz); (c) 5 s, the direct
     layout, 4-block spans; every PRN tracked, launches equal to
     blocks, then one chained span submitted with the sync debug mode
     at "error" (the submit path never waits for the card);
 10. kernel B5 (one epoch's E/P/L correlations) against its plain
     version at full width (32 channels): 2.046 MHz (W=2054, shift 1),
     4.092 MHz (W=4100, shift 2) and Galileo E1B at 8.184 MHz (two
     samples per chip), interp off and on, partial and idle epoch masks,
     random u32 phases; each sum's largest difference over its column's
     largest |value|; the block-reading entry (the windows read from a
     block at each channel's start, as the tracker calls it) equal to
     the [C, W] entry bit for bit;
 11. B5's time per launch and per 500 ms block (501 launches of the
     block-reading entry, fresh inputs, the L2 flushed before each; the
     kernel's device time from the profiler, events around each launch
     beside it), the plain version's and the bound;
 12. the scanned receiver (the JAX package's default tracker) on the
     24-satellite scene, 5 s from a cold start: correlator="pallas" (B5
     launched blocks x 501 times, B1 and B3 never) and the default
     "shift" (no kernel launch), each twice, on the eager loop and on
     its CUDA graph (the first block the warm-up, the second the
     capture and a replay, apart from the later blocks'), the two runs'
     telemetry and summaries equal; every PRN tracked within 40 Hz; one
     block of each profiled (host launch calls, device kernels per
     epoch, busy share, B5's launches and time inside the replay); then
     the graph against the eager loop block by block, bit for bit in
     the state and the 17 telemetry fields, 3 blocks and a 200 ms tail
     on the same graph, the replays with the sync debug mode at "error";
 13. the IF capture: an int8 real file at 16.368 MHz with a 4.092 MHz
     IF, DC removal, mixed and decimated 4x on the card, 2 s,
     correlator="pallas": every PRN tracked within 40 Hz, eager and
     graph runs equal;
 14. the fused receiver on a stream that ends in a partial block: the
     full blocks through B1, the tail through the scanned tracker,
     eager and graph runs equal;
 15. the per-epoch kernels against their plain versions at full width
     (32 channels, 24 tracking and 8 idle), open loop (pieces of 20-25
     epochs, each from the kernel's own state), power, Costas and
     forced death: B4a (windows, T=500, wp=2176), B4b (seg, T=125,
     wp=2432) with B4c's segments (equal to its plain version bit for
     bit), B6 (resident, T=500, wp=4352, chunks of 5) and B6 against
     B4a on the same stream, kernel to kernel; then the window copy's
     alignment edges (power lock), each against its plain version open
     loop and equal bit for bit to the unmoved run: B3 with every start
     moved to each residue mod 4 and the stream cut where the last
     window ends, B4b on segments cut at the last window and widened so
     their rows start at every residue, B6 on the stream cut at its read
     bound; a base pointer off 16 bytes raising on all four; then B6
     once through its entry point;
 16. the per-epoch kernels' times per block, their plain versions' and
     their bounds, as 4 (B4c beside one PyTorch indexing call);
 17. the receiver on the 24-satellite scene, 5 s, through the per-epoch
     layouts: 125 ms blocks (an odd epoch count: mxu and direct fall to
     seg, B4b and B4c once per block), and 500 ms blocks on the windows
     layout (B4a once per block) against the direct layout; every PRN
     tracked within 40 Hz;
 18. kernel B2 (the shared fetch, FusedTracker(shared_fetch=True))
     against its plain version at full width, open loop, in the power,
     Costas and forced-death variants, full and lean telemetry, and
     against B1 kernel to kernel, bit for bit, on the tracker's own
     inputs with the base clamped at 0 and with the channels moved by
     whole code periods to random starts across [base, base +
     spread_cap] above a base of the guard's, and on those with the
     stream cut where the last slice ends (equal to the uncut run);
 19. B2's path on the 10 s scene: FusedTracker(shared_fetch=True) as
     single blocks and as synchronous 8-block spans on the slim2 wire,
     every downloaded array and the final ledger equal to the same run
     with shared_fetch=False, B2 launched once per block and B1 never;
 20. B2's time per block beside B1's in turns, its plain version's and
     its bound, the registers and stack of B1's and B2's instantiations;
 21. the CLI journey: native/ingest.cpp built, a 26 s int8 I/Q capture
     of 8 satellites broadcasting LNAV (circular-orbit ephemerides above a
     truth position, ranges on the SV-clock timeline), cli.main with
     --pvt --ekf --rinex-obs on the file driver (NativeFileSource), the
     fused tracker (B1) at 32 channels, 508 ms blocks: every PRN tracked
     and its ephemeris decoded, the fix and the EKF within 100 m of the
     truth, OBS epochs that parse back, B1 launched once per full block;
     then
     ``python -m gnss_sdr_tpu_torch --blocks 10`` in a subprocess;
 22. phase 9 (b)'s steady receiver behind ArraySource, DeviceArraySource
     (f32 and int8) and StreamingDeviceSource (int8): the f32 device
     source's telemetry and summary equal ArraySource's bit for bit, the
     int8 ones within 40 Hz, ingest per block and the feeder's counters,
     no device-to-host copy in one profiled _pull_block;
 23. ladder 2's pad-FFT acquisition on the card: detections equal the
     CPU run's; one search's time beside the circular engine's;
 24. slice 10's kernel shapes (the other GNSS systems at ladder 4's 8.184
     MHz): B1 at the four ladder-4 shapes (GPS wp 8704 R 13, BeiDou R 9,
     GLONASS R 21, all K 8; Galileo E1B wp 33,280 R 9 K 6; 96 ms blocks),
     at ladder 4's 20 ms shapes (K 5) and at R 21 on GLONASS's 1.023 MHz
     window, in lane clusters at every cluster size the plan offers
     (and 8 warps at its first), against its plain version open loop,
     power and Costas, full and lean (lean equal to full bit for bit);
     the per-epoch core in lane clusters (one channel over a
     thread-block cluster, wide_epoch_check): B4c (bit for bit) and B4b
     at Galileo's seg width (wp 33,152, 20 ms blocks) and B3 at its
     direct width (wp 33,280), power and Costas, at 4 and 8 channels, at
     every cluster size the plan offers; B4a (wp 8,320) and B6 (wp
     16,640) once each on GPS at 8.184 MHz; each open loop against its
     plain version, every launch counted and every rank's final state
     equal to rank 0's;
 25. the times per block of those shapes, their plain versions' and
     their bounds, as 4 and 16; B1 at the 96 ms and 20 ms shapes in
     turns against its earlier lane-chunk kernel (tools/b1_chunked.py),
     at each cluster size the plan offers and at 8 warps; B4b and B3 at
     4 and 8 channels at each cluster size in turns (epoch_turns), B4a
     and B6 at their wide shapes;
 26. ladder 4 at full width as bench.py's mixed row runs it: 14
     satellites of four systems in one 8.184 MHz stream (seed 7), 32
     channels (GPS 8, Galileo 4, GLONASS 4, BeiDou 16), 96 ms blocks,
     correlator "fused" (B1 on every branch), a DeviceArraySource(store=
     "int8") per branch; single blocks, then 10-block spans: every scene
     PRN the acquisition searches tracked within 40 Hz, each branch's B1
     launches equal to its blocks, the real-time factor of two timed
     passes; then presets.ladder4_multi_constellation() with "fused" at
     20 ms blocks (Galileo on seg: B4c and B4b once per block, B4b in
     lane clusters), each branch's stage totals and B4b's share of the
     Galileo branch's `track`;
 27. the three live-decode scenes of tests/test_nav_live_multi.py
     (Galileo I/NAV, BeiDou D1, GLONASS strings; one satellite each, cold
     start): each ephemeris decoded on the card and equal to its truth;
 28. slice 11: kernel B2 (the shared fetch) in lane clusters at the four
     ladder-4 shapes (there the wrapper launches B1's lane kernel on
     starts[:C]) against its plain version open loop, power and Costas,
     full and lean, and against B1 kernel to kernel bit for bit at the
     same cluster size, on the tracker's starts (base 0) and on random
     starts across the cap above a raised base;
 29. B2's times per 96 ms block at those shapes beside B1's in turns, its
     plain version's and its bounds;
 30. B2's path at ladder 4's GPS shape (8 channels, 96 ms blocks):
     FusedTracker(shared_fetch=True) as single blocks, through run_blocks
     and in 5-block spans (slim and slim2 wires), every block's telemetry and the final ledger
     equal bit for bit to shared_fetch=False, B2 launched once per block;
 31. the conv acquisition engine (ROADMAP A11): acquire_conv on the
     24-satellite scene's chunk (2.046 MHz, 32 PRNs) held to the port's
     CPU run, its time on the card, one search cold (32 PRNs) and steady
     (the 8-row bucket) against the FFT engine's, and one search on each
     of the mixed row's branches (GLONASS FDMA: the conv engine's
     detections equal to the FFT engine's, ROADMAP C4);
 32. the in-scan search at full width: 32 channels at 2.046 MHz, mxu,
     500 ms blocks, spans of 4, the 24-satellite scene with PRN 25 rising
     at 1.5 s: acquired by a span's own search on synchronous and on
     pipelined spans, every PRN tracked within 40 Hz; the FFT engine's
     boundary search beside it; each run's real-time factor;
 33. slice 12, the device mesh (parallel/) as 2 and 4 channel shards of
     the one card (``make_mesh(devices=[cuda:0] * n)``): the fused
     tracker at 32 channels on the 24-satellite scene, mxu single-block
     and in 8-block slim2 spans (10 s), direct in 4-block spans (5 s),
     one 125 ms seg block (B4c + B4b) and one 500 ms windows block (B4a),
     every downloaded array and the final ledger equal to the unsharded
     run bit for bit, each kernel launched blocks x shards times; the
     sharded B1 step's time per block at 1, 2 and 4 shards in turns;
 34. the receiver on meshes of 2 and 4 shards (``Receiver._use_mesh``)
     against the unsharded one: the fused receiver in spans of 4 over 9
     blocks and a 200 ms tail (the tail through
     ``parallel.sharded_track_block``), and the scanned receiver with
     "pallas" over 3 blocks and a tail (B5 per shard); telemetry and
     summaries equal (the fused tail at 4 shards within tolerance: torch
     sums its 8-row correlations in another order), every PRN within 40
     Hz; ``ParallelConfig(channel_axis=2)`` raising on a one-card
     machine;
 35. the sharded searches at full width (32 PRNs x 29 bins): time-
     sharded over 10 ms in 2 shards and 20 ms in 4, PRN-sharded in 4,
     each against one pcps_search, and their times beside it;
 36. two processes on the one card (gloo, 2 shards of cuda:0 each): the
     time-sharded search all-reduced across the process boundary equal
     to each rank's unsharded search, the ranks' events merged;
 37. ``parallel.dryrun.dryrun_multichip(4)`` on the card;
 38. the kernels line (each kernel's launches on phases 33-34 under
     "launches_mesh"), then the last line: {"ok": true, "device": {...}}.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and nvcc; without a device it exits non-zero and prints no
result. Any failed check raises.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

FS = 2_046_000.0
N_CHANNELS = 32
BLOCK_MS = 500
E2E_BLOCKS = 10                     # 5 s of signal
KERNEL_PASSES = 15
# the spin ahead of a turn of queued kernel calls, in clock cycles (~25
# ms at ~2 GHz): longer than the host takes to queue KERNEL_PASSES calls
HEAD_START_CYCLES = 50_000_000
PLAIN_PASSES = 3

# published peaks of one H100 SXM (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
H100_BYTES_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12

STEADY_S = 10                       # steady-state scene, mxu runs
SCAN_S = 5                          # scanned receiver runs
IF_S = 2                            # IF capture run
FS_IF_IN = 16_368_000.0             # ... its capture rate, IF and
F_IF = 4_092_000.0                  # decimation (tests/test_pipeline.py)
IF_DECIM = 4
# f32 ops per in-mask lane in B5 (csrc/epl_correlator.cu): the complex
# mix (4 multiplies, 2 adds), three chip-ramp fmas (2 each) and six
# correlation multiply-adds (12)
B5_OPS_PER_LANE = 24
B5_TOL = 1e-4                       # of each sum's column max
DIRECT_S = 5                        # ... and the direct run
STEADY_SPAN = 8                     # blocks per span, mxu runs
# a channel's Doppler measured over the last block: the mean of its
# carrier-frequency trace over the last 500 epochs (phase 9)
SETTLED_EPOCHS = 500
DIRECT_SPAN = 4                     # ... and the direct run
# the per-epoch layouts (phases 15-17)
WINDOWS_BLOCK_MS = 500              # B4a and B6: T = 500
SEG_BLOCK_MS = 125                  # B4b + B4c: T = 125, odd: seg
SEG_S = 5                           # the per-epoch receiver runs
RESIDENT_K = 8                      # B6's k_epochs: chunks of 5 at T = 500
EPOCH_PIECE = 20                    # open-loop piece (seg: 25)
# B6 against B4a on the same stream (tests/test_fused_kernel.py:146-149):
# cols 0-6 within 1e-4 of their max, the carrier rate within 0.05 Hz,
# state cols 0-8 within 0.1
RESIDENT_TOL = (1e-4, 0.05, 0.1)

# telemetry column groups: exact flags and integers; values that carry
# the bf16 rounding of the mixed window (a sin/cos ulp apart flips a
# rounding), judged against the column's own scale; f32 rates. The
# direct layout's 17 columns take the groups' first 17.
EXACT_COLS = [7, 12, 13, 15, 16]
BF16_COLS = [0, 1, 2, 3, 4, 5, 6, 8, 9, 14, 19, 20]
RATE_COLS = [10, 11, 17, 18]
RATE_ATOL_HZ = 1e-3
CORR_COLS = [0, 1, 2, 3, 4, 5]
# f32 ops per mixed lane: the carrier rotation from its trig factors
# (4 multiplies, 2 adds) and the complex mix of the sample (4, 2)
MIX_OPS_PER_LANE = 12
# f32 ops per mixed lane in B3 (csrc/track_block_direct.cu, stage 2):
# the mix as above (12) and six correlation products with their sums
# (6 multiplies, 6 adds)
DIRECT_OPS_PER_LANE = 24
# B1's lean telemetry mode: columns stored on every epoch, on each
# superstep's first epoch, and there on even supersteps (all under
# Costas lock)
LEAN_EVERY = [2, 3]
LEAN_ROW0 = [17, 18, 19, 20]
LEAN_ROW0_EVEN = [0, 1, 4, 5, 8, 9]


def scene_sats(SatelliteScenario):
    """bench.py's 24-satellite receiver scene (PRN 1-24)."""
    return [SatelliteScenario(
        prn=p, doppler_hz=float(500.0 * ((p % 7) - 3) + (100 * p) % 900),
        code_phase_chips=float((37 * p) % 1023), amplitude=0.3)
        for p in range(1, 25)]


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # the plain versions' f32 products must not drop to TF32
    assert not torch.backends.cuda.matmul.allow_tf32
    return smi


def phase_build():
    from gnss_sdr_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    logs = _build.build_all(extra={"track_block_mxu_chunked": Path(
        __file__).resolve().parent / "tools" / "track_block_mxu_chunked.cu"})
    print(f"build: {len(logs)} source(s) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"  {name}: {log['seconds']:.2f} s cached={log['cached']}")
        for line in log["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())
    return logs


def ptxas_summary(log):
    """Registers, stack frame and spills per kernel from ``nvcc -Xptxas
    -v``'s output (``_build.BUILD_LOG[name]["ptxas"]``): {entry name:
    {"registers", "stack", "spill_stores", "spill_loads"}}."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def mxu_ptxas():
    """ptxas_summary of the mxu source's four instantiations (B1 and B2,
    full and lean), as the build of this run reported them."""
    from gnss_sdr_tpu_torch.ops.cuda import _build

    return {k: v for k, v in ptxas_summary(
        _build.BUILD_LOG["track_block_mxu"]["ptxas"]).items()
        if "track_block_mxu_kernel" in k}


def full_width_inputs(torch, device, cfg_kw, n_channels=N_CHANNELS,
                      block_ms=BLOCK_MS, layout="mxu", shared_fetch=False,
                      spread_seed=None):
    """One block's kernel inputs at the receiver's full width: a
    24-satellite aligned ledger (channels started on each satellite's
    code boundary and true Doppler) plus idle channels, through the
    FusedTracker's own host re-anchor (``shared_fetch``: B2's [C + 1]
    starts and ``spread_cap``; ``spread_seed``: see _scene_tracker)."""
    ft, args, kw, _ = _full_width(torch, device, cfg_kw, n_channels,
                                  block_ms, layout, shared_fetch,
                                  spread_seed)
    return ft, args, kw


def _full_width(torch, device, cfg_kw, n_channels, block_ms, layout,
                shared_fetch=False, spread_seed=None):
    """full_width_inputs, and the channels' code rows on the card."""
    from gnss_sdr_tpu_torch.models import SatelliteScenario, synthesize

    ft, st, rows, history = _scene_tracker(
        torch, device, cfg_kw, n_channels, block_ms, spread_seed,
        layout=layout, shared_fetch=shared_fetch)
    sig = synthesize(scene_sats(SatelliteScenario),
                     history + block_ms * ft.n0, FS, noise_std=1.0, seed=3)
    anc = ft.anchor_block(st)
    args, kw = ft.kernel_args(anc, np.real(sig).astype(np.float32),
                              np.imag(sig).astype(np.float32), rows)
    return ft, args, kw, rows


def _scene_tracker(torch, device, cfg_kw, n_channels, block_ms,
                   spread_seed=None, **ft_kw):
    """A FusedTracker at 2.046 MHz over windows of [history | block]
    (history: the acquisition's samples and two code periods), and the
    24-satellite scene's ledger: each channel started where its
    satellite's code phase crosses a period boundary, at its true
    Doppler, the rest idle. With ``spread_seed`` each channel starts
    whole code periods later instead, still on its satellite's code
    boundary: in a random window [X, X + n0) deep in the history, some a
    period further where that stays within 2304 samples of X, so the
    window starts spread at random across less than B2's spread_cap
    above a base the guard does not clamp. Returns (tracker, ledger, the
    channels' code rows on ``device``, history)."""
    from gnss_sdr_tpu_torch.config import AcqConfig, TrackConfig
    from gnss_sdr_tpu_torch.models import GPS_L1CA, SatelliteScenario
    from gnss_sdr_tpu_torch.receiver import tracking as trk
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine
    from gnss_sdr_tpu_torch.receiver.fused_runner import FusedTracker

    n0 = GPS_L1CA.samples_per_code(FS)
    cfg = TrackConfig(n_channels=n_channels, correlator="fused", **cfg_kw)
    params = trk.TrackParams.create(cfg, GPS_L1CA, FS)
    history = AcquisitionEngine(AcqConfig(), GPS_L1CA, FS,
                                device="cpu").samples_needed + 2 * n0
    codes = trk.make_sampled_code_table(GPS_L1CA, FS, 32,
                                        window=params.window)
    ft = FusedTracker(params, cfg, GPS_L1CA, FS, codes, block_ms,
                      history + block_ms * n0, device=device, **ft_kw)
    rng = None if spread_seed is None else np.random.default_rng(spread_seed)
    x0 = 0 if rng is None else int(rng.integers(3 * n0, 10 * n0))
    st = trk.init_state(n_channels)
    for ch, s in enumerate(scene_sats(SatelliteScenario)[:n_channels]):
        off = int(round((1023.0 - s.code_phase_chips) % 1023.0
                        * FS / GPS_L1CA.code_rate_hz))
        if off <= ft.el_pad:
            off += n0
        if rng is not None:
            off += -(-(x0 - off) // n0) * n0
            if off + n0 - x0 <= 2304 and rng.random() < 0.5:
                off += n0
        st = trk.start_channel(st, ch, s.prn - 1, s.doppler_hz, off,
                               GPS_L1CA.code_rate_hz)
    rows = torch.from_numpy(codes[np.maximum(st.prn_idx, 0)]).to(device)
    return ft, st, rows, history


def compare(tk, sk, tr, sr):
    """Telemetry [T, C, >=21] and state [C, 128] of one side (tk, sk)
    against the other (tr, sr), tensors or arrays, with the tolerances
    of the port's kernel tests: exact columns equal, bf16 columns
    within 1e-3 of the column's max, rate columns (Hz) rtol 1e-4 with
    a 1 mHz floor, state rtol 1e-4 (atol 1e-6; the rates as the rate
    columns, the carrier phase circular, the loop-filter memories 1e-3
    of their max). Raises on a violation; returns the margins: the bf16
    columns' error over their column max, and the rate and state errors
    over their tolerance."""
    tk, sk, tr, sr = (
        np.asarray(x.double().cpu() if hasattr(x, "double") else x,
                   dtype=np.float64) for x in (tk, sk, tr, sr))
    n_cols = tr.shape[-1]
    for k in (k for k in EXACT_COLS if k < n_cols):
        if not np.array_equal(tk[..., k], tr[..., k]):
            raise AssertionError(f"telemetry col {k} differs: "
                                 f"{np.abs(tk[..., k] - tr[..., k]).max()}")
    err = {"bf16_cols": 0.0, "rate_cols": 0.0, "state": 0.0}
    for k in (k for k in BF16_COLS if k < n_cols):
        scale = max(float(np.abs(tr[..., k]).max()), 1e-30)
        rel = float(np.abs(tk[..., k] - tr[..., k]).max()) / scale
        if rel >= 1e-3:
            raise AssertionError(f"telemetry col {k} differs by {rel} of "
                                 "the column max")
        err["bf16_cols"] = max(err["bf16_cols"], rel)
    for k in (k for k in RATE_COLS if k < n_cols):
        # the floor judges a carrier loop near 0 Hz, where ulps of its
        # discriminators are a large part of the rate itself
        ratio = float((np.abs(tk[..., k] - tr[..., k])
                       / (RATE_ATOL_HZ + 1e-4 * np.abs(tr[..., k]))).max())
        if ratio >= 1.0:
            raise AssertionError(f"telemetry col {k} differs "
                                 f"({ratio} x tol)")
        err["rate_cols"] = max(err["rate_cols"], ratio)
    for k in range(sr.shape[1]):
        a, b = sk[:, k], sr[:, k]
        if k == 1:                  # carrier phase in cycles: circular
            d = np.abs((a - b + 0.5) % 1.0 - 0.5)
        else:
            d = np.abs(a - b)
        if k in (2, 5):             # loop-filter memory: discriminators
            ratio = float(d.max()) / max(float(np.abs(b).max()), 1e-30) / 1e-3
        elif k in (0, 3):           # the rates, in Hz: as the columns
            ratio = float((d / (RATE_ATOL_HZ + 1e-4 * np.abs(b))).max())
        else:                       # rtol 1e-4, atol 1e-6
            ratio = float((d / (1e-6 + 1e-4 * np.abs(b))).max())
        if ratio >= 1.0:
            raise AssertionError(f"state col {k} differs ({ratio} x tol)")
        err["state"] = max(err["state"], ratio)
    err["corr_max_abs"] = float(np.abs(tk[..., CORR_COLS]
                                       - tr[..., CORR_COLS]).max())
    return err


def open_loop_compare(torch, args, kw, layout="mxu"):
    """The CUDA kernel against its plain version, open loop. The kernel
    runs the block once, and once more for each prefix of 2K epochs to
    give its state at every second superstep boundary; from each such
    state the plain version runs the next two supersteps, and their
    telemetry and end state are held to the kernel's (``compare``).
    Both sides thus start every piece from the same state: the f32
    correlation sums, which the two add in different orders, differ by
    ulps, and through the closed loops of a whole block such an ulp can
    become an E/P/L pick one sample apart. Returns (kernel telemetry,
    kernel state, the largest margins over the pieces)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    kernel, plain = {
        "mxu": (fused.track_block_fused_mxu,
                fused.track_block_fused_mxu_reference),
        "direct": (fused.track_block_fused_direct,
                   fused.track_block_fused_direct_reference)}[layout]
    k, t_all = kw["k_epochs"], kw["t_epochs"]
    tk, sk = kernel(*args, **kw)
    st, err = args[4], {}
    for e0 in range(0, t_all, 2 * k):
        e1 = e0 + 2 * k
        if e1 < t_all:
            tp, s_next = kernel(*args, **dict(kw, t_epochs=e1))
            # the kernel is deterministic: a prefix repeats the block
            assert torch.equal(tp, tk[:e1]), f"prefix {e1} differs"
        else:
            s_next = sk
        tr, sr = plain(
            *args[:4], st, **dict(kw, t_epochs=2 * k),
            first_superstep=e0 // k)
        for name, v in compare(tk[e0:e1], s_next, tr, sr).items():
            err[name] = max(err.get(name, 0.0), v)
        st = s_next
    torch.cuda.synchronize()
    return tk, sk, err


def phase_kernel_check(torch):
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    variants = {
        "power": {},
        "costas": dict(lock_mode="costas"),
        "forced_death": dict(lock_threshold=1e12, max_lost_epochs=7),
    }
    max_abs = 0.0
    for name, cfg_kw in variants.items():
        ft, args, kw = full_width_inputs(torch, "cuda", cfg_kw)
        assert (ft.wp, ft.n_rows) == (2560, 8)
        assert args[0].shape[0] == 1_047_552
        before = fused.launch_count
        tk, sk, err = open_loop_compare(torch, args, kw)
        assert fused.launch_count == before + kw["t_epochs"] // (
            2 * kw["k_epochs"])
        active = sk[:, 7].cpu().numpy()
        if name == "forced_death":
            assert not active.any(), "forced death left a channel alive"
        else:
            assert active[:24].all() and not active[24:].any()
        max_abs = max(max_abs, err["corr_max_abs"])
        print(f"kernel vs plain, open loop [{name}, K={kw['k_epochs']}]: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()}))
    _, args, kw = full_width_inputs(torch, "cuda", {})
    max_abs = max(max_abs, edge_check(torch, args, kw))
    return max_abs


def prefetch_span(start, j, k_epochs, n0, wp, spread_cap=0):
    """The samples the mxu kernel (csrc/track_block_mxu.cu, stage_window
    and stage_slice) copies into shared memory for superstep ``j`` of a
    window that starts at ``start`` (an int or an integer tensor; B2:
    the shared base, with its ``spread_cap``): (origin, length, offset),
    the span [origin, origin + length) of the stream and the window's
    offset in it. The origin is the 4-sample (16-byte) floor of
    start + off_j, as a bulk copy needs; the kernel copies the span's
    first ``length // 4 * 4`` samples by TMA and the last 0-3 by plain
    loads, so the span ends where the window does. The receiver's starts
    and bases are 128-multiples (offset 0); the other residues come from
    direct callers of the wrapper."""
    g = start + (j * k_epochs * n0 // 128) * 128
    origin = (g // 4) * 4
    offset = g - origin
    span = ((k_epochs - 1) * n0 // 128) * 128 + wp
    return origin, offset + span + spread_cap, offset


def b2_chunk_reads(base, dc, j, e, lanes, *, k_epochs, n0, wp):
    """The stream samples B2 in lane clusters (B1's lane kernel,
    csrc/track_block_mxu.cu track_block_mxu_lanes, on starts[:C]) mixes
    for epoch ``e`` of superstep ``j`` over tile lanes ``lanes`` (one
    block's part [l0, l0 + width)), for a channel ``dc`` above the
    shared ``base``: lane l reads m = l + shift, less wp past the
    window's end (shift = rem_e + rem_j < 256 < wp, the roll), of the
    epoch's window at starts[c] + off_j + a_e, starts[c] = base + dc.
    Returns an int64 array."""
    kk = j * k_epochs * n0
    off_j = (kk // 128) * 128
    a_e = (e * n0 // 128) * 128
    shift = (e * n0 - a_e) + (kk - off_j)
    m = np.asarray(lanes, np.int64) + shift
    m = np.where(m >= wp, m - wp, m)
    return base + dc + off_j + a_e + m


def lane_row_samples(start, j, e, l0, w, *, k_epochs, n0, wp,
                     reach=256):
    """The stream samples B1's lane clusters stage into row ``e`` of a
    block's window rows for superstep ``j`` (csrc/track_block_mxu.cu
    stage_rows_windows), the block's part [l0, l0 + w) of a window that
    starts at ``start``: position b holds the epoch window's sample
    l0 - o + b (o the window's offset from its 16-byte floor), from
    b1 = o + wp - l0 on its sample b - b1 (the roll's wrap), for b in
    [0, o + w + reach). Returns (int64 samples, o, b1, the positions the
    bulk copies fill: a boolean array; the rest are plain loads)."""
    g0 = start + (j * k_epochs * n0 // 128) * 128
    o = g0 % 4
    ws = g0 + (e * n0 // 128) * 128
    nb = o + w + reach
    b1 = min(nb, o + wp - l0)
    b = np.arange(nb, dtype=np.int64)
    samples = np.where(b < b1, ws + l0 - o + b, ws + (b - b1))
    t1, h2, t2 = b1 // 4 * 4, min(nb, -(-b1 // 4) * 4), nb // 4 * 4
    bulk = (b < t1) | ((b >= h2) & (b < t2))
    return samples, o, b1, bulk


def edge_case(torch, args, kw, r):
    """B1's arguments with the same windows at starts moved to residue
    ``r`` mod 4: ``r`` samples put before the stream and added to every
    start, and the stream cut where the last superstep's window of the
    highest start ends (that start the last valid one). The state and
    replicas stay, so the kernel sees the same samples: the window copy
    starts 0-3 samples before its window and ends with plain loads of
    the last 0-3 samples (prefetch_span)."""
    sre, sim, starts, reps, st = args
    host = (np.asarray(kw["starts_host"]) + r).astype(np.int32)
    j_last = kw["t_epochs"] // kw["k_epochs"] - 1
    origin, length, _ = prefetch_span(
        int(host.max()), j_last, kw["k_epochs"], kw["n0"], kw["wp"])
    end = origin + length
    pad = sre.new_zeros(r)
    return ((torch.cat([pad, sre])[:end].contiguous(),
             torch.cat([pad, sim])[:end].contiguous(),
             starts.new_tensor(host), reps, st),
            dict(kw, starts_host=host))


def edge_check(torch, args, kw):
    """B1 at the window copy's alignment edges (edge_case, r = 0..3):
    against its plain version open loop, and equal bit for bit to the
    run on the unmoved stream. Returns the largest |error| of the
    correlations against the plain version."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    t0, s0 = fused.track_block_fused_mxu(*args, **kw)
    max_abs = 0.0
    for r in range(4):
        e_args, e_kw = edge_case(torch, args, kw, r)
        tk, sk, err = open_loop_compare(torch, e_args, e_kw)
        assert torch.equal(tk, t0) and torch.equal(sk, s0), r
        max_abs = max(max_abs, err["corr_max_abs"])
        print(f"kernel vs plain, open loop [starts at residue {r} mod 4, "
              f"stream cut at {e_args[0].shape[0]}, the last window's "
              "end]: " + json.dumps({k: float(f"{v:.3e}")
                                     for k, v in err.items()})
              + "; equal to the unmoved run bit for bit")
    return max_abs


def _timed_turns(torch, kernel, plain, plain_passes=PLAIN_PASSES,
                 kernel_passes=KERNEL_PASSES):
    """Times (ms) of ``kernel`` and ``plain`` (no-argument callables) in
    turns: plain, kernel, kernel, plain, the L2 flushed before each call.
    The kernel's launches are all queued before one synchronise, with
    events around each (the host prepares the next launch while the card
    runs this one, so each interval holds the kernel and not the host's
    work); the plain version runs one call at a time, its interval
    holding its many small kernels and the host work between them.
    ``plain_passes`` counts both of the plain version's turns together.
    Returns (kernel times, plain times, synced kernel times: the launch
    with the wrapper's host work before it, for comparison)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def time_kernel(passes):
        return _time_queued(torch, kernel, passes, flush)

    def time_synced(fn, passes):
        times = []
        for _ in range(passes):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return times

    for _ in range(3):
        kernel()
    plain()
    torch.cuda.synchronize()
    p1 = time_synced(plain, (plain_passes + 1) // 2)
    k1 = time_kernel(kernel_passes)
    k2 = time_kernel(kernel_passes)
    p2 = time_synced(plain, plain_passes // 2)
    return k1 + k2, p1 + p2, time_synced(kernel, kernel_passes)


def _time_queued(torch, kernel, passes, flush, head_start=True):
    """Times (ms) of ``passes`` calls of ``kernel`` queued back to back,
    CUDA events around each and ``flush`` zeroed before each (the 50 MB
    L2 evicted), one synchronise at the end. With ``head_start`` a spin
    kernel ahead of them holds the card until the host has queued every
    call, so an interval holds the card's work and not the host's work to
    launch it (which is the longer of the two for a kernel of tens of
    microseconds behind a Python wrapper)."""
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True))
              for _ in range(passes)]
    if head_start:
        torch.cuda._sleep(HEAD_START_CYCLES)
    for start, end in events:
        flush.zero_()
        start.record()
        kernel()
        end.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(end) for start, end in events]


def _bound(n_bytes, f32_ops, bf16_ops=0.0):
    """(bound ms, "bytes" or "operations"): the bytes over 3.35 TB/s
    against the operations over their peak rates."""
    t_bytes = n_bytes / H100_BYTES_S * 1e3
    t_ops = max(bf16_ops / H100_BF16_FLOPS, f32_ops / H100_F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def phase_timing(torch, layout="mxu"):
    _, args, kw = full_width_inputs(torch, "cuda", {}, layout=layout)
    res = kernel_timing(torch, layout, args, kw)
    if layout == "mxu":
        res["ptxas"] = mxu_ptxas()
    print(f"timing [{layout}] (ms per 500 ms block, 32 ch): " + json.dumps(
        {k: (round(v, 6) if isinstance(v, float) else v)
         for k, v in res.items()}))
    return res


def kernel_timing(torch, layout, args, kw, plain_passes=2 * PLAIN_PASSES):
    """B1's (``layout`` "mxu") or B3's ("direct") time per block on
    ``args``/``kw`` (_timed_turns: the L2 flushed, queued behind a head
    start), its plain version's, and the bound from this run's inputs."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    kernel_fn, plain_fn = {
        "mxu": (fused.track_block_fused_mxu,
                fused.track_block_fused_mxu_reference),
        "direct": (fused.track_block_fused_direct,
                   fused.track_block_fused_direct_reference)}[layout]
    ks, ps, k_sync = _timed_turns(torch, lambda: kernel_fn(*args, **kw),
                                  lambda: plain_fn(*args, **kw),
                                  plain_passes=plain_passes)

    # the least time for the same work, from this run's inputs and what
    # its data needs: only the lanes inside each processed epoch's mask
    # (n_t of them, telemetry cols 12 and 16) are mixed and correlated
    telem, st = kernel_fn(*args, **kw)
    r_rows = args[3].shape[1]
    lanes = float((telem[..., 12] * telem[..., 16]).double().sum())
    n_bytes = _nbytes(*args, telem, st)
    if layout == "mxu":
        bf16_ops = 2.0 * 2 * r_rows * lanes  # re and im rows x R: mul + add
        f32_ops = MIX_OPS_PER_LANE * lanes
    else:
        bf16_ops = 0.0
        f32_ops = DIRECT_OPS_PER_LANE * lanes
    bound, bound_by = _bound(n_bytes, f32_ops, bf16_ops)
    return dict(
        ms=statistics.median(ks), ms_min=min(ks), ms_max=max(ks),
        plain_ms=statistics.median(ps), plain_min=min(ps),
        plain_max=max(ps), ms_synced=statistics.median(k_sync),
        bound_ms=bound, bound_by=bound_by,
        bytes=n_bytes, mixed_lanes=lanes, bf16_ops=bf16_ops,
        f32_ops=f32_ops)


def phase_receiver(torch, device="cuda", n_blocks=E2E_BLOCKS):
    """The single-block receiver from a cold start, with each block's
    stage times."""
    sats, sig = _scene(n_blocks * BLOCK_MS / 1000.0)
    per_block = []                          # stage totals after each block

    def on_block(r):
        per_block.append((time.perf_counter(), {
            k: v.total_s for k, v in r.timers.stats.items()}))

    t0 = time.perf_counter()
    rx, _, launches = _run_receiver(torch, sats, sig, "single-block, cold",
                                    layout="mxu", on_block=on_block,
                                    device=device)
    if device == "cuda":
        assert launches["track_block_fused_mxu"] == n_blocks, launches
    prev_t, prev = t0, {}
    for b, (t, tot) in enumerate(per_block):
        print(f"  block {b}: wall {1e3 * (t - prev_t):.3f} ms, " + ", ".join(
            f"{k} {1e3 * (v - prev.get(k, 0.0)):.3f}"
            for k, v in sorted(tot.items())))
        prev_t, prev = t, tot
    return launches["track_block_fused_mxu"]


def phase_direct_check(torch):
    """Kernel B3 against its plain version at full width, open loop."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    variants = {
        "power": {},
        "costas": dict(lock_mode="costas"),
        "forced_death": dict(lock_threshold=1e12, max_lost_epochs=7),
    }
    max_abs = 0.0
    for name, cfg_kw in variants.items():
        ft, args, kw = full_width_inputs(torch, "cuda", cfg_kw,
                                         layout="direct")
        assert (ft.wp, ft.n_rows, ft.k_epochs) == (2560, 5, 10)
        assert args[3].dtype == torch.float32
        before = fused.direct_launch_count
        tk, sk, err = open_loop_compare(torch, args, kw, layout="direct")
        assert fused.direct_launch_count == before + kw["t_epochs"] // (
            2 * kw["k_epochs"])
        active = sk[:, 7].cpu().numpy()
        if name == "forced_death":
            assert not active.any(), "forced death left a channel alive"
        else:
            assert active[:24].all() and not active[24:].any()
        max_abs = max(max_abs, err["corr_max_abs"])
        print(f"direct kernel vs plain, open loop [{name}, "
              f"K={kw['k_epochs']}]: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()}))
    return max_abs


def phase_lean_check(torch):
    """B1's lean telemetry mode against its full mode on the same
    inputs: the columns it stores, the zeros elsewhere and the end
    state, bit for bit."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    for name, cfg_kw in {"power": {},
                         "costas": dict(lock_mode="costas")}.items():
        ft, args, kw = full_width_inputs(torch, "cuda", cfg_kw)
        tf, sf = fused.track_block_fused_mxu(*args, **kw)
        tl, sl = fused.track_block_fused_mxu(
            *args, **dict(kw, telem_mode="lean"))
        n = lean_equals_full(torch, tf, sf, tl, sl, kw["k_epochs"],
                             costas=name == "costas")
        print(f"lean vs full [{name}, K={kw['k_epochs']}]: {n} stored "
              f"values equal, the rest zero, end state equal")


def lean_equals_full(torch, tf, sf, tl, sl, k, costas):
    """B1's lean telemetry (tl, sl) against its full mode (tf, sf) on the
    same inputs at K = ``k``: the columns it stores, the zeros elsewhere
    and the end state, bit for bit. Returns the number of stored
    values."""
    torch.cuda.synchronize()
    even = slice(None) if costas else slice(None, None, 2)
    stored = torch.zeros_like(tl, dtype=torch.bool)
    stored[..., LEAN_EVERY + [16]] = True
    stored[::k, :, LEAN_ROW0] = True
    rows0 = stored[::k]                 # a view: writes reach stored
    rows0[even, :, LEAN_ROW0_EVEN] = True
    assert torch.equal(tl[..., LEAN_EVERY], tf[..., LEAN_EVERY])
    assert torch.equal(tl[..., 16], tf[..., 16] + 2.0 * tf[..., 7]
                       + 4.0 * tf[..., 15])
    assert torch.equal(tl[stored & (torch.arange(
        tl.shape[-1], device=tl.device) != 16)], tf[stored & (
            torch.arange(tf.shape[-1], device=tf.device) != 16)])
    assert not tl[~stored].any(), "lean mode stored an extra column"
    assert torch.equal(sl, sf), "lean and full end states differ"
    return int(stored.sum())


_SCENES: dict = {}


def _scene(seconds):
    """bench.py's 24-satellite scene, ``seconds`` long at 2.046 MHz
    (rendered once per length)."""
    from gnss_sdr_tpu_torch.models import SatelliteScenario, synthesize

    if seconds not in _SCENES:
        sats = scene_sats(SatelliteScenario)
        n = int(seconds * 1000 / BLOCK_MS) * BLOCK_MS * 2046
        t0 = time.perf_counter()
        sig = synthesize(sats, n, FS, noise_std=1.0, seed=3)
        print(f"scene: {seconds:.1f} s of signal, 24 satellites, rendered "
              f"in {time.perf_counter() - t0:.1f} s")
        _SCENES[seconds] = (sats, sig)
    return _SCENES[seconds]


def _launch_counts():
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    return {"track_block_fused_mxu": fused.launch_count,
            "_mxu_kernel_shared": fused.shared_launch_count,
            "track_block_fused_direct": fused.direct_launch_count,
            "epl_correlate_pallas": b5.launch_count,
            "track_block_fused": ep.windows_launch_count,
            "track_block_fused_seg": ep.seg_launch_count,
            "gather_segments": ep.gather_launch_count,
            "track_block_fused_resident": ep.resident_launch_count}


def _reset_launch_counts():
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    fused.reset_launch_count()
    ep.reset_launch_count()
    b5.reset_launch_count()


def _expect_launches(launches, **counts):
    """Each kernel's launches equal ``counts`` (0 where not named)."""
    want = {k: counts.pop(k, 0) for k in launches}
    assert not counts, f"unknown kernels {sorted(counts)}"
    assert launches == want, (launches, want)


def _run_receiver(torch, sats, sig, label, layout="auto", scan_blocks=1,
                  span_pipeline=False, on_block=None, device="cuda",
                  correlator="fused", source=None, rf_kw=None,
                  n_blocks=None, block_ms=BLOCK_MS, scan_graph=True,
                  mesh=None):
    """One receiver run from a cold start on ``sig`` (or ``source``):
    checks every PRN tracked within 40 Hz and all blocks processed;
    prints its real-time factor and stage shares. The launch counts are
    set to 0 just before the run and read just after. ``scan_graph``:
    the scanned tracker's CUDA graph (True) or its eager loop; ``mesh``:
    given to the receiver through its own ``_use_mesh`` before the run.
    Returns (receiver, summary with the run's wall time "wall_s" added,
    launches)."""
    from gnss_sdr_tpu_torch import AcqConfig, ReceiverConfig, RfConfig, \
        TrackConfig
    from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver

    if n_blocks is None:
        n_blocks = sig.size // (block_ms * 2046)
    rf = {"freq_if_hz": 0.0, "output_sample_rate_hz": FS, **(rf_kw or {})}
    rx = Receiver(
        ReceiverConfig(
            rf=RfConfig(**rf),
            acq=AcqConfig(),
            track=TrackConfig(n_channels=N_CHANNELS, correlator=correlator,
                              fused_layout=layout),
            block_ms=block_ms),
        source if source is not None else ArraySource(sig, FS),
        device=device, scan_graph=scan_graph)
    assert rx.device.type == device
    if mesh is not None:
        rx._use_mesh(mesh)
    _reset_launch_counts()                  # this path starts here
    t0 = time.perf_counter()
    summary = rx.run(on_block=on_block, scan_blocks=scan_blocks,
                     span_pipeline=span_pipeline)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    truth = {s.prn: s.doppler_hz for s in sats}
    errs = {c["prn"]: c["last_doppler_hz"] - truth[c["prn"]]
            for c in summary["channels"]}
    timing = summary["stage_timing"]
    # the top-level stages (a dotted name is a sub-step of its parent)
    total = sum(v["total_s"] for k, v in timing.items() if "." not in k)
    signal_s = (n_blocks * block_ms / 1000.0 if sig is None
                else sig.size / FS)
    path = (f"layout {rx.fused.layout}, wire {rx.fused.wire}"
            if rx.fused is not None else
            f"scanned tracker, {'graph' if scan_graph else 'eager'}")
    if mesh is not None:
        path += f", mesh {mesh.shape}"
    print(f"receiver [{label}: correlator {correlator}, {path}, "
          f"block_ms {block_ms}, scan_blocks {scan_blocks}, "
          f"span_pipeline {span_pipeline}]: "
          f"{signal_s:.1f} s of signal in {wall:.3f} s wall, real-time "
          f"factor {signal_s / wall:.2f}x; launches {json.dumps(launches)}; "
          f"track calls {timing['track']['calls']}")
    print("  stage totals (s): " + json.dumps(
        {k: v["total_s"] for k, v in timing.items()}))
    print("  stage shares: " + json.dumps(
        {k: round(v["total_s"] / total, 4) for k, v in timing.items()}))
    print("  max |doppler error| (Hz): "
          f"{max(abs(e) for e in errs.values()):.3f}")
    assert summary["tracked_prns"] == list(range(1, 25)), summary
    assert max(abs(e) for e in errs.values()) < 40.0, errs
    assert summary["blocks"] == n_blocks
    summary["wall_s"] = wall
    return rx, summary, launches


def settled_doppler(rx, n_epochs=SETTLED_EPOCHS):
    """Per PRN of a receiver's open channels, the mean Doppler (Hz) over
    the last ``n_epochs`` epochs of its carrier-frequency trace, where
    the loop's output of one superstep jitters by a few Hz."""
    return {t.prn: float(np.mean(t.carr_freq[-n_epochs:], dtype=np.float64))
            - rx.f_if for t in rx.telemetry.traces.values()
            if t.carr_freq.size}


def _submit_without_sync(torch, rx, sig, n_span=STEADY_SPAN):
    """One span of the pipelined submit path (window framing with the
    fresh blocks' upload, the codes, two chained submits) with the sync
    debug mode at "error": any wait for the card there raises. Runs in
    the main thread, with no collector."""
    ft = rx.fused
    block = BLOCK_MS * 2046
    blocks = []
    for b in range(n_span):
        x = sig[b * block:(b + 1) * block]
        blocks.append((np.ascontiguousarray(x.real, dtype=np.float32),
                       np.ascontiguousarray(x.imag, dtype=np.float32)))
    prn = np.asarray(rx.state.prn_idx).copy()
    rx._codes_for_prns(prn)                 # the codes cache, warm
    led = ft._led_from_state(rx.state)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        codes = rx._codes_for_prns(prn)
        sre, sim, _ = rx._advance_span_window(blocks)
        h1 = ft.submit_span(led, sre, sim, codes, n_span)
        sre, sim, _ = rx._advance_span_window(blocks)
        h2 = ft.submit_span(h1.led, sre, sim, codes, n_span)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    telems = ft.collect_span(h2)
    assert len(telems) == n_span
    print(f"submit path under sync debug mode 'error': 2 chained spans of "
          f"{n_span} blocks queued without a host sync")


def phase_steady(torch):
    """The steady-state receiver on the 24-satellite scene: (a) pipelined
    spans with the auto layout and wire, (b) synchronous spans against a
    single-block run of the same scene, (c) the direct layout."""
    sats, sig = _scene(STEADY_S)
    n_blocks = sig.size // (BLOCK_MS * 2046)
    rx_1, single, _ = _run_receiver(torch, sats, sig, "single-block")
    rx_a, sum_a, la = _run_receiver(torch, sats, sig, "a", scan_blocks=
                                    STEADY_SPAN, span_pipeline=True)
    rx_b, sum_b, lb = _run_receiver(torch, sats, sig, "b",
                                    scan_blocks=STEADY_SPAN)
    n_direct = int(DIRECT_S * 1000 / BLOCK_MS)
    sig_c = sig[:n_direct * BLOCK_MS * 2046]
    _, sum_c, lc = _run_receiver(torch, sats, sig_c, "c", layout="direct",
                                 scan_blocks=DIRECT_SPAN)
    assert (rx_a.fused.layout, rx_a.fused.wire) == ("mxu", "slim2")
    _expect_launches(la, track_block_fused_mxu=n_blocks)
    assert lb == la, lb
    _expect_launches(lc, track_block_fused_direct=n_direct)
    for s, n in ((sum_a, n_blocks), (sum_b, n_blocks), (sum_c, n_direct)):
        assert s["stage_timing"]["track"]["calls"] < n, s["stage_timing"]
    ch_1 = {c["prn"]: c for c in single["channels"]}
    ch_a = {c["prn"]: c for c in sum_a["channels"]}
    ch_b = {c["prn"]: c for c in sum_b["channels"]}
    # the two runs mix each window on another 128-sample grid (a span's
    # blocks sit 24 samples apart on it), so their bf16 roundings
    # differ and a few channels' closed loops take other E/P/L picks:
    # one superstep's held rate (the last Doppler) then parts by up to
    # 6-8 Hz between the runs, also in the plain version's two runs, and
    # its mean over 50 epochs by up to 1.14 Hz; over the last block
    # loops locked to the same carrier agree, by up to 0.31 Hz in the
    # plain version (tools/port_steady_probe.py, ROADMAP C10): that
    # mean is held per PRN
    settled_1 = settled_doppler(rx_1)
    settled_b = settled_doppler(rx_b)
    diff, last = {}, {}
    for prn in range(1, 25):
        assert ch_b[prn]["epochs"] == ch_1[prn]["epochs"], prn
        assert abs(ch_a[prn]["epochs"] - ch_b[prn]["epochs"]) <= 1, prn
        diff[prn] = abs(settled_b[prn] - settled_1[prn])
        last[prn] = abs(ch_b[prn]["last_doppler_hz"]
                        - ch_1[prn]["last_doppler_hz"])
    worst = max(diff, key=diff.get)
    assert diff[worst] < 1.0, diff
    print(f"steady (b) vs single-block: epochs equal for all 24 PRNs, "
          f"Doppler over the last block (mean of {SETTLED_EPOCHS} epochs) "
          f"within {diff[worst]:.4f} Hz for every PRN (PRN {worst}); last "
          f"held rate: median {statistics.median(last.values()):.4f} Hz, "
          f"largest {max(last.values()):.4f} Hz (PRN "
          f"{max(last, key=last.get)}); (a) epochs within 1 of (b)")
    _submit_without_sync(torch, rx_a, sig)
    return {"a": la, "b": lb, "c": lc}


B5_CASES = {
    # name: (signal, fs, interp)
    "gps_2046k": ("gps_l1ca", FS, False),
    "gps_2046k_interp": ("gps_l1ca", FS, True),
    "gps_4092k": ("gps_l1ca", 4_092_000.0, False),
    "e1b_8184k": ("galileo_e1b", 8_184_000.0, False),
    "e1b_8184k_interp": ("galileo_e1b", 8_184_000.0, True),
}


def b5_inputs(torch, signal, fs, n_epochs=1, seed=0, idle=8):
    """B5's arguments at the receiver's full width (32 channels) for
    ``signal`` at ``fs``: the window, shift and code table the scanned
    tracker gives it (TrackParams, make_code_table), noisy windows with
    the channel's code in them, random u32 carrier phases and steps,
    random chip phases near the nominal rate, and the receiver's epoch
    masks: n_t for the tracking channels, saturated for ``idle`` idle
    ones, and (with idle=0) partial masks 0, 1, 500 and n0 - 1. Returns
    (list of ``n_epochs`` argument tuples on the card, statics)."""
    from gnss_sdr_tpu_torch.config import TrackConfig
    from gnss_sdr_tpu_torch.models import get_signal
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    spec = get_signal(signal)
    params = trk.TrackParams.create(TrackConfig(), spec, fs)
    n0, w = spec.samples_per_code(fs), params.window
    codes = torch.from_numpy(trk.make_code_table(spec, N_CHANNELS)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_valid = torch.full((N_CHANNELS,), n0, dtype=torch.int32)
    if idle:
        n_valid[-idle:] = 2 ** 31 - 1
    else:
        n_valid[-4:] = torch.tensor([0, 1, 500, n0 - 1], dtype=torch.int32)
    n_valid = n_valid.cuda()
    c = N_CHANNELS
    rate = 1.023e6 + 3.0 * torch.randn(c, generator=gen, device="cuda")
    cps = (rate.float() * float(np.float32(1.0) / np.float32(fs)))
    out = []
    for _ in range(n_epochs):
        def u32():
            return torch.randint(0, 2 ** 32, (c,), generator=gen,
                                 device="cuda", dtype=torch.int64)
        chip_int = torch.randint(0, spec.code_length_chips, (c,),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
        chip_frac = torch.rand(c, generator=gen, device="cuda")
        # windows: unit noise plus each channel's code at 0.5, so the
        # prompt sums carry signal as in tracking
        idx = torch.remainder(
            (chip_int.double()[:, None] * params.oversample
             + torch.arange(w, device="cuda")[None, :].double()
             * cps.double()[:, None] * params.oversample).long(),
            codes.shape[1])
        sig = 0.5 * torch.gather(codes, 1, idx)
        re = (sig + torch.randn(c, w, generator=gen, device="cuda"))
        im = torch.randn(c, w, generator=gen, device="cuda")
        out.append((re.contiguous(), im.contiguous(), n_valid, u32(), u32(),
                    chip_int, chip_frac, cps.contiguous(), codes))
    return out, dict(shift=params.el_shift, oversample=params.oversample,
                     n0=n0, window=w)


def _b5_bound(args, n_epochs):
    """(bound ms, "bytes" or "operations", bytes, ops) of ``n_epochs``
    B5 launches on inputs like ``args``: each input read once and the
    [C, 6] sums written once, over 3.35 TB/s; the in-mask lanes' f32
    operations over 67 TFLOP/s."""
    re, n_valid = args[0], args[2]
    n_bytes = sum(x.numel() * x.element_size() for x in args) \
        + re.shape[0] * 6 * 4
    lanes = float(n_valid.clamp(0, re.shape[1]).double().sum())
    ops = B5_OPS_PER_LANE * lanes
    t_bytes = n_epochs * n_bytes / H100_BYTES_S * 1e3
    t_ops = n_epochs * ops / H100_F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", n_epochs * n_bytes, n_epochs * ops)


def b5_block_form(torch, args, seed=0, gap=37):
    """The [C, W] windows of B5 arguments ``args`` placed in one sample
    block in a shuffled order, ``gap`` noise samples apart (the first
    window at the block's start, the last at its end): (block_re,
    block_im, starts int32, the largest start allowed)."""
    re, im = args[0], args[1]
    c, w = re.shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    order = torch.randperm(c, generator=gen, device="cuda")
    n = c * w + (c - 1) * gap
    block_re = torch.randn(n, generator=gen, device="cuda")
    block_im = torch.randn(n, generator=gen, device="cuda")
    starts = torch.empty(c, dtype=torch.int32, device="cuda")
    starts[order] = (torch.arange(c, device="cuda") * (w + gap)).to(
        torch.int32)
    idx = starts.long()[:, None] + torch.arange(w, device="cuda")
    block_re[idx] = re
    block_im[idx] = im
    return block_re, block_im, starts, n - w


def phase_b5_check(torch):
    """B5 against its plain version on the card, every case of B5_CASES
    with the idle masks and with the partial masks; the block-reading
    entry equal to the [C, W] entry bit for bit on the same windows
    placed in a block."""
    from gnss_sdr_tpu_torch.ops import correlator as corr
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    fields = ("i_e", "q_e", "i_p", "q_p", "i_l", "q_l")
    max_abs = 0.0
    for name, (signal, fs, interp) in B5_CASES.items():
        for idle in (8, 0):
            (args,), st = b5_inputs(torch, signal, fs, seed=len(name) + idle,
                                    idle=idle)
            kw = dict(shift=st["shift"], oversample=st["oversample"],
                      interp=interp)
            before = b5.launch_count
            got = b5.epl_correlate_pallas(*args, **kw)
            block_re, block_im, starts, max_start = b5_block_form(
                torch, args, seed=idle)
            from_block = b5.epl_correlate_block(
                block_re, block_im, starts, *args[2:], window=st["window"],
                max_start=max_start, **kw)
            torch.cuda.synchronize()
            assert b5.launch_count == before + 2
            for f in fields:
                assert torch.equal(getattr(from_block, f),
                                   getattr(got, f)), (name, f)
            ref = corr.epl_correlate_one_shift(*args, **kw)
            assert b5.launch_count == before + 2   # the plain never counts
            rel = {}
            for f in fields:
                a, b = getattr(got, f).double(), getattr(ref, f).double()
                d = float((a - b).abs().max())
                max_abs = max(max_abs, d)
                rel[f] = d / max(float(b.abs().max()), 1e-30)
            print(f"B5 vs plain [{name}, W={st['window']}, shift "
                  f"{st['shift']}, os {st['oversample']}, "
                  f"{'idle' if idle else 'partial'} masks]: "
                  + json.dumps({k: float(f"{v:.3e}") for k, v in rel.items()}))
            assert max(rel.values()) < B5_TOL, (name, rel)
    print("B5 block entry: equal to the [C, W] entry bit for bit in every "
          "case")
    return max_abs


def phase_b5_timing(torch):
    """B5 at the operating point (32 channels, 2.046 MHz, 24 tracking and
    8 idle masks), through the block-reading entry the tracker calls:
    per launch and per 500 ms block (501 launches), each launch on fresh
    inputs with the L2 flushed before it; the plain version's time; the
    bound (the windows' bytes, not the block's). A launch of B5 is
    shorter than the wrapper's host work, so events around it would also
    hold the card's wait for the host: the kernel's own time is the
    profiler's device time of the kernel, summed over the block's
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from gnss_sdr_tpu_torch.ops import correlator as corr
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    t_epochs = BLOCK_MS + 1
    inputs, st = b5_inputs(torch, "gps_l1ca", FS, n_epochs=t_epochs, seed=7)
    kw = dict(shift=st["shift"], oversample=st["oversample"])
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    # the kernel as the tracker calls it: windows read from a block
    blocks = [b5_block_form(torch, args, seed=k)
              for k, args in enumerate(inputs)]

    def kernel(k):
        block_re, block_im, starts, max_start = blocks[k]
        return b5.epl_correlate_block(
            block_re, block_im, starts, *inputs[k][2:], window=st["window"],
            max_start=max_start, **kw)

    def plain(k):
        return corr.epl_correlate_one_shift(*inputs[k], **kw)

    def timed(fn):
        """Events around each call (the plain version: its interval holds
        its many small kernels and the host work between them)."""
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in inputs]
        for k, (start, end) in enumerate(events):
            flush.zero_()                    # evict the 50 MB L2
            start.record()
            fn(k)
            end.record()
        torch.cuda.synchronize()
        return [start.elapsed_time(end) for start, end in events]

    def profiled():
        """The kernel's device time per launch (ms), from the profiler."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(t_epochs):
                flush.zero_()
                kernel(k)
            torch.cuda.synchronize()
        per = [e for e in prof.key_averages()
               if "epl_correlator_kernel" in e.key]
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in per)
        n = sum(e.count for e in per)
        return us / 1e3, n

    def profiled_whole():
        """A profiled pass that saw all of the block's launches: a pass
        whose trace lost some of them (the profiler's activity buffer can
        drop events) is taken again, twice at most. Returns (ms, passes
        taken)."""
        for tries in range(1, 4):
            ms, n = profiled()
            if n == t_epochs and ms > 0:
                return ms, tries
        raise AssertionError(f"the profiler saw {n} of {t_epochs} B5 "
                             f"launches ({ms} ms) in 3 passes")

    for k in range(3):
        kernel(k)
        plain(k)
    torch.cuda.synchronize()
    # in turns: plain, kernel, kernel, plain
    p1 = timed(plain)
    k1_ms, k1_tries = profiled_whole()
    k2_ms, k2_tries = profiled_whole()
    p2 = timed(plain)
    ev = timed(kernel)
    # the host's side: 501 launches back to back, wall clock to the sync
    t0 = time.perf_counter()
    for k in range(t_epochs):
        kernel(k)
    torch.cuda.synchronize()
    wall_block = (time.perf_counter() - t0) * 1e3
    bound, bound_by, n_bytes, ops = _b5_bound(inputs[0], t_epochs)
    res = dict(
        ms=(k1_ms + k2_ms) / 2, ms_passes=[k1_ms, k2_ms],
        profiled_tries=[k1_tries, k2_tries],
        ms_per_launch=(k1_ms + k2_ms) / 2 / t_epochs,
        events_ms_per_launch_median=statistics.median(ev),
        plain_ms=(sum(p1) + sum(p2)) / 2,
        plain_ms_per_launch=statistics.median(p1 + p2),
        wall_ms_per_block_back_to_back=wall_block,
        bound_ms=bound, bound_by=bound_by, bytes=n_bytes, f32_ops=ops)
    print(f"timing [B5] (ms per 500 ms block = {t_epochs} launches, 32 ch): "
          + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in res.items()}))
    return res


_RUN_ONLY = ("stage_timing", "wall_s")


def _same_run(label, a, b, what="graph and eager runs"):
    """Two receiver runs ``a``, ``b`` = (receiver, summary) gave the same
    telemetry, bit for bit, and the same summary (but for its timing)."""
    from gnss_sdr_tpu_torch.utils.telemetry import _FIELDS

    ta, tb = a[0].telemetry.all_traces(), b[0].telemetry.all_traces()
    assert [t.prn for t in ta] == [t.prn for t in tb], label
    for x, y in zip(ta, tb):
        for f in _FIELDS:
            assert (np.asarray(getattr(x, f)).tobytes()
                    == np.asarray(getattr(y, f)).tobytes()), (label, x.prn, f)

    def plain(summary):
        return json.dumps({k: v for k, v in summary.items()
                           if k not in _RUN_ONLY}, sort_keys=True, default=str)
    assert plain(a[1]) == plain(b[1]), label
    print(f"{label}: {what} equal: {len(ta)} traces bit for bit, "
          "summaries equal")


def _close_tree(label, a, b, path=""):
    """Two summaries equal but for their floats, which agree within 1e-4
    relative with a 1e-3 floor (the kernel tests' rate tolerance)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (label, path)
        for k in a:
            _close_tree(label, a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        assert len(a) == len(b), (label, path)
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(label, x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)):
        assert abs(float(a) - float(b)) <= (RATE_ATOL_HZ
                                            + 1e-4 * abs(float(b))), \
            (label, path, a, b)
    else:
        assert a == b, (label, path, a, b)


_SUM_FIELDS = ("i_p", "q_p", "i_e", "q_e", "i_l", "q_l")


def _same_run_but_tail(label, a, b, tail_from, what):
    """Two receiver runs ``a``, ``b`` = (receiver, summary): every epoch
    that starts before sample ``tail_from`` (the fused kernel's) equal
    bit for bit; the later ones (the partial tail block's, through the
    scanned tracker) with the same epochs and lock flags, the
    correlation sums within 1e-3 of the trace's largest |i_p| and the
    rates within the kernel tests' rate tolerance, and the summaries as
    _close_tree. Returns the tail's largest deviations."""
    from gnss_sdr_tpu_torch.utils.telemetry import _FIELDS

    ta, tb = a[0].telemetry.all_traces(), b[0].telemetry.all_traces()
    assert [t.prn for t in ta] == [t.prn for t in tb], label
    worst = {"sums_rel": 0.0, "rates_over_tol": 0.0, "epochs_differing": 0}
    for x, y in zip(ta, tb):
        gs = np.asarray(x.global_sample)
        assert gs.tobytes() == np.asarray(y.global_sample).tobytes(), \
            (label, x.prn)
        head = gs < tail_from
        for f in _FIELDS:
            u, v = np.asarray(getattr(x, f)), np.asarray(getattr(y, f))
            assert u[head].tobytes() == v[head].tobytes(), (label, x.prn, f)
            if f in ("epoch_index", "locked"):
                assert u[~head].tobytes() == v[~head].tobytes(), \
                    (label, x.prn, f)
        if not (~head).any():
            continue
        scale = max(float(np.abs(np.asarray(y.i_p)).max()), 1e-30)
        diff = np.zeros(int((~head).sum()), bool)
        for f in _SUM_FIELDS:
            u = np.asarray(getattr(x, f), np.float64)[~head]
            v = np.asarray(getattr(y, f), np.float64)[~head]
            diff |= u != v
            worst["sums_rel"] = max(worst["sums_rel"],
                                    float(np.abs(u - v).max()) / scale)
        for f in ("carr_freq", "code_rate"):
            u = np.asarray(getattr(x, f), np.float64)[~head]
            v = np.asarray(getattr(y, f), np.float64)[~head]
            diff |= u != v
            worst["rates_over_tol"] = max(worst["rates_over_tol"], float(
                (np.abs(u - v) / (RATE_ATOL_HZ + 1e-4 * np.abs(v))).max()))
        worst["epochs_differing"] += int(diff.sum())
    assert worst["sums_rel"] < 1e-3 and worst["rates_over_tol"] <= 1.0, \
        (label, worst)

    def plain(summary):
        return {k: v for k, v in summary.items() if k not in _RUN_ONLY}
    _close_tree(label, plain(a[1]), plain(b[1]))
    print(f"{label}: {what}: {len(ta)} traces, the epochs before sample "
          f"{tail_from} bit for bit; the tail within tolerance "
          f"({json.dumps(worst)}); summaries within it")
    return worst


def _profile(torch, fn):
    """``fn()`` under the profiler, then a synchronise: the wall time (ms,
    profiler on), the device's kernels (count and summed device ms, B5's
    among them) and the host's launch calls by name (cudaGraphLaunch,
    cudaLaunchKernel and their kin)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    res = dict(wall_ms=wall * 1e3, kernels=0, kernel_ms=0.0, b5_kernels=0,
               b5_ms=0.0, host_calls={})
    for e in prof.key_averages():
        name = e.key
        if name.startswith(("cudaGraphLaunch", "cuGraphLaunch",
                            "cudaLaunchKernel", "cuLaunchKernel")):
            res["host_calls"][name] = res["host_calls"].get(name, 0) + e.count
        elif (str(e.device_type).endswith("CUDA")
              and not name.startswith(("Memcpy", "Memset"))):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            res["kernels"] += e.count
            res["kernel_ms"] += us / 1e3
            if "epl_correlator_kernel" in name:
                res["b5_kernels"] += e.count
                res["b5_ms"] += us / 1e3
    res["host_launch_calls"] = sum(res["host_calls"].values())
    res["busy_share"] = res["kernel_ms"] / res["wall_ms"]
    return res


def _scan_run(torch, sats, sig, label, correlator, scan_graph, **kw):
    """One scanned receiver run (_run_receiver) with its first two blocks
    apart from the rest: on the graph path the first block is the eager
    warm-up and the second the capture and a replay, where this run's
    key is new. Reports each one's ``track`` seconds, the later blocks'
    per block, the whole run's real-time factor and the later blocks'
    (from the on_block marks), and the key's warm-up and capture
    seconds. Returns (receiver, summary, launches, stats)."""
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    marks = []
    logged = set(trk.GRAPH_LOG)
    rx, summary, launches = _run_receiver(
        torch, sats, sig, label, correlator=correlator,
        scan_graph=scan_graph, on_block=lambda r: marks.append(
            (time.perf_counter(), r.timers.stats["track"].total_s)), **kw)
    n = len(marks)
    track = summary["stage_timing"]["track"]["total_s"]
    block_s = BLOCK_MS / 1000.0
    stats = dict(
        wall_s=summary["wall_s"], rtf=n * block_s / summary["wall_s"],
        block1_track_s=marks[0][1],
        block2_track_s=marks[1][1] - marks[0][1],
        later_track_s_per_block=(track - marks[1][1]) / (n - 2),
        later_rtf=(n - 2) * block_s / (marks[-1][0] - marks[1][0]))
    new = [k for k in trk.GRAPH_LOG if k not in logged]
    if new:
        stats["graph"] = trk.GRAPH_LOG[new[-1]]
    print(f"  [{label}, {correlator}, {'graph' if scan_graph else 'eager'}] "
          + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in stats.items()}))
    return rx, summary, launches, stats


def scan_graph_vs_eager(torch, correlator, sats, sig, n_full=3, tail_ms=200):
    """The scanned tracker's CUDA graph against its eager loop on the
    card, bit for bit in the [13, C] state and the 17 telemetry fields:
    ``n_full`` 500 ms blocks and then a tail of ``tail_ms`` valid ms
    through the same graph, each pair from the same ledger (the scene's
    first 32 satellites started on their code boundaries), the graph
    calls after the second (the first two warm up and capture, where the
    key is new) with the sync debug mode at "error". B5's launches are
    counted from the replays (501 per block with "pallas"). Returns the
    number of blocks compared."""
    from gnss_sdr_tpu_torch.config import AcqConfig, TrackConfig
    from gnss_sdr_tpu_torch.models import GPS_L1CA
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5
    from gnss_sdr_tpu_torch.receiver import tracking as trk
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    n0 = GPS_L1CA.samples_per_code(FS)
    block = BLOCK_MS * n0
    t_epochs = BLOCK_MS + 1
    params = trk.TrackParams.create(
        TrackConfig(n_channels=N_CHANNELS, correlator=correlator), GPS_L1CA,
        FS)
    history = AcquisitionEngine(AcqConfig(), GPS_L1CA, FS,
                                device="cpu").samples_needed + 2 * n0
    assert sig.size >= history + (n_full + 1) * block, sig.size
    st = trk.init_state(N_CHANNELS)
    for ch, s in enumerate(sats[:N_CHANNELS]):
        off = int(round((1023.0 - s.code_phase_chips) % 1023.0
                        * FS / GPS_L1CA.code_rate_hz))
        st = trk.start_channel(st, ch, s.prn - 1, s.doppler_hz, off,
                               GPS_L1CA.code_rate_hz)
    codes = torch.from_numpy(trk.make_code_table(GPS_L1CA, 32)[
        np.maximum(st.prn_idx, 0)]).cuda()
    per_replay = t_epochs if correlator == "pallas" else 0
    graphs = set()
    for k in range(n_full + 1):
        x = sig[k * block:k * block + history + block]
        re = torch.from_numpy(np.ascontiguousarray(x.real,
                                                   dtype=np.float32)).cuda()
        im = torch.from_numpy(np.ascontiguousarray(x.imag,
                                                   dtype=np.float32)).cuda()
        valid = None if k < n_full else history + tail_ms * n0
        eager = trk.track_block_device(params, codes, st, re, im, t_epochs,
                                       valid, graph=False)
        before = b5.launch_count
        torch.cuda.synchronize()
        if k >= 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            replay = trk.track_block_device(params, codes, st, re, im,
                                            t_epochs, valid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # the tail block too replays the graph of its key
        graphs.add(trk._GRAPHS[trk.graph_key(params, codes, st, re,
                                             t_epochs)])
        assert b5.launch_count - before == per_replay
        assert torch.equal(replay, eager), (correlator, k)
        end, tl = trk.unpack_block(replay, N_CHANNELS, t_epochs)
        assert tl.processed.any(axis=0)[:len(sats)].all(), (correlator, k)
        st = trk.rebase(end, block)
    (g,) = graphs
    assert g.graph is not None and g.key in trk.GRAPH_LOG
    print(f"scanned tracker graph vs eager [{correlator}]: {n_full} blocks "
          f"and a {tail_ms} ms tail on the same graph equal bit for bit "
          "(state and 17 telemetry fields); blocks 3 on under sync debug "
          f"mode 'error'; B5 launches counted from the replays: {per_replay} "
          "per block")
    return n_full + 1


def phase_scan_receiver(torch):
    """The scanned receiver at the operating point, cold start, 5 s:
    correlator="pallas" through B5 and the default "shift", each on its
    eager loop and on its CUDA graph (first block apart), the two runs'
    telemetry equal; one block of each profiled (host launch calls,
    device kernels, busy share); the graph against the eager loop block
    by block, bit for bit, with a tail block on the same graph."""
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    sats, sig = _scene(SCAN_S)
    n_blocks = sig.size // (BLOCK_MS * 2046)
    t_epochs = BLOCK_MS + 1
    out = {}
    for correlator in ("pallas", "shift"):
        runs = {}
        for graph in (False, True):
            rx, summary, launches, stats = _scan_run(
                torch, sats, sig, "scan", correlator, graph)
            _expect_launches(launches, epl_correlate_pallas=(
                n_blocks * t_epochs if correlator == "pallas" else 0))
            codes = rx._codes_for_state()
            prof = _profile(torch, lambda: trk.track_block(
                rx.params, codes, rx.state, rx.window.re, rx.window.im,
                t_epochs, valid_len=rx.history + rx.block, graph=graph))
            assert prof["b5_kernels"] == (t_epochs if correlator == "pallas"
                                          else 0), prof
            stats["profiled_block"] = prof
            print(f"  profiled block [{correlator}, "
                  f"{'graph' if graph else 'eager'}]: wall "
                  f"{prof['wall_ms']:.3f} ms (profiler on), host launch "
                  f"calls {prof['host_launch_calls']} "
                  f"{json.dumps(prof['host_calls'])}, device kernels "
                  f"{prof['kernels']} ({prof['kernels'] / t_epochs:.1f} per "
                  f"epoch) {prof['kernel_ms']:.3f} ms, busy share "
                  f"{prof['busy_share']:.4f}, B5 {prof['b5_kernels']} "
                  f"kernels {prof['b5_ms']:.3f} ms")
            runs[graph] = (rx, summary, launches, stats)
        _same_run(f"scanned receiver [{correlator}]", runs[False][:2],
                  runs[True][:2])
        assert runs[True][3]["profiled_block"]["host_launch_calls"] <= 10
        out[correlator] = runs
    ch_p = {c["prn"]: c for c in out["pallas"][True][1]["channels"]}
    ch_s = {c["prn"]: c for c in out["shift"][True][1]["channels"]}
    worst = max(abs(ch_p[p]["last_doppler_hz"] - ch_s[p]["last_doppler_hz"])
                for p in range(1, 25))
    print(f"pallas vs shift receiver: |Doppler difference| <= {worst:.4f} Hz")
    for correlator in ("pallas", "shift"):
        scan_graph_vs_eager(torch, correlator, sats, sig)
    return out


def phase_if_capture(torch):
    """The IF capture at full width: an int8 real file (16.368 MHz, 4.092
    MHz IF), DC removal on, mixed and decimated 4x on the card, 24
    satellites, 32 channels, 500 ms blocks, correlator="pallas"."""
    import tempfile

    from gnss_sdr_tpu_torch.models import (SatelliteScenario,
                                           synthesize_real_if_int8)
    from gnss_sdr_tpu_torch.receiver import FileSource

    sats = scene_sats(SatelliteScenario)
    n = int(IF_S * FS_IF_IN)
    t0 = time.perf_counter()
    raw = synthesize_real_if_int8(sats, n, FS_IF_IN, F_IF, noise_std=1.0,
                                  scale=20.0, seed=5)
    print(f"IF capture: {IF_S} s of int8 real samples at {FS_IF_IN:g} Hz, "
          f"IF {F_IF:g} Hz, rendered in {time.perf_counter() - t0:.1f} s")
    n_blocks = IF_S * 1000 // BLOCK_MS
    runs = {}
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/capture.bin"
        with open(path, "wb") as f:
            f.write(raw.tobytes())
        for graph in (False, True):
            src = FileSource(path, FS_IF_IN, "int8_real")
            try:
                rx, summary, launches, stats = _scan_run(
                    torch, sats, None, "IF capture", "pallas", graph,
                    source=src, n_blocks=n_blocks,
                    rf_kw=dict(freq_if_hz=F_IF, output_sample_rate_hz=F_IF,
                               enable_dc_removal=True, enable_mixing=True,
                               decimation=IF_DECIM))
            finally:
                src.close()
            assert rx.fs == FS_IF_IN / IF_DECIM and rx.f_if == 0.0
            assert launches["epl_correlate_pallas"] == n_blocks * (
                BLOCK_MS + 1)
            runs[graph] = (rx, summary, launches, stats)
    _same_run("IF capture", runs[False][:2], runs[True][:2])
    return runs


def phase_fused_tail(torch):
    """The fused receiver on 3 full blocks and a 200 ms partial one: B1
    runs the full blocks, the scanned tracker (slice correlator) the
    tail, whose epochs are processed."""
    sats, sig = _scene(SCAN_S)
    block = BLOCK_MS * 2046
    n_full = 3
    tail = sig[:n_full * block + 200 * 2046]
    runs = {}
    for graph in (False, True):
        rx, summary, launches = _run_receiver(
            torch, sats, tail, "fused tail", n_blocks=n_full + 1,
            scan_graph=graph)
        _expect_launches(launches, track_block_fused_mxu=n_full)
        ends = [int(t.global_sample[-1]) for t in rx.telemetry.all_traces()]
        assert min(ends) >= n_full * block, ends
        runs[graph] = (rx, summary, launches)
    _same_run("fused receiver, partial tail", runs[False][:2],
              runs[True][:2])
    print(f"fused receiver, partial tail: {summary['blocks']} blocks, the "
          f"tail's epochs processed (last epoch starts >= sample "
          f"{min(ends)}, full blocks end at {n_full * block})")
    return runs


# ---------------------------------------------------------------------------
# the per-epoch layouts: B4a (windows), B4b (seg) fed by B4c, B6 (resident)
# ---------------------------------------------------------------------------

def epoch_inputs(torch, feed, cfg_kw, device="cuda", block_ms=None):
    """Full-width inputs of one per-epoch kernel through FusedTracker's
    own re-anchor (the 24-satellite ledger of full_width_inputs, 8 idle
    channels): "windows" (B4a, 500 ms blocks, the windows cut by
    slice_windows), "seg" (B4b, 125 ms blocks, the segments made by B4c's
    plain version) or "resident" (B6 on the windows run's stream, the
    channels' offsets in state col 9, replicas from
    build_replicas_shared). Returns a dict: "args" and "kw" of the
    kernel, "ft"; for seg "gather" (B4c's args and kw); for resident
    "windows" (B4a's args and kw on the same stream)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    if block_ms is None:
        block_ms = SEG_BLOCK_MS if feed == "seg" else WINDOWS_BLOCK_MS
    ft, (sre, sim, starts, reps, mat), kw, rows = _full_width(
        torch, device, cfg_kw, N_CHANNELS, block_ms,
        "seg" if feed == "seg" else "windows")
    host = kw.pop("starts_host")
    if feed == "seg":
        gather = ((sre, sim, starts, ft.l_seg), dict(starts_host=host))
        seg_re, seg_im = fused.gather_segments_reference(*gather[0],
                                                         **gather[1])
        return dict(ft=ft, args=(seg_re, seg_im, reps, mat), kw=kw,
                    gather=gather)
    wre, wim = fused.slice_windows(sre, sim, host, ft.t_epochs, ft.n0,
                                   ft.wp, ft.el_pad)
    out = dict(ft=ft, args=(wre, wim, reps, mat), kw=kw)
    if feed == "windows":
        return out
    return dict(resident_inputs(torch, ft, (sre, sim), host, rows, reps,
                                mat, kw, FS),
                windows=(out["args"], out["kw"]))


def resident_inputs(torch, ft, stream, host, rows, reps, mat, kw, fs):
    """B6's inputs on a windows tracker's block (``ft``, the stream, the
    channels' host offsets, their code rows, replica rows, state and
    kernel kw at rate ``fs``): one double-length window per epoch (+256:
    the alignment residue), the offsets in state col 9, the replicas from
    build_replicas_shared. Returns {"ft", "args", "kw"}."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    n0, c, device = ft.n0, mat.shape[0], mat.device
    wp = ((2 * n0 + 256 + 127) // 128) * 128
    need = 3 * n0 + wp + 2 * ft.el_pad
    codes4x = rows[:, :n0].repeat(1, -(-need // n0))[:, :need].contiguous()
    # every channel starts on a code boundary: chip phase 0, anchor 0 (the
    # windows run's frac0 is 0 too)
    cps = float(np.float32(1.023e6) * (np.float32(1.0) / np.float32(fs)))
    reps_sh = fused.build_replicas_shared(
        codes4x, torch.zeros(c, device=device),
        torch.full((c,), cps, device=device), host, ft.params.el_shift,
        n0, wp, n_drift=reps.shape[1]).contiguous()
    st = mat.clone()
    st[:, 9] = torch.from_numpy(host.astype(np.float32)).to(device)
    return dict(ft=ft, args=(*stream, reps_sh, st),
                kw=dict(kw, t_epochs=ft.t_epochs, k_epochs=RESIDENT_K, wp=wp))


def _epoch_fns(feed):
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    return {"windows": (fused.track_block_fused,
                        fused.track_block_fused_reference),
            "seg": (fused.track_block_fused_seg,
                    fused.track_block_fused_seg_reference),
            "resident": (fused.track_block_fused_resident,
                         fused.track_block_fused_resident_reference),
            "direct": (fused.track_block_fused_direct,
                       fused.track_block_fused_direct_reference)}[feed]


def epoch_window_origin(feed, t, *, n0, wp, c=0, c_channels=1, l_seg=0,
                        k_chunk=1, start=0, k_epochs=1):
    """The sample of a feed's array at which epoch ``t``'s window of
    channel ``c`` starts, as the per-epoch kernels' feeds compute it
    (origin() in csrc/track_block_epoch.cu and csrc/track_block_direct.cu):
    windows row (t, c) of [T, C, wp]; seg row c of [C, l_seg] at the
    128-floor of t*n0; resident chunk t // k_chunk of the stream (at
    t // k_chunk * k_chunk * n0) at the 128-floor of (t % k_chunk)*n0
    within it; direct epoch e of superstep j (t = j*K + e) at the
    channel's start plus the 128-floors of j*K*n0 and e*n0."""
    if feed == "windows":
        return (t * c_channels + c) * wp
    if feed == "seg":
        return c * l_seg + (t * n0 // 128) * 128
    if feed == "resident":
        return ((t // k_chunk) * k_chunk * n0
                + ((t % k_chunk) * n0 // 128) * 128)
    if feed == "direct":
        j, e = divmod(t, k_epochs)
        return (start + (j * k_epochs * n0 // 128) * 128
                + (e * n0 // 128) * 128)
    raise ValueError(f"unknown feed {feed!r}")


def epoch_stage_span(origin, wp, part=None):
    """The samples the per-epoch kernels (csrc/epoch_core.cuh,
    stage_window) copy into shared memory for a window at ``origin`` (an
    int or an integer tensor): (first, length, offset), the span [first,
    first + length) of the feed's array and the window's offset in it.
    The first sample is the 4-sample (16-byte) floor of the origin, as a
    bulk copy needs; the kernel copies wp samples from it by TMA and the
    last ``offset`` (0-3) by 4-byte cp.async, so the span ends where the
    window does. ``part`` (a, w): a lane-cluster block's lanes [a, a +
    w) of the window (a a multiple of 128), copied from the 4-sample
    floor of origin + a, w samples by TMA and the 0-3 past them, so the
    span ends at origin + a + w; the lane l of the part lies at l - a +
    offset in it."""
    a, w = part or (0, wp)
    offset = origin % 4
    return origin + a - offset, offset + w, offset


def epoch_part_rows(a, w, wp, el):
    """What a lane-cluster block of the per-epoch kernels holds of its
    channel's replica rows (csrc/epoch_core.cuh, stage_part_rows) for the
    part [a, a + w): (the row index at each position of its rows, [lr]
    ints; the bulk copies' runs [(first row index, length), ...], one, or
    two where the range wraps mod wp). The range is [a - before, a + w +
    after) mod wp, the halo of track_block_epoch.lane_halo(el)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    before, after = ep.lane_halo(el)
    n = before + w + after
    s0 = (a - before) % wp
    n1 = min(n, wp - s0)
    runs = [(s0, n1)] + ([(0, n - n1)] if n > n1 else [])
    return (a - before + np.arange(n)) % wp, runs


def epoch_part_reads(lane, a, rem, el):
    """(early, prompt, late) positions in a lane-cluster block's prompt
    row (epoch_part_rows) that the mix reads at window lane ``lane`` of
    its part at ``a`` (csrc/epoch_core.cuh, mix_part): (lane - a) +
    before - rem and its +- el, with no wrap."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    ip = np.asarray(lane) - a + ep.lane_halo(el)[0] - rem
    return ip + el, ip, ip - el


def epoch_lane_range(start_lane, n_t, wp):
    """The lanes the per-epoch kernels mix (csrc/epoch_core.cuh,
    mask_lanes): the integers l in [0, wp) with start_lane <= l <
    start_lane + n_t in f32 (the plain version's mask), as (l0, l1):
    [ceil(start_lane), ceil(start_lane + n_t)) clamped to [0, wp), NaN
    to 0 as fmaxf takes it."""
    sl = np.float32(start_lane)
    end = np.float32(sl + np.float32(n_t))

    def lane(x):
        return int(np.fmin(np.fmax(np.ceil(x), np.float32(0.0)),
                           np.float32(wp)))

    return lane(sl), lane(end)


def epoch_wrap(x, wp):
    """x mod wp for x in (-wp, 2wp) by one compare and add or subtract,
    as the per-epoch kernels' mix wraps the rolled prompt index."""
    x = np.asarray(x)
    return np.where(x < 0, x + wp, np.where(x >= wp, x - wp, x))


def epoch_rolled_lanes(lane, rem, el, wp):
    """(early, prompt, late) indices of the epoch's prompt row that the
    per-epoch kernels' mix reads at window lane ``lane`` (csrc/
    epoch_core.cuh, mix): (lane - rem) mod wp and its +- el rolls, each
    wrapped by epoch_wrap (rem taken mod wp once per epoch)."""
    rw = rem if rem < wp else rem % wp
    ip = epoch_wrap(np.asarray(lane) - rw, wp)
    return epoch_wrap(ip + el, wp), ip, epoch_wrap(ip - el, wp)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a
    16-byte boundary."""
    buf = t.new_empty(t.numel() + 1)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def epoch_edge_check(torch, device="cuda", seg_ms=SEG_BLOCK_MS,
                     long_ms=WINDOWS_BLOCK_MS, piece=EPOCH_PIECE):
    """The per-epoch kernels at the window copy's alignment edges, each
    against its plain version open loop and equal bit for bit to the run
    on the unmoved inputs: B3 (direct) with every start moved to each
    residue r mod 4 and the stream cut where the highest start's last
    window ends (edge_case); B4b (seg) on segments cut where the last
    window ends and widened by r = 0-3 columns, so that row c's windows
    start at residue c*r mod 4; B6 (resident) on the stream cut at the
    wrapper's read bound T*n0 + wp (its odd chunks start at residue 2
    at n0 = 2046, their windows ending in 2 cp.async samples). B4a's
    windows are whole wp rows (residue 0). Then a base pointer 4 bytes
    off a 16-byte boundary raises on each of the four, launching
    nothing. Blocks of ``seg_ms`` for B4b, ``long_ms`` for the rest;
    open-loop pieces of ``piece`` epochs (B4b 5/4 of it). Returns the
    largest |error| of the correlations per kernel."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    worst = {"direct": 0.0, "seg": 0.0, "resident": 0.0}

    def note(name, label, err):
        worst[name] = max(worst[name], err["corr_max_abs"])
        print(f"{name} kernel vs plain, open loop [{label}]: "
              + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})
              + "; equal to the unmoved run bit for bit")

    # B3: starts at each residue mod 4, the stream cut at the last window
    _, d_args, d_kw = full_width_inputs(torch, device, {}, block_ms=long_ms,
                                        layout="direct")
    t0, s0 = fused.track_block_fused_direct(*d_args, **d_kw)
    for r in range(4):
        e_args, e_kw = edge_case(torch, d_args, d_kw, r)
        tk, sk, err = open_loop_compare(torch, e_args, e_kw, layout="direct")
        assert torch.equal(tk, t0) and torch.equal(sk, s0), ("direct", r)
        note("direct", f"starts at residue {r} mod 4, stream cut at "
             f"{e_args[0].shape[0]}", err)
    # B4b: rows at residues c*r mod 4, each segment cut at its last window
    inp = epoch_inputs(torch, "seg", {}, device=device, block_ms=seg_ms)
    (seg_re, seg_im, reps, mat), seg_kw = inp["args"], inp["kw"]
    t0, s0 = fused.track_block_fused_seg(*inp["args"], **seg_kw)
    n0, wp, t_all = seg_kw["n0"], seg_kw["wp"], seg_kw["t_epochs"]
    need = ((t_all - 1) * n0 // 128) * 128 + wp
    for r in range(4):
        pad = seg_re.new_zeros((seg_re.shape[0], r))
        cut = tuple(torch.cat([x[:, :need], pad], dim=1).contiguous()
                    for x in (seg_re, seg_im))
        origins = {epoch_window_origin("seg", t_all - 1, n0=n0, wp=wp, c=c,
                                       l_seg=need + r) % 4
                   for c in range(seg_re.shape[0])}
        assert origins == {c * r % 4 for c in range(4)}, origins
        tk, sk, err = epoch_open_loop(torch, "seg", (*cut, reps, mat),
                                      seg_kw, piece=max(1, piece * 5 // 4))
        assert torch.equal(tk, t0) and torch.equal(sk, s0), ("seg", r)
        note("seg", f"Lseg {need + r}: rows at residues "
             f"{sorted(origins)} mod 4, cut at the last window", err)
    # B6: the stream cut at the read bound; chunks at residues 0 and 2
    inp = epoch_inputs(torch, "resident", {}, device=device,
                       block_ms=long_ms)
    (sre, sim, r_reps, r_st), kw = inp["args"], inp["kw"]
    t_all, n0, wp = kw["t_epochs"], kw["n0"], kw["wp"]
    k = fused.resident_chunk(t_all, kw["k_epochs"])
    assert {epoch_window_origin("resident", t, n0=n0, wp=wp, k_chunk=k) % 4
            for t in range(t_all)} == {0, 2}
    t0, s0 = fused.track_block_fused_resident(*inp["args"], **kw)
    bound = t_all * n0 + wp
    cut = (sre[:bound], sim[:bound], r_reps, r_st)
    tk, sk, err = epoch_open_loop(torch, "resident", cut, kw, piece=piece)
    assert torch.equal(tk, t0) and torch.equal(sk, s0), "resident"
    note("resident", f"stream cut at the read bound {bound}", err)
    # a base pointer off 16 bytes raises before anything launches
    win = epoch_inputs(torch, "windows", {}, device=device,
                       block_ms=long_ms)
    before = _launch_counts()
    for fn, a, k_w in (
            (fused.track_block_fused,
             (_misaligned(win["args"][0]), *win["args"][1:]), win["kw"]),
            (fused.track_block_fused_seg,
             (seg_re, _misaligned(seg_im), reps, mat), seg_kw),
            (fused.track_block_fused_resident,
             (sre[1:], sim[1:], r_reps, r_st), kw),
            (fused.track_block_fused_direct,
             (d_args[0][1:], d_args[1][1:], *d_args[2:]), d_kw)):
        try:
            fn(*a, **k_w)
        except ValueError as exc:
            assert "16-byte aligned" in str(exc), exc
        else:
            raise AssertionError(f"{fn.__name__}: a misaligned base "
                                 "launched")
    assert _launch_counts() == before
    print("misaligned base pointers: windows, seg, resident and direct "
          "raise, nothing launched")
    return worst


def epoch_open_loop(torch, feed, args, kw, piece=EPOCH_PIECE):
    """A per-epoch kernel against its plain version, open loop: the
    kernel runs the block once, and once more for each prefix that ends
    a piece of ``piece`` epochs, to give its state there; from each such
    state the plain version runs the next piece, held to the kernel's
    telemetry and end state (``compare``). Returns (kernel telemetry,
    kernel state, the largest margins over the pieces)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    kernel, plain = _epoch_fns(feed)
    if feed == "windows":
        t_all = args[0].shape[0]
    else:
        t_all = kw["t_epochs"]
    extra = {}
    if feed == "resident":
        # the block's chunk, so every prefix and piece keeps its lanes
        extra = dict(k_epochs=fused.resident_chunk(t_all, kw["k_epochs"]))
        assert piece % extra["k_epochs"] == 0
    tk, sk = kernel(*args, **kw)
    st, err = args[3], {}
    for e0 in range(0, t_all, piece):
        e1 = min(e0 + piece, t_all)
        if e1 < t_all:
            if feed == "windows":
                tp, s_next = kernel(args[0][:e1], args[1][:e1], *args[2:],
                                    **kw)
            else:
                tp, s_next = kernel(*args, **dict(kw, t_epochs=e1, **extra))
            # the kernel is deterministic: a prefix repeats the block
            assert torch.equal(tp, tk[:e1]), f"prefix {e1} differs"
        else:
            s_next = sk
        if feed == "windows":
            tr, sr = plain(args[0][e0:e1], args[1][e0:e1], args[2], st, **kw)
        else:
            tr, sr = plain(*args[:3], st, **dict(
                kw, t_epochs=e1 - e0, first_epoch=e0, **extra))
        for name, v in compare(tk[e0:e1], s_next, tr, sr).items():
            err[name] = max(err.get(name, 0.0), v)
        st = s_next
    return tk, sk, err


def resident_vs_windows(torch, inp, piece=EPOCH_PIECE):
    """B6 against B4a, kernel to kernel, on the same stream, open loop:
    from B4a's state at the start of each piece (its offsets put in
    col 9), B6 runs the piece on the stream from the piece's first epoch
    (the piece starts on a chunk boundary, so its lanes are the whole
    block's); telemetry and state held to B4a's with the JAX suite's
    tolerances (RESIDENT_TOL). Returns the largest differences."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    (wre, wim, w_reps, w_st), w_kw = inp["windows"]
    sre, sim, reps, st_r = inp["args"]
    kw = inp["kw"]
    n0, t_all = kw["n0"], kw["t_epochs"]
    k = fused.resident_chunk(t_all, kw["k_epochs"])
    assert piece % k == 0
    tw, sw = fused.track_block_fused(wre, wim, w_reps, w_st, **w_kw)
    worst = [0.0, 0.0, 0.0]
    st = w_st
    for e0 in range(0, t_all, piece):
        e1 = min(e0 + piece, t_all)
        st_w = (fused.track_block_fused(wre[:e1], wim[:e1], w_reps, w_st,
                                        **w_kw)[1] if e1 < t_all else sw)
        st_in = st.clone()
        st_in[:, 9] = st_r[:, 9]
        tr, sr = fused.track_block_fused_resident(
            sre[e0 * n0:], sim[e0 * n0:], reps, st_in,
            **dict(kw, t_epochs=e1 - e0, k_epochs=k))
        a, b = tw[e0:e1].double(), tr.double()
        scale = max(1.0, float(a[..., :7].abs().max()))
        worst[0] = max(worst[0], float((a[..., :7] - b[..., :7]).abs().max())
                       / scale)
        worst[1] = max(worst[1], float((a[..., 10] - b[..., 10]).abs().max()))
        worst[2] = max(worst[2], float((st_w[:, :9].double()
                                        - sr[:, :9].double()).abs().max()))
        st = st_w
    assert all(w < tol for w, tol in zip(worst, RESIDENT_TOL)), worst
    return worst


VARIANTS_EPOCH = {
    "power": {},
    "costas": dict(lock_mode="costas"),
    "forced_death": dict(lock_threshold=1e12, max_lost_epochs=7),
}


def phase_epoch_check(torch):
    """B4a, B4b (+ B4c) and B6 against their plain versions at full
    width, open loop; B4c bit for bit; B6 against B4a; the window copy's
    alignment edges of B3, B4b and B6 (epoch_edge_check); then B6 once
    through its entry point with the launch counts set to 0 just before
    (its only path: no receiver runs it). Returns the largest |error| of
    the correlations per kernel (B3's at the edges under "direct") and
    B6's launches."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    max_abs = {"windows": 0.0, "seg": 0.0, "resident": 0.0, "gather": 0.0}
    shapes = {"windows": (2176, 500), "seg": (2432, 125),
              "resident": (4352, 500)}
    for name, cfg_kw in VARIANTS_EPOCH.items():
        for feed in ("windows", "seg", "resident"):
            inp = epoch_inputs(torch, feed, cfg_kw)
            args, kw = inp["args"], inp["kw"]
            assert (args[2].shape[2], inp["ft"].t_epochs) == shapes[feed]
            if feed == "seg":
                assert inp["ft"].l_seg == 256_128
                g_args, g_kw = inp["gather"]
                got = fused.gather_segments(*g_args, **g_kw)
                torch.cuda.synchronize()
                assert torch.equal(got[0], args[0]) and \
                    torch.equal(got[1], args[1]), "B4c differs"
            before = _launch_counts()
            tk, sk, err = epoch_open_loop(
                torch, feed, args, kw, piece=25 if feed == "seg" else
                EPOCH_PIECE)
            launched = {k: v - before[k] for k, v in _launch_counts().items()}
            key = {"windows": "track_block_fused",
                   "seg": "track_block_fused_seg",
                   "resident": "track_block_fused_resident"}[feed]
            assert launched[key] > 0 and sum(launched.values()) == \
                launched[key], launched
            active = sk[:, 7].cpu().numpy()
            if name == "forced_death":
                assert not active.any(), "forced death left a channel alive"
            else:
                assert active[:24].all() and not active[24:].any()
            max_abs[feed] = max(max_abs[feed], err["corr_max_abs"])
            print(f"{key} kernel vs plain, open loop [{name}, wp "
                  f"{args[2].shape[2]}, T {inp['ft'].t_epochs}]: "
                  + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()}))
            if feed == "resident":
                worst = resident_vs_windows(torch, inp)
                print(f"B6 vs B4a, kernel to kernel, open loop [{name}]: "
                      f"cols 0-6 {worst[0]:.3e} of max, carrier rate "
                      f"{worst[1]:.3e} Hz, state {worst[2]:.3e} "
                      f"(limits {RESIDENT_TOL})")
    for feed, err in epoch_edge_check(torch).items():
        max_abs[feed] = max(max_abs.get(feed, 0.0), err)
    # B6's path: its entry point over one full block
    inp = epoch_inputs(torch, "resident", {})
    _reset_launch_counts()
    telem, st = fused.track_block_fused_resident(*inp["args"], **inp["kw"])
    torch.cuda.synchronize()
    launches = _launch_counts()
    _expect_launches(launches, track_block_fused_resident=1)
    assert telem.shape == (500, N_CHANNELS, 17) and \
        bool(torch.isfinite(telem).all())
    assert (st[:24, 7] > 0.5).all(), "B6 lost a channel"
    print("B6 entry point, one 500 ms block: 1 launch, 24 channels "
          f"tracking, locked share "
          f"{float(telem[:, :24, 7].mean()):.4f}")
    return max_abs, launches["track_block_fused_resident"]


def epoch_bytes(feed, args, telem, st):
    """The bytes a per-epoch kernel's block must move, counted from this
    run's data as its operations are: where each channel has windows of
    its own (windows, seg), the lanes inside each active epoch's mask
    (telemetry cols 12 x 16) once, re and im f32 (an idle channel's
    window and the lanes outside the mask reach no output); where every
    channel reads one stream (resident), the stream; then the active
    channels' replica rows, the state in and out, and the telemetry."""
    lanes = float((telem[..., 12] * telem[..., 16]).double().sum())
    reps = args[2]
    active = int((telem[..., 16].amax(dim=0) > 0).sum())
    win = 8.0 * lanes if feed in ("windows", "seg") else _nbytes(*args[:2])
    return (win + active * reps[0].numel() * reps.element_size()
            + _nbytes(args[3], telem, st))


def phase_epoch_timing(torch):
    """Each per-epoch kernel's time per block at full width (as
    phase_timing: L2 flushed, median of the passes), its plain version's
    (two passes), its bound from this run's inputs, and for B4c the time
    of one PyTorch indexing call per component computing the same copy."""
    out = {}
    for feed in ("windows", "seg", "resident"):
        inp = epoch_inputs(torch, feed, {})
        out[feed] = epoch_timing(torch, feed, inp["args"], inp["kw"])
        t = out[feed]["t_epochs"]
        print(f"timing [{feed}] (ms per {t} ms block, 32 ch): "
              + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                            for k, v in out[feed].items()}))
        if feed == "seg":
            out["gather"] = gather_timing(torch, *inp["gather"])
            print("timing [gather] (ms per 125 ms block, 32 ch): "
                  + json.dumps({k: (round(v, 6) if isinstance(v, float)
                                    else v)
                                for k, v in out["gather"].items()}))
    return out


def epoch_timing(torch, feed, args, kw):
    """One per-epoch kernel's time per block on ``args``/``kw``, its
    plain version's (two passes), its launches per block and its bound
    from this run's inputs."""
    kernel, plain = _epoch_fns(feed)
    ks, ps, k_sync = _timed_turns(torch, lambda: kernel(*args, **kw),
                                  lambda: plain(*args, **kw),
                                  plain_passes=2)
    before = sum(_launch_counts().values())
    telem, st = kernel(*args, **kw)
    per_block = sum(_launch_counts().values()) - before
    lanes = float((telem[..., 12] * telem[..., 16]).double().sum())
    n_bytes = epoch_bytes(feed, args, telem, st)
    f32_ops = DIRECT_OPS_PER_LANE * lanes
    bound, bound_by = _bound(n_bytes, f32_ops)
    return dict(launches_per_block=per_block,
                ms=statistics.median(ks), ms_min=min(ks), ms_max=max(ks),
                plain_ms=statistics.median(ps), plain_passes=ps,
                ms_synced=statistics.median(k_sync), bound_ms=bound,
                bound_by=bound_by, bytes=n_bytes, mixed_lanes=lanes,
                f32_ops=f32_ops, t_epochs=int(telem.shape[0]),
                wp=args[2].shape[2], library_ms=None)


def gather_timing(torch, g_args, g_kw):
    """B4c's time per block on its args/kw, its plain version's, one
    PyTorch indexing call per component computing the same copy (the
    library column) and the bound."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    sre, sim, starts, l_seg = g_args
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        l_seg, device="cuda")[None, :]
    ks, ps, k_sync = _timed_turns(
        torch, lambda: fused.gather_segments(sre, sim, starts, l_seg,
                                             **g_kw),
        lambda: fused.gather_segments_reference(sre, sim, starts, l_seg,
                                                **g_kw),
        plain_passes=2)
    ls, _, _ = _timed_turns(torch, lambda: (sre[idx], sim[idx]),
                            lambda: None, plain_passes=0)
    before = sum(_launch_counts().values())
    seg = fused.gather_segments(sre, sim, starts, l_seg, **g_kw)
    per_block = sum(_launch_counts().values()) - before
    n_bytes = _nbytes(sre, sim, starts, *seg)
    bound, bound_by = _bound(n_bytes, 0.0)
    return dict(launches_per_block=per_block,
                ms=statistics.median(ks), ms_min=min(ks), ms_max=max(ks),
                plain_ms=statistics.median(ps),
                ms_synced=statistics.median(k_sync),
                library_ms=statistics.median(ls), bound_ms=bound,
                bound_by=bound_by, bytes=n_bytes, l_seg=l_seg)


def phase_epoch_receivers(torch):
    """The receiver through the per-epoch layouts on the 24-satellite
    scene, 5 s, cold: 125 ms blocks (T = 125 has no superstep pairing:
    the auto layout falls from mxu to direct to seg; B4b and B4c once
    per block, nothing else), and 500 ms blocks on the windows layout
    (B4a once per block) against the direct layout (B3): epochs equal
    per PRN, Doppler within 1 Hz."""
    sats, sig = _scene(SEG_S)
    n_seg = SEG_S * 1000 // SEG_BLOCK_MS
    n_win = SEG_S * 1000 // WINDOWS_BLOCK_MS
    rx_s, _, ls = _run_receiver(torch, sats, sig, "odd epoch count",
                                block_ms=SEG_BLOCK_MS)
    assert rx_s.fused.layout == "seg", rx_s.fused.layout
    _expect_launches(ls, track_block_fused_seg=n_seg, gather_segments=n_seg)
    rx_w, sum_w, lw = _run_receiver(torch, sats, sig, "windows",
                                    layout="windows")
    _expect_launches(lw, track_block_fused=n_win)
    _, sum_d, ld = _run_receiver(torch, sats, sig, "direct", layout="direct")
    _expect_launches(ld, track_block_fused_direct=n_win)
    ch_w = {c["prn"]: c for c in sum_w["channels"]}
    ch_d = {c["prn"]: c for c in sum_d["channels"]}
    worst = 0.0
    for prn in range(1, 25):
        assert ch_w[prn]["epochs"] == ch_d[prn]["epochs"], prn
        d = abs(ch_w[prn]["last_doppler_hz"] - ch_d[prn]["last_doppler_hz"])
        assert d < 1.0, (prn, d)
        worst = max(worst, d)
    print(f"windows vs direct receiver: epochs equal for all 24 PRNs, "
          f"|Doppler difference| <= {worst:.4f} Hz")
    return {"seg": ls, "windows": lw, "direct": ld}


# ---------------------------------------------------------------------------
# the shared fetch: B2 (FusedTracker(shared_fetch=True))
# ---------------------------------------------------------------------------

def shared_cases(torch, device, cfg_kw, block_ms=BLOCK_MS, seed=0):
    """B2's full-width inputs through the tracker's own re-anchor, two
    ways: "clamped", the scene's ledger (every window starts below
    spread_cap, so the base is clamped at 0), and "spread", the ledger
    moved by whole code periods to random starts across the cap above a
    base of the guard's own (_scene_tracker's ``spread_seed``). Returns
    {name: (args, kw)}."""
    out = {}
    for name, spread_seed in (("clamped", None), ("spread", seed)):
        ft, args, kw = full_width_inputs(torch, device, cfg_kw,
                                         block_ms=block_ms,
                                         shared_fetch=True,
                                         spread_seed=spread_seed)
        host = np.asarray(kw["starts_host"])
        c, cap = args[4].shape[0], kw["spread_cap"]
        assert cap == 2560 and host.shape == (c + 1,)
        dc = host[:c] - host[c]
        if name == "clamped":
            assert host[c] == 0, host
        else:
            assert host[c] > 0 and dc.max() == cap, host
        assert (dc >= 0).all() and (dc <= cap).all()
        out[name] = (args, kw)
    return out


def offcode_case(args, kw, seed, bases=(20, 100)):
    """B2's inputs with every window start replaced by the base plus a
    random 128-multiple in [0, spread_cap], the base a random 128-multiple
    (128 times an integer in ``bases``; at 2.046 MHz well above the cap,
    at 8.184 MHz what the stream's history holds): the ledger's code
    offsets stay as they were, so
    no channel's code lines up with its window and every channel tracks
    noise. B2 is held to B1 on it kernel to kernel; against the plain
    version such channels' carrier rates part by more than compare's
    1 mHz floor (tools/port_b2_offcode_probe.py, PERF.md section 7).
    Returns (args, kw)."""
    rng = np.random.default_rng(seed)
    c, cap = args[4].shape[0], kw["spread_cap"]
    host = np.empty(c + 1, np.int32)
    host[c] = 128 * int(rng.integers(*bases))
    host[:c] = host[c] + 128 * rng.integers(0, cap // 128 + 1, size=c)
    return ((args[0], args[1], args[2].new_tensor(host), *args[3:]),
            dict(kw, starts_host=host))


def direct_span_of(kw):
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    return fused.direct_span(kw["k_epochs"], kw["n0"], kw["wp"])


def b1_of(args, kw):
    """B1's arguments on the same windows as B2's ``args``/``kw``: the
    starts without the base, no spread_cap."""
    c = args[4].shape[0]
    b1_kw = {k: v for k, v in kw.items() if k != "spread_cap"}
    b1_kw["starts_host"] = np.asarray(kw["starts_host"])[:c]
    return (args[0], args[1], args[2][:c].contiguous(), *args[3:]), b1_kw


def b2_equals_b1(torch, args, kw):
    """B2 on [C + 1] starts against B1 on starts[:C], kernel to kernel:
    telemetry and state torch.equal. Returns the launches of each."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    before = (fused.shared_launch_count, fused.launch_count)
    t2, s2 = fused.track_block_fused_mxu(*args, **kw)
    b1_args, b1_kw = b1_of(args, kw)
    t1, s1 = fused.track_block_fused_mxu(*b1_args, **b1_kw)
    torch.cuda.synchronize()
    assert torch.equal(t2, t1), "B2 telemetry differs from B1's"
    assert torch.equal(s2, s1), "B2 state differs from B1's"
    return (fused.shared_launch_count - before[0],
            fused.launch_count - before[1])


def phase_shared_check(torch, block_ms=BLOCK_MS):
    """B2 at full width (32 channels, 24 tracking and 8 idle), on the
    clamped and the spread inputs of shared_cases, in full and lean
    telemetry: against its plain version open loop (power, Costas and
    forced death), and against B1 kernel to kernel, bit for bit, on those
    and on offcode_case's. Returns the largest |error| of the
    correlations against the plain version."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    max_abs = 0.0
    for name, cfg_kw in VARIANTS_EPOCH.items():
        cases = shared_cases(torch, "cuda", cfg_kw, block_ms=block_ms,
                             seed=len(name))
        runs = [(case, mode) for case in cases for mode in ("full", "lean")]
        for case, mode in runs:
            c_args, c_kw = cases[case]
            c_kw = dict(c_kw, telem_mode=mode)
            before = fused.shared_launch_count
            tk, sk, err = open_loop_compare(torch, c_args, c_kw)
            assert fused.shared_launch_count > before
            active = sk[:, 7].cpu().numpy()
            if name == "forced_death":
                assert not active.any(), "forced death left a channel alive"
            else:
                # from the scene's own starts every satellite tracks;
                # moved by whole code periods a channel starts at another
                # carrier phase, and one that starts a few degrees from
                # the Costas loop's +-90 degree point can lose its lock,
                # as in the JAX kernel (PERF.md section 7); compare holds
                # the kernel's states to the plain version's
                assert not active[24:].any()
                assert case == "spread" or active[:24].all(), active
            max_abs = max(max_abs, err["corr_max_abs"])
            lost = np.flatnonzero(active[:24] < 0.5).tolist()
            print(f"B2 kernel vs plain, open loop [{name}, {case} base "
                  f"{int(c_kw['starts_host'][-1])}, {mode}]: "
                  + json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})
                  + (f"; channels lost {lost}" if lost and
                     name != "forced_death" else ""))
        cases["offcode"] = offcode_case(*cases["clamped"], seed=len(name))
        for case in ("clamped", "spread"):
            cases[case + "_cut"] = shared_edge_case(torch, *cases[case])
        for case, (c_args, c_kw) in cases.items():
            for mode in ("full", "lean"):
                n2, n1 = b2_equals_b1(torch, c_args,
                                      dict(c_kw, telem_mode=mode))
                assert (n2, n1) == (1, 1), (n2, n1)
        for case in ("clamped", "spread"):
            whole = fused.track_block_fused_mxu(*cases[case][0],
                                                **cases[case][1])
            cut = fused.track_block_fused_mxu(*cases[case + "_cut"][0],
                                              **cases[case + "_cut"][1])
            assert all(torch.equal(x, y) for x, y in zip(whole, cut)), case
        print(f"B2 vs B1, kernel to kernel [{name}]: telemetry and state "
              f"equal bit for bit, {len(cases)} start layouts x full/lean "
              "(the cut streams' runs equal to the uncut ones)")
    return max_abs


def shared_edge_case(torch, args, kw):
    """B2's arguments with the stream cut where the last superstep's
    slice ends (prefetch_span of the base with spread_cap): the
    last multicast part then ends at the stream's last sample."""
    base = int(np.asarray(kw["starts_host"])[-1])
    origin, length, offset = prefetch_span(
        base, kw["t_epochs"] // kw["k_epochs"] - 1, kw["k_epochs"],
        kw["n0"], kw["wp"], kw["spread_cap"])
    assert offset == 0
    end = origin + length
    return ((args[0][:end].contiguous(), args[1][:end].contiguous(),
             *args[2:]), kw)


def _drive_tracker(torch, sig, shared, wire, span, tracker=None,
                   run_blocks=False):
    """FusedTracker on ``sig`` (by default the 24-satellite scene, 32
    channels, 500 ms blocks, the ledger of full_width_inputs; or
    ``tracker(shared, wire)`` -> (tracker, state, rows, history)), as
    single blocks (span 1: run_block + rebase) or as synchronous spans
    of ``span`` blocks (submit_span, each from the last one's ledger on
    the card; ``run_blocks``: FusedTracker.run_blocks, the ledger
    absorbed on the host after each span). The launch counts are set to
    0 just before and read just after. Returns (the downloaded arrays of every block or span, the
    final ledger as arrays, whether each channel is active at the end,
    launches, blocks, seconds)."""
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    if tracker is None:
        ft, st, rows, history = _scene_tracker(
            torch, "cuda", {}, N_CHANNELS, BLOCK_MS, layout="mxu",
            wire=wire, shared_fetch=shared)
        assert ft.spread_cap == (2560 if shared else 0)
    else:
        ft, st, rows, history = tracker(shared, wire)
    block = ft.t_epochs * ft.n0
    sre = np.ascontiguousarray(sig.real, dtype=np.float32)
    sim = np.ascontiguousarray(sig.imag, dtype=np.float32)
    n_blocks = (sre.size - history) // block
    out = []
    _reset_launch_counts()                  # this path starts here
    t0 = time.perf_counter()
    if span == 1:
        for b in range(n_blocks):
            w = slice(b * block, b * block + history + block)
            st, tl = ft.run_block(st, sre[w], sim[w], rows)
            out.append([np.asarray(v) for v in tl])
            st = trk.rebase(st, block)
        led = [np.asarray(v) for v in st]
        active = np.asarray(st.active)
    elif run_blocks:
        b0 = 0
        while b0 < n_blocks:
            n = min(span, n_blocks - b0)
            w = slice(b0 * block, b0 * block + history + n * block)
            st, tels = ft.run_blocks(st, sre[w], sim[w], rows, n)
            out += [[np.asarray(v) for v in tl] for tl in tels]
            b0 += n
        led = [np.asarray(v) for v in st]
        active = np.asarray(st.active)
    else:
        led_dev, b0 = st, 0
        while b0 < n_blocks:
            n = min(span, n_blocks - b0)
            w = slice(b0 * block, b0 * block + history + n * block)
            h = ft.submit_span(led_dev, sre[w], sim[w], rows, n,
                               with_ledger=True)
            out.append(h.ys.fetch())
            led_dev, b0 = h.led, b0 + n
        led = out[-1][-6:]
        active = led[0] > 0.5
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, led, active, _launch_counts(), n_blocks, seconds


def phase_shared_path(torch, seconds=STEADY_S, span=STEADY_SPAN):
    """B2's path on the 24-satellite scene, 10 s: FusedTracker with
    shared_fetch=True as single blocks (f32 telemetry, full mode) and as
    synchronous ``span``-block spans on the slim2 wire (lean mode), each
    against
    the same run with shared_fetch=False: every downloaded array and the
    final ledger equal bit for bit; B2 launched once per block, B1 never
    (and B1 once per block in the comparison run). Returns B2's
    launches on the span run."""
    _, sig = _scene(seconds)
    res = {}
    for label, wire, n_span in (("single-block", "f32", 1),
                                ("spans", "slim2", span)):
        for shared in (True, False):
            res[shared] = _drive_tracker(torch, sig, shared, wire, n_span)
        (out_s, led_s, active, l_s, n, sec_s), \
            (out_b, led_b, _, l_b, _, sec_b) = res[True], res[False]
        _expect_launches(l_s, _mxu_kernel_shared=n)
        _expect_launches(l_b, track_block_fused_mxu=n)
        assert len(out_s) == len(out_b)
        n_arrays = 0
        for xs, ys in zip(out_s + [led_s], out_b + [led_b]):
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert np.array_equal(x, y), label
                n_arrays += 1
        assert active[:24].all() and not active[24:].any(), active
        print(f"B2 path [{label}, wire {wire}]: {n} blocks, {n_arrays} "
              f"arrays equal bit for bit to shared_fetch=False, 24 channels "
              f"tracking; launches {json.dumps(l_s)}; wall {sec_s:.3f} s "
              f"(B1 {sec_b:.3f} s)")
    return l_s["_mxu_kernel_shared"]


SHARED_CLUSTERS = (2, 4, 8, 1)          # B2 cluster sizes timed


def phase_shared_timing(torch):
    """B2's time per 500 ms block at full width beside B1's, in turns
    (B1, then B2 at each cluster size of SHARED_CLUSTERS, then the same
    backwards; events around each queued launch, the L2 flushed, median
    of 30 each), on the tracker's own inputs, each cluster size's result
    equal to B1's bit for bit; its plain version's (two passes); its
    bound, B1's function on the same samples: each input read once (the
    stream, [C + 1] starts, bank, state) and the telemetry and state
    written once, against B1's operations. The slices the clusters read
    (one [span + spread_cap] slice per cluster per superstep) are
    reported beside it as ``slice_bytes``, at the wrapper's first
    cluster size."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    ft, args, kw = full_width_inputs(torch, "cuda", {}, shared_fetch=True)
    c = args[4].shape[0]
    b1_args, b1_kw = b1_of(args, kw)
    cs = fused.shared_cluster_sizes(c)[0]
    assert cs == SHARED_CLUSTERS[0], cs

    def b1():
        return fused.track_block_fused_mxu(*b1_args, **b1_kw)

    def b2_at(n):
        def run():
            # the cluster sizes the wrapper tries: n alone, for this launch
            default = fused.shared_cluster_sizes
            fused.shared_cluster_sizes = lambda c_channels: (n,)
            try:
                return fused.track_block_fused_mxu(*args, **kw)
            finally:
                fused.shared_cluster_sizes = default
        return run

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    t_ref, s_ref = b1()
    for n in SHARED_CLUSTERS:
        t_n, s_n = b2_at(n)()
        assert torch.equal(t_n, t_ref) and torch.equal(s_n, s_ref), n
    for _ in range(3):
        b1()
    torch.cuda.synchronize()
    times = {0: []} | {n: [] for n in SHARED_CLUSTERS}
    order = (0,) + SHARED_CLUSTERS
    for n in order + order[::-1]:
        times[n] += _time_queued(torch, b1 if n == 0 else b2_at(n),
                                 KERNEL_PASSES, flush)
    t1, t2 = times[0], times[cs]
    ps = []
    for _ in range(2):
        flush.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused.track_block_fused_mxu_reference(*args, **kw)
        torch.cuda.synchronize()
        ps.append((time.perf_counter() - t0) * 1e3)
    telem, st = b2_at(cs)()
    lanes = float((telem[..., 12] * telem[..., 16]).double().sum())
    r_rows = args[3].shape[1]
    span_u = direct_span_of(kw) + kw["spread_cap"]
    n_super = kw["t_epochs"] // kw["k_epochs"]
    slice_bytes = (c // cs) * n_super * span_u * 2 * 4
    n_bytes = _nbytes(*args, telem, st)
    bf16_ops = 2.0 * 2 * r_rows * lanes
    f32_ops = MIX_OPS_PER_LANE * lanes
    bound, bound_by = _bound(n_bytes, f32_ops, bf16_ops)
    res = dict(ms=statistics.median(t2), ms_min=min(t2), ms_max=max(t2),
               b1_ms_in_turns=statistics.median(t1), b1_min=min(t1),
               b1_max=max(t1),
               ms_by_cluster={n: statistics.median(times[n])
                              for n in SHARED_CLUSTERS},
               plain_ms=statistics.median(ps),
               plain_passes=ps, bound_ms=bound, bound_by=bound_by,
               bytes=n_bytes, slice_bytes=slice_bytes, cluster=cs,
               span_u=span_u, mixed_lanes=lanes, bf16_ops=bf16_ops,
               f32_ops=f32_ops, library_ms=None, ptxas=mxu_ptxas())
    print("timing [B2 shared fetch] (ms per 500 ms block, 32 ch): "
          + json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                        for k, v in res.items()}))
    return res


# ---------------------------------------------------------------------------
# the receiver as users launch it: the CLI on a nav-broadcasting capture
# (21), the device-resident sources (22) and the pad-FFT search (23)
# ---------------------------------------------------------------------------

NAV_FS = 2_046_000.0
NAV_S = 26.0                        # the capture: 52 blocks of 500 ms
NAV_CHUNK_S = 0.5                   # the range is linear within a chunk
NAV_WEEK = 2290
NAV_T_OE = 345_600.0                # seconds of week (a multiple of 16)
# GPS time of the capture's first sample: every first transmit time lies
# in the SV second before a subframe boundary, about 0.45 s on
NAV_T_RX0 = NAV_T_OE + 119.6
NAV_RX_TRUE = np.array([4_027_894.0, 307_045.7, 4_919_474.9])
NAV_RADIUS_M = 26_560_000.0
# (PRN, azimuth deg, elevation deg, SV clock offset a_f0 s)
NAV_SATS = ((2, 30.0, 75.0, 2.1e-5), (5, 110.0, 40.0, -1.3e-5),
            (10, 200.0, 55.0, 4.0e-6), (13, 290.0, 30.0, -7.5e-6),
            (18, 60.0, 25.0, 1.6e-5), (23, 160.0, 20.0, -2.2e-5),
            (27, 240.0, 65.0, 9.0e-6), (31, 330.0, 45.0, -3.0e-6))
NAV_AMPLITUDE = 0.3
NAV_INT8_SCALE = 16.0               # noise sigma per rail ~11 counts
# the journey's blocks: 508 epochs pair supersteps only at K = 2, so B1's
# held rate is 2 ms; at 500 ms (K = 5) three of the eight channels
# false-lock 60-75 Hz off, from the 50-65 Hz fine-Doppler errors that a
# bit edge inside the acquisition's 10 ms leaves (ROADMAP C11)
NAV_BLOCK_MS = 508
# the fix and the EKF against the truth: tests/test_full_chain_live.py's
# bound for a live fix. At 2 samples per chip the code phase wanders by
# tens of metres on this scene, in the JAX package too (ROADMAP C12)
NAV_FIX_M = 100.0
# phase 22: the steady receiver of phase 9 (b) behind four sources
INGEST_SOURCES = ("array", "device_f32", "device_int8", "streaming_int8")
# phase 23: ladder 2's search, repeated for its time
ACQ_PASSES = 10


def _wrap_pi(x):
    return float(np.angle(np.exp(1j * x)))


def _sat_pos_at(az_deg, el_deg):
    """ECEF point on the az/el ray from the truth at |pos| =
    NAV_RADIUS_M."""
    rx = NAV_RX_TRUE
    up = rx / np.linalg.norm(rx)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    az, el = np.radians(az_deg), np.radians(el_deg)
    d = (np.cos(el) * np.sin(az) * east + np.cos(el) * np.cos(az) * north
         + np.sin(el) * up)
    b = 2.0 * np.dot(rx, d)
    c0 = np.dot(rx, rx) - NAV_RADIUS_M ** 2
    return rx + (-b + np.sqrt(b * b - 4 * c0)) / 2.0 * d


def kepler_ephemeris(prn, pos, a_f0):
    """A circular-orbit GPS ephemeris whose position at NAV_T_OE is
    ``pos`` (tests/test_pvt_multi_constellation.py's _kepler_ephemeris,
    on the port's orbits), with its angles wrapped into the LNAV ranges
    and every field rounded as LNAV broadcasts it (through the port's
    encoder and subframe assembler): the ephemeris a receiver decodes."""
    from gnss_sdr_tpu_torch import constants as C
    from gnss_sdr_tpu_torch.nav import Subframe, encode_words
    from gnss_sdr_tpu_torch.nav.ephemeris import Ephemeris, \
        EphemerisAssembler
    from gnss_sdr_tpu_torch.nav.orbits import satellite_position

    radius_m, t_oe = NAV_RADIUS_M, NAV_T_OE
    g = pos / radius_m
    i0 = max(np.radians(55.0), np.arcsin(min(abs(g[2]), 1.0)) + 0.1)
    su = np.clip(g[2] / np.sin(i0), -1.0, 1.0)
    for u in (np.arcsin(su), np.pi - np.arcsin(su)):
        a_, b_ = np.cos(u), np.sin(u) * np.cos(i0)
        om = np.arctan2(g[1], g[0]) - np.arctan2(b_, a_)
        eph = Ephemeris(
            prn=prn, week=NAV_WEEK % 1024, sqrt_a=np.sqrt(radius_m), e=0.0,
            m0=_wrap_pi(u), omega=0.0, i0=i0,
            omega0=_wrap_pi(om + C.OMEGA_E_DOT_RAD_S * t_oe),
            t_oe=t_oe, t_oc=t_oe, a_f0=a_f0)
        asm = EphemerisAssembler()
        for k in (1, 2, 3):
            data = np.zeros((10, 24), np.uint8)
            data[2:] = encode_words(eph, k)
            out = asm.feed(prn, Subframe(subframe_id=k, tow_counts=0,
                                         data=data, first_bit_index=0))
        p, _, _ = satellite_position(out, t_oe)
        if np.linalg.norm(p - pos) < 1.0:
            return out
    raise AssertionError(f"PRN {prn}: placement failed")


def nav_ephemerides():
    """{PRN: the broadcast ephemeris} of the nav scene."""
    return {prn: kepler_ephemeris(prn, _sat_pos_at(az, el), af0)
            for prn, az, el, af0 in NAV_SATS}


def nav_delay(eph, t_rx):
    """The SV-clock transmit time of the signal received at GPS time
    ``t_rx``, less ``t_rx``: -(light time) + the SV clock offset, the
    light time iterated with the Earth's rotation during flight, as the
    PVT solver models it (tests/test_pvt_end_to_end.py)."""
    from gnss_sdr_tpu_torch import constants as C
    from gnss_sdr_tpu_torch.nav.orbits import satellite_position

    tau = 0.075
    for _ in range(5):
        pos, _, clk = satellite_position(eph, t_rx - tau)
        th = C.OMEGA_E_DOT_RAD_S * tau
        rot = np.array([[np.cos(th), np.sin(th), 0.0],
                        [-np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
        tau = np.linalg.norm(rot @ pos - NAV_RX_TRUE) / C.SPEED_OF_LIGHT_M_S
    return -tau + clk


def nav_bits(ephs, s0, seconds, seed=17):
    """+-1 LNAV bits per PRN from SV second ``s0``: random fill to the
    next subframe boundary, then subframes 4 (filler), 1, 2, 3 and 4
    (tests/test_full_chain_live.py's layout), long enough for
    ``seconds``."""
    from gnss_sdr_tpu_torch.nav import encode_frames, encode_words

    boundary = 6 * (s0 // 6 + 1)
    m = boundary // 6
    rng = np.random.default_rng(seed)
    out = {}
    for prn, eph in ephs.items():
        frames = [(4, m + 1, rng.integers(0, 2, (8, 24)).astype(np.uint8))]
        frames += [(k, m + 1 + k, encode_words(eph, k)) for k in (1, 2, 3)]
        frames.append((4, m + 5, rng.integers(0, 2, (8, 24)).astype(np.uint8)))
        bits = np.concatenate([
            rng.choice([-1, 1], (boundary - s0) * 50).astype(np.int8),
            encode_frames(frames)])
        assert bits.size >= (seconds + 2) * 50
        out[prn] = bits
    return out


def nav_render(sats, n, fs, seed):
    """``n`` complex64 samples of ``sats`` (SatelliteScenario, GPS L1 C/A,
    nav bits from their first code period) plus unit complex noise, each
    sample the mean of the signal over its own interval (the front end's
    integrate-and-dump): a sample that straddles a chip edge mixes the
    two chips by their shares of it. models.signal.synthesize samples
    each chip at the sample's start instead, which at a whole number of
    samples per chip makes the DLL's correlation flat across a quarter
    chip, and the code phase wander there by up to +-73 m at 2.046 MHz."""
    from gnss_sdr_tpu_torch.models.signal import _unit_carrier

    out = np.zeros(n, np.complex64)
    i = np.arange(n, dtype=np.float64)
    for sat in sats:
        spec = sat.signal
        step = (spec.code_rate_hz + sat.code_rate_offset_hz) / fs
        phi = sat.code_phase_chips + step * i       # chips at each start
        k = np.floor(phi).astype(np.int64)
        code = spec.code_table()[sat.prn - 1].astype(np.float32)
        length = spec.code_length_chips

        def signed(chip):
            bit = sat.nav_bits[(chip // length // spec.symbols_per_bit)
                               % sat.nav_bits.size]
            return code[chip % length] * bit
        w = np.clip((k + 1 - phi) / step, 0.0, 1.0).astype(np.float32)
        chips = signed(k) * w + signed(k + 1) * (1.0 - w)
        out += (sat.amplitude * chips) * _unit_carrier(
            sat.carrier_phase_rad, 2.0 * np.pi * sat.doppler_hz / fs, 0, n)
    rng = np.random.default_rng(seed)
    out += ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            / np.sqrt(2.0)).astype(np.complex64)
    return out


def nav_capture(path):
    """Write the nav scene as an int8_iq capture of NAV_S at NAV_FS
    (rendered once: kept under ``path`` by its parameters). Within each
    chunk of NAV_CHUNK_S every satellite's code and carrier follow its
    transmit time linearly between the exact values at the chunk's ends
    (phase continuous). Returns (path, {PRN: ephemeris})."""
    import hashlib
    import os

    from gnss_sdr_tpu_torch import constants as C
    from gnss_sdr_tpu_torch.models import SatelliteScenario

    seconds, fs, seed = NAV_S, NAV_FS, 23
    ephs = nav_ephemerides()
    key = hashlib.sha256(repr((
        "nav-capture-2", seconds, fs, seed, NAV_CHUNK_S, NAV_T_RX0, NAV_SATS,
        NAV_AMPLITUDE, NAV_INT8_SCALE, NAV_RX_TRUE.tolist())).encode())
    path = os.path.join(path, f"nav_{key.hexdigest()[:12]}.int8_iq")
    if os.path.exists(path):
        return path, ephs
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    n_total = int(round(seconds * fs))
    n_chunk = int(round(NAV_CHUNK_S * fs))
    n_chunks = -(-n_total // n_chunk)
    # delays at the chunk ends, and the nav bits' origin: the SV second
    # of the earliest first transmit time
    d = {prn: np.array([nav_delay(e, NAV_T_RX0 + k * NAV_CHUNK_S)
                        for k in range(n_chunks + 1)])
         for prn, e in ephs.items()}
    s0 = int(np.floor(NAV_T_RX0 + min(v[0] for v in d.values())))
    bits = nav_bits(ephs, s0, seconds)
    cr, fl1 = C.GPS_L1_CA_CODE_RATE_CHIPS_PER_S, C.GPS_L1_FREQ_HZ
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        for k in range(n_chunks):
            n = min(n_chunk, n_total - k * n_chunk)
            sats = []
            for prn, dk in d.items():
                rate = (dk[k + 1] - dk[k]) / NAV_CHUNK_S   # d(delay)/dt
                cyc = fl1 * dk[k]
                sats.append(SatelliteScenario(
                    prn=prn, doppler_hz=fl1 * rate,
                    code_phase_chips=(NAV_T_RX0 - s0 + k * NAV_CHUNK_S
                                      + dk[k]) * cr,
                    carrier_phase_rad=2.0 * np.pi * (cyc - np.floor(cyc)),
                    amplitude=NAV_AMPLITUDE, nav_bits=bits[prn],
                    code_rate_offset_hz=cr * rate))
            x = nav_render(sats, n, fs, seed=seed + k)
            iq = np.empty(2 * n, np.float32)
            iq[0::2], iq[1::2] = x.real, x.imag
            f.write(np.clip(np.round(iq * NAV_INT8_SCALE), -127, 127)
                    .astype(np.int8).tobytes())
    os.replace(tmp, path)
    print(f"nav capture: {seconds:.1f} s of int8 I/Q at {fs:g} Hz, "
          f"{len(ephs)} satellites broadcasting LNAV, "
          f"{os.path.getsize(path) / 1e6:.1f} MB, rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    return path, ephs


def nav_toml(path, capture, n_channels=N_CHANNELS, extra_track=""):
    """The receiver config of the CLI journey: the capture through the
    file driver, the fused tracker, NAV_BLOCK_MS blocks."""
    block_ms, fs = NAV_BLOCK_MS, NAV_FS
    with open(path, "w") as f:
        f.write(f"""block_ms = {block_ms}

[sdr]
driver = "file"
path = "{capture}"
file_format = "int8_iq"
sample_rate_hz = {fs!r}

[rf]
freq_if_hz = 0.0
output_sample_rate_hz = {fs!r}

[track]
n_channels = {n_channels}
correlator = "fused"
carrier_aiding = true
{extra_track}""")
    return path


def phase_cli(torch):
    """The CLI journey on the card: ``cli.main`` in process on the nav
    capture (native file ingest, B1, observables to RINEX, the EKF, the
    fix), then ``python -m gnss_sdr_tpu_torch`` as a user runs it."""
    import io
    import os

    from gnss_sdr_tpu_torch import cli
    from gnss_sdr_tpu_torch.io import NativeFileSource, native_available
    from gnss_sdr_tpu_torch.nav import parse_obs_file

    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, ".chip_scratch")
    t0 = time.perf_counter()
    assert native_available(), "native/ingest.cpp did not build"
    print(f"native ingest library built in {time.perf_counter() - t0:.2f} s")
    capture, ephs = nav_capture(scratch)
    toml = nav_toml(os.path.join(scratch, "nav_rx.toml"), capture)
    obs = os.path.join(scratch, "nav_obs.rnx")
    sources = []
    build_source = cli.build_source

    def recording_build_source(cfg):
        sources.append(build_source(cfg))
        return sources[-1]

    cli.build_source = recording_build_source
    out, err = io.StringIO(), io.StringIO()
    _reset_launch_counts()                  # this path starts here
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(["--config", toml, "--pvt", "--ekf", "--rinex-obs",
                           obs, "--gps-week", str(NAV_WEEK), "--json"])
    finally:
        cli.build_source = build_source
    wall = time.perf_counter() - t0
    launches = _launch_counts()
    print(err.getvalue().rstrip())
    assert rc == 0, rc
    summary = json.loads(out.getvalue().strip().splitlines()[-1])
    timing = summary["stage_timing"]
    # the top-level stages (a dotted name is a sub-step of its parent)
    total = sum(v["total_s"] for k, v in timing.items() if "." not in k)
    print(f"CLI journey: {summary['time_ms'] / 1000:.1f} s of signal in "
          f"{wall:.3f} s wall (cli.main; the CLI's own wall_s "
          f"{summary['wall_s']}), real-time factor "
          f"{summary['realtime_factor']}x; launches {json.dumps(launches)}")
    print("  stage totals (s): " + json.dumps(
        {k: v["total_s"] for k, v in timing.items()}))
    print("  stage shares: " + json.dumps(
        {k: round(v["total_s"] / total, 4) for k, v in timing.items()}))
    assert len(sources) == 1 and isinstance(sources[0], NativeFileSource), \
        sources
    broadcast = sorted(ephs)
    assert summary["tracked_prns"] == broadcast, summary["tracked_prns"]
    assert summary["ephemerides"] == broadcast, summary["ephemerides"]
    fix = np.asarray(summary["pvt"]["ecef_m"])
    fix_err = float(np.linalg.norm(fix - NAV_RX_TRUE))
    header, epochs = parse_obs_file(obs)
    assert header["obs_types"] == ["C1C", "D1C", "S1C"], header
    assert len(epochs) > 0
    assert all(sorted(ep["sats"]) == broadcast for ep in epochs), epochs
    ekf_line = [ln for ln in err.getvalue().splitlines()
                if ln.startswith("ekf position:")]
    assert len(ekf_line) == 1, err.getvalue()
    ekf = np.asarray(json.loads(ekf_line[0].split(":", 1)[1]))
    ekf_err = float(np.linalg.norm(ekf - NAV_RX_TRUE))
    block = NAV_BLOCK_MS * int(NAV_FS) // 1000
    n_full = int(round(NAV_S * NAV_FS)) // block
    _expect_launches(launches, track_block_fused_mxu=n_full)
    print(f"  tracked and decoded {broadcast}; fix {fix_err:.2f} m from the "
          f"truth (gdop {summary['pvt']['gdop']}), EKF {ekf_err:.2f} m "
          f"(bound {NAV_FIX_M:g} m each); "
          f"{len(epochs)} RINEX OBS epochs parsed back; B1 launches "
          f"{launches['track_block_fused_mxu']} = tracking blocks")
    assert fix_err < NAV_FIX_M, fix_err
    assert ekf_err < NAV_FIX_M, ekf_err
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "gnss_sdr_tpu_torch", "--config", toml,
         "--blocks", "10", "--json"], capture_output=True, text=True,
        timeout=600, cwd=root)
    print(f"python -m gnss_sdr_tpu_torch --config {os.path.basename(toml)} "
          f"--blocks 10 --json: exit {sub.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    assert sub.returncode == 0, sub.stderr[-4000:]
    sub_summary = json.loads(sub.stdout.strip().splitlines()[-1])
    assert sub_summary["blocks"] == 10, sub_summary["blocks"]
    return {"wall_s": wall, "fix_m": fix_err, "ekf_m": ekf_err,
            "obs_epochs": len(epochs), "launches": launches}


def _count_dtoh(prof):
    """Device-to-host copies in a torch.profiler trace: the device's
    "Memcpy DtoH (Device -> ...)" records, summed by key as phase 12's
    profile is read."""
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("Memcpy DtoH"))


def _dtoh_in_pull(torch, rx):
    """Device-to-host copies made by one ``rx._pull_block()`` (its block
    on the card), from a profiler session that also makes one ``.cpu()``
    of its own (the control) and some kernels after it: a session whose
    trace lost the control (the profiler's activity buffer can drop
    records) is taken again, twice at most. Returns (copies, sessions)."""
    from gnss_sdr_tpu_torch.utils.profiling import trace

    probe = torch.ones(4, device="cuda")
    filler = torch.ones(1 << 20, device="cuda")
    for tries in range(1, 4):
        torch.cuda.synchronize()
        with trace(".chip_scratch/ingest_trace") as prof:
            (re, _), _ = rx._pull_block()
            torch.cuda.synchronize()
            probe.cpu()
            for _ in range(8):
                filler.mul_(1.0)
            torch.cuda.synchronize()
        assert isinstance(re, torch.Tensor) and re.is_cuda
        n = _count_dtoh(prof)
        if n >= 1:
            return n - 1, tries
    seen = sorted({e.key for e in prof.key_averages()
                   if "emcpy" in e.key or "mul" in e.key})
    raise AssertionError("the profiler lost the control copy in 3 "
                         f"sessions; the last one saw {seen}")


def pull_copies(torch):
    """{source: device-to-host copies in one ``_pull_block``} and the
    profiler sessions taken, for each device source feeding a 32-channel
    fused receiver (5 blocks of noise: a warm read and up to three
    sessions)."""
    from gnss_sdr_tpu_torch import AcqConfig, ReceiverConfig, RfConfig, \
        TrackConfig
    from gnss_sdr_tpu_torch.receiver import Receiver

    rng = np.random.default_rng(0)
    n = 5 * BLOCK_MS * 2046
    sig = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    copies, tries = {}, {}
    for kind in INGEST_SOURCES[1:]:
        src = _ingest_source(kind, sig, torch)
        rx = Receiver(ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(), track=TrackConfig(
                n_channels=N_CHANNELS, correlator="fused"),
            block_ms=BLOCK_MS), src, device="cuda")
        try:
            rx._pull_block()                # warm: the feeder started
            copies[kind], tries[kind] = _dtoh_in_pull(torch, rx)
        finally:
            if hasattr(src, "close"):
                src.close()
    return copies, tries


def pull_copies_fresh():
    """pull_copies in a fresh process: after the earlier phases' profiler
    sessions, this process's profiler records no device activity (seen on
    the H100 in whole runs of this script)."""
    import os

    out = subprocess.run(
        [sys.executable, "-c", "import json, torch, chip_smoke; "
         "print(json.dumps(chip_smoke.pull_copies(torch)))"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _ingest_source(kind, sig, torch):
    from gnss_sdr_tpu_torch.receiver import ArraySource, DeviceArraySource, \
        StreamingDeviceSource

    if kind == "array":
        return ArraySource(sig, FS)
    if kind == "device_f32":
        return DeviceArraySource(sig, FS, store="f32", device="cuda")
    if kind == "device_int8":
        return DeviceArraySource(sig, FS, store="int8", device="cuda")
    return StreamingDeviceSource(ArraySource(sig, FS), store="int8",
                                 device="cuda")


def phase_ingest(torch):
    """Phase 9 (b)'s steady receiver behind the four sources: the f32
    device source bit for bit equal to ArraySource, the int8 ones within
    40 Hz; ingest per block and the feeder's counters; one block pulled
    from each device source under the profiler with no device-to-host
    copy."""
    sats, sig = _scene(STEADY_S)
    n_blocks = sig.size // (BLOCK_MS * 2046)
    runs = {}
    for kind in INGEST_SOURCES:
        src = _ingest_source(kind, sig, torch)
        try:
            rx, summary, launches = _run_receiver(
                torch, sats, sig, f"ingest {kind}", scan_blocks=STEADY_SPAN,
                source=src)
        finally:
            if hasattr(src, "close"):
                src.close()
        _expect_launches(launches, track_block_fused_mxu=n_blocks)
        ing = summary["stage_timing"]["ingest"]
        stats = src.stats() if hasattr(src, "stats") else {}
        print(f"  ingest [{kind}]: {ing['total_s'] / ing['calls']:.6f} s per "
              f"block ({ing['calls']} reads), consumer_wait_s "
              f"{stats.get('consumer_wait_s', 'n/a')}, max_queue_depth "
              f"{stats.get('max_queue_depth', 'n/a')}")
        runs[kind] = (rx, summary, ing["total_s"] / ing["calls"], stats)
    _same_run("ingest", runs["array"][:2], runs["device_f32"][:2],
              what="ArraySource and DeviceArraySource(store='f32') runs")
    copies, tries = pull_copies_fresh()
    print(f"  device-to-host copies in one profiled _pull_block: "
          f"{json.dumps(copies)} (a fresh process; sessions taken "
          f"{json.dumps(tries)}, each ending with one .cpu() of its own, "
          f"not counted)")
    assert all(v == 0 for v in copies.values()), copies
    return {k: {"ingest_s_per_block": v[2], **v[3]} for k, v in runs.items()}


def phase_pad_fft(torch):
    """Ladder 2's acquisition (pad_fft, 4.092 MHz, 8 channels) on the
    card against the same engine on the CPU, then one search's time
    beside the circular engine's on the same samples."""
    import dataclasses

    from gnss_sdr_tpu_torch import presets
    from gnss_sdr_tpu_torch.models import GPS_L1CA, SatelliteScenario, \
        synthesize
    from gnss_sdr_tpu_torch.ops import pcps
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    cfg = presets.ladder2_eight_channel()
    fs = cfg.rf.output_sample_rate_hz
    assert cfg.acq.pad_fft and cfg.track.n_channels == 8 and fs == 4.092e6
    sats = [SatelliteScenario(prn=p, doppler_hz=d, code_phase_chips=c,
                              amplitude=0.25).with_code_doppler()
            for p, d, c in ((3, 1500.0, 100.5), (9, -3200.0, 511.0),
                            (17, 4750.0, 870.25), (22, -750.0, 33.0),
                            (28, 2250.0, 640.0))]
    engines = {dev: AcquisitionEngine(cfg.acq, GPS_L1CA, fs, device=dev)
               for dev in ("cuda", "cpu")}
    n = engines["cuda"].samples_needed
    x = synthesize(sats, n, fs, noise_std=1.0, seed=31)
    n_int = cfg.acq.non_coherent_ms
    res = {}
    for dev, eng in engines.items():
        xt = torch.from_numpy(x).to(dev)
        r = pcps.pcps_search(
            xt, eng.code_ffts, torch.from_numpy(eng.grid).to(dev), fs_hz=fs,
            n_int=n_int, threshold=eng._threshold(n_int, eng.grid)[0],
            pad_fft=True, n_fft=eng.n_fft)
        res[dev] = {k: getattr(r, k).cpu().numpy()
                    for k in ("detected", "code_phase_samples",
                              "carrier_freq_hz")}
        res[dev]["cands"] = [(c.prn, c.code_phase_samples)
                             for c in eng.search(x)]
    det = res["cuda"]["detected"]
    for k in ("detected", "code_phase_samples", "carrier_freq_hz"):
        np.testing.assert_array_equal(res["cuda"][k][det], res["cpu"][k][det],
                                      err_msg=k)
    np.testing.assert_array_equal(det, res["cpu"]["detected"])
    assert sorted(np.where(det)[0] + 1) == sorted(s.prn for s in sats), det
    assert res["cuda"]["cands"] == res["cpu"]["cands"]

    circ = AcquisitionEngine(dataclasses.replace(cfg.acq, pad_fft=False),
                             GPS_L1CA, fs, device="cuda")
    times = {}
    for name, eng, chunk in (("pad_fft", engines["cuda"], x),
                             ("circular", circ, x[:circ.samples_needed])):
        eng.search(chunk)                   # warm: cuFFT plans
        torch.cuda.synchronize()
        walls = []
        for _ in range(ACQ_PASSES):
            t0 = time.perf_counter()
            eng.search(chunk)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        times[name] = statistics.median(walls) * 1e3
    print(f"pad-FFT acquisition (ladder 2, {fs:g} Hz, 32 PRNs x "
          f"{engines['cuda'].grid.size} Doppler bins, {n_int} ms): "
          f"detections on the card equal the CPU run's "
          f"({[p for p, _ in res['cuda']['cands']]}); one search "
          f"(median of {ACQ_PASSES}, host clock, synchronized): pad_fft "
          f"{times['pad_fft']:.3f} ms, circular {times['circular']:.3f} ms")
    return times


# ---------------------------------------------------------------------------
# slice 10: the other GNSS systems at ladder 4's full width
# ---------------------------------------------------------------------------

WIDE_FS = 8_184_000.0               # ladder 4's rate (bench.py:_run_mixed)
MIXED_BLOCK_MS = 96                 # E1B 24 epochs, the 1 ms systems 96
MIXED_SPAN = 10                     # blocks per span
MIXED_WARM = 2 * MIXED_SPAN         # single blocks before the spans
MIXED_PASSES = 2                    # timed passes of MIXED_SPANS spans
MIXED_SPANS = 2
MIXED_CHANNELS = {"gps_l1ca": 8, "galileo_e1b": 4, "glonass_l1of": 4,
                  "beidou_b1i": 16}
# B1 at 96 ms blocks, power lock: (wp, R, K) per system
WIDE_MXU_SHAPES = {"gps_l1ca": (8704, 13, 8), "beidou_b1i": (8704, 9, 8),
                   "glonass_l1of": (8704, 21, 8),
                   "galileo_e1b": (33280, 9, 6)}
LADDER4_BLOCK_MS = 20               # presets.ladder4_multi_constellation
LADDER4_S = 1.0                     # its run: 50 blocks per branch
# ... at ladder 4's own 20 ms blocks (the second path), power lock
LADDER4_MXU_SHAPES = {"gps_l1ca": (8704, 13, 5), "beidou_b1i": (8704, 9, 5),
                      "glonass_l1of": (8704, 21, 5)}
# R above the whole-width layout's 16 on a narrow window: GLONASS at
# 1.023 MHz with 4-chip early-late spacing (wp 1536, R 21)
ONE_CHUNK_FS, ONE_CHUNK_EL = 1_023_000.0, 4.0
WIDE_SEG_WP = 33152                 # E1B on seg at 8.184 MHz (5 epochs)
WIDE_DIRECT_WP = 33280              # ... on direct (96 ms: 24 epochs)
WIDE_VARIANTS = {"power": {}, "costas": dict(lock_mode="costas")}
FDMA_HZ = 562_500.0


def mixed_sats(models):
    """bench.py's mixed scene (:541-558): 6 GPS L1 C/A, 2 Galileo E1B, 2
    GLONASS L1OF (FDMA channels +2 and -3), 4 BeiDou B1I; ``models`` the
    port's models package."""
    sat = models.SatelliteScenario
    return ([sat(prn=p, doppler_hz=float(400.0 * ((p % 5) - 2)),
                 code_phase_chips=float((37 * p) % 1023), amplitude=0.25,
                 signal=models.GPS_L1CA) for p in (2, 5, 9, 14, 21, 28)]
            + [sat(prn=p, doppler_hz=float(300.0 * (p % 3) - 300),
                   amplitude=0.22, signal=models.GALILEO_E1B)
               for p in (11, 19)]
            + [sat(prn=1, doppler_hz=2 * FDMA_HZ - 1200.0, amplitude=0.3,
                   signal=models.GLONASS_L1OF),
               sat(prn=2, doppler_hz=-3 * FDMA_HZ + 800.0, amplitude=0.3,
                   signal=models.GLONASS_L1OF)]
            + [sat(prn=p, doppler_hz=float(250.0 * (p % 4) - 500),
                   amplitude=0.28, signal=models.BEIDOU_B1I)
               for p in (6, 12, 27, 33)])


def mixed_truth(sats):
    """{system: {reported PRN: Doppler}} of a scene: GLONASS channels
    report the pseudo-PRN of their FDMA channel (k + 8 for channel k in
    range(-7, 7)), their Doppler with its FDMA offset."""
    out: dict = {}
    for s in sats:
        prn = s.prn
        if s.signal.name == "glonass_l1of":
            prn = int(round(s.doppler_hz / FDMA_HZ)) + 8
        out.setdefault(s.signal.name, {})[prn] = s.doppler_hz
    return out


def wide_tracker(torch, device, system, cfg_kw, layout="mxu",
                 block_ms=MIXED_BLOCK_MS, fs=WIDE_FS, n_channels=None,
                 shared_fetch=False, wire="f32"):
    """A FusedTracker for ``system`` at ``fs`` (8.184 MHz) with the mixed
    scene's satellites of that system (each channel started on its
    satellite's code boundary at its true Doppler, the FDMA offset
    included; the system's other channels, MIXED_CHANNELS or
    ``n_channels``, idle). Returns (tracker, state, replica rows on
    ``device``, the satellites, the history)."""
    from gnss_sdr_tpu_torch import models
    from gnss_sdr_tpu_torch.config import TrackConfig
    from gnss_sdr_tpu_torch.models.constellation import get_signal
    from gnss_sdr_tpu_torch.receiver import tracking as trk
    from gnss_sdr_tpu_torch.receiver.fused_runner import FusedTracker

    spec = get_signal(system)
    c = n_channels or MIXED_CHANNELS[system]
    sats = [s for s in mixed_sats(models) if s.signal.name == system][:c]
    n0 = spec.samples_per_code(fs)
    t_epochs = block_ms // spec.code_period_ms
    cfg = TrackConfig(signal=system, n_channels=c, correlator="fused",
                      **cfg_kw)
    params = trk.TrackParams.create(cfg, spec, fs)
    codes = trk.make_sampled_code_table(spec, fs,
                                        max(s.prn for s in sats),
                                        window=params.window)
    history = 2 * n0 + 4096
    ft = FusedTracker(params, cfg, spec, fs, codes, t_epochs,
                      history + t_epochs * n0, layout=layout, device=device,
                      shared_fetch=shared_fetch, wire=wire)
    st = trk.init_state(c)
    chips = spec.code_length_chips
    for ch, s in enumerate(sats):
        off = int(round((chips - s.code_phase_chips) % chips * fs
                        / spec.code_rate_hz))
        if off <= ft.el_pad:
            off += n0
        st = trk.start_channel(st, ch, s.prn - 1, s.doppler_hz, off,
                               spec.code_rate_hz)
    rows = torch.from_numpy(codes[np.maximum(st.prn_idx, 0)]).to(device)
    return ft, st, rows, sats, history


def wide_inputs(torch, device, system, cfg_kw, layout="mxu",
                block_ms=MIXED_BLOCK_MS, seed=7, fs=WIDE_FS,
                n_channels=None, shared_fetch=False):
    """One block's kernel inputs for ``system`` at ``fs`` (8.184 MHz)
    through FusedTracker's own re-anchor, on wide_tracker's channels and
    the system's satellites rendered alone (``seed``); with
    ``shared_fetch`` B2's ([C + 1] starts, spread_cap).
    Returns a dict: "ft", "args", "kw", "n_sats"; for seg, args are
    B4b's on the segments of B4c's plain version and "gather" holds
    B4c's (args, kw)."""
    from gnss_sdr_tpu_torch import models
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    ft, st, rows, sats, history = wide_tracker(
        torch, device, system, cfg_kw, layout=layout, block_ms=block_ms,
        fs=fs, n_channels=n_channels, shared_fetch=shared_fetch)
    sig = models.synthesize(sats, history + ft.t_epochs * ft.n0, fs,
                            noise_std=1.0, seed=seed)
    args, kw = ft.kernel_args(ft.anchor_block(st),
                              np.real(sig).astype(np.float32),
                              np.imag(sig).astype(np.float32), rows)
    out = dict(ft=ft, args=args, kw=kw, n_sats=len(sats))
    if ft.layout == "seg":
        host = kw.pop("starts_host")
        sre, sim, starts, reps, mat = args
        gather = ((sre, sim, starts, ft.l_seg), dict(starts_host=host))
        seg = fused.gather_segments_reference(*gather[0], **gather[1])
        out.update(args=(*seg, reps, mat), gather=gather)
    return out


def _margins(err):
    return json.dumps({k: float(f"{v:.3e}") for k, v in err.items()})


def _check_active(sk, n_sats, label):
    active = sk[:, 7].cpu().numpy()
    assert active[:n_sats].all() and not active[n_sats:].any(), (
        label, active)


@contextlib.contextmanager
def lane_layout(fused, cs, warps=None):
    """B1's lane clusters at size ``cs`` only (and ``warps`` warps a
    block) while the context is open: the plan offers that size alone."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    saved = ep.LANE_CLUSTERS, fused.MXU_LANE_WARPS
    ep.LANE_CLUSTERS = (cs,)
    fused.MXU_LANE_WARPS = warps or saved[1]
    try:
        yield
    finally:
        ep.LANE_CLUSTERS, fused.MXU_LANE_WARPS = saved


def streamed_case(torch, device, wp=98_304, rows=16, c=2, seed=3):
    """B1's inputs on a window far wider than any receiver path's (K 5,
    T 10, random stream and sign replicas, 8.184 MHz' n0): wide enough
    that a block's bank rows do not stay resident in lane clusters but
    are streamed in sub-chunks. Returns (args, kw)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    n0 = 8184
    n = fused.direct_span(5, n0, wp) + (5 * n0 // 128) * 128
    gen = torch.Generator(device=device).manual_seed(seed)
    sre, sim = (torch.randn(n, generator=gen, device=device)
                for _ in range(2))
    reps = torch.sign(torch.randn((c, rows, wp), generator=gen,
                                  device=device)).to(torch.bfloat16)
    st = torch.zeros((c, fused.N_FIELDS), device=device)
    st[:, 0], st[:, 3], st[:, 7], st[:, 11] = 800.0, 1.023e6, 1.0, 1.0
    st[:, 9] = 3.0
    starts = torch.zeros(c, dtype=torch.int32, device=device)
    kw = dict(t_epochs=10, k_epochs=5, n0=n0, wp=wp, fs=WIDE_FS,
              starts_host=np.zeros(c, np.int32))
    return (sre, sim, starts, reps, st), kw


def launched_lane(args, kw):
    """The lane option the wrapper launches on ``args``/``kw`` (the
    plan's, in launch_order) with the clusters the card holds at once
    ("active")."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    wp, k, reps, st = kw["wp"], kw["k_epochs"], args[3], args[4]
    lean = kw.get("telem_mode") == "lean"
    plan = fused.mxu_smem_plan(wp, reps.shape[1], k,
                               c_channels=st.shape[0])
    opt = ep.launch_order(plan["options"], st.shape[0],
                          lambda o: fused.lane_active_clusters(
                              st.device, k, wp, reps.shape[1], lean, o))[0]
    return dict(opt, active=fused.lane_active_clusters(
        st.device, k, wp, reps.shape[1], lean, opt))


def _lane_label(plan):
    """A lane-cluster option in a few words."""
    bank = "resident" if plan["resident"] else f"streamed by {plan['sub']}"
    rows = "staged" if plan["staged"] else "from global memory"
    active = (f", {plan['active']} clusters at once" if "active" in plan
              else "")
    return (f"cluster {plan['cs']} x {plan['warps']} warps, parts of <= "
            f"{max(w for _, w in plan['parts'])} lanes, bank {bank}, "
            f"windows {rows}, {plan['bytes']} B{active}")


def phase_wide_check(torch):
    """Slice 10's kernel shapes against the plain versions, open loop,
    power and Costas lock: B1 in lane clusters at the four ladder-4
    shapes (8.184 MHz, 96 ms blocks), at the three 1 ms systems' shapes
    of ladder 4's own 20 ms blocks (K 5, the second path), and at R 21 on
    GLONASS's 1.023 MHz window (4-chip early-late spacing), at every
    cluster size the plan offers and at 8 warps at its first, full and
    lean (lean equal to full bit for bit); then the per-epoch kernels in
    lane clusters (wide_epoch_check). Returns the largest |error| of the
    correlations per kernel."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    max_abs = {"mxu": 0.0, "seg": 0.0, "direct": 0.0}
    cases = ([(system, shape, {}, MIXED_BLOCK_MS)
              for system, shape in WIDE_MXU_SHAPES.items()]
             + [(system, shape, {}, LADDER4_BLOCK_MS)
                for system, shape in LADDER4_MXU_SHAPES.items()]
             + [("glonass_l1of", (1536, 21, 5),
                 dict(fs=ONE_CHUNK_FS, n_channels=2), LADDER4_BLOCK_MS)])
    for system, (wp, rows, k), in_kw, block_ms in cases:
        for name, cfg_kw in WIDE_VARIANTS.items():
            if "fs" in in_kw:
                cfg_kw = dict(cfg_kw, early_late_chips=ONE_CHUNK_EL)
            inp = wide_inputs(torch, "cuda", system, cfg_kw,
                              block_ms=block_ms, **in_kw)
            ft, args, kw = inp["ft"], inp["args"], inp["kw"]
            assert (ft.layout, ft.wp, ft.n_rows) == ("mxu", wp, rows), (
                system, ft.layout, ft.wp, ft.n_rows)
            k_run = kw["k_epochs"]
            assert k_run == (k if name == "power" else 2), (system, k_run)
            c = args[4].shape[0]
            plan = fused.mxu_smem_plan(wp, rows, k_run, c_channels=c)
            assert plan["layout"] == "cluster", plan
            variants = [(o["cs"], None) for o in plan["options"]]
            variants.append((plan["cs"], 24 - plan["warps"]))
            for cs, warps in variants:
                with lane_layout(fused, cs, warps):
                    opt = launched_lane(args, kw)
                    before = fused.launch_count
                    tk, sk, err = open_loop_compare(torch, args, kw)
                    assert fused.launch_count == before + kw[
                        "t_epochs"] // (2 * k_run)
                    tl, sl = fused.track_block_fused_mxu(
                        *args, **dict(kw, telem_mode="lean"))
                lean_equals_full(torch, tk, sk, tl, sl, k_run,
                                 name == "costas")
                _check_active(sk, inp["n_sats"], (system, name, cs))
                max_abs["mxu"] = max(max_abs["mxu"], err["corr_max_abs"])
                print(f"B1 vs plain, open loop [{system} {name}: "
                      f"{in_kw.get('fs', WIDE_FS) / 1e6:g} MHz, wp {wp}, "
                      f"R {rows}, K {k_run}, T {kw['t_epochs']}, {c} ch, "
                      f"{_lane_label(opt)}]: {_margins(err)}; lean equal "
                      "to full")
    # far wider than any path: the bank rows streamed in sub-chunks
    args, kw = streamed_case(torch, "cuda")
    plan = fused.mxu_smem_plan(kw["wp"], args[3].shape[1], kw["k_epochs"],
                               c_channels=args[4].shape[0])
    assert plan["layout"] == "cluster" and not plan["resident"], plan
    _, _, err = open_loop_compare(torch, args, kw)
    max_abs["mxu"] = max(max_abs["mxu"], err["corr_max_abs"])
    print(f"B1 vs plain, open loop [random, wp {kw['wp']}, R "
          f"{args[3].shape[1]}, K 5, T 10, "
          f"{_lane_label(launched_lane(args, kw))}]: {_margins(err)}")
    max_abs.update(wide_epoch_check(torch))
    return max_abs


EPOCH_WIDE_CHANNELS = (4, 8)        # E1B: the mixed row's 4, the preset's 8
EPOCH_WIDE_PIECE = {"seg": 1, "windows": 5, "resident": 5}


@contextlib.contextmanager
def epoch_layout(cs):
    """The per-epoch kernels' lane clusters at size ``cs`` only while the
    context is open: the plan offers that size alone."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    saved = ep.LANE_CLUSTERS
    ep.LANE_CLUSTERS = (cs,)
    try:
        yield
    finally:
        ep.LANE_CLUSTERS = saved


def _epoch_shape(kind, args, kw):
    """(wp, replica rows, el_shift, state) of a per-epoch kernel's
    args/kw (B3's "direct" args hold the starts before the replicas)."""
    reps, st = (args[3], args[4]) if kind == "direct" else args[2:4]
    return reps.shape[2], reps.shape[1], int(kw.get("el_shift", 1)), st


def launched_epoch(kind, args, kw):
    """The layout the per-epoch wrapper launches on ``args``/``kw``: the
    plan (epoch_smem_plan) where it is one block a channel, else its
    first option in launch_order with the clusters the card holds at once
    ("active")."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    wp, rows, el, st = _epoch_shape(kind, args, kw)
    c = st.shape[0]
    plan = ep.epoch_smem_plan(wp, rows, el_shift=el)
    if plan["layout"] == "single":
        return plan
    active = {o["cs"]: ep.epoch_active_clusters(st.device, kind, wp, rows,
                                                el, o["cs"])
              for o in plan["options"]}
    opt = ep.launch_order(plan["options"], c, lambda o: active[o["cs"]])[0]
    return dict(opt, layout="cluster", active=active[opt["cs"]])


def _epoch_label(plan):
    """A per-epoch layout in a few words."""
    if plan["layout"] == "single":
        return f"one block a channel, {plan['bytes']} B"
    active = (f", {plan['active']} clusters at once" if "active" in plan
              else "")
    return (f"cluster {plan['cs']}, parts of <= "
            f"{max(w for _, w in plan['parts'])} lanes, halo "
            f"{plan['halo']}, {plan['bytes']} B{active}")


def check_ranks(torch, ranks, label):
    """Every rank's final state equals the launch's (rank 0's) in each
    collected lane-cluster launch (track_block_epoch.rank_states);
    returns the launches checked."""
    torch.cuda.synchronize()
    assert ranks, f"{label}: no lane-cluster launch"
    for rs, st in ranks:
        for r in range(rs.shape[1]):
            assert torch.equal(rs[:, r], st[:, :12]), (label, r)
    return len(ranks)


def epoch_wide_inputs(torch, kind, cfg_kw, n_channels, device="cuda"):
    """One wide block of a per-epoch kernel through FusedTracker's own
    re-anchor (wide_inputs): B4b ("seg", with B4c's gather) and B3
    ("direct") on Galileo E1B at 8.184 MHz (20 and 96 ms blocks), B4a
    ("windows": slice_windows) and B6 ("resident": the windows run's
    stream, its offsets in state col 9, build_replicas_shared) on GPS L1
    C/A at 8.184 MHz, 20 ms blocks. Returns a dict as wide_inputs."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    if kind in ("seg", "direct"):
        inp = wide_inputs(torch, device, "galileo_e1b", cfg_kw, layout=kind,
                          block_ms=LADDER4_BLOCK_MS if kind == "seg"
                          else MIXED_BLOCK_MS, n_channels=n_channels)
        wp = WIDE_SEG_WP if kind == "seg" else WIDE_DIRECT_WP
        assert (inp["ft"].layout, inp["ft"].wp) == (kind, wp)
        return inp
    ft, st0, rows, sats, history = wide_tracker(
        torch, device, "gps_l1ca", cfg_kw, layout="windows",
        block_ms=LADDER4_BLOCK_MS, n_channels=n_channels)
    from gnss_sdr_tpu_torch import models

    sig = models.synthesize(sats, history + ft.t_epochs * ft.n0, WIDE_FS,
                            noise_std=1.0, seed=7)
    (sre, sim, _, reps, mat), kw = ft.kernel_args(
        ft.anchor_block(st0), np.real(sig).astype(np.float32),
        np.imag(sig).astype(np.float32), rows)
    host = kw.pop("starts_host")
    wre, wim = fused.slice_windows(sre, sim, host, ft.t_epochs, ft.n0,
                                   ft.wp, ft.el_pad)
    if kind == "windows":
        return dict(ft=ft, args=(wre, wim, reps, mat), kw=kw,
                    n_sats=len(sats))
    assert host.min() >= 0 and host.max() < ft.n0, host
    return dict(resident_inputs(torch, ft, (sre, sim), host, rows, reps,
                                mat, kw, WIDE_FS), n_sats=len(sats))


def _epoch_open(torch, kind, args, kw):
    """One per-epoch kernel against its plain version, open loop (B3 by
    supersteps, the others by EPOCH_WIDE_PIECE)."""
    if kind == "direct":
        return open_loop_compare(torch, args, kw, layout="direct")
    return epoch_open_loop(torch, kind, args, kw,
                           piece=EPOCH_WIDE_PIECE[kind])


def wide_epoch_check(torch):
    """The per-epoch kernels in lane clusters against their plain
    versions, open loop: B4b (with B4c, bit for bit) at Galileo E1B's seg
    width (wp 33,152, 20 ms blocks: 5 epochs, pieces of one) and B3 at
    its direct width (wp 33,280, 96 ms blocks), power and Costas, at 4
    and 8 channels (the mixed row's, the preset's), at every cluster size
    the plan offers; then B4a (windows) and B6 (resident) once each on
    GPS at 8.184 MHz. Each run holds the launches (the prefixes of the
    open loop included) and every rank's final state equal to rank 0's.
    Returns the largest |error| of the correlations per kernel."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    key = {"seg": "track_block_fused_seg",
           "direct": "track_block_fused_direct",
           "windows": "track_block_fused", "resident":
           "track_block_fused_resident"}
    max_abs = {k: 0.0 for k in key}
    cases = ([(kind, name, cfg_kw, c) for name, cfg_kw in
              WIDE_VARIANTS.items() for c in EPOCH_WIDE_CHANNELS
              for kind in ("seg", "direct")]
             + [("windows", "power", {}, 8), ("resident", "power", {}, 8)])
    for kind, name, cfg_kw, c in cases:
        inp = epoch_wide_inputs(torch, kind, cfg_kw, c)
        args, kw = inp["args"], inp["kw"]
        if kind == "seg":
            g_args, g_kw = inp["gather"]
            got = fused.gather_segments(*g_args, **g_kw)
            torch.cuda.synchronize()
            assert torch.equal(got[0], args[0]) and \
                torch.equal(got[1], args[1]), "B4c differs"
        wp, rows, el, _ = _epoch_shape(kind, args, kw)
        plan = ep.epoch_smem_plan(wp, rows, el_shift=el)
        assert plan["layout"] == "cluster", (kind, plan)
        # the size the wrapper takes: C clusters the card holds at once,
        # so its C x cs blocks fit on the card's SMs
        first = launched_epoch(kind, args, kw)
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        assert first["active"] >= c and c * first["cs"] <= n_sm, first
        sizes = [o["cs"] for o in plan["options"]]
        if kind in ("windows", "resident"):
            sizes = [first["cs"]]
        for cs in sizes:
            with epoch_layout(cs), ep.rank_states() as ranks:
                opt = launched_epoch(kind, args, kw)
                assert opt["cs"] == cs, (opt, cs)
                before = _launch_counts()
                tk, sk, err = _epoch_open(torch, kind, args, kw)
                launched = {k: v - before[k]
                            for k, v in _launch_counts().items()}
            n = check_ranks(torch, ranks, (kind, name, c, cs))
            assert launched[key[kind]] == n and \
                sum(launched.values()) == n, launched
            _check_active(sk, inp["n_sats"], (kind, name, c, cs))
            max_abs[kind] = max(max_abs[kind], err["corr_max_abs"])
            print(f"{key[kind]} vs plain, open loop [{name}, wp {wp}, T "
                  f"{kw.get('t_epochs', args[0].shape[0])}, {c} ch, "
                  f"{_epoch_label(opt)}]: {_margins(err)}; {n} launches, "
                  "every rank's state equal to rank 0's"
                  + ("; B4c equal to its plain version" if kind == "seg"
                     else ""))
    return max_abs


def old_chunks():
    """tools/b1_chunked.py: B1's earlier lane-chunk kernel, for timing."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tools" / "b1_chunked.py"
    spec = importlib.util.spec_from_file_location("b1_chunked", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lane_turns(torch, args, kw, old_fn, passes=KERNEL_PASSES):
    """B1 in lane clusters on ``args``/``kw`` in turns against its
    earlier lane-chunk kernel (``old_fn``, tools/b1_chunked.py): the old
    kernel, then each cluster size the plan offers at 8 and at 16 warps,
    then the same backwards, each turn
    ``passes`` queued launches behind a head start with the L2 flushed
    (_time_queued). Returns {"turns": {variant: median ms}, "old_ms",
    "old_chunk", "cs", "warps", "staged", "resident" (what the wrapper
    launches: launched_lane), "active_clusters" (per size, the clusters
    the card holds at once)}."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    wp, k = kw["wp"], kw["k_epochs"]
    rows, c = args[3].shape[1], args[4].shape[0]
    plan = fused.mxu_smem_plan(wp, rows, k, c_channels=c)
    layouts = [(o["cs"], w) for o in plan["options"] for w in (8, 16)]
    tools = old_chunks()

    def variant(layout):
        if layout is None:
            def run():
                with tools.using(old_fn):
                    return fused.track_block_fused_mxu(*args, **kw)
            return run

        def run():
            with lane_layout(fused, *layout):
                return fused.track_block_fused_mxu(*args, **kw)
        return run

    names = {None: "old"} | {v: f"cs{v[0]}_w{v[1]}" for v in layouts}
    runs = {v: variant(v) for v in names}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for run in runs.values():
        run()
    torch.cuda.synchronize()
    times = {v: [] for v in names}
    order = list(names)
    for v in order + order[::-1]:
        times[v] += _time_queued(torch, runs[v], passes, flush)
    turns = {names[v]: statistics.median(t) for v, t in times.items()}
    opt = launched_lane(args, kw)
    active = {f"cs{o['cs']}": fused.lane_active_clusters(
        args[4].device, k, wp, rows, False, o) for o in plan["options"]}
    return dict(turns=turns, old_ms=turns["old"],
                old_chunk=tools.chunk_plan(wp, rows, k)["chunk"],
                cs=opt["cs"], warps=opt["warps"], staged=opt["staged"],
                resident=opt["resident"], active_clusters=active)


def phase_wide_timing(torch):
    """The wide shapes' times per block (as phases 4 and 16: the L2
    flushed, queued launches behind a head start, median of the passes),
    their plain versions' (two passes) and their bounds: B1 at the four
    ladder-4 shapes per 96 ms block and at the three 20 ms shapes, each
    also in turns against its earlier lane-chunk kernel at each cluster
    size (lane_turns); B4b per 20 ms Galileo block at wp 33,152 and B3
    per 96 ms Galileo block at wp 33,280, at 4 and 8 channels, each at
    every cluster size the plan offers in turns (epoch_turns); B4c at 4
    channels; B4a and B6 per 20 ms GPS block at 8.184 MHz (8 channels)
    in the size the wrapper launches."""
    out = {}

    def show(key, res, what):
        out[key] = res
        print(f"timing [{key}] (ms per {what}): " + json.dumps(
            {k: (round(v, 6) if isinstance(v, float) else v)
             for k, v in res.items()}))

    old_fn = old_chunks().launcher(old_chunks().load())
    for key, system, (wp, rows, _), block_ms in (
            [("mxu_" + k, k, v, MIXED_BLOCK_MS)
             for k, v in WIDE_MXU_SHAPES.items()]
            + [("mxu20_" + k, k, v, LADDER4_BLOCK_MS)
               for k, v in LADDER4_MXU_SHAPES.items()]):
        inp = wide_inputs(torch, "cuda", system, {}, block_ms=block_ms)
        res = kernel_timing(torch, "mxu", inp["args"], inp["kw"],
                            plain_passes=2)
        res.update(wp=wp, rows=rows, k_epochs=inp["kw"]["k_epochs"],
                   t_epochs=inp["kw"]["t_epochs"],
                   channels=MIXED_CHANNELS[system])
        res.update(lane_turns(torch, inp["args"], inp["kw"], old_fn))
        show(key, res, f"{block_ms} ms block, {res['channels']} ch")
    for c in EPOCH_WIDE_CHANNELS:
        sfx = "" if c == 4 else f"_{c}ch"
        inp = epoch_wide_inputs(torch, "seg", {}, c)
        res = epoch_timing(torch, "seg", inp["args"], inp["kw"])
        res.update(epoch_turns(torch, "seg", inp["args"], inp["kw"]),
                   channels=c, l_seg=inp["ft"].l_seg)
        show("seg" + sfx, res, f"20 ms block, {c} ch")
        if c == 4:
            show("gather", gather_timing(torch, *inp["gather"]),
                 "20 ms block, 4 ch")
        inp = epoch_wide_inputs(torch, "direct", {}, c)
        res = kernel_timing(torch, "direct", inp["args"], inp["kw"],
                            plain_passes=2)
        res.update(epoch_turns(torch, "direct", inp["args"], inp["kw"]),
                   channels=c, t_epochs=inp["kw"]["t_epochs"],
                   k_epochs=inp["kw"]["k_epochs"], wp=WIDE_DIRECT_WP)
        show("direct" + sfx, res, f"96 ms block, {c} ch")
    for kind in ("windows", "resident"):
        inp = epoch_wide_inputs(torch, kind, {}, 8)
        res = epoch_timing(torch, kind, inp["args"], inp["kw"])
        res.update(cs=launched_epoch(kind, inp["args"], inp["kw"])["cs"],
                   channels=8)
        show(kind + "_wide", res, "20 ms GPS block at 8.184 MHz, 8 ch")
    return out


def epoch_turns(torch, kind, args, kw, passes=KERNEL_PASSES):
    """A per-epoch kernel in lane clusters on ``args``/``kw``, at each
    cluster size the plan offers in turns (each size once, then the same
    backwards), each turn ``passes`` queued launches behind a head start
    with the L2 flushed (_time_queued). Returns {"turns": {"cs<n>":
    median ms}, "cs" (the size the wrapper launches), "active_clusters"
    (per size, the clusters the card holds at once)}."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep

    kernel = _epoch_fns(kind)[0]
    wp, rows, el, st = _epoch_shape(kind, args, kw)
    plan = ep.epoch_smem_plan(wp, rows, el_shift=el)
    sizes = [o["cs"] for o in plan["options"]]

    def run(cs):
        with epoch_layout(cs):
            return kernel(*args, **kw)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for cs in sizes:
        run(cs)
    torch.cuda.synchronize()
    times = {cs: [] for cs in sizes}
    for cs in sizes + sizes[::-1]:
        times[cs] += _time_queued(torch, lambda: run(cs), passes, flush)
    return dict(turns={f"cs{cs}": statistics.median(t)
                       for cs, t in times.items()},
                cs=launched_epoch(kind, args, kw)["cs"],
                active_clusters={f"cs{cs}": ep.epoch_active_clusters(
                    st.device, kind, wp, rows, el, cs) for cs in sizes})


def mixed_configs(block_ms=MIXED_BLOCK_MS, correlator="fused"):
    """bench.py's mixed row (:576-611): 32 channels, GPS 8, Galileo E1B 4,
    GLONASS L1OF 4, BeiDou B1I 16, at 8.184 MHz."""
    from gnss_sdr_tpu_torch import AcqConfig, ReceiverConfig, RfConfig, \
        TrackConfig

    def cfg(signal, n_channels, **acq):
        return ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=WIDE_FS),
            acq=AcqConfig(signal=signal, **acq),
            track=TrackConfig(signal=signal, n_channels=n_channels,
                              correlator=correlator),
            block_ms=block_ms)

    configs = {
        "gps_l1ca": cfg("gps_l1ca", 8),
        "galileo_e1b": cfg("galileo_e1b", 4, n_prn=36, non_coherent_ms=16,
                           detection_threshold=12.0),
        "glonass_l1of": cfg("glonass_l1of", 4, n_prn=14,
                            fdma_spacing_hz=FDMA_HZ,
                            fdma_channels=tuple(range(-7, 7))),
        "beidou_b1i": cfg("beidou_b1i", 16, n_prn=37,
                          detection_threshold=10.0),
    }
    assert {k: c.track.n_channels for k, c in configs.items()} == \
        MIXED_CHANNELS
    return configs


def multi_run_counted(mrx, n_blocks, scan_blocks=1):
    """``mrx.run(max_blocks=n_blocks, scan_blocks=scan_blocks)``, each
    branch's kernel launches and blocks counted around its own turn: the
    round robin calls each branch's ``step`` (single blocks) or ``run``
    (spans) once per turn, and that method is wrapped on the instance for
    the call. Returns {branch: (blocks, launches)}."""
    per = {name: (0, dict.fromkeys(_launch_counts(), 0))
           for name in mrx.receivers}
    attr = "run" if scan_blocks > 1 else "step"

    def counted(name, rx, turn):
        def call(*args, **kw):
            before, b0 = _launch_counts(), rx.window.blocks_fed
            out = turn(*args, **kw)
            blocks, launches = per[name]
            per[name] = (blocks + rx.window.blocks_fed - b0,
                         {k: launches[k] + v - before[k]
                          for k, v in _launch_counts().items()})
            return out
        return call

    for name, rx in mrx.receivers.items():
        setattr(rx, attr, counted(name, rx, getattr(rx, attr)))
    try:
        mrx.run(max_blocks=n_blocks, scan_blocks=scan_blocks)
    finally:
        for rx in mrx.receivers.values():
            delattr(rx, attr)
    return per


def searched(truth, configs):
    """The scene's PRNs that the acquisition scheduler searches: the cold
    search takes the first ``cold_pacing[1]`` PRNs (32) and the warm and
    steady ones the first 8 and 5 untracked (do_acquisition.rs:65-68, as
    the JAX package), so a PRN above 32 is never searched once one
    satellite is tracked (ROADMAP C17: BeiDou 33 of the mixed scene, which
    bench.py's TPU row did not track either)."""
    return {system: {p: d for p, d in prns.items()
                     if p <= configs[system].acq.cold_pacing[1]}
            for system, prns in truth.items()}


def _check_multi(mrx, truth, label):
    """Every PRN of ``truth`` tracked per system and no other, each one's
    Doppler over the last block (the mean of its carrier-frequency trace
    over the block's epochs, as phase 9 reads it: B1's held rates jitter
    from superstep to superstep, by up to ~70 Hz at E1B's 24 ms
    supersteps, K 6) within 40 Hz; returns the largest |error| per
    system."""
    worst = {}
    for system, prns in truth.items():
        rx = mrx.receivers[system]
        tracked = rx.summary()["tracked_prns"]
        assert tracked == sorted(prns), (label, system, tracked)
        dop = settled_doppler(rx, rx.epochs_per_block)
        errs = [abs(dop[p] - want) for p, want in prns.items()]
        worst[system] = max(errs)
        assert worst[system] < 40.0, (label, system, errs)
    return worst


# the mixed row's `track` s per branch and B1's ms per 96 ms block in its
# run on the lane-chunk kernel (PERF.md section 5): B1's share of `track`
# then, 70 blocks x ms / track
CHUNKED_MIXED_TRACK_S = {"gps_l1ca": 0.136, "galileo_e1b": 0.093,
                         "glonass_l1of": 0.117, "beidou_b1i": 0.110}
CHUNKED_B1_MS = {"gps_l1ca": 0.464, "galileo_e1b": 0.382,
                 "glonass_l1of": 0.723, "beidou_b1i": 0.460}


def phase_mixed(torch, b1_ms=None, seg_ms=None):
    """Ladder 4 at full width, as bench.py's mixed row runs it: one 8.184
    MHz stream of the 14 satellites (seed 7), 32 channels over four
    branches, 96 ms blocks, correlator "fused" (every branch on B1's mxu
    layout, the lane-chunked layout at these widths), a
    DeviceArraySource(store="int8") per branch; single blocks, then
    10-block spans, each branch's B1 launches equal to its blocks; the
    real-time factor of two timed passes of two spans each; every scene
    PRN that the acquisition searches (``searched``: all but BeiDou 33)
    tracked per system, its Doppler over the last block within 40 Hz.
    Then presets.ladder4_multi_constellation() with correlator "fused" at
    its 20 ms blocks: Galileo on seg (B4c and B4b once per block at wp
    33,152), the others on B1 at K = 5. Returns the B1 launches per
    branch of the mixed row and each kernel's launches per branch of
    ladder 4's."""
    import dataclasses

    from gnss_sdr_tpu_torch import models, presets
    from gnss_sdr_tpu_torch.receiver import DeviceArraySource, \
        MultiConstellationReceiver

    sats = mixed_sats(models)
    truth = mixed_truth(sats)
    # what the run reads: the single blocks, one span, the timed passes
    blocks = MIXED_WARM + MIXED_SPAN + MIXED_PASSES * MIXED_SPANS \
        * MIXED_SPAN + 1
    n = blocks * MIXED_BLOCK_MS * int(WIDE_FS) // 1000
    t0 = time.perf_counter()
    sig = render_scene(models, sats, n, WIDE_FS, seed=7)
    print(f"mixed scene: {n / WIDE_FS:.3f} s at {WIDE_FS:g} Hz, 14 "
          f"satellites, rendered in {time.perf_counter() - t0:.1f} s")
    configs = mixed_configs()
    mrx = MultiConstellationReceiver(configs, sources={
        name: DeviceArraySource(sig, WIDE_FS, store="int8")
        for name in configs})
    assert all(rx.device.type == "cuda" for rx in mrx.receivers.values())
    _reset_launch_counts()                  # this path starts here
    per = multi_run_counted(mrx, MIXED_WARM)
    spans = multi_run_counted(mrx, MIXED_SPAN, scan_blocks=MIXED_SPAN)
    for name, rx in mrx.receivers.items():
        assert rx.fused.layout == "mxu", (name, rx.fused.layout)
        for part in (per, spans):
            b, launches = part[name]
            _expect_launches(launches, track_block_fused_mxu=b)
    launches = {name: per[name][1]["track_block_fused_mxu"]
                + spans[name][1]["track_block_fused_mxu"]
                for name in per}
    rtf = []
    for _ in range(MIXED_PASSES):
        t0 = time.perf_counter()
        timed = multi_run_counted(mrx, MIXED_SPANS * MIXED_SPAN,
                                  scan_blocks=MIXED_SPAN)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rtf.append(MIXED_SPANS * MIXED_SPAN * MIXED_BLOCK_MS / 1000 / wall)
        for name, (b, got) in timed.items():
            assert b == MIXED_SPANS * MIXED_SPAN, (name, b)
            _expect_launches(got, track_block_fused_mxu=b)
            launches[name] += got["track_block_fused_mxu"]
    summary = mrx.summary()
    worst = _check_multi(mrx, searched(truth, configs), "mixed")
    shares = {name: {k: round(v["total_s"], 4)
                     for k, v in out["stage_timing"].items()}
              for name, out in summary.items()}
    print(f"mixed receiver [32 ch, {MIXED_BLOCK_MS} ms blocks, spans of "
          f"{MIXED_SPAN}, DeviceArraySource int8]: tracked "
          f"{ {k: v['tracked_prns'] for k, v in summary.items()} }, max "
          f"|doppler error| {json.dumps(worst)} Hz; B1 launches per "
          f"branch {json.dumps(launches)} (= blocks); real-time factor "
          f"{[round(r, 3) for r in rtf]} (pass agreement "
          f"{min(rtf) / max(rtf):.3f})")
    print("  stage totals (s) per branch: " + json.dumps(shares))
    if b1_ms:
        # B1's share of each branch's `track`: its launches x its time per
        # block (phase 25), beside the lane-chunk kernel's run
        share = {name: {
            "track_s": shares[name]["track"], "b1_launches": launches[name],
            "b1_ms": b1_ms[name],
            "b1_share": launches[name] * b1_ms[name] / 1e3
            / shares[name]["track"],
            "chunked_track_s": CHUNKED_MIXED_TRACK_S[name],
            "chunked_b1_share": 70 * CHUNKED_B1_MS[name] / 1e3
            / CHUNKED_MIXED_TRACK_S[name]} for name in shares}
        print("  B1's share of track per branch (beside the lane-chunk "
              "kernel's run, PERF.md section 5): " + json.dumps(
                  {k: {n: round(x, 4) if isinstance(x, float) else x
                       for n, x in v.items()} for k, v in share.items()}))

    # ladder 4 as its preset stands, correlator "fused", 20 ms blocks
    cfgs = {name: dataclasses.replace(c, track=dataclasses.replace(
        c.track, correlator="fused"))
        for name, c in presets.ladder4_multi_constellation().items()}
    n4 = int(LADDER4_S * WIDE_FS)
    mrx4 = MultiConstellationReceiver(cfgs, sources={
        name: DeviceArraySource(sig[:n4], WIDE_FS, store="int8")
        for name in cfgs})
    _reset_launch_counts()
    t0 = time.perf_counter()
    per4 = multi_run_counted(mrx4, n4 * 1000 // int(WIDE_FS)
                             // LADDER4_BLOCK_MS)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    layouts = {name: rx.fused.layout for name, rx in mrx4.receivers.items()}
    assert layouts == {"gps_l1ca": "mxu", "galileo_e1b": "seg",
                       "beidou_b1i": "mxu", "glonass_l1of": "mxu"}, layouts
    for name, (b, got) in per4.items():
        if name == "galileo_e1b":
            _expect_launches(got, track_block_fused_seg=b, gather_segments=b)
        else:
            _expect_launches(got, track_block_fused_mxu=b)
    worst4 = _check_multi(mrx4, searched(truth, cfgs), "ladder 4")
    print(f"ladder 4 preset [fused, {LADDER4_BLOCK_MS} ms blocks, "
          f"{LADDER4_S} s, layouts {json.dumps(layouts)}]: launches "
          f"per branch {json.dumps({k: {n: c for n, c in v[1].items() if c} for k, v in per4.items()})}"
          f"; max |doppler error| {json.dumps(worst4)} Hz; "
          f"{LADDER4_S / wall4:.3f}x real time")
    shares4 = {name: {k: round(v["total_s"], 4)
                      for k, v in out["stage_timing"].items()}
               for name, out in mrx4.summary().items()}
    print("  ladder 4 stage totals (s) per branch: " + json.dumps(shares4))
    if seg_ms:
        # B4b's share of the Galileo branch's `track`: its launches x its
        # time per 20 ms block at the preset's 8 channels (phase 25)
        b = per4["galileo_e1b"][1]["track_block_fused_seg"]
        print("  ladder 4 Galileo branch: B4b " + json.dumps({
            "launches": b, "ms_per_block": seg_ms,
            "track_s": shares4["galileo_e1b"]["track"],
            "b4b_share": b * seg_ms / 1e3 / shares4["galileo_e1b"]["track"]}))
    return {"launches": launches, "stage_totals": shares,
            "ladder4": {k: v[1] for k, v in per4.items()},
            "ladder4_stage_totals": shares4}


def render_scene(models, sats, n, fs, seed, chunk=1 << 20):
    """``models.synthesize(sats, n, fs, noise_std=1.0, seed=seed)``
    rendered in chunks on the host's cores: each chunk's satellites at
    its ``start_sample`` (the carrier and code continue exactly), then
    the whole stream's noise from one generator, as synthesize draws
    it."""
    from concurrent.futures import ThreadPoolExecutor

    out = np.empty(n, np.complex64)

    def one(i0):
        m = min(chunk, n - i0)
        out[i0:i0 + m] = models.synthesize(sats, m, fs, start_sample=i0)

    with ThreadPoolExecutor(max_workers=8) as pool:
        list(pool.map(one, range(0, n, chunk)))
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(
        2.0)
    out += noise.astype(np.complex64)
    return out


# the live-decode scenes of tests/test_nav_live_multi.py: the truths of
# tests/test_nav_messages.py, each scene's satellite, rate, length, seed
def live_truths(gn, ephemeris_cls):
    gal = ephemeris_cls(
        prn=11, system="galileo", sqrt_a=5440.588, e=0.01, m0=1.2,
        omega0=-2.1, i0=0.96, omega=0.5, omega_dot=-8.0e-9, idot=3.0e-10,
        delta_n=4.5e-9, c_uc=1e-6, c_us=2e-6, c_rc=200.0, c_rs=-50.0,
        c_ic=5e-8, c_is=-4e-8, t_oe=3600.0, t_oc=3600.0, a_f0=1e-4,
        a_f1=-2e-11, a_f2=0.0, t_gd=3e-9, ura=107, week=1234)
    bds = ephemeris_cls(
        prn=8, system="beidou", sqrt_a=5282.6, e=0.002, m0=0.7,
        omega0=1.1, i0=0.956, omega=-2.4, omega_dot=-7e-9, idot=2e-10,
        delta_n=4e-9, c_uc=1e-6, c_us=7e-6, c_rc=180.0, c_rs=60.0,
        c_ic=4e-8, c_is=1e-8, t_oe=241920.0, t_oc=241920.0, a_f0=2e-5,
        a_f1=1e-12, a_f2=0.0, t_gd=4e-9, week=700, ura=2, iodc=11,
        iode=11, health=0)
    glo = gn.GlonassEphemeris(
        prn=5, pos_m=np.array([11e6, -13e6, 19e6]),
        vel_m_s=np.array([-1200.0, 2500.0, 900.0]),
        acc_m_s2=np.array([1e-6, -2e-6, 3e-6]),
        t_b_s=11700.0, gamma_n=2e-12, tau_n=-5e-7, nt=400, health=0)
    return gal, bds, glo


def live_scenes():
    """The three scenes of tests/test_nav_live_multi.py as (name,
    receiver config, satellite, rate, seconds, seed, truth, the PRN the
    receiver reports)."""
    from gnss_sdr_tpu_torch import AcqConfig, ReceiverConfig, RfConfig, \
        TrackConfig, models
    from gnss_sdr_tpu_torch.models.constellation import BEIDOU_B1I, \
        GALILEO_E1B, GLONASS_L1OF
    from gnss_sdr_tpu_torch.nav import bds_d1, glonass_nav as gn, inav
    from gnss_sdr_tpu_torch.nav.ephemeris import Ephemeris

    gal, bds, glo = live_truths(gn, Ephemeris)

    def cfg(fs, signal, n_channels=4, **acq):
        return ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=fs),
            acq=AcqConfig(signal=signal, **acq),
            track=TrackConfig(signal=signal, n_channels=n_channels),
            block_ms=100)

    sat = models.SatelliteScenario
    return [
        ("galileo_e1b",
         cfg(4_092_000.0, "galileo_e1b", n_prn=36, non_coherent_ms=16,
             detection_threshold=12.0),
         sat(prn=gal.prn, doppler_hz=987.0, amplitude=0.3,
             nav_bits=inav.encode_symbol_stream(
                 gal, wn=gal.week, tow0_s=432_000.0, n_pages=7,
                 order=[5, 1, 2, 3, 4]), signal=GALILEO_E1B),
         4_092_000.0, 13.0, 31, gal, gal.prn),
        ("beidou_b1i",
         cfg(4_092_000.0, "beidou_b1i", n_prn=37, detection_threshold=10.0),
         sat(prn=bds.prn, doppler_hz=-1543.0, amplitude=0.3,
             nav_bits=bds_d1.encode_bit_stream(bds, sow0=345_600,
                                               n_subframes=4,
                                               order=[5, 1, 2, 3]),
             signal=BEIDOU_B1I),
         4_092_000.0, 25.0, 32, bds, bds.prn),
        ("glonass_l1of",
         cfg(4_088_000.0, "glonass_l1of", n_prn=14, fdma_spacing_hz=FDMA_HZ,
             fdma_channels=tuple(range(-7, 7))),
         sat(prn=10, doppler_hz=2 * FDMA_HZ + 777.0, amplitude=0.3,
             nav_bits=gn.encode_bit_stream(glo, tk_s=11_430.0, n_strings=6,
                                           order=[15, 1, 2, 3, 4]),
             signal=GLONASS_L1OF),
         4_088_000.0, 12.5, 33, glo, 10),
    ]


def live_ephemeris_ok(name, eph, truth):
    """tests/test_nav_live_multi.py's checks of a decoded ephemeris."""
    if name == "glonass_l1of":
        assert eph.system == "glonass"
        assert np.allclose(eph.pos_m, truth.pos_m, atol=2.0)
        assert np.allclose(eph.vel_m_s, truth.vel_m_s, atol=1e-3)
        assert eph.t_b_s == truth.t_b_s
        assert abs(eph.tau_n - truth.tau_n) < 2e-9
        return
    assert eph.system == {"galileo_e1b": "galileo",
                          "beidou_b1i": "beidou"}[name]
    assert abs(eph.sqrt_a - truth.sqrt_a) <= 2**-19
    assert abs(eph.e - truth.e) <= 2**-33
    assert eph.t_oe == truth.t_oe and eph.week == truth.week
    assert abs(eph.a_f0 - truth.a_f0) <= (2**-33 if name == "galileo_e1b"
                                          else 2**-32)
    if name == "galileo_e1b":
        assert abs(eph.m0 - truth.m0) <= 2**-30 * np.pi


def phase_live_nav(torch):
    """The three live-decode scenes of tests/test_nav_live_multi.py on
    the card (Galileo E1B I/NAV 13 s, BeiDou B1I D1 25 s, GLONASS L1OF
    12.5 s; one satellite each with its genuine message, 100 ms blocks,
    the default tracker; the test's SyntheticSource and seeds, rendered on
    the host as the receiver reads): a cold start, the one PRN tracked,
    bit sync and
    frame lock, and its ephemeris equal to its truth as that test checks.
    Returns {scene: (seconds of signal, wall s)}."""
    from gnss_sdr_tpu_torch.receiver import Receiver, SyntheticSource

    out = {}
    for name, cfg, sat, fs, seconds, seed, truth, prn in live_scenes():
        # the test's source: rendered block by block as the receiver reads
        src = SyntheticSource([sat], fs, noise_std=1.0, seed=seed,
                              total_samples=int(seconds * fs))
        rx = Receiver(cfg, src)
        assert rx.device.type == "cuda"
        t0 = time.perf_counter()
        summary = rx.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert set(rx.active) == {prn}, (name, rx.active)
        status = list(summary["nav"].values())[0]
        assert status["bit_synced"] and status["frame_locked"], status
        assert prn in rx.nav.ephemerides, (name, sorted(rx.nav.ephemerides))
        live_ephemeris_ok(name, rx.nav.ephemerides[prn], truth)
        out[name] = (seconds, wall)
        print(f"live decode [{name}]: {seconds} s of signal in {wall:.3f} s "
              f"({seconds / wall:.2f}x), PRN {prn} tracked, nav "
              f"{json.dumps(status)}, ephemeris equal to its truth")
    return out


# ---------------------------------------------------------------------------
# slice 11: B2 in lane chunks at ladder 4's widths (28-30), the conv
# acquisition engine (31) and the in-scan search (32)
# ---------------------------------------------------------------------------

# B2's spread_cap at 8.184 MHz: ((n0 + 512 + 127) // 128) * 128
WIDE_SPREAD_CAP = {"gps_l1ca": 8704, "beidou_b1i": 8704,
                   "glonass_l1of": 8704, "galileo_e1b": 33280}
# offcode_case's bases at 8.184 MHz: the highest start plus the last
# superstep's reach stays inside the block's stream (GPS, BeiDou and
# GLONASS: base <= 11,376)
WIDE_OFFCODE_BASES = (1, 60)
B2_PATH_SYSTEM = "gps_l1ca"         # phase 30's ladder-4 shape
B2_PATH_BLOCKS = 10                 # ... 96 ms blocks: 0.96 s
B2_PATH_SPAN = 5
CONV_PASSES = 10                    # timed searches per engine
INSCAN_S = 6                        # the in-scan receiver's scene
INSCAN_RISE_S = 1.5                 # PRN 25 rises here
INSCAN_PRN = 25
INSCAN_SPAN = 4
INSCAN_PACING = (1000, 8)           # steady re-search every 1 s, 8 PRNs


def phase_b2_wide_check(torch):
    """B2 (the shared fetch) in lane chunks at the four ladder-4 shapes
    (8.184 MHz, 96 ms blocks; there the wrapper launches B1's chunked
    kernel on starts[:C]), power and Costas lock, full and lean: against
    its plain version open loop within B1's tolerances (compare), and
    against B1
    kernel to kernel bit for bit at the same chunk width, on the
    tracker's own starts (the base clamped at 0) and on offcode_case's
    (a raised base, every dc across the cap). Returns the largest
    |error| of the correlations against the plain version."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    max_abs = 0.0
    for system, (wp, rows, k) in WIDE_MXU_SHAPES.items():
        for name, cfg_kw in WIDE_VARIANTS.items():
            inp = wide_inputs(torch, "cuda", system, cfg_kw,
                              shared_fetch=True)
            ft, args, kw = inp["ft"], inp["args"], inp["kw"]
            cap = WIDE_SPREAD_CAP[system]
            assert (ft.wp, ft.n_rows, ft.spread_cap) == (wp, rows, cap), (
                system, ft.wp, ft.n_rows, ft.spread_cap)
            k_run = kw["k_epochs"]
            plan = fused.mxu_smem_plan(wp, rows, k_run,
                                       c_channels=args[4].shape[0])
            assert plan["layout"] == "cluster", plan
            plan = launched_lane(args, kw)
            host = np.asarray(kw["starts_host"])
            assert host[-1] == 0 and (host[:-1] <= cap).all(), host
            for mode in ("full", "lean"):
                m_kw = dict(kw, telem_mode=mode)
                before = fused.shared_launch_count
                tk, sk, err = open_loop_compare(torch, args, m_kw)
                assert fused.shared_launch_count > before
                _check_active(sk, inp["n_sats"], (system, name, "B2"))
                max_abs = max(max_abs, err["corr_max_abs"])
                print(f"B2 vs plain, open loop [{system} {name} {mode}: "
                      f"wp {wp}, R {rows}, K {k_run}, spread_cap {cap}, "
                      f"B1's lane kernel, {_lane_label(plan)}]: "
                      f"{_margins(err)}")
                cases = {"clamped": (args, m_kw),
                         "offcode": offcode_case(args, m_kw,
                                                 seed=len(system) + k_run,
                                                 bases=WIDE_OFFCODE_BASES)}
                for case, (c_args, c_kw) in cases.items():
                    n2, n1 = b2_equals_b1(torch, c_args, c_kw)
                    assert (n2, n1) == (1, 1), (n2, n1)
            print(f"B2 vs B1, kernel to kernel [{system} {name}]: telemetry "
                  "and state equal bit for bit at the same cluster size "
                  "(clamped and offcode bases, full and lean)")
    return max_abs


def phase_b2_wide_timing(torch):
    """B2's time per 96 ms block at the four ladder-4 shapes beside B1's
    in lane chunks, in turns (B1, B2, B2, B1; events around each queued
    launch behind a head start, the L2 flushed, median of 2 x
    KERNEL_PASSES each), each equal to B1 bit for bit; its plain
    version's (two passes); its bound, from this run's inputs (each input
    read once, telemetry and state written once; the mixed lanes' bf16
    and f32 operations), and its bytes."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    out = {}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    for system, (wp, rows, _) in WIDE_MXU_SHAPES.items():
        inp = wide_inputs(torch, "cuda", system, {}, shared_fetch=True)
        args, kw = inp["args"], inp["kw"]
        b1_args, b1_kw = b1_of(args, kw)
        plan = launched_lane(args, kw)

        def b1():
            return fused.track_block_fused_mxu(*b1_args, **b1_kw)

        def b2():
            return fused.track_block_fused_mxu(*args, **kw)

        t_ref, s_ref = b1()
        telem, st = b2()
        assert torch.equal(telem, t_ref) and torch.equal(st, s_ref), system
        for _ in range(3):
            b1()
            b2()
        torch.cuda.synchronize()
        t1 = _time_queued(torch, b1, KERNEL_PASSES, flush)
        t2 = _time_queued(torch, b2, KERNEL_PASSES, flush)
        t2 += _time_queued(torch, b2, KERNEL_PASSES, flush)
        t1 += _time_queued(torch, b1, KERNEL_PASSES, flush)
        ps = []
        for _ in range(2):
            flush.zero_()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fused.track_block_fused_mxu_reference(*args, **kw)
            torch.cuda.synchronize()
            ps.append((time.perf_counter() - t0) * 1e3)
        lanes = float((telem[..., 12] * telem[..., 16]).double().sum())
        n_bytes = _nbytes(*args, telem, st)
        bf16_ops = 2.0 * 2 * rows * lanes
        f32_ops = MIX_OPS_PER_LANE * lanes
        bound, bound_by = _bound(n_bytes, f32_ops, bf16_ops)
        res = dict(ms=statistics.median(t2), ms_min=min(t2),
                   ms_max=max(t2), b1_ms_in_turns=statistics.median(t1),
                   b1_min=min(t1), b1_max=max(t1),
                   plain_ms=statistics.median(ps), plain_passes=ps,
                   bound_ms=bound, bound_by=bound_by, bytes=n_bytes,
                   mixed_lanes=lanes, wp=wp, rows=rows,
                   k_epochs=kw["k_epochs"], channels=MIXED_CHANNELS[system],
                   spread_cap=kw["spread_cap"], cs=plan["cs"],
                   warps=plan["warps"], staged=plan["staged"],
                   active_clusters=plan["active"], layout="cluster",
                   library_ms=None)
        out[system] = res
        print(f"timing [B2 {system}] (ms per 96 ms block, "
              f"{res['channels']} ch): " + json.dumps(
                  {k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in res.items()}))
    return out


def phase_b2_wide_path(torch):
    """B2's path at ladder 4's GPS shape (8.184 MHz, 8 channels, 96 ms
    blocks, wp 8704 in lane chunks): FusedTracker(shared_fetch=True) as
    single blocks (f32 wire, full mode), through run_blocks (f32) and in
    chained spans of B2_PATH_SPAN (the slim wire, full mode, and the
    slim2 wire, lean mode), each against the same run with
    shared_fetch=False. Both run B1's chunked kernel at the same chunk
    width, so every block's telemetry and the final ledger are equal bit
    for bit; B2 launched once per block, B1 never. Returns B2's launches
    on the slim2 span run."""
    from gnss_sdr_tpu_torch import models

    ft, _, _, sats, history = wide_tracker(torch, "cuda", B2_PATH_SYSTEM,
                                           {})
    block = ft.t_epochs * ft.n0
    sig = models.synthesize(sats, history + B2_PATH_BLOCKS * block, WIDE_FS,
                            noise_std=1.0, seed=11)

    def tracker(shared, wire):
        ft, st, rows, _, _ = wide_tracker(torch, "cuda", B2_PATH_SYSTEM, {},
                                          shared_fetch=shared, wire=wire)
        assert ft.spread_cap == (WIDE_SPREAD_CAP[B2_PATH_SYSTEM]
                                 if shared else 0)
        return ft, st, rows, history

    launched = 0
    for label, wire, n_span, api in (
            ("single-block", "f32", 1, False),
            ("run_blocks", "f32", B2_PATH_SPAN, True),
            ("spans", "slim", B2_PATH_SPAN, False),
            ("spans", "slim2", B2_PATH_SPAN, False)):
        res = {shared: _drive_tracker(torch, sig, shared, wire, n_span,
                                      tracker, run_blocks=api)
               for shared in (True, False)}
        (out_s, led_s, active, l_s, n, sec_s), \
            (out_b, led_b, _, l_b, _, sec_b) = res[True], res[False]
        _expect_launches(l_s, _mxu_kernel_shared=n)
        _expect_launches(l_b, track_block_fused_mxu=n)
        n_arrays = 0
        for xs, ys in zip(out_s + [led_s], out_b + [led_b]):
            assert len(xs) == len(ys)
            for x, y in zip(xs, ys):
                assert np.array_equal(x, y), label
                n_arrays += 1
        n_sats = len(sats)
        assert active[:n_sats].all() and not active[n_sats:].any(), active
        launched = l_s["_mxu_kernel_shared"]
        print(f"B2 path at 8.184 MHz [{B2_PATH_SYSTEM}, {label}, wire "
              f"{wire}]: {n} blocks of 96 ms, {n_arrays} arrays equal bit "
              f"for bit to shared_fetch=False, {n_sats} channels tracking; "
              f"launches {json.dumps(l_s)}; wall {sec_s:.3f} s (B1 "
              f"{sec_b:.3f} s)")
    return launched


def _conv_engines(torch, system, fs, acq_kw, device):
    """(conv engine, FFT engine) for ``system`` at ``fs`` on ``device``."""
    from gnss_sdr_tpu_torch.config import AcqConfig
    from gnss_sdr_tpu_torch.models.constellation import get_signal
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    spec = get_signal(system)
    return tuple(AcquisitionEngine(AcqConfig(signal=system, engine=e,
                                             **acq_kw), spec, fs,
                                   device=device)
                 for e in ("conv", "fft"))


def _search_ms(torch, eng, chunk, allowed, passes=CONV_PASSES):
    """One search's wall (ms, host clock, synchronized; median of
    ``passes``) and its candidates."""
    cands = eng.search(chunk, allowed_prns=allowed)
    torch.cuda.synchronize()
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        eng.search(chunk, allowed_prns=allowed)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls), cands


def phase_conv_engine(torch):
    """The conv acquisition engine on the card (ROADMAP A11): acquire_conv
    on the 24-satellite scene's search chunk (2.046 MHz, 32 PRNs, the
    full grid) held to the port's CPU run on the same samples (detections
    and code phases equal, the fine Doppler within one line-search step,
    the ratio within 1e-3), its device search alone (CUDA events, queued),
    then one search (host clock, synchronized, median of CONV_PASSES)
    cold (32 PRNs) and steady (the 8-row bucket), conv against the FFT
    engine on the same chunk; then each branch of the mixed row (GPS,
    Galileo E1B, BeiDou B1I and GLONASS FDMA at 8.184 MHz, bench.py's
    AcqConfig each, its satellites rendered alone), conv against FFT:
    GLONASS's detections equal (ROADMAP C4), the others reported.
    Returns the times."""
    from gnss_sdr_tpu_torch import models
    from gnss_sdr_tpu_torch.ops import pcps

    sats, sig = _scene(SCAN_S)
    out = {}
    conv, fft = _conv_engines(torch, "gps_l1ca", FS, {}, "cuda")
    conv_cpu, _ = _conv_engines(torch, "gps_l1ca", FS, {}, "cpu")
    n = conv.samples_needed
    x = sig[:n]
    re = np.ascontiguousarray(x.real, dtype=np.float32)
    im = np.ascontiguousarray(x.imag, dtype=np.float32)
    dev = tuple(torch.from_numpy(v).cuda() for v in (re, im))
    res = conv.conv_search_device(*dev)
    ref = conv_cpu.conv_search_device(torch.from_numpy(re),
                                      torch.from_numpy(im))
    got = [v.cpu().numpy() for v in res]
    want = [v.numpy() for v in ref]
    det = want[0]
    assert np.array_equal(got[0], det), (got[0], det)
    assert np.array_equal(got[3][det], want[3][det])
    step = 2.0 * conv.cfg.doppler_step_hz / 128
    f_err = float(np.abs(got[4][det] - want[4][det]).max())
    assert f_err <= step, f_err
    r_err = float(np.abs(got[1] / want[1] - 1.0)[det].max())
    assert r_err < 1e-3, r_err
    found = sorted(np.flatnonzero(det) + 1)
    assert set(found) >= set(range(1, 25)), found
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    sel8 = torch.from_numpy(conv.steady_sel(range(25, 33))[0]).cuda()
    dev_ms = {}
    for name, sel in (("cold", None), ("steady", sel8)):
        for _ in range(2):
            conv.conv_search_device(*dev, sel)
        ts = _time_queued(torch, lambda: conv.conv_search_device(*dev, sel),
                          KERNEL_PASSES, flush)
        dev_ms[name] = statistics.median(ts)
    times = {}
    for name, allowed in (("cold", None), ("steady", set(range(25, 33)))):
        for eng_name, eng in (("conv", conv), ("fft", fft)):
            chunk = (dev if eng_name == "conv" else
                     tuple(v[:eng.samples_needed] for v in dev))
            ms, cands = _search_ms(torch, eng, chunk, allowed)
            times[f"{name}_{eng_name}"] = ms
            if name == "cold":
                assert {c.prn for c in cands} >= set(range(1, 25)), (
                    eng_name, [c.prn for c in cands])
    out["gps_2046k"] = dict(search_ms=times, device_ms=dev_ms,
                            detected=len(found), f_err_hz=f_err,
                            ratio_rel_err=r_err, decim=conv.decim)
    print("conv engine [gps_l1ca, 2.046 MHz, 32 PRNs x "
          f"{conv.grid.size} bins, decim {conv.decim}]: detections and "
          f"code phases equal to the CPU run's ({len(found)} PRNs), fine "
          f"Doppler within {f_err:.3g} Hz, ratio within {r_err:.2e}; "
          "acquire_conv on the card (ms, queued): " + json.dumps(
              {k: round(v, 4) for k, v in dev_ms.items()})
          + "; one search (ms, synchronized): " + json.dumps(
              {k: round(v, 3) for k, v in times.items()}))
    # the mixed row's CDMA branches, each with bench.py's AcqConfig
    configs = mixed_configs()
    msats = mixed_sats(models)
    for system in ("gps_l1ca", "galileo_e1b", "beidou_b1i", "glonass_l1of"):
        acq = configs[system].acq
        acq_kw = {f: getattr(acq, f) for f in (
            "n_prn", "doppler_span_hz", "doppler_step_hz", "non_coherent_ms",
            "coherent_ms", "bit_edge_hypotheses", "detection_threshold",
            "fdma_spacing_hz", "fdma_channels")}
        conv, fft = _conv_engines(torch, system, WIDE_FS, acq_kw, "cuda")
        scene = [s for s in msats if s.signal.name == system]
        n = conv.samples_needed
        xs = models.synthesize(scene, n, WIDE_FS, noise_std=1.0, seed=7)
        dev = tuple(torch.from_numpy(np.ascontiguousarray(
            v, dtype=np.float32)).cuda() for v in (xs.real, xs.imag))
        row = {}
        for eng_name, eng in (("conv", conv), ("fft", fft)):
            chunk = tuple(v[:eng.samples_needed] for v in dev)
            ms, cands = _search_ms(torch, eng, chunk, None)
            row[eng_name + "_ms"] = ms
            row[eng_name + "_prns"] = sorted(c.prn for c in cands)
        truth = sorted(mixed_truth(scene)[system]) if acq.fdma_spacing_hz \
            else sorted(s.prn for s in scene if s.prn <= acq.n_prn)
        for eng_name in ("conv", "fft"):
            row[eng_name + "_finds_truth"] = \
                set(row[eng_name + "_prns"]) >= set(truth)
        if acq.fdma_spacing_hz:
            # ROADMAP C4: the FDMA channels mixed out before the coarse
            # decimation, the conv engine finds what the FFT engine finds
            assert row["conv_prns"] == row["fft_prns"] == truth, row
        row["decim"] = conv.decim
        out[system + "_8184k"] = row
        print(f"conv engine [{system}, 8.184 MHz, mixed row's AcqConfig, "
              f"decim {conv.decim}]: " + json.dumps(
                  {k: (round(v, 3) if isinstance(v, float) else v)
                   for k, v in row.items()}) + f"; truth {truth}")
    return out


def _inscan_scene():
    """The 24-satellite scene for INSCAN_S seconds with PRN INSCAN_PRN
    rising at INSCAN_RISE_S (bench.py's scene's amplitude, 1900 Hz)."""
    from gnss_sdr_tpu_torch.models import SatelliteScenario, synthesize

    sats = scene_sats(SatelliteScenario)
    riser = SatelliteScenario(prn=INSCAN_PRN, doppler_hz=1900.0,
                              code_phase_chips=311.0, amplitude=0.3)
    n1 = int(INSCAN_RISE_S * FS)
    n2 = int(INSCAN_S * FS)
    a = synthesize(sats, n1, FS, noise_std=1.0, seed=3)
    b = synthesize(sats + [riser], n2 - n1, FS, noise_std=1.0, seed=4,
                   start_sample=n1)
    return sats + [riser], np.concatenate([a, b])


def phase_inscan(torch):
    """The in-scan search at full width: 32 channels at 2.046 MHz, mxu,
    500 ms blocks, spans of INSCAN_SPAN, on the 24-satellite scene with
    PRN 25 rising at 1.5 s: the conv engine's steady search queued inside
    each span (synchronous and pipelined spans) must acquire the riser
    from a span's own search (an acquisition event at or after the rise,
    the search stage's calls the spans'), every satellite tracked within
    40 Hz; beside them the FFT engine's boundary search on the same
    scene. Returns each run's real-time factor, stage totals and
    launches."""
    from gnss_sdr_tpu_torch import AcqConfig, ReceiverConfig, RfConfig, \
        TrackConfig
    from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver

    sats, sig = _inscan_scene()
    truth = {s.prn: s.doppler_hz for s in sats}
    out = {}
    for label, engine, pipe in (("conv, synchronous spans", "conv", False),
                                ("conv, pipelined spans", "conv", True),
                                ("fft boundary search", "fft", False)):
        rx = Receiver(ReceiverConfig(
            rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
            acq=AcqConfig(engine=engine, steady_pacing=INSCAN_PACING),
            track=TrackConfig(n_channels=N_CHANNELS, correlator="fused",
                              fused_layout="mxu"),
            block_ms=BLOCK_MS), ArraySource(sig, FS), device="cuda")
        assert rx._span_acq == (engine == "conv")
        # the boundary searches' times (Receiver._run_acquisition): the
        # conv runs' riser must come from a span's own search instead
        boundary = []

        def searched(run=rx._run_acquisition, rx=rx):
            boundary.append(rx.time_ms)
            run()

        rx._run_acquisition = searched
        _reset_launch_counts()
        t0 = time.perf_counter()
        summary = rx.run(scan_blocks=INSCAN_SPAN, span_pipeline=pipe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        rise = [t for t, c in rx.acq_events if c.prn == INSCAN_PRN]
        assert summary["tracked_prns"] == sorted(truth), summary
        assert rise and rise[0] >= INSCAN_RISE_S * 1000.0, rise
        if engine == "conv":
            assert rx.fused.last_span_extra is not None or pipe
            assert rise[0] not in boundary, (rise, boundary)
        errs = {c["prn"]: abs(c["last_doppler_hz"] - truth[c["prn"]])
                for c in summary["channels"]}
        assert max(errs.values()) < 40.0, errs
        timing = summary["stage_timing"]
        out[label] = dict(
            wall_s=wall, rtf=INSCAN_S / wall, rise_ms=rise[0],
            boundary_searches_ms=boundary,
            launches=launches,
            stages={k: v["total_s"] for k, v in timing.items()},
            calls={k: v["calls"] for k, v in timing.items()})
        print(f"in-scan receiver [{label}, 32 ch, 2.046 MHz, mxu, spans of "
              f"{INSCAN_SPAN}]: {INSCAN_S} s in {wall:.3f} s, real-time "
              f"factor {INSCAN_S / wall:.2f}x; PRN {INSCAN_PRN} acquired at "
              f"{rise[0]:.0f} ms (rises at {INSCAN_RISE_S * 1000:.0f}; "
              f"boundary searches at {boundary} ms); max "
              f"|doppler error| {max(errs.values()):.2f} Hz; stages "
              + json.dumps({k: round(v, 4)
                            for k, v in out[label]["stages"].items()})
              + f"; calls {json.dumps(out[label]['calls'])}; launches "
              + json.dumps(launches))
    return out


# ---------------------------------------------------------------------------
# slice 12: the device mesh (parallel/) as shards of the one card
# ---------------------------------------------------------------------------

MESH_SHARDS = (2, 4)                # channel shards of the one card
MESH_SPAN = 8                       # blocks per span, mxu
MESH_DIRECT_SPAN = 4                # ... direct
MESH_TAIL_MS = 200                  # the receivers' partial last block
MESH_SCAN_FULL = 3                  # full blocks of the scanned receiver
MESH_PASSES = 15                    # timed sharded steps per turn
# shard counts whose fused receiver's tail (the slice correlator's torch
# row sums at C / n rows) equals the unsharded run bit for bit on the
# H100: torch sums [16, W] rows as it sums [32, W], [8, W] in another
# order (measured for W 2048-4096)
MESH_EXACT_TAIL = (2,)
# (kind, ms integrated, shards) of the sharded searches (phase 35)
MESH_SEARCHES = (("time", 10, 2), ("time", 20, 4), ("prn", 10, 4))
DIST_TIMEOUT_S = 300


def card_mesh(torch, n_channel, n_time=1, device="cuda:0"):
    """A mesh of ``n_time * n_channel`` shards, every one on ``device``
    (the one card; the CPU in a rehearsal); ``device`` "cards": one
    shard on each visible card (parallel.make_mesh's default)."""
    from gnss_sdr_tpu_torch import parallel

    if device == "cards":
        return parallel.make_mesh(n_time, n_channel)
    return parallel.make_mesh(n_time, n_channel, devices=device)


def _mesh_where(mesh):
    """The devices a mesh's shards run on, for a log line."""
    return ", ".join(sorted({str(d) for d in mesh.devices.reshape(-1)}))


def _history():
    """The fused trackers' history (_scene_tracker's): the acquisition's
    samples and two code periods."""
    from gnss_sdr_tpu_torch.config import AcqConfig
    from gnss_sdr_tpu_torch.models import GPS_L1CA
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    return (AcquisitionEngine(AcqConfig(), GPS_L1CA, FS,
                              device="cpu").samples_needed
            + 2 * GPS_L1CA.samples_per_code(FS))


def _same_arrays(label, a, b):
    """Two _drive_tracker runs downloaded the same arrays (every block's
    or span's, then the final ledger), byte for byte. Returns the count."""
    n = 0
    assert len(a[0]) == len(b[0]), label
    for xs, ys in zip(a[0] + [a[1]], b[0] + [b[1]]):
        assert len(xs) == len(ys), label
        for x, y in zip(xs, ys):
            x, y = np.asarray(x), np.asarray(y)
            assert x.shape == y.shape and x.dtype == y.dtype, label
            assert x.tobytes() == y.tobytes(), (label, n)
            n += 1
    return n


def phase_mesh_fused(torch, device="cuda", mesh_devices=None):
    """The fused tracker on meshes of 2 and 4 channel shards of the one
    card (parallel.shard_fused_step), 32 channels, the 24-satellite
    scene: mxu single-block (full telemetry) and in synchronous 8-block
    spans (slim2, lean mode) over 10 s, direct in 4-block spans over 5
    s, one 125 ms block on seg (B4c + B4b) and one 500 ms block on
    windows (B4a); every downloaded array and the final ledger equal to
    the unsharded run bit for bit, each kernel launched blocks x shards
    times (``device`` "cpu" rehearses it on the plain versions, where
    nothing counts). Each run goes unsharded, 2, 4 shards, unsharded
    again: the first run of a path pays its first launches, so each
    shard count's wall per block is its last run's. ``mesh_devices``
    "cards" puts the shards on the visible cards, one each (the tracker
    on ``device``). Returns the launches by run and shards and the walls
    per block."""
    _, sig10 = _scene(STEADY_S)
    _, sig5 = _scene(DIRECT_S)
    hist = _history()

    def cut(block_ms):
        return sig5[:hist + block_ms * 2046]

    meshes = {1: None, **{n: card_mesh(torch, n,
                                       device=mesh_devices or device)
                          for n in MESH_SHARDS}}
    runs = (("mxu, single-block", "mxu", "f32", 1, sig10, BLOCK_MS,
             ("track_block_fused_mxu",)),
            ("mxu, spans, slim2", "mxu", "slim2", MESH_SPAN, sig10,
             BLOCK_MS, ("track_block_fused_mxu",)),
            ("direct, spans, slim", "direct", "slim", MESH_DIRECT_SPAN, sig5,
             BLOCK_MS, ("track_block_fused_direct",)),
            ("seg, 125 ms", "seg", "f32", 1, cut(SEG_BLOCK_MS),
             SEG_BLOCK_MS, ("track_block_fused_seg", "gather_segments")),
            ("windows, 500 ms", "windows", "f32", 1, cut(WINDOWS_BLOCK_MS),
             WINDOWS_BLOCK_MS, ("track_block_fused",)))
    out = {"launches": {}, "wall_ms_per_block": {}}
    for label, layout, wire, span, x, block_ms, kernels in runs:
        base = None
        for n in (1, *MESH_SHARDS, 1):
            mesh = meshes[n]

            def tracker(shared, w, mesh=mesh, layout=layout,
                        block_ms=block_ms):
                ft, st, rows, history = _scene_tracker(
                    torch, device, {}, N_CHANNELS, block_ms, layout=layout,
                    wire=w, mesh=mesh)
                assert ft.layout == layout and ft.mesh is mesh
                return ft, st, rows, history

            r = _drive_tracker(torch, x, False, wire, span, tracker=tracker)
            launches, n_blocks = r[3], r[4]
            if device == "cuda":
                _expect_launches(launches,
                                 **{k: n_blocks * n for k in kernels})
            assert r[2][:24].all() and not r[2][24:].any(), (label, n)
            out["launches"].setdefault(label, {})[n] = launches
            out["wall_ms_per_block"].setdefault(label, {})[n] = \
                r[5] / n_blocks * 1e3
            if base is None:
                base = r
                continue
            n_arrays = _same_arrays(f"{label}, {n} shards", base, r)
            where = ("unsharded, again" if mesh is None else
                     f"{n} shards of {_mesh_where(mesh)}")
            print(f"mesh [{label}, {where}]: {n_blocks} blocks, "
                  f"{n_arrays} arrays equal bit for bit to the unsharded "
                  f"run; launches {json.dumps(launches)}; wall "
                  f"{r[5]:.3f} s (unsharded {base[5]:.3f} s)")
    return out


def mesh_step_timing(torch):
    """The sharded B1 step's time per 500 ms block at 1, 2 and 4 shards
    of the one card in turns (1, 2, 4, 4, 2, 1; the L2 flushed, queued
    behind a head start), after one step at each equal to the unsharded
    kernel. Returns {shards: median ms} and the ranges."""
    from gnss_sdr_tpu_torch import parallel
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    _, args, kw = full_width_inputs(torch, "cuda", {}, layout="mxu")
    steps = {1: fused.track_block_fused_mxu,
             **{n: parallel.shard_fused_step(card_mesh(torch, n),
                                             fused.track_block_fused_mxu)
                for n in MESH_SHARDS}}
    ref = steps[1](*args, **kw)
    for n in MESH_SHARDS:
        tl, st = steps[n](*args, **kw)
        assert torch.equal(tl, ref[0]) and torch.equal(st, ref[1]), n
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    times = {n: [] for n in steps}
    for n in (1, *MESH_SHARDS, *reversed(MESH_SHARDS), 1):
        times[n] += _time_queued(torch, lambda: steps[n](*args, **kw),
                                 MESH_PASSES, flush)
    out = {"step_ms": {n: statistics.median(t) for n, t in times.items()},
           "step_ms_range": {n: (min(t), max(t))
                             for n, t in times.items()}}
    print("mesh: B1's step per 500 ms block (32 channels; n launches of "
          "B1 and the gather on the one card; median of "
          f"{2 * MESH_PASSES}, in turns): " + json.dumps(
              {n: round(v, 6) for n, v in out["step_ms"].items()})
          + "; range " + json.dumps(out["step_ms_range"]))
    return out


def phase_mesh_receiver(torch, device="cuda", mesh_devices=None):
    """The receiver on meshes of 2 and 4 shards of the one card, given
    through its own ``Receiver._use_mesh``, against the unsharded
    receiver on the same stream: (1) the fused receiver (mxu),
    ``run(scan_blocks=4)`` on 9 blocks and a 200 ms tail, whose tail goes
    through ``parallel.sharded_track_block`` (the slice correlator); (2)
    the scanned receiver with correlator="pallas" on 3 blocks and a 200
    ms tail, every block through sharded_track_block, B5 launched per
    shard (16 and 8 channels a shard: cluster 8, as at 32, so the sums
    match). Each run tracks every PRN within 40 Hz; telemetry and
    summaries equal to the unsharded run's (the fused receiver's tail at
    a shard count outside MESH_EXACT_TAIL within tolerance,
    _same_run_but_tail); the kernels launched shards x the unsharded
    count. On a one-card machine a
    ParallelConfig(channel_axis=2) without given devices raises, naming
    the count. ``mesh_devices`` "cards": the shards on the visible
    cards, one each. Returns the launches and each run's track stage
    seconds per block by shards (``device`` "cpu": a rehearsal on the
    plain versions)."""
    from gnss_sdr_tpu_torch import ParallelConfig, ReceiverConfig, \
        RfConfig, TrackConfig
    from gnss_sdr_tpu_torch.ops.cuda.epl_correlator import cluster_size
    from gnss_sdr_tpu_torch.receiver import ArraySource, Receiver

    sats, sig = _scene(SCAN_S)
    block = BLOCK_MS * 2046
    n_sm = (torch.cuda.get_device_properties(0).multi_processor_count
            if device == "cuda" else 132)
    assert {cluster_size(N_CHANNELS // n, n_sm)
            for n in (1, *MESH_SHARDS)} == {8}
    out = {"launches": {}, "track_s_per_block": {}}
    for label, correlator, n_full, kernel, kw in (
            ("fused, spans of 4", "fused", 9, "track_block_fused_mxu",
             dict(scan_blocks=4)),
            ("scanned, pallas", "pallas", MESH_SCAN_FULL,
             "epl_correlate_pallas", {})):
        x = sig[:n_full * block + MESH_TAIL_MS * 2046]
        runs = {}
        for n in (1, *MESH_SHARDS):
            marks = []
            runs[n] = _run_receiver(
                torch, sats, x, f"mesh receiver, {n} shard(s)",
                correlator=correlator, n_blocks=n_full + 1, device=device,
                block_ms=BLOCK_MS,
                mesh=None if n == 1 else card_mesh(
                    torch, n, device=mesh_devices or device),
                on_block=lambda r: marks.append(
                    (r.window.blocks_fed, r.timers.stats["track"].total_s)),
                **kw)
            rx, summary, launches = runs[n]
            assert (rx.mesh is None) == (n == 1)
            ends = [int(t.global_sample[-1])
                    for t in rx.telemetry.all_traces()]
            assert min(ends) >= n_full * block, ends     # the tail ran
            # the whole run's, and the blocks' after the first two (the
            # scanned tracker's graph warm-up and capture)
            (b2, t2), (b_end, t_end) = marks[1], marks[-1]
            out["track_s_per_block"].setdefault(label, {})[n] = {
                "all": summary["stage_timing"]["track"]["total_s"]
                / (n_full + 1),
                "after_block_2": (t_end - t2) / max(b_end - b2, 1)}
        l1 = runs[1][2]
        if device == "cuda":
            assert l1[kernel] > 0
            for n in MESH_SHARDS:
                _expect_launches(runs[n][2], **{kernel: n * l1[kernel]})
        if correlator == "pallas" and device == "cuda":
            assert l1[kernel] == (n_full + 1) * (BLOCK_MS + 1), l1
        out["launches"][label] = {n: r[2] for n, r in runs.items()}
        for n in MESH_SHARDS:
            what = f"unsharded and {n}-shard runs"
            if correlator == "fused" and n not in MESH_EXACT_TAIL:
                # the tail's slice correlator sums [C/n, W] rows with
                # torch's reduction, whose split (and so its f32 order)
                # follows the row count
                out["tail_deviation"] = _same_run_but_tail(
                    f"mesh receiver [{label}]", runs[1][:2], runs[n][:2],
                    n_full * block - 2046, what)
            else:
                _same_run(f"mesh receiver [{label}]", runs[1][:2],
                          runs[n][:2], what)
    if device == "cuda" and torch.cuda.device_count() == 1:
        try:
            Receiver(ReceiverConfig(
                rf=RfConfig(freq_if_hz=0.0, output_sample_rate_hz=FS),
                track=TrackConfig(n_channels=N_CHANNELS),
                parallel=ParallelConfig(channel_axis=2), block_ms=BLOCK_MS),
                ArraySource(sig[:block], FS))
        except ValueError as e:
            assert "needs 2 devices, have 1" in str(e), e
            print(f"ParallelConfig(channel_axis=2) on one card: {e}")
        else:
            raise AssertionError("a 2-card mesh built on one card")
    print("mesh receiver: track s per block by shards " + json.dumps(
        out["track_s_per_block"]))
    return out


def phase_mesh_acquisition(torch, device="cuda", mesh_devices=None):
    """The main path's search at full width (32 PRNs x 29 bins at 2.046
    MHz, the 24-satellite scene) sharded over the one card:
    time_sharded_pcps_search over 10 ms in 2 shards and 20 ms in 4, and
    sharded_pcps_search (PRN rows) over 10 ms in 4, each against one
    pcps_search on the same samples (detections and code phases equal,
    ratios within rtol 1e-4, the 24 satellites detected), then one
    search's time beside the unsharded one's in turns (host clock,
    synchronized, median of ACQ_PASSES; ``device`` "cpu": a rehearsal;
    ``mesh_devices`` "cards": the shards on the visible cards, one
    each). Returns the times."""
    from gnss_sdr_tpu_torch import parallel
    from gnss_sdr_tpu_torch.config import AcqConfig
    from gnss_sdr_tpu_torch.models import GPS_L1CA
    from gnss_sdr_tpu_torch.ops import pcps
    from gnss_sdr_tpu_torch.receiver.acquisition import AcquisitionEngine

    eng = AcquisitionEngine(AcqConfig(), GPS_L1CA, FS, device=device)
    codes = eng.code_ffts
    grid = torch.from_numpy(eng.grid).to(device)
    assert tuple(codes.shape) == (32, 2046) and grid.shape[0] == 29
    _, sig = _scene(SCAN_S)
    out = {}
    for kind, n_int, n in MESH_SEARCHES:
        x = torch.from_numpy(sig[:n_int * 2046]).to(device)
        where = mesh_devices or device
        if kind == "time":
            mesh = card_mesh(torch, 1, n_time=n, device=where)
            fn = parallel.time_sharded_pcps_search
        else:
            mesh = card_mesh(torch, n, device=where)
            fn = parallel.sharded_pcps_search
        fns = {"sharded": lambda: fn(mesh, x, codes, grid, fs_hz=FS,
                                     n_int=n_int),
               "unsharded": lambda: pcps.pcps_search(x, codes, grid,
                                                     fs_hz=FS, n_int=n_int)}
        res = {k: [f.cpu().numpy() for f in f_()] for k, f_ in fns.items()}
        a, b = res["sharded"], res["unsharded"]
        np.testing.assert_array_equal(a[0], b[0])           # detected
        np.testing.assert_array_equal(a[3], b[3])           # code phase
        np.testing.assert_allclose(a[1], b[1], rtol=1e-4)   # ratio
        assert a[0][:24].all(), a[0]
        times = {k: [] for k in fns}
        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
        for k in ("unsharded", "sharded", "sharded", "unsharded"):
            for _ in range(ACQ_PASSES // 2):
                sync()
                t0 = time.perf_counter()
                fns[k]()
                sync()
                times[k].append((time.perf_counter() - t0) * 1e3)
        label = f"{kind}-sharded, {n_int} ms over {n} shards"
        out[label] = {k: statistics.median(v) for k, v in times.items()}
        print(f"mesh acquisition [{label}]: detections and code phases "
              f"equal to one pcps_search ({int(a[0].sum())} PRNs), ratios "
              f"within rtol 1e-4 (max rel {float(np.max(np.abs(a[1] - b[1]) / np.abs(b[1]))):.2e}); "
              f"one search (ms, median of {len(times['sharded'])}, in "
              f"turns): sharded {out[label]['sharded']:.3f}, unsharded "
              f"{out[label]['unsharded']:.3f}")
    return out


def dist_run_workers(out_dir, device="cpu", timeout=DIST_TIMEOUT_S,
                     n_procs=2, shards=2):
    """tests/_torch_dist_worker.py in ``n_procs`` processes (the ranks of
    one group at a free localhost port, each with ``shards`` shards of
    ``device``; ``device`` "cards": each on its own cards, with
    torchrun's LOCAL_RANK and LOCAL_WORLD_SIZE set, the backend its
    default); each worker's exit code checked. Returns their JSON
    results."""
    import os
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(root, "tests", "_torch_dist_worker.py")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        addr = f"localhost:{sock.getsockname()[1]}"
    outs = [os.path.join(out_dir, f"rank{i}.json") for i in range(n_procs)]
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        env.pop(var, None)
    if device == "cards":
        env["LOCAL_WORLD_SIZE"] = str(n_procs)
    procs = [subprocess.Popen(
        [sys.executable, worker, addr, str(n_procs), str(i), outs[i],
         device, str(shards)],
        env=dict(env, **({"LOCAL_RANK": str(i)} if device == "cards"
                         else {})),
        cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n_procs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    results = []
    for o in outs:
        with open(o) as f:
            results.append(json.load(f))
    return results


def dist_check(results, backend="gloo"):
    """Every rank saw the group of len(results) processes on ``backend``
    and the 4-entry mesh, matched its unsharded search, and their merged
    shard events
    (merge_shard_results) keep each PRN once per authoritative region,
    with the unsharded search's global code phase. Returns the merged
    events."""
    from gnss_sdr_tpu_torch import parallel

    for r in results:
        assert r["world_size"] == len(results), r
        assert r["mesh_devices"] == 4, r
        assert r["backend"] == backend, r
        assert r["timeshard_matches_reference"] is True
        assert sorted(r["ref_detected_prns"]) == [5, 17], r
    assert all(r["ref_code_phase"] == results[0]["ref_code_phase"]
               for r in results)
    shards = [parallel.TimeShard(host_id=i, **r["shard"])
              for i, r in enumerate(results)]
    merged = parallel.merge_shard_results(
        shards, [r["events"] for r in results])
    ref_phase = results[0]["ref_code_phase"]
    # each host detects both PRNs in its own core; a halo never reports
    # twice
    for sh in shards:
        core = range(sh.core_start, sh.core_start + sh.core_count)
        assert sorted(e["prn"] for e in merged
                      if e["global_sample"] in core) == [5, 17], merged
    assert len(merged) == 2 * len(shards), merged
    for ev in merged:
        assert ev["code_phase"] == ref_phase[str(ev["prn"])], ev
    return merged


def phase_mesh_processes(torch):
    """Two processes on the one card (tests/_torch_dist_worker.py):
    initialize_from_env picks gloo (two ranks on one GPU), each rank
    holds 2 shards of cuda:0 in a 4-entry global_mesh, and
    time_sharded_pcps_search sums the partial cubes of CUDA tensors with
    torch.distributed.all_reduce across the process boundary; each
    rank's result equals its unsharded search; the parent merges the
    ranks' events (partition_stream, merge_shard_results)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, ".chip_scratch", "dist")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    results = dist_run_workers(out_dir, device="cuda:0")
    merged = dist_check(results)
    print(f"mesh processes: 2 ranks ({results[0]['backend']}) x 2 shards of "
          f"{results[0]['device']}: the all-reduced time-sharded search "
          f"equals each rank's unsharded search; merged events "
          f"{[(e['prn'], e['global_sample']) for e in merged]}; "
          f"{time.perf_counter() - t0:.1f} s")
    return results


def phase_mesh_dryrun(torch):
    from gnss_sdr_tpu_torch.parallel.dryrun import dryrun_multichip

    return dryrun_multichip(4)


def _wide_row(res):
    """A wide shape's numbers for the kernels line."""
    keep = ("wp", "rows", "k_epochs", "channels", "t_epochs", "l_seg", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_per_block", "cs", "warps", "staged", "resident",
            "active_clusters", "old_ms", "old_chunk", "turns")
    return {k: res[k] for k in keep if k in res}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import gnss_sdr_tpu_torch  # noqa: F401  (fails outside the repository)

    t_start = time.perf_counter()
    phase_device(torch)
    phase_build()
    max_abs = phase_kernel_check(torch)
    timing = phase_timing(torch)
    launches = phase_receiver(torch)
    direct_abs = phase_direct_check(torch)
    phase_lean_check(torch)
    dtiming = phase_timing(torch, layout="direct")
    steady = phase_steady(torch)
    b5_abs = phase_b5_check(torch)
    b5_timing = phase_b5_timing(torch)
    scan = phase_scan_receiver(torch)
    phase_if_capture(torch)
    phase_fused_tail(torch)
    b5_graph = scan["pallas"][True][3]["profiled_block"]
    epoch_abs, resident_launches = phase_epoch_check(torch)
    direct_abs = max(direct_abs, epoch_abs["direct"])
    etiming = phase_epoch_timing(torch)
    epoch_rx = phase_epoch_receivers(torch)
    shared_abs = phase_shared_check(torch)
    shared_launches = phase_shared_path(torch)
    stiming = phase_shared_timing(torch)
    journey = phase_cli(torch)
    phase_ingest(torch)
    phase_pad_fft(torch)
    wide_abs = phase_wide_check(torch)
    wtiming = phase_wide_timing(torch)
    mixed = phase_mixed(torch, b1_ms={
        k[4:]: v["ms"] for k, v in wtiming.items() if k.startswith("mxu_")},
        seg_ms=wtiming["seg_8ch"]["ms"])
    phase_live_nav(torch)
    b2w_abs = phase_b2_wide_check(torch)
    b2w_timing = phase_b2_wide_timing(torch)
    b2w_launches = phase_b2_wide_path(torch)
    phase_conv_engine(torch)
    phase_inscan(torch)
    t_mesh = time.perf_counter()
    mesh = phase_mesh_fused(torch)
    mesh_timing = mesh_step_timing(torch)
    mesh_rx = phase_mesh_receiver(torch)
    phase_mesh_acquisition(torch)
    phase_mesh_processes(torch)
    phase_mesh_dryrun(torch)
    print(f"chip_smoke: mesh phases in {time.perf_counter() - t_mesh:.1f} s")
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")
    mesh_l = mesh["launches"]

    def on_mesh(runs, name):
        """A kernel's launches on phase 33's runs, by run and shards."""
        return {run: {n: mesh_l[run][n][name] for n in MESH_SHARDS}
                for run in runs}
    src = "gnss_sdr_tpu_torch/csrc/"
    replaces = "gnss_sdr_tpu/ops/pallas/track_block_fused.py:"
    print(json.dumps({"kernels": [{
        "name": "track_block_fused_mxu",
        "route": "cuda",
        "source": src + "track_block_mxu.cu",
        "replaces": replaces + "1872",
        # the slice's main path: the pipelined steady state (a), lean mode
        "launches": steady["a"]["track_block_fused_mxu"],
        "launches_by_path": {
            "single_block": launches,
            "steady_pipelined": steady["a"]["track_block_fused_mxu"],
            "steady_sync": steady["b"]["track_block_fused_mxu"],
            "cli_journey": journey["launches"]["track_block_fused_mxu"],
            "mixed_8184k": mixed["launches"],
            "ladder4_20ms": {k: v["track_block_fused_mxu"]
                             for k, v in mixed["ladder4"].items()
                             if v["track_block_fused_mxu"]}},
        "launches_mesh": on_mesh(("mxu, single-block",
                                  "mxu, spans, slim2"),
                                 "track_block_fused_mxu"),
        "mesh_step_ms": mesh_timing["step_ms"],
        "lean_mode_checked": True,
        "registers_stack": timing["ptxas"],
        "wide_shapes": {k[4:]: _wide_row(v) for k, v in wtiming.items()
                        if k.startswith("mxu_")},
        "wide_shapes_20ms": {k[6:]: _wide_row(v)
                             for k, v in wtiming.items()
                             if k.startswith("mxu20_")},
        "max_abs_err": max(max_abs, wide_abs["mxu"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
    }, {
        "name": "_mxu_kernel_shared",
        "route": "cuda",
        "source": src + "track_block_mxu.cu",
        "replaces": replaces + "1713",
        # its path: FusedTracker(shared_fetch=True), synchronous spans
        "launches": shared_launches,
        "launches_by_path": {"spans_2046k": shared_launches,
                             "ladder4_gps_spans": b2w_launches},
        # the shared fetch is off under a mesh (B2's [C + 1] starts)
        "launches_mesh": on_mesh(("mxu, single-block",
                                  "mxu, spans, slim2"),
                                 "_mxu_kernel_shared"),
        "wide_shapes": {k: dict(_wide_row(v), b1_ms_in_turns=v[
            "b1_ms_in_turns"], layout=v["layout"])
            for k, v in b2w_timing.items()},
        "max_abs_err": max(shared_abs, b2w_abs),
        "equals_b1_bit_for_bit": True,
        "ms": stiming["ms"],
        "b1_ms_in_turns": stiming["b1_ms_in_turns"],
        "plain_ms": stiming["plain_ms"],
        "bound_ms": stiming["bound_ms"],
        "bound_by": stiming["bound_by"],
        "library_ms": None,
    }, {
        "name": "track_block_fused_direct",
        "route": "cuda",
        "source": src + "track_block_direct.cu",
        "replaces": replaces + "848",
        "launches": steady["c"]["track_block_fused_direct"],
        "launches_mesh": on_mesh(("direct, spans, slim",),
                                 "track_block_fused_direct"),
        "wide_shape": _wide_row(wtiming["direct"]),
        "wide_shape_8ch": _wide_row(wtiming["direct_8ch"]),
        "max_abs_err": max(direct_abs, wide_abs["direct"]),
        "ms": dtiming["ms"],
        "plain_ms": dtiming["plain_ms"],
        "bound_ms": dtiming["bound_ms"],
        "bound_by": dtiming["bound_by"],
        "library_ms": None,
    }, {
        "name": "epl_correlate_pallas",
        "route": "cuda",
        "source": src + "epl_correlator.cu",
        "replaces": "gnss_sdr_tpu/ops/pallas/epl_correlator.py:104",
        # the slice's main path: the scanned receiver, correlator="pallas",
        # on its CUDA graph (launches counted from the replays)
        "launches": scan["pallas"][True][2]["epl_correlate_pallas"],
        "launches_eager": scan["pallas"][False][2]["epl_correlate_pallas"],
        "launches_mesh": {"scanned, pallas": {
            n: mesh_rx["launches"]["scanned, pallas"][n][
                "epl_correlate_pallas"] for n in MESH_SHARDS}},
        "max_abs_err": b5_abs,
        "ms": b5_timing["ms"],
        "ms_per_launch": b5_timing["ms_per_launch"],
        "graph_replay_ms_per_block": b5_graph["b5_ms"],
        "graph_replay_ms_per_launch": (b5_graph["b5_ms"]
                                       / b5_graph["b5_kernels"]),
        "plain_ms": b5_timing["plain_ms"],
        "bound_ms": b5_timing["bound_ms"],
        "bound_by": b5_timing["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": replaces + line,
        "launches": launches,
        "max_abs_err": max(epoch_abs[feed], wide_abs.get(feed, 0.0)),
        "ms": etiming[feed]["ms"],
        "plain_ms": etiming[feed]["plain_ms"],
        "bound_ms": etiming[feed]["bound_ms"],
        "bound_by": etiming[feed]["bound_by"],
        "library_ms": etiming[feed]["library_ms"],
        "launches_mesh": on_mesh(("seg, 125 ms", "windows, 500 ms"), name),
        **({"wide_shape": _wide_row(wtiming[feed]),
            "launches_ladder4_galileo_20ms":
                mixed["ladder4"]["galileo_e1b"][name]}
           if feed in ("seg", "gather") else {}),
        **({"wide_shape_8ch": _wide_row(wtiming["seg_8ch"])}
           if feed == "seg" else {}),
        **({"wide_shape": _wide_row(wtiming[feed + "_wide"])}
           if feed in ("windows", "resident") else {}),
    } for name, source, line, feed, launches in (
        # the windows receiver (500 ms blocks) and the receiver at an odd
        # epoch count (125 ms blocks, seg); B6 through its entry point
        ("track_block_fused", "track_block_epoch.cu", "499", "windows",
         epoch_rx["windows"]["track_block_fused"]),
        ("track_block_fused_seg", "track_block_epoch.cu", "579", "seg",
         epoch_rx["seg"]["track_block_fused_seg"]),
        ("gather_segments", "gather_segments.cu", "2001", "gather",
         epoch_rx["seg"]["gather_segments"]),
        ("track_block_fused_resident", "track_block_epoch.cu", "2065",
         "resident", resident_launches))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
