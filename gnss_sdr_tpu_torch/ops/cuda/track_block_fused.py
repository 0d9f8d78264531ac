"""Fused whole-block tracking on Hopper: ONE kernel launch per sample
block (T epochs x C channels), in two layouts.

**mxu** (kernel B1) replaces the Pallas TPU kernel
``track_block_fused_mxu`` (``gnss_sdr_tpu/ops/pallas/track_block_fused.py:1872``,
kernel body ``_mxu_kernel`` :1603 driving ``_mxu_run_k`` :969). The CUDA
source is ``gnss_sdr_tpu_torch/csrc/track_block_mxu.cu``.

**mxu, shared fetch** (kernel B2) replaces ``_mxu_kernel_shared``
(:1713), which the same wrapper selects with ``spread_cap > 0``: B1's
arithmetic, with each superstep's windows cut from one shared slice of
the stream (below, "the shared fetch"). Same CUDA source, a template
flag.

**direct** (kernel B3) replaces ``track_block_fused_direct`` (:848,
``_direct_kernel`` :687 over ``_epoch_core`` :76): exact per-epoch
NCOs, f32 throughout. The CUDA source is
``gnss_sdr_tpu_torch/csrc/track_block_direct.cu``; its contract and
design are under "the direct layout" below.

The per-epoch layouts of the same kernel body (B4a windows, B4b seg fed
by B4c ``gather_segments``, B6 resident) live in ``track_block_epoch``
and are re-exported here under the JAX module's names.

Contract kept from the mxu TPU kernel:

  * K-epoch supersteps with the NCO rates HELD at their superstep-start
    values for the carrier mix, mask, replica select and ledger advance;
    discriminators, lock and loop filters still run per epoch, and the
    filtered rates take effect at the next superstep;
  * the mixed window and the replica bank are rounded to bf16
    (round-to-nearest-even); their products are accumulated in f32.
    The kernel and the plain version sum in different orders, so their
    correlations differ by ulps, and through the closed tracking loops
    such an ulp can grow, over hundreds of epochs, into an E/P/L pick
    one sample apart: hold the two against each other superstep by
    superstep from a common state (``first_superstep``), not over a
    whole block;
  * the [C, 128] f32 state columns (0 carr_freq, 1 carr_phase (cycles),
    2 carr_err, 3 code_rate, 4 chip_res, 5 code_err, 6 lost_count,
    7 active, 8 drift, 9 window_offset, 10 frac0, 11 lock_ema; the rest
    come back zero);
  * the telemetry columns 0-20 (0 i_e 1 q_e 2 i_p 3 q_p 4 i_l 5 q_l
    6 power 7 locked 8 pll_err 9 dll_err 10 carr_freq 11 code_rate
    12 n_t 13 drift 14 chip_res 15 lost_event 16 processed 17/18 held
    rates 19/20 per-epoch chip/drift increments), full mode, as a
    [T, C, 21] f32 tensor; in the lean mode (``telem_mode="lean"``, the
    slim2 wire's feed) only cols 2 and 3 and the packed flags in col 16
    (processed + 2 locked + 4 lost) per epoch, cols 17-20 on each
    superstep's first epoch and cols 0, 1, 4, 5, 8, 9 on the first
    epoch of even supersteps (of every superstep under Costas lock),
    zeros elsewhere; the arithmetic is the full mode's;
  * power lock through the closed-form lifecycle chain, Costas lock
    through the sequential EMA chain.

What bounds it on the H100, and the design: per 500 ms block at full
width (C=32, T=500, K=5, R=8, wp=2560) the work is ~1.3 GFLOP of bf16
products and ~11 MB of stream, replica and telemetry bytes, so the card
could do it in a few microseconds (the byte side bounds it). The kernel
is one thread block per channel that walks its T/K supersteps in order
(GPU blocks run in no order, so the TPU's sequential grid becomes a loop
inside the block), so the supersteps' serial chain bounds it. Since
the addresses a superstep reads do not depend on the channel's state,
superstep j + 1's window span is copied into shared
memory by TMA (``cp.async.bulk`` on an mbarrier) while superstep j
computes; each warp mixes its lanes of the K windows into a bf16 [2K,
wp] tile and contracts them with the [R, wp] bf16 bank on the tensor
cores (``mma.sync``); warp 0 runs the per-epoch discriminators one lane
per epoch and the lock / loop-filter recurrences on lane 0. The copy
starts at the 4-sample floor of the window and ends at the window's
end, so its read bound is the plain version's. Where the windows do not
fit in shared memory beside the bank and the tile (4.092 MHz; a wide
bank beside B2's slice), the mix reads them from global memory instead.
Where the bank and the tile themselves do not fit (every system at
8.184 MHz, ROADMAP C15), one channel runs on a thread-block cluster of
cs blocks (``mxu_smem_plan`` picks the layout,
``track_block_epoch.launch_order`` the size the card holds at once):
block r keeps lane part r's bank rows in its shared memory for the
whole launch (staged once by TMA), stages its lanes of each
superstep's windows one superstep ahead where they fit, mixes and
contracts its part, and writes its [2K, R] partial sums into
rank 0's shared memory (DSMEM); rank 0 adds them in rank order and runs
the chain, and its new state goes back to every block. Only the order
of the f32 sums changes.

The shared fetch (B2): on the TPU one DMA of [span + spread_cap]
samples per superstep replaces C overlapping per-channel window DMAs.
On the card a thread-block cluster (``shared_cluster_sizes`` picks its
size; one block per channel) shares the copy: each block issues 1/cs of
the superstep's slice as a TMA multicast into every block of the
cluster, each block holds the whole slice and reads its channel's
window at dc = starts[c] - base, and a cluster barrier per superstep
lets the next slice be multicast. Only where a sample is read from
changes, so B2 equals B1 bit for bit. Where the plan takes the lane
clusters (every system at 8.184 MHz) the slice fits in no block's
shared memory beside a part's bank and tile: B2 then launches B1's lane
kernel on starts[:C] (base + dc), so it is B1 there and has no shared
fetch (one across channels would need a second cluster axis; ROADMAP
B.1). The
slice's read bound is checked on the host (``_check_shared``, ROADMAP
C3): with the base clamped at 0 it reaches past every channel's own
window.

What the port drops from the TPU kernel: the C-fold block-diagonal
contraction and its selection matmuls (on the card it is a per-channel
[R, wp] x [wp, 2K] product), the identity-matmul transposes, the lane
rolls (an indexed read reproduces the roll's lane mapping), the
``ablate`` hooks and the ``pin`` barriers.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..correlator import fma as _fma  # noqa: F401  (fused_runner's scan)
from . import _build, launches
from . import track_block_epoch as _epoch
from .track_block_epoch import (  # noqa: F401  (the JAX module's names)
    MAX_WP, _atan_poly, _check_aligned, _epoch_core_reference,
    check_max_wp, epoch_launch, epoch_smem_plan, lane_parts,
    build_replicas_shared, gather_segments, gather_segments_reference,
    resident_chunk, seg_length, slice_windows, track_block_fused,
    track_block_fused_reference, track_block_fused_resident,
    track_block_fused_resident_reference, track_block_fused_seg,
    track_block_fused_seg_reference)

N_FIELDS = 128
N_TELEM = 21            # mxu telemetry columns
N_TELEM_DIRECT = 17     # direct telemetry columns (fused_runner.N_TELEM_COLS)
TWO_PI = 6.283185307179586
TELEM_MODES = ("full", "lean")

# launches of each CUDA kernel (plain ints, counted by launches.record;
# the plain versions never count): B1 (mxu), B2 (mxu, shared fetch) and B3 (direct)
launch_count = 0
shared_launch_count = 0
direct_launch_count = 0


def reset_launch_count() -> None:
    global launch_count, shared_launch_count, direct_launch_count
    launch_count = shared_launch_count = direct_launch_count = 0


# ---------------------------------------------------------------------------
# geometry glue (counterparts of track_block_fused.py:668-685, 956-966)
# ---------------------------------------------------------------------------

def choose_k(t_epochs: int, k_max: int = 16) -> int | None:
    """Largest superstep size K <= k_max with t_epochs % (2K) == 0 (the
    TPU kernel pairs supersteps; the pairing is kept so both packages
    pick the same K)."""
    for k in range(min(k_max, t_epochs // 2), 0, -1):
        if t_epochs % (2 * k) == 0:
            return k
    return None


def direct_span(k_epochs: int, n0: int, wp: int) -> int:
    """Per-channel window span for one K-epoch superstep (samples)."""
    return ((k_epochs - 1) * n0 // 128) * 128 + wp


def mxu_rows(n_drift: int, el_shift: int) -> int:
    """Replica-bank rows: every integer shift the drift select and the
    early/late lags can address (``n_drift + 2 * el_shift``), padded up
    to 8 when that fits (the extra row is extra drift range)."""
    rows = n_drift + 2 * el_shift
    return 8 if rows <= 8 else rows


def loop_filter_consts(cfg, code_period_ms: int = 1):
    """(pll_c1, pll_c2, dll_c1, dll_c2) from a TrackConfig."""
    from ...receiver.tracking import _loop_filter_taus

    dt = cfg.integration_s * code_period_ms
    p1, p2 = _loop_filter_taus(cfg.pll_bandwidth_hz, cfg.pll_damping,
                               cfg.pll_gain)
    d1, d2 = _loop_filter_taus(cfg.dll_bandwidth_hz, cfg.dll_damping,
                               cfg.dll_gain)
    return dt / p1, p2 / p1, dt / d1, d2 / d1


def build_replicas(codes3x: torch.Tensor, el_shift: int, n0: int, wp: int,
                   n_drift: int, anchor, lane_shift=None) -> torch.Tensor:
    """[C, n_drift, WP] f32 PROMPT replica rows at integer drift shifts
    around each channel's code phase, as one exact index gather from
    ``codes3x`` ([C, >= 2*n0 + wp - el_shift] sampled nominal-rate code,
    tiled; make_sampled_code_table). Row d, lane l holds
    ``code[s_i + l - el_pad - (d - half)]`` shifted right by
    ``lane_shift[c]``.

    ``anchor`` ([C] ints) is the sample anchor
    s_i = floor(chip_phase / chips_per_sample) precomputed by the
    caller, and is consumed verbatim. It MUST be floor-consistent with
    the frac0 state column the kernel selects rows against: the same f32
    division computed in two places can disagree by one ulp exactly at
    a sample boundary, anchoring the replica one sample away from where
    frac0 says it is, a whole-block misalignment the DLL integrates into
    a runaway.

    ``lane_shift`` ([C] ints in [0, 128)) is the per-channel 128-
    alignment residue of the window start (state col 9 carries the
    matching mask shift); it needs n0 > el_pad + half + 128.

    ``anchor`` and ``lane_shift`` may be host arrays or tensors on the
    table's device; on a CUDA tensor nothing here waits for the card
    (the multi-block scan computes both on the card), so the range of
    ``lane_shift`` is checked only where it lies on the host.

    A short table raises: the JAX gather would clamp silently and hand
    the kernel a misaligned replica for the whole block.
    """
    half = (n_drift - 1) // 2
    el_pad = el_shift + half
    need = 2 * n0 + wp - el_shift
    if codes3x.shape[-1] < need:
        raise ValueError(
            f"codes3x rows too short for build_replicas: have "
            f"{codes3x.shape[-1]}, need >= {need} "
            f"(= 2*n0 + wp - el_shift; see make_sampled_code_table)")
    if lane_shift is not None and n0 <= el_pad + half + 128:
        raise ValueError(
            f"n0={n0} too small for lane_shift (need > "
            f"{el_pad + half + 128})")
    c = codes3x.shape[0]
    dev = codes3x.device

    def as_index(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=torch.int64)
        return torch.from_numpy(np.asarray(x, dtype=np.int64)).to(dev)

    s_i = as_index(anchor)
    s_i = torch.where(s_i >= n0, s_i - n0, s_i)
    s_i = torch.where(s_i < 0, s_i + n0, s_i)
    shift = (torch.zeros(c, dtype=torch.int64, device=dev)
             if lane_shift is None else as_index(lane_shift))
    if s_i.shape != (c,) or shift.shape != (c,):
        raise ValueError("anchor / lane_shift must be [C]")
    if lane_shift is not None and shift.device.type == "cpu" and \
            bool(((shift < 0) | (shift >= 128)).any()):
        raise ValueError(f"lane_shift must lie in [0, 128), got {shift}")
    # row d, lane l reads table index base - d + l; the + n0 keeps every
    # index of the tiled table non-negative
    base = s_i + n0 - el_pad + half - shift
    rows = torch.arange(n_drift, device=dev, dtype=torch.int64)
    lanes = torch.arange(wp, device=dev, dtype=torch.int64)
    idx = (base[:, None, None]
           - rows[None, :, None] + lanes[None, None, :])
    return torch.gather(
        codes3x.to(torch.float32), 1, idx.reshape(c, -1)
    ).reshape(c, n_drift, wp)


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def _superstep_windows(stream_re, stream_im, starts, j, *, k_epochs, n0,
                       wp, spread_cap=0):
    """Each channel's [span] window of superstep j, [C, span] per
    component. B1 reads it at starts[c] + off_j in the stream; B2
    (``spread_cap > 0``, starts [C + 1], the last the base) slices the
    superstep's shared [span + spread_cap] at base + off_j and cuts each
    channel's window out of it at dc = starts[c] - base, as
    _mxu_kernel_shared does. The samples are the same either way."""
    span = direct_span(k_epochs, n0, wp)
    off = (j * k_epochs * n0 // 128) * 128
    s64 = starts.to(torch.int64)
    lanes = torch.arange(span, device=starts.device, dtype=torch.int64)
    if spread_cap:
        c = starts.shape[0] - 1
        slot = s64[c] + off + torch.arange(span + spread_cap,
                                           device=starts.device)
        sl_re, sl_im = stream_re[slot], stream_im[slot]
        idx = (s64[:c] - s64[c])[:, None] + lanes[None, :]
        return sl_re[idx], sl_im[idx]
    idx = s64[:, None] + off + lanes[None, :]
    return stream_re[idx], stream_im[idx]


def _superstep_reference(st, j, win_re, win_im, bank, *,
                         k_epochs, wp, n0, fs, code_len,
                         lock_threshold, max_lost, pll_c1, pll_c2,
                         dll_c1, dll_c2, el_shift, aiding_scale, if_freq,
                         lock_mode, costas_thr, interp, lane_parts=None):
    """One K-epoch superstep for all channels from their [C, span]
    windows (_superstep_windows): returns (new state [C, 128], telemetry
    [K, C, 21]). Follows _mxu_run_k's arithmetic step by step.
    ``lane_parts`` [(l0, width), ...]: the contraction summed per lane
    part, the parts' [2K, R] partials then added in part order, as the
    lane clusters add their blocks' (the order within a part is still
    this version's)."""
    dev = st.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    c_channels = st.shape[0]
    r_rows = bank.shape[1]
    half_r = (r_rows - 1) // 2
    kk = k_epochs * n0
    fs_f = f(fs)

    def col(k):
        return st[:, k:k + 1]                                   # [C, 1]

    carr_freq, carr_phase, carr_err0 = col(0), col(1), col(2)
    code_rate, chip_res0, code_err0 = col(3), col(4), col(5)
    lost0, active0, drift0 = col(6), col(7), col(8)
    woff, frac0, lock_ema0 = col(9), col(10), col(11)

    if aiding_scale != 0.0:
        rate_eff = code_rate + (carr_freq - f(if_freq)) * f(aiding_scale)
    else:
        rate_eff = code_rate
    # x / fs is x * (1/fs), the f32 reciprocal: the JAX kernel's
    # compilers (XLA and Mosaic) rewrite a division by a constant so,
    # and a chip phase sitting exactly on a sample boundary floors to
    # the same side only with the same rounding
    inv_fs = f(1.0) / fs_f
    dc = rate_eff * inv_fs
    n_t_f = torch.round(fs_f * f(code_len) / rate_eff)
    step = carr_freq * inv_fs
    adv = step * n_t_f                      # carrier cycles per epoch
    d_drift = n_t_f - f(n0)                 # drift advance per epoch
    # one fused multiply-add, as XLA contracts it: dc * n_t is ~L, so
    # an unfused product would lose up to 2^-10 of d_chip to rounding
    # (f32 operands: the f64 product and difference are exact)
    d_chip = (dc.double() * n_t_f.double() - code_len).float()
    rem_j = j * kk - (j * kk // 128) * 128
    rem_j_f = f(rem_j)

    # ---- stage 1: carrier mix + mask + bf16 window tile ---------------
    w128 = wp // 128
    lane = torch.arange(wp, device=dev, dtype=torch.float32)[None, :]
    q128 = torch.arange(128, device=dev, dtype=torch.float32)[None, :]
    q_w = torch.arange(w128, device=dev, dtype=torch.float32)[None, :]
    th_b = step * q128
    th_b = (th_b - torch.floor(th_b)) * f(TWO_PI)
    b_c, b_s = torch.cos(th_b), torch.sin(th_b)                 # [C, 128]
    tiles = []
    for e in range(k_epochs):
        a_e = (e * n0 // 128) * 128
        rem_e = e * n0 - a_e
        ef = f(e)
        drift_e = drift0 + ef * d_drift
        rem_i = rem_e + rem_j
        # mix and mask in the slice's own lane frame (sl includes
        # rem_i), then roll left by rem_i: the wrapped lanes are zero
        # only because the mask zeroed them
        sl = woff + drift_e + f(rem_e) + rem_j_f
        phi0 = carr_phase + ef * adv - sl * step
        th_a = phi0 + (step * f(128.0)) * q_w
        th_a = (th_a - torch.floor(th_a)) * f(TWO_PI)
        a_c, a_s = torch.cos(th_a), torch.sin(th_a)             # [C, w128]
        ra_c = a_c.repeat_interleave(128, dim=1)                # lane // 128
        ra_s = a_s.repeat_interleave(128, dim=1)
        tb_c, tb_s = b_c.repeat(1, w128), b_s.repeat(1, w128)   # lane % 128
        cth = ra_c * tb_c - ra_s * tb_s
        sth = ra_s * tb_c + ra_c * tb_s
        wre = win_re[:, a_e:a_e + wp]
        wim = win_im[:, a_e:a_e + wp]
        mask = ((lane >= sl) & (lane < sl + n_t_f)).to(torch.float32)
        m_re = (wre * cth + wim * sth) * mask
        m_im = (wim * cth - wre * sth) * mask
        tiles.append(torch.roll(m_re, -rem_i, dims=1).to(torch.bfloat16))
        tiles.append(torch.roll(m_im, -rem_i, dims=1).to(torch.bfloat16))

    # ---- stage 2: per-channel [2K, wp] x [wp, R] contraction ----------
    # bf16 in, f32 accumulation (the f32 products of bf16 are exact)
    tile = torch.stack(tiles[0::2] + tiles[1::2], dim=1)        # [C, 2K, wp]
    corr = None
    for l0, w in lane_parts or [(0, wp)]:
        part = torch.bmm(tile[:, :, l0:l0 + w].to(torch.float32),
                         bank[:, :, l0:l0 + w].to(torch.float32)
                         .transpose(1, 2))                      # [C, 2K, R]
        corr = part if corr is None else corr + part
    corr_re, corr_im = corr[:, :k_epochs], corr[:, k_epochs:]

    # ---- stage 3: picks + discriminators over the K epochs ------------
    ef_all = torch.arange(k_epochs, device=dev,
                          dtype=torch.float32)[None, :]
    drift_all = drift0 + ef_all * d_drift                       # [C, K]
    chip_all = chip_res0 + ef_all * d_chip
    qq_all = (chip_all + frac0) / dc
    qf_all = torch.floor(qq_all)
    shift_all = drift_all - qf_all
    idx_p_all = f(half_r) + shift_all
    r3 = torch.arange(r_rows, device=dev, dtype=torch.float32)[None, None, :]

    def pick(corr3, idx):
        # an index outside [0, R) picks 0, never an out-of-bounds row
        m = (r3 == idx[:, :, None]).to(torch.float32)
        return torch.sum(corr3 * m, dim=2)                      # [C, K]

    if interp:
        f_sub_all = qq_all - qf_all

        def pick_b(corr3, idx):
            return ((1.0 - f_sub_all) * pick(corr3, idx)
                    + f_sub_all * pick(corr3, idx - 1.0))
    else:
        pick_b = pick
    el_f = f(el_shift)
    i_p_all = pick_b(corr_re, idx_p_all)
    q_p_all = pick_b(corr_im, idx_p_all)
    i_e_all = pick_b(corr_re, idx_p_all - el_f)
    q_e_all = pick_b(corr_im, idx_p_all - el_f)
    i_l_all = pick_b(corr_re, idx_p_all + el_f)
    q_l_all = pick_b(corr_im, idx_p_all + el_f)

    power_all = i_p_all * i_p_all + q_p_all * q_p_all
    safe_ip = torch.where(torch.abs(i_p_all) < 1e-12, f(1e-12), i_p_all)
    pll_err_all = _atan_poly(q_p_all / safe_ip) * f(1.0 / TWO_PI)
    pow_e_all = torch.sqrt(i_e_all * i_e_all + q_e_all * q_e_all)
    pow_l_all = torch.sqrt(i_l_all * i_l_all + q_l_all * q_l_all)
    el_sum = pow_e_all + pow_l_all
    dll_err_all = torch.where(
        el_sum > 0.0,
        (pow_e_all - pow_l_all) / torch.maximum(el_sum, f(1e-12)), f(0.0))

    telem = torch.zeros((k_epochs, c_channels, N_TELEM),
                        dtype=torch.float32, device=dev)

    def put(e, k, v):
        telem[e, :, k] = v.reshape(c_channels)

    zero = torch.zeros_like(carr_freq)
    if lock_mode != "costas":
        # ---- stage 4, power lock: closed-form lifecycle chain ---------
        locked_all = power_all > f(lock_threshold)
        kf = k_epochs
        act0_b = active0 > 0.5
        e_row = torch.arange(kf, device=dev)[None, :]
        e_f = e_row.to(torch.float32)
        j3 = torch.arange(kf, device=dev)[None, None, :]
        e3 = torch.arange(kf, device=dev)[None, :, None]
        lk3 = locked_all[:, None, :]
        neg1 = torch.tensor(-1, device=dev)
        # last locked epoch <= e (or -1)
        last_lk = torch.amax(torch.where((j3 <= e3) & lk3, j3, neg1), dim=2)
        lo_all = torch.where(last_lk >= 0, (e_row - last_lk).to(torch.float32),
                             lost0 + e_f + 1.0)
        death = lo_all >= f(max_lost)
        d_idx = torch.amin(torch.where(death, e_row, torch.tensor(kf, device=dev)),
                           dim=1, keepdim=True)
        act_all = act0_b & (e_row <= d_idx)
        upd_all = act_all & locked_all
        wr_all = act_all.to(torch.float32)
        upd_f = upd_all.to(torch.float32)
        emit_lost = (act0_b & (e_row == d_idx)).to(torch.float32)
        n_act = torch.sum(wr_all, dim=1, keepdim=True)
        # loop-filter memory at the start of epoch e = discriminator of
        # the last update epoch strictly before e (ce0/de0 if none)
        last_u = torch.amax(torch.where((j3 < e3) & upd_all[:, None, :],
                                        j3, neg1), dim=2)
        oh_u = (j3 == last_u[:, :, None]).to(torch.float32)
        ce_all = torch.where(last_u >= 0, torch.sum(
            oh_u * pll_err_all[:, None, :], dim=2), carr_err0)
        de_all = torch.where(last_u >= 0, torch.sum(
            oh_u * dll_err_all[:, None, :], dim=2), code_err0)
        carr_nco_all = pll_err_all * f(pll_c1) + (
            pll_err_all - ce_all) * f(pll_c2)
        code_nco_all = dll_err_all * f(dll_c1) + (
            dll_err_all - de_all) * f(dll_c2)
        upd_nco_c = upd_f * carr_nco_all
        upd_nco_d = upd_f * code_nco_all
        # rate sums as explicit left folds from 0 (the order of XLA's
        # reduce and of the CUDA kernel's loop): a 1.023 MHz code rate
        # has a 0.0625 Hz ulp, and a rounding flip there moves the chip
        # ledger by 6e-5 chips per epoch
        sum_c, sum_d = torch.zeros_like(carr_freq), torch.zeros_like(code_rate)
        cf_steps, cr_steps = [], []
        for e in range(kf):
            sum_c = sum_c + upd_nco_c[:, e:e + 1]
            sum_d = sum_d + upd_nco_d[:, e:e + 1]
            # per-epoch post-update rates: prefix sums
            cf_steps.append(carr_freq + sum_c)
            cr_steps.append(code_rate + sum_d)
        cf_f = carr_freq + sum_c
        cr_f = code_rate + sum_d
        cf_steps = torch.cat(cf_steps, dim=1)
        cr_steps = torch.cat(cr_steps, dim=1)
        u_last = torch.amax(torch.where(upd_all, e_row, neg1), dim=1,
                            keepdim=True)
        oh_k = (e_row == u_last).to(torch.float32)
        ce_f = torch.where(u_last >= 0, torch.sum(
            oh_k * pll_err_all, dim=1, keepdim=True), carr_err0)
        de_f = torch.where(u_last >= 0, torch.sum(
            oh_k * dll_err_all, dim=1, keepdim=True), code_err0)
        # the lost counter freezes at its death-epoch value
        oh_lo = (e_row == torch.clamp(d_idx, max=kf - 1)).to(torch.float32)
        lo_f = torch.where(act0_b, torch.sum(oh_lo * lo_all, dim=1,
                                             keepdim=True), lost0)
        died_now = act0_b & (d_idx < kf)
        ac_f = torch.where(died_now, zero, active0)
        died_any = died_now | (~act0_b & (lost0 >= f(max_lost)))
        le_f = torch.where(died_any, zero, lock_ema0)
        for e in range(kf):
            wr_e = wr_all[:, e:e + 1]
            for k, v in ((0, i_e_all), (1, q_e_all), (2, i_p_all),
                         (3, q_p_all), (4, i_l_all), (5, q_l_all),
                         (6, power_all), (8, pll_err_all),
                         (9, dll_err_all), (14, chip_all)):
                put(e, k, v[:, e:e + 1] * wr_e)
            put(e, 7, upd_f[:, e:e + 1])
            put(e, 10, cf_steps[:, e:e + 1])
            put(e, 11, cr_steps[:, e:e + 1])
            put(e, 12, n_t_f)
            put(e, 13, drift_all[:, e:e + 1])
            put(e, 15, emit_lost[:, e:e + 1])
            put(e, 16, wr_e)
            put(e, 17, carr_freq)
            put(e, 18, code_rate)
            put(e, 19, d_chip)
            put(e, 20, d_drift)
    else:
        # ---- stage 4, Costas lock: the sequential EMA chain -----------
        metric_all = (i_p_all * i_p_all - q_p_all * q_p_all) \
            / torch.maximum(power_all, f(1e-12))
        cf_f, ce_f = carr_freq, carr_err0
        cr_f, de_f = code_rate, code_err0
        lo_f, ac_f, le_f = lost0, active0, lock_ema0
        n_act = torch.zeros_like(carr_freq)
        alpha = f(0.1)
        one = torch.ones_like(carr_freq)
        for e in range(k_epochs):
            pll_err = pll_err_all[:, e:e + 1]
            dll_err = dll_err_all[:, e:e + 1]
            new_le = torch.where(
                ac_f > 0.5,
                (1.0 - alpha) * le_f + alpha * metric_all[:, e:e + 1], le_f)
            locked = new_le > f(costas_thr)
            carr_nco = pll_err * f(pll_c1) + (pll_err - ce_f) * f(pll_c2)
            code_nco = dll_err * f(dll_c1) + (dll_err - de_f) * f(dll_c2)
            act_e = ac_f > 0.5
            upd = act_e & locked
            new_cf = torch.where(upd, cf_f + carr_nco, cf_f)
            new_ce = torch.where(upd, pll_err, ce_f)
            new_cr = torch.where(upd, cr_f + code_nco, cr_f)
            new_de = torch.where(upd, dll_err, de_f)
            new_lo = torch.where(act_e, torch.where(locked, zero, lo_f + 1.0),
                                 lo_f)
            died = new_lo >= f(max_lost)
            new_ac = torch.where(died, zero, ac_f)
            wr = torch.where(act_e, one, zero)
            n_act = n_act + wr
            for k, v in ((0, i_e_all), (1, q_e_all), (2, i_p_all),
                         (3, q_p_all), (4, i_l_all), (5, q_l_all),
                         (6, power_all), (8, pll_err_all),
                         (9, dll_err_all), (14, chip_all)):
                put(e, k, v[:, e:e + 1] * wr)
            put(e, 7, upd.to(torch.float32))
            put(e, 10, torch.where(act_e, new_cf, cf_f))
            put(e, 11, torch.where(act_e, new_cr, cr_f))
            put(e, 12, n_t_f)
            put(e, 13, drift_all[:, e:e + 1])
            put(e, 15, (died & act_e).to(torch.float32))
            put(e, 16, wr)
            put(e, 17, carr_freq)
            put(e, 18, code_rate)
            put(e, 19, d_chip)
            put(e, 20, d_drift)
            cf_f, ce_f, cr_f, de_f = new_cf, new_ce, new_cr, new_de
            lo_f, le_f = new_lo, torch.where(died, zero, new_le)
            ac_f = new_ac

    # ---- superstep writeback (held-rate ledger advance) ---------------
    ncp = carr_phase + n_act * adv
    new = torch.zeros_like(st)
    for k, v in ((0, cf_f), (1, ncp - torch.floor(ncp)), (2, ce_f),
                 (3, cr_f), (4, chip_res0 + n_act * d_chip), (5, de_f),
                 (6, lo_f), (7, ac_f), (8, drift0 + n_act * d_drift),
                 (9, woff), (10, frac0), (11, le_f)):
        new[:, k] = v.reshape(c_channels)
    return new, telem


def _lean_from_full(telem, k_epochs, first_superstep, costas):
    """The lean telemetry of a block from its full telemetry: what the
    lean mode stores, zeros elsewhere (the mode's contract, module
    docstring)."""
    lean = torch.zeros_like(telem)
    lean[..., 2:4] = telem[..., 2:4]
    lean[..., 16] = telem[..., 16] + 2.0 * telem[..., 7] \
        + 4.0 * telem[..., 15]
    for u in range(telem.shape[0] // k_epochs):
        e = u * k_epochs
        lean[e, :, 17:21] = telem[e, :, 17:21]
        if costas or (first_superstep + u) % 2 == 0:
            for k in (0, 1, 4, 5, 8, 9):
                lean[e, :, k] = telem[e, :, k]
    return lean


def _check_args(stream_re, stream_im, starts, replicas, state_in, *,
                t_epochs, k_epochs, n0, wp, lock_mode, starts_host=None,
                starts_bound=None, first_superstep=0,
                replica_dtype=torch.bfloat16, spread_cap=0):
    """Types, shapes, devices, contiguity and the read bound of one
    launch of either layout (they share the window feed); with
    ``spread_cap > 0`` (B2) also the shared slices' read bound."""
    if wp % 128:
        raise ValueError(f"the fused kernels require wp % 128 == 0, "
                         f"got {wp}")
    if k_epochs < 1 or t_epochs % (2 * k_epochs):
        raise ValueError(f"t_epochs={t_epochs} not divisible by "
                         f"2*k_epochs={2 * k_epochs}")
    if lock_mode not in ("power", "costas"):
        raise ValueError(f"unknown lock_mode {lock_mode!r}")
    if spread_cap < 0 or spread_cap % 128:
        raise ValueError(f"spread_cap must be a 128-multiple >= 0, got "
                         f"{spread_cap}")
    dev = state_in.device
    for name, t, dt in (("stream_re", stream_re, torch.float32),
                        ("stream_im", stream_im, torch.float32),
                        ("starts", starts, torch.int32),
                        ("replicas", replicas, replica_dtype),
                        ("state_in", state_in, torch.float32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, state_in on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    c = state_in.shape[0]
    n_starts = c + 1 if spread_cap else c
    if state_in.shape != (c, N_FIELDS):
        raise ValueError(f"state_in must be [C, {N_FIELDS}], "
                         f"got {tuple(state_in.shape)}")
    if stream_re.ndim != 1 or stream_im.shape != stream_re.shape:
        raise ValueError("stream_re / stream_im must be matching [L]")
    if starts.shape != (n_starts,):
        what = "[C + 1] (the last the shared base)" if spread_cap else "[C]"
        raise ValueError(f"starts must be {what}, C={c}, got "
                         f"{tuple(starts.shape)}")
    if replicas.ndim != 3 or replicas.shape[0] != c or \
            replicas.shape[2] != wp:
        raise ValueError(f"replicas must be [C, R, wp={wp}], "
                         f"got {tuple(replicas.shape)}")
    # read bound: the last superstep's window must lie inside the stream
    # (an out-of-bounds read on the card goes unnoticed or faults),
    # checked on the host, so a launch never waits for the card: from
    # the host copy of the starts, or from a static bound the caller
    # guarantees (0 <= every start <= starts_bound; the multi-block scan
    # computes its starts on the card and knows only this bound)
    if starts_host is not None and starts_bound is not None:
        raise ValueError("give starts_host or starts_bound, not both")
    host = None                     # the start values, where known here
    if starts_bound is not None:
        lo, hi = 0, int(starts_bound)
        if starts.device.type == "cpu" and starts.numel():
            # on the host the guarantee itself is checked too
            host = starts.numpy()
            s_lo, s_hi = int(host[:c].min()), int(host[:c].max())
            if s_lo < 0 or s_hi > hi:
                raise ValueError(f"starts in [{s_lo}, {s_hi}] break their "
                                 f"bound [0, {hi}]")
    else:
        if starts_host is None:
            if starts.device.type != "cpu":
                raise ValueError(
                    "starts on the card needs starts_host, the host values "
                    "it was uploaded from, or starts_bound, for the "
                    "read-bound check")
            host = starts.numpy()
        else:
            host = np.asarray(starts_host)
            if host.shape != (n_starts,):
                raise ValueError(f"starts_host must be [{n_starts}] (C={c}), "
                                 f"got {host.shape}")
        lo, hi = int(host[:c].min()), int(host[:c].max())
    span = direct_span(k_epochs, n0, wp)
    j_last = first_superstep + t_epochs // k_epochs - 1
    last = (j_last * k_epochs * n0 // 128) * 128
    if lo < 0 or hi + last + span > stream_re.shape[0]:
        raise ValueError(
            f"window read out of bounds: starts in [{lo}, {hi}], last "
            f"superstep reads to {hi + last + span} > "
            f"len(stream)={stream_re.shape[0]}")
    if spread_cap:
        _check_shared(host, c, spread_cap, starts_bound, last + span,
                      stream_re.shape[0])


def _check_shared(host, c, spread_cap, starts_bound, tail, length):
    """B2's slices: every channel's window inside the shared slice
    (dc = starts[c] - base a 128-multiple in [0, spread_cap], base a
    128-multiple >= 0) and the last superstep's slice inside the stream,
    base + spread_cap + ``tail`` <= ``length`` (ROADMAP C3). The per-
    channel bound does not imply it when the base is clamped at 0
    (max(starts) < spread_cap): the slice then reads past every window.
    From a static bound (the scan, whose base is max(0, max(starts) -
    spread_cap)) the slice ends by max(bound, spread_cap) + tail."""
    ends = []
    if host is not None:
        base = int(host[c])
        dc = host[:c].astype(np.int64) - base
        if base < 0 or base % 128:
            raise ValueError(f"shared base {base} must be a 128-multiple "
                             ">= 0")
        if (dc % 128).any() or dc.min() < 0 or dc.max() > spread_cap:
            raise ValueError(
                f"shared-fetch starts must lie in [base, base + spread_cap="
                f"{spread_cap}] on 128-sample steps, got offsets from the "
                f"base {dc.tolist()}")
        ends.append(base + spread_cap + tail)
    if starts_bound is not None:
        ends.append(max(int(starts_bound), spread_cap) + tail)
    if max(ends) > length:
        raise ValueError(
            f"shared window read out of bounds (ROADMAP C3): the last "
            f"superstep's [span + spread_cap] slice reads to {max(ends)} > "
            f"len(stream)={length}")


def track_block_fused_mxu_reference(
    stream_re, stream_im, starts, replicas, state_in, *, t_epochs,
    k_epochs, n0, wp, fs, code_len=1023.0, lock_threshold=15.0,
    max_lost=20, pll_c1=0.0, pll_c2=0.0, dll_c1=0.0, dll_c2=0.0,
    el_shift=1, aiding_scale=0.0, if_freq=0.0, lock_mode="power",
    costas_thr=0.4, interp=False, telem_mode="full", starts_host=None,
    starts_bound=None, first_superstep=0, spread_cap=0, lane_parts=None,
):
    """The plain PyTorch version of the mxu kernel, on any device: the
    same arithmetic, step by step, one Python iteration per superstep.
    Returns (telemetry [T, C, 21] f32, state [C, 128] f32).
    ``lane_parts`` sums the correlations per lane part, then in part
    order (_superstep_reference), as the lane clusters do.

    ``spread_cap > 0`` is B2's (``_mxu_kernel_shared``): ``starts`` is
    [C + 1], the last the shared base; each superstep slices
    [base + off_j, + span + spread_cap) and cuts every channel's window
    out of it at starts[c] - base, then runs B1's arithmetic.

    ``first_superstep`` > 0 runs supersteps ``first_superstep ..`` of a
    longer block from ``state_in`` (their window offsets in the block),
    so a check can hold the kernel's block to this version piece by
    piece, each piece started from the kernel's own state."""
    if telem_mode not in TELEM_MODES:
        raise ValueError(f"unknown telem_mode {telem_mode!r}")
    _check_args(stream_re, stream_im, starts, replicas, state_in,
                t_epochs=t_epochs, k_epochs=k_epochs, n0=n0, wp=wp,
                lock_mode=lock_mode, starts_host=starts_host,
                starts_bound=starts_bound, first_superstep=first_superstep,
                spread_cap=spread_cap)
    st = state_in
    telems = []
    for j in range(first_superstep,
                   first_superstep + t_epochs // k_epochs):
        win_re, win_im = _superstep_windows(
            stream_re, stream_im, starts, j, k_epochs=k_epochs, n0=n0,
            wp=wp, spread_cap=spread_cap)
        st, tl = _superstep_reference(
            st, j, win_re, win_im, replicas,
            k_epochs=k_epochs, wp=wp, n0=n0, fs=fs,
            code_len=code_len, lock_threshold=lock_threshold,
            max_lost=max_lost, pll_c1=pll_c1, pll_c2=pll_c2,
            dll_c1=dll_c1, dll_c2=dll_c2, el_shift=el_shift,
            aiding_scale=aiding_scale, if_freq=if_freq,
            lock_mode=lock_mode, costas_thr=costas_thr, interp=interp,
            lane_parts=lane_parts)
        telems.append(tl)
    telem = torch.cat(telems, dim=0)
    if telem_mode == "lean":
        telem = _lean_from_full(telem, k_epochs, first_superstep,
                                lock_mode == "costas")
    return telem, st


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# track_block_mxu_launch's parameters (csrc/track_block_mxu.cu; the lane
# clusters' sub-chunk width, window staging and warps last, after the
# stream)
MXU_ARGTYPES = [_VP, _VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP,
                _I, _I, _I, _I, _I, _I,
                _F, _F, _F, _I, _F, _F, _F, _F, _I,
                _F, _F, _I, _F, _I, _I, _I, _I, _VP, _I, _I, _I]

# shared memory on the H100: what one block may have (227 KB), and an
# upper bound of the mxu kernels' static arrays, which the plan keeps free
# beside the dynamic part. The whole-width kernel's: the warps' partial
# sums [16, 2 * 8 * 16] f32, the correlations, the mix's factors [2, 128],
# the chain's [16] and [8, 5], an mbarrier and a zero row, rounded up to
# 28 KB. The lane clusters' (their partials are dynamic): the
# correlations [2 * 8 * 24] f32, the mix's factors, the chain's arrays,
# three mbarriers and a zero row, 2,824 B, rounded up to 4 KB. The plan
# is the only decision: the launcher runs the layout it is given and
# returns -2 where it does not fit. Bank rows: up to 16 whole-width, 24
# in lane clusters.
SMEM_BLOCK = 232_448
MXU_STATIC_SMEM = 28_672
MXU_LANES_STATIC_SMEM = 4_096
MXU_MAX_K, MXU_MAX_R, MXU_WHOLE_MAX_R = 8, 24, 16
_MXU_PAD = 8            # bf16 pad per tile and bank row
# lane clusters: a staged window row holds the part and this many more
# samples (the roll's reach) behind the 0-3 of its 16-byte floor
MXU_LANE_REACH = 256
# the plan offers the cluster sizes of track_block_epoch.LANE_CLUSTERS
# that fit: on the H100 a larger cluster is faster while the channels'
# clusters all run at once (PERF.md section 6), so the plan puts first the
# sizes whose C x cs blocks fit on the card's SMs and the wrapper those
# the card holds at once (launch_order). The warps of a block: None for 8
# where the window rows are staged and 16 where the mix reads global
# memory (the faster of the two in each case, section 6); 8 or 16 to force
# them.
H100_SMS = 132
MXU_LANE_WARPS = None


def lane_cluster_bytes(wp: int, r_rows: int, k_epochs: int, cs: int,
                       warps: int, sub: int, staged: bool) -> int:
    """The lane clusters' dynamic shared memory per block, as the
    launcher lays it out: the staged window rows [2, K, widest + reach +
    4] f32 (``staged``), the bank [R, sub] bf16 (two buffers where the
    sub-chunk ``sub`` is narrower than the widest part: streamed), the
    tile [2K, sub] bf16 (rows padded by 8), the A factors [2, K, widest /
    128 + 2] f32, and the warps' and ranks' partial sums [warps + cs, 2K,
    R] f32."""
    widest = max(w for _, w in lane_parts(wp, cs))
    bufs = 1 if sub >= widest else 2
    ts = min(sub, widest) + _MXU_PAD
    n = ((bufs * r_rows + 2 * k_epochs) * ts * 2
         + 2 * k_epochs * (widest // 128 + 2) * 4
         + (warps + cs) * 2 * k_epochs * r_rows * 4)
    if staged:
        n += 2 * k_epochs * (widest + MXU_LANE_REACH + 4) * 4
    return n


def _lane_option(wp, r_rows, k_epochs, cs, warps, room):
    """The lane clusters at size ``cs``: the bank resident (the windows
    staged where they fit too), else streamed in the widest sub-chunks
    that fit, evened out; None where not even 128 lanes fit. ``warps``
    None: 8 where the windows are staged, else 16."""
    widest = max(w for _, w in lane_parts(wp, cs))
    opt = dict(cs=cs, parts=lane_parts(wp, cs), sub=widest, resident=True)
    for staged in (True, False)[wp < MXU_LANE_REACH:]:
        w_opt = warps or (8 if staged else 16)
        n = lane_cluster_bytes(wp, r_rows, k_epochs, cs, w_opt, widest,
                               staged)
        if n <= room:
            return dict(opt, warps=w_opt, staged=staged, bytes=n)
    warps = warps or 16
    opt["warps"] = warps
    sub = 0
    while (sub + 128 < widest and lane_cluster_bytes(
            wp, r_rows, k_epochs, cs, warps, sub + 128, False) <= room):
        sub += 128
    if sub == 0:
        return None
    n = -(-widest // sub)
    sub = -(-(widest // 128) // n) * 128
    return dict(opt, sub=sub, resident=False, staged=False,
                bytes=lane_cluster_bytes(wp, r_rows, k_epochs, cs, warps,
                                         sub, False))


def _lane_max_wp(r_rows, k_epochs, cs, warps, room):
    """The widest wp the lane clusters take at size ``cs``: 128-lane
    sub-chunks streamed, the A factors of the widest part filling what
    the bank's buffers, the tile and the partial sums leave."""
    fixed = ((2 * r_rows + 2 * k_epochs) * (128 + _MXU_PAD) * 2
             + ((warps or 16) + cs) * 2 * k_epochs * r_rows * 4)
    groups = (room - fixed) // (8 * k_epochs) - 2
    return max(0, groups) * cs * 128


def mxu_smem_plan(wp: int, r_rows: int, k_epochs: int,
                  smem: int = SMEM_BLOCK, c_channels: int | None = None,
                  n_sm: int = H100_SMS) -> dict:
    """B1's shared-memory layout for [R, wp] banks at K-epoch supersteps,
    which the launcher (csrc/track_block_mxu.cu) runs as given:
    ``"whole"`` while the bank [R, wp] and the tile [2K, wp] (bf16, rows
    padded by 8) fit beside the trig factors [2, K, wp/128] f32 and R <=
    16 (the window staged beside them when it fits too, which the
    launcher decides); else ``"cluster"``: one channel over a
    thread-block cluster of cs blocks, block r holding lane part r's
    bank rows (``lane_cluster_bytes``). ``"options"`` lists the cluster
    sizes of ``track_block_epoch.LANE_CLUSTERS`` that fit, each {"cs",
    "warps", "parts" [(l0, width), ...] covering [0, wp) once, "sub" (the
    bank's sub-chunk: the widest part where "resident"), "resident", "staged"
    (the window rows in shared memory), "bytes" (the dynamic part)}, in
    the order the wrapper tries them: with ``c_channels``, the sizes
    whose C x cs blocks fit on ``n_sm`` SMs first. The plan's own keys
    are the first option's. B2 takes the same plan (in lane clusters it
    launches B1's kernel). Also "max_wp", the widest wp this R and K
    take; raises ValueError naming ROADMAP C15 above it."""
    w128 = wp // 128
    room = smem - MXU_STATIC_SMEM
    warps = MXU_LANE_WARPS
    lane_room = smem - MXU_LANES_STATIC_SMEM
    max_wp = max(_lane_max_wp(r_rows, k_epochs, cs, warps, lane_room)
                 for cs in _epoch.LANE_CLUSTERS)
    trig = 2 * k_epochs * w128 * 4
    whole = (r_rows + 2 * k_epochs) * (wp + _MXU_PAD) * 2 + trig
    if whole <= room and r_rows <= MXU_WHOLE_MAX_R:
        return {"layout": "whole", "cs": 0, "parts": [(0, wp)],
                "bytes": whole, "max_wp": max_wp, "options": []}
    # (one block per channel only where wp has a single lane group)
    sizes = [cs for cs in _epoch.LANE_CLUSTERS if cs <= w128] or [1]
    if c_channels:
        sizes.sort(key=lambda cs: c_channels * cs > n_sm)
    options = [o for o in (
        _lane_option(wp, r_rows, k_epochs, cs, warps, lane_room)
        for cs in sizes if wp <= _lane_max_wp(
            r_rows, k_epochs, cs, warps, lane_room)) if o]
    if wp > max_wp or not options:
        raise ValueError(
            f"track_block_mxu (B1): wp={wp} at R={r_rows}, K={k_epochs} "
            f"is wider than the kernel takes (wp <= {max_wp}: the A "
            "factors of a cluster's widest part and one 128-lane "
            f"sub-chunk fill the {smem} bytes of shared memory a block "
            "may have; ROADMAP C15)")
    return dict(options[0], layout="cluster", max_wp=max_wp,
                options=options)


def _lib():
    lib = _build.load_library("track_block_mxu")
    fn = lib.track_block_mxu_launch
    fn.argtypes, fn.restype = MXU_ARGTYPES, _I
    return fn


_LANE_ACTIVE: dict = {}


def lane_active_clusters(device, k_epochs: int, wp: int, r_rows: int,
                         lean: bool, opt: dict) -> int:
    """How many clusters of the lane option ``opt`` the card ``device``
    holds at once with every block on an SM of its own
    (cudaOccupancyMaxActiveClusters for a whole SM's shared memory a
    block, through the launcher's own set-up; csrc/track_block_mxu.cu
    track_block_mxu_lane_clusters), or the launcher's -1 / -2 where it
    cannot run; cached per card and layout. On the H100 (132 SMs): 7
    clusters of 16, 15 of 8, 30 of 4, 66 of 2 (PERF.md section 6)."""
    key = (device.index, k_epochs, wp, r_rows, bool(lean), opt["cs"],
           opt["sub"], bool(opt["staged"]), opt["warps"])
    if key not in _LANE_ACTIVE:
        lib = _build.load_library("track_block_mxu")
        fn = lib.track_block_mxu_lane_clusters
        fn.argtypes, fn.restype = [_I] * 8, _I
        with torch.cuda.device(device):
            _LANE_ACTIVE[key] = fn(k_epochs, wp, r_rows, int(bool(lean)),
                                   opt["cs"], opt["sub"],
                                   int(opt["staged"]), opt["warps"])
    return _LANE_ACTIVE[key]


# track_block_mxu_launch's own error codes (CUDA's are >= 0)
_ERR_NO_CLUSTER = -1        # above 8 blocks, or no such cluster fits
_ERR_SMEM = -2              # more shared memory than a block can have


def shared_cluster_sizes(c_channels: int) -> tuple[int, ...]:
    """B2's thread-block cluster sizes, in the order the wrapper tries
    them: the divisors of C from 2 to 8 (8 the portable maximum; a
    divisor, so the grid of C blocks, one per channel, is a whole number
    of clusters), smallest first (since the whole slice sits in every
    block, the size moves B2's time by a few percent at most, PERF.md
    section 6). The first the card can run is launched. A C with no such divisor (1, or
    a prime > 8) gives 1: each block then copies the whole slice alone."""
    return tuple(d for d in range(2, 9) if c_channels % d == 0) or (1,)


# B3's launch entry: as the epoch kernel's (EPOCH_ARGTYPES), the stream
# then the cluster size and every rank's state
DIRECT_ARGTYPES = [_VP, _VP, ctypes.c_longlong, _VP, _VP, _VP, _VP, _VP,
                   _I, _I, _I, _I, _I, _I,
                   _F, _F, _F, _I, _F, _F, _F, _F, _I,
                   _F, _F, _I, _F, _I, _VP, _I, _VP]


def _direct_lib():
    lib = _build.load_library("track_block_direct")
    fn = lib.track_block_direct_launch
    fn.argtypes, fn.restype = DIRECT_ARGTYPES, _I
    return fn


def track_block_fused_mxu(
    stream_re: torch.Tensor,   # [L] f32 shared sample stream
    stream_im: torch.Tensor,   # [L] f32
    starts: torch.Tensor,      # [C] i32 per-channel window starts
    replicas: torch.Tensor,    # [C, R, wp] bf16 bank (build_replicas)
    state_in: torch.Tensor,    # [C, 128] f32
    *,
    t_epochs: int,
    k_epochs: int,
    n0: int,
    wp: int,
    fs: float,
    code_len: float = 1023.0,
    lock_threshold: float = 15.0,
    max_lost: int = 20,
    pll_c1: float = 0.0,
    pll_c2: float = 0.0,
    dll_c1: float = 0.0,
    dll_c2: float = 0.0,
    el_shift: int = 1,
    aiding_scale: float = 0.0,
    if_freq: float = 0.0,
    lock_mode: str = "power",
    costas_thr: float = 0.4,
    interp: bool = False,
    telem_mode: str = "full",
    starts_host=None,          # [C] host copy of starts (numpy)
    starts_bound=None,         # or: int, 0 <= every start <= it
    spread_cap: int = 0,       # > 0: B2, starts [C + 1] (last = base)
):
    """mxu fused tracking: T epochs, ONE kernel launch. Returns
    (telemetry [T, C, 21] f32, full or lean, state [C, 128] f32).

    ``spread_cap > 0`` launches B2, the shared-fetch kernel
    (``_mxu_kernel_shared``): ``starts`` is [C + 1] with starts[C] the
    base, every starts[c] - base a 128-multiple in [0, spread_cap]; each
    superstep's [span + spread_cap] slice at base + off_j is read once
    per thread-block cluster (a TMA multicast into each of its blocks)
    and every channel cuts its window out of it (in lane clusters, the
    8.184 MHz widths, B1's lane kernel runs on ``starts[:C]``). The
    result equals B1's on ``starts[:C]`` at the same cluster size bit
    for bit.

    CPU tensors run the plain version; CUDA tensors launch the CUDA
    kernel or raise (failed build, refused launch, bad argument). There
    is no fallback from the card to the plain version, nor from B2 to
    B1. On the card ``stream_re``, ``stream_im`` and ``replicas`` must
    start 16-byte aligned (a fresh tensor does). The read bound (with
    ``spread_cap``, also the shared slices', ROADMAP C3) is checked on
    the host before the launch, from
    ``starts_host`` (the values ``starts`` was uploaded from) or
    ``starts_bound`` (one of them is required on the card), so the
    launch never waits for the card."""
    kw = dict(t_epochs=t_epochs, k_epochs=k_epochs, n0=n0, wp=wp, fs=fs,
              code_len=code_len, lock_threshold=lock_threshold,
              max_lost=max_lost, pll_c1=pll_c1, pll_c2=pll_c2,
              dll_c1=dll_c1, dll_c2=dll_c2, el_shift=el_shift,
              aiding_scale=aiding_scale, if_freq=if_freq,
              lock_mode=lock_mode, costas_thr=costas_thr, interp=interp,
              telem_mode=telem_mode, starts_host=starts_host,
              starts_bound=starts_bound, spread_cap=spread_cap)
    if state_in.device.type == "cpu":
        return track_block_fused_mxu_reference(
            stream_re, stream_im, starts, replicas, state_in, **kw)
    if state_in.device.type != "cuda":
        raise ValueError(f"unsupported device {state_in.device}")
    if telem_mode not in TELEM_MODES:
        raise ValueError(f"unknown telem_mode {telem_mode!r}")
    _check_args(stream_re, stream_im, starts, replicas, state_in,
                t_epochs=t_epochs, k_epochs=k_epochs, n0=n0, wp=wp,
                lock_mode=lock_mode, starts_host=starts_host,
                starts_bound=starts_bound, spread_cap=spread_cap)
    c, r_rows = replicas.shape[0], replicas.shape[1]
    if k_epochs > MXU_MAX_K or r_rows > MXU_MAX_R:
        raise ValueError(f"the CUDA kernel takes K <= {MXU_MAX_K} and R <= "
                         f"{MXU_MAX_R}, got K={k_epochs}, R={r_rows}")
    plan = mxu_smem_plan(wp, r_rows, k_epochs, c_channels=c)
    _check_aligned(("stream_re", stream_re), ("stream_im", stream_im),
                   ("replicas", replicas))
    fn = _lib()
    lean = telem_mode == "lean"
    # the lean mode stores a few columns: the rest must read zero
    telem = (torch.zeros if lean else torch.empty)(
        (t_epochs, c, N_TELEM), dtype=torch.float32, device=state_in.device)
    state_out = torch.empty_like(state_in)
    with torch.cuda.device(state_in.device):
        stream = torch.cuda.current_stream().cuda_stream
        # the launcher refuses a cluster size that cannot run, or shared
        # memory that does not fit, before it launches anything; the next
        # size then has a try (B2 in lane clusters runs B1's kernel)
        if plan["layout"] == "whole":
            tries = [(cluster, 0, 0, 0) for cluster in (
                shared_cluster_sizes(c) if spread_cap else (1,))]
        else:
            tries = [(o["cs"], o["sub"], int(o["staged"]), o["warps"])
                     for o in _epoch.launch_order(
                         plan["options"], c,
                         lambda o: lane_active_clusters(
                             state_in.device, k_epochs, wp, r_rows, lean,
                             o))]
        for cluster, lanes, staged, warps in tries:
            err = fn(stream_re.data_ptr(), stream_im.data_ptr(),
                     stream_re.shape[0], starts.data_ptr(),
                     replicas.data_ptr(), state_in.data_ptr(),
                     telem.data_ptr(), state_out.data_ptr(),
                     c, t_epochs, k_epochs, n0, wp, r_rows,
                     fs, code_len, lock_threshold, int(max_lost),
                     pll_c1, pll_c2, dll_c1, dll_c2, int(el_shift),
                     aiding_scale, if_freq, int(lock_mode == "costas"),
                     costas_thr, int(bool(interp)), int(lean),
                     int(spread_cap), cluster, stream, lanes, staged,
                     warps)
            if err not in (_ERR_NO_CLUSTER, _ERR_SMEM):
                break
    name = "track_block_mxu (B2, shared fetch)" if spread_cap else \
        "track_block_mxu"
    if err == _ERR_NO_CLUSTER:
        raise RuntimeError(
            f"{name}: no cluster of {cluster} blocks can run on the card "
            "(above the portable 8, or 16 for the lane clusters, or "
            "cudaOccupancyMaxActiveClusters = 0)")
    if err == _ERR_SMEM:
        raise RuntimeError(f"{name}: the launch needs more shared memory "
                           "than a block can have (wp, K, R or spread_cap "
                           f"too large; the plan was {plan['layout']}, "
                           f"cluster {plan['cs']}, {plan['bytes']} bytes; "
                           "ROADMAP C15)")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches.record(__name__, "shared_launch_count" if spread_cap
                    else "launch_count")
    return telem, state_out


# ---------------------------------------------------------------------------
# the direct layout (kernel B3)
# ---------------------------------------------------------------------------
#
# Contract kept from the TPU kernel (``_direct_kernel`` driving
# ``_epoch_core``), per epoch e of superstep j (K epochs each):
#   * exact per-epoch NCOs: every epoch derives its rates from the state
#     the previous epoch left, and the loop filters update it at once;
#   * the window frame of superstep j starts at a_c + floor(jKn0/128)*128
#     in the stream, epoch e's window at floor(en0/128)*128 inside it, and
#     the epoch's lanes are [start_lane, start_lane + n_t) with
#     start_lane = col9 + drift + rem_e + rem_j (the alignment residues);
#   * the carrier from the outer-product trig factors A (per 128-lane
#     group) and B (per lane mod 128), phase referenced to start_lane;
#   * the prompt selected from N_DRIFT f32 replica rows by the drift less
#     floor((chip_res + frac0) / dc), blended with the row below by the
#     fractional sample when ``interp``; rolled right by rem_i = rem_e +
#     rem_j; early and late the prompt's +-el_shift rolls (the mask zeroes
#     the wrapped lanes);
#   * six f32 correlations, power or Costas lock, the PLL/DLL
#     discriminators and loop filters, death after max_lost unlocked
#     epochs;
#   * telemetry columns 0-16 as [T, C, 17] f32, the [C, 128] state.
# Arithmetic as XLA computes the TPU kernel's on the CPU (checked bit for
# bit against the Pallas kernel in interpret mode): x / fs is x * (1/fs)
# (the constant-divisor rewrite), and the carrier phase and chip ledger
# advances are fused multiply-adds, fma(step, n_t, phase) and
# fma(dc, n_t, chip_res) - L (here exact f64 products, fmaf on the card).
# bf16 appears nowhere in this layout.

def _epoch_direct_reference(st, j, e, stream_re, stream_im, starts, reps, *,
                            k_epochs, **kw):
    """Epoch e of superstep j for all channels: (new state [C, 128],
    telemetry row [C, 17]), the direct feed of _epoch_core_reference."""
    kk = k_epochs * kw["n0"]
    off = (j * kk // 128) * 128
    rem_j = j * kk - off
    a_e = (e * kw["n0"] // 128) * 128
    rem_e = e * kw["n0"] - a_e
    start_lane = (st[:, 9:10] + st[:, 8:9]) + float(rem_e) + float(rem_j)
    pos = starts.to(torch.int64)[:, None] + (off + a_e) + torch.arange(
        kw["wp"], device=st.device, dtype=torch.int64)[None, :]
    return _epoch_core_reference(st, stream_re[pos], stream_im[pos], reps,
                                 start_lane, rem_e + rem_j, **kw)


def track_block_fused_direct_reference(
    stream_re, stream_im, starts, replicas, state_in, *, t_epochs,
    k_epochs, n0, wp, fs, code_len=1023.0, lock_threshold=15.0,
    max_lost=20, pll_c1=0.0, pll_c2=0.0, dll_c1=0.0, dll_c2=0.0,
    el_shift=1, aiding_scale=0.0, if_freq=0.0, lock_mode="power",
    costas_thr=0.4, interp=False, starts_host=None, starts_bound=None,
    first_superstep=0, lane_parts=None,
):
    """The plain PyTorch version of the direct kernel, on any device:
    the same arithmetic, one Python iteration per epoch. Returns
    (telemetry [T, C, 17] f32, state [C, 128] f32). ``first_superstep``
    as in track_block_fused_mxu_reference; ``lane_parts`` sums each
    correlation per lane part, then in rank order (the lane clusters'
    order, _epoch_core_reference)."""
    _check_args(stream_re, stream_im, starts, replicas, state_in,
                t_epochs=t_epochs, k_epochs=k_epochs, n0=n0, wp=wp,
                lock_mode=lock_mode, starts_host=starts_host,
                starts_bound=starts_bound, first_superstep=first_superstep,
                replica_dtype=torch.float32)
    kw = dict(k_epochs=k_epochs, wp=wp, n0=n0, fs=fs, code_len=code_len,
              lock_threshold=lock_threshold, max_lost=max_lost,
              pll_c1=pll_c1, pll_c2=pll_c2, dll_c1=dll_c1, dll_c2=dll_c2,
              el_shift=el_shift, aiding_scale=aiding_scale,
              if_freq=if_freq, lock_mode=lock_mode, costas_thr=costas_thr,
              interp=interp, lane_parts=lane_parts)
    st, rows = state_in, []
    for j in range(first_superstep,
                   first_superstep + t_epochs // k_epochs):
        for e in range(k_epochs):
            st, row = _epoch_direct_reference(
                st, j, e, stream_re, stream_im, starts, replicas, **kw)
            rows.append(row)
    return torch.stack(rows, dim=0), st


def track_block_fused_direct(
    stream_re: torch.Tensor,   # [L] f32 shared sample stream
    stream_im: torch.Tensor,   # [L] f32
    starts: torch.Tensor,      # [C] i32 per-channel window starts
    replicas: torch.Tensor,    # [C, N_DRIFT, wp] f32 (build_replicas)
    state_in: torch.Tensor,    # [C, 128] f32
    *,
    t_epochs: int,
    k_epochs: int,
    n0: int,
    wp: int,
    fs: float,
    code_len: float = 1023.0,
    lock_threshold: float = 15.0,
    max_lost: int = 20,
    pll_c1: float = 0.0,
    pll_c2: float = 0.0,
    dll_c1: float = 0.0,
    dll_c2: float = 0.0,
    el_shift: int = 1,
    aiding_scale: float = 0.0,
    if_freq: float = 0.0,
    lock_mode: str = "power",
    costas_thr: float = 0.4,
    interp: bool = False,
    starts_host=None,          # [C] host copy of starts (numpy)
    starts_bound=None,         # or: int, 0 <= every start <= it
):
    """direct fused tracking: T epochs, ONE kernel launch. Returns
    (telemetry [T, C, 17] f32, state [C, 128] f32). Devices, checks
    (the stream 16-byte aligned among them) and the read bound as
    track_block_fused_mxu."""
    kw = dict(t_epochs=t_epochs, k_epochs=k_epochs, n0=n0, wp=wp, fs=fs,
              code_len=code_len, lock_threshold=lock_threshold,
              max_lost=max_lost, pll_c1=pll_c1, pll_c2=pll_c2,
              dll_c1=dll_c1, dll_c2=dll_c2, el_shift=el_shift,
              aiding_scale=aiding_scale, if_freq=if_freq,
              lock_mode=lock_mode, costas_thr=costas_thr, interp=interp,
              starts_host=starts_host, starts_bound=starts_bound)
    if state_in.device.type == "cpu":
        return track_block_fused_direct_reference(
            stream_re, stream_im, starts, replicas, state_in, **kw)
    if state_in.device.type != "cuda":
        raise ValueError(f"unsupported device {state_in.device}")
    _check_args(stream_re, stream_im, starts, replicas, state_in,
                t_epochs=t_epochs, k_epochs=k_epochs, n0=n0, wp=wp,
                lock_mode=lock_mode, starts_host=starts_host,
                starts_bound=starts_bound, replica_dtype=torch.float32)
    c, n_drift = replicas.shape[0], replicas.shape[1]
    if n_drift > 8:
        raise ValueError(f"the CUDA kernel takes <= 8 replica rows, got "
                         f"{n_drift}")
    check_max_wp(wp)
    _check_aligned(("stream_re", stream_re), ("stream_im", stream_im),
                   ("replicas", replicas))
    telem = torch.empty((t_epochs, c, N_TELEM_DIRECT), dtype=torch.float32,
                        device=state_in.device)
    state_out = torch.empty_like(state_in)
    args = (stream_re.data_ptr(), stream_im.data_ptr(), stream_re.shape[0],
            starts.data_ptr(), replicas.data_ptr(), state_in.data_ptr(),
            telem.data_ptr(), state_out.data_ptr(), c, t_epochs, k_epochs,
            n0, wp, n_drift, fs, code_len, lock_threshold, int(max_lost),
            pll_c1, pll_c2, dll_c1, dll_c2, int(el_shift), aiding_scale,
            if_freq, int(lock_mode == "costas"), costas_thr,
            int(bool(interp)))
    epoch_launch("direct", _direct_lib(), args, state_out, wp, n_drift,
                 int(el_shift))
    launches.record(__name__, "direct_launch_count")
    return telem, state_out
