"""Per-epoch fused tracking on Hopper: the three window feeds of the
Pallas TPU kernel body ``_kernel`` (``gnss_sdr_tpu/ops/pallas/
track_block_fused.py:350`` over ``_epoch_core`` :76) as ONE CUDA epoch
kernel, and the segment gather that feeds one of them.

  * **B4a** ``track_block_fused`` (:499): T epochs from windows pre-sliced
    by ``slice_windows`` (:2211), [T, C, wp] f32;
  * **B4b** ``track_block_fused_seg`` (:579): each epoch's C windows at
    the same 128-aligned lane ``floor(t*n0/128)*128`` of [C, Lseg]
    per-channel segments; the residue rolls the prompt right;
  * **B4c** ``gather_segments`` (:2001): the copy that makes those
    segments, [C, Lseg] of one stream at 128-aligned per-channel starts;
  * **B6** ``track_block_fused_resident`` (:2065): every channel reads one
    shared double-length window of the stream; the per-channel offset
    rides state column 9 and the replicas are pre-anchored
    (``build_replicas_shared``, :2170).

The CUDA sources are ``gnss_sdr_tpu_torch/csrc/track_block_epoch.cu``
(B4a, B4b and B6: one kernel templated on the feed) and
``csrc/gather_segments.cu`` (B4c). The per-epoch arithmetic lives once,
in ``csrc/epoch_core.cuh``, which the direct kernel (B3,
``csrc/track_block_direct.cu``) includes too; its plain PyTorch version
is ``_epoch_core_reference`` here, which B3's plain version also calls.

Contract kept from the TPU kernel, per epoch t (all feeds):
  * exact per-epoch NCOs; the carrier from the outer-product trig factors
    A (per 128-lane group) and B (per lane mod 128), phase referenced to
    the epoch's start lane; the prompt selected from the f32 drift rows
    by drift - floor((chip_res + frac0) / dc), blended with the row below
    by the fractional sample when ``interp``, rolled right by ``rem``;
    early and late its -/+ el_shift rolls (the mask zeroes the wrapped
    lanes); six f32 correlations; power or Costas lock, discriminators,
    loop filters, death after ``max_lost`` unlocked epochs;
  * where epoch t's window starts and its start lane, exactly as
    ``_kernel`` :398-472 sets them:
      - windows: row [t, c, :]; start_lane = drift + el_pad; no roll;
      - seg: seg[c, T128 : T128 + wp], T128 = floor(t*n0/128)*128,
        rem = t*n0 - T128; start_lane = col9 + drift + rem (col 9 holds
        el_pad + rem_c0, the gather start's residue);
      - resident: chunks of k epochs (k the largest divisor of T <=
        ``k_epochs``, the TPU kernel's VMEM chunking kept so the lane
        residues match); chunk i starts at i*k*n0, its epoch t_local at
        the 128-floor of t_local*n0 within it; start_lane = col9 + drift
        + rem (col 9 holds the channel's offset in the shared window);
  * the [C, 128] f32 state (columns 0-11 as ``track_block_fused``'s
    module docstring, the rest zero) and telemetry columns 0-16 as
    [T, C, 17] f32 (the TPU kernel writes 128 lanes, of which the
    receiver reads these 17);
  * x / fs is x * f32(1/fs), and the carrier phase and chip ledger
    advances are fused multiply-adds, as XLA computes ``_epoch_core``.

What bounds it on the H100, and the design. At the seg layout's main
shapes (32 channels, 125 ms blocks at 2.046 MHz, wp = 2432) an epoch of
a channel mixes and correlates ~2046 in-mask lanes at 24 f32 operations
each, and needs those lanes of its window once (8 bytes each; an idle
channel's window and the lanes outside the mask reach no output): per
block, at 24 tracking channels, ~0.15 GFLOP against ~49 MB, so the
bytes bound it (~0.015 ms). The windows layout needs ~196 MB of its
[T, C, wp] windows per 500 ms block (bytes again, ~0.06 ms); the
resident layout reads one stream for all channels.
The kernel shares B3's core (``csrc/epoch_core.cuh``): one thread block
per channel walks its T epochs in order (the TPU's sequential grid
becomes this loop); each epoch's window is staged into shared memory by
TMA two epochs ahead (a window's address depends on t alone, never on
the state), the channel's 5 f32 prompt rows sit in shared memory and
each epoch blends its prompt row once, the 128 + w128 carrier trig
factors are rebuilt per epoch, only the lanes in the epoch's mask are
mixed, the prompt roll and the E/L rolls are indexed reads wrapped
without a modulo, and every warp adds the warp sums and runs the
discriminators and loop filters itself, so an epoch has two block
barriers. The bulk copy needs 16-byte-aligned base pointers (checked;
a fresh tensor is). It uses C of the 132 SMs and a serial chain per
channel, so it sits far above its bound (PERF.md section 6). B4c copies
with 16-byte loads (the starts are 128 samples, 512 bytes, aligned), one
thread block per chunk of a channel's segment, and is bound by its
bytes.

Widths (ROADMAP C6): the JAX ``_epoch_core`` builds its carrier A
factors from a fixed 128-wide iota, so it breaks above wp = 16,384; the
port's plain version builds the whole [C, wp/128] table and the CUDA
core builds its w128 factors in a loop over the threads. Where one
block cannot hold the replica rows and two window slots (from wp 5,888
at 5 rows, e.g. Galileo E1B's seg windows at 8.184 MHz, wp 33,152) one
channel runs over a thread-block cluster of cs blocks, the lane
clusters (``epoch_smem_plan`` lays them out, ``launch_order`` picks
the size the card holds at once): block r keeps lane part r's
replica rows, with the prompt roll's halo, in shared memory for the
whole launch, stages its part of each window by TMA two epochs ahead,
and every block adds the cluster's warp sums in rank order through
DSMEM and runs the chain itself. Only the order of the f32 sums
changes (``lane_parts=`` of the plain versions sums per part, then the
parts in rank order: a per-part order, not the kernel's, which adds
within each warp, then across the ranks for each warp, then over the
warps). The port takes wp <= ``MAX_WP`` = 49,152 and raises above
it, naming C6. Above 16,384 the plain version, not the JAX kernel, is
what the card is held to.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ..correlator import fma as _fma
from . import _build, launches

N_FIELDS = 128
N_TELEM = 17            # telemetry columns (fused_runner.N_TELEM_COLS)
TWO_PI = 6.283185307179586
MAX_WP = 384 * 128      # the widest window (ROADMAP C6; epoch_core.cuh)
SMEM_BLOCK = 232_448    # shared memory one block may have on the H100


def check_max_wp(wp: int) -> None:
    """Raise ValueError naming ROADMAP C6 for wp > MAX_WP."""
    if wp > MAX_WP:
        raise ValueError(
            f"wp={wp} > {MAX_WP}: the per-epoch fused layouts take at most "
            f"{MAX_WP // 128} carrier A factors, where the prompt row and "
            "the trig factors still fit in shared memory (ROADMAP C6; the "
            "JAX _epoch_core's 128-wide iota breaks above 16384)")


# the lane clusters' sizes, largest first (16 only where the card allows
# a non-portable size), for the per-epoch core (epoch_smem_plan) and B1
# and B2 (track_block_fused.mxu_smem_plan) alike: each plan offers those
# that fit, and launch_order puts first the ones whose C clusters the card
# holds at once
LANE_CLUSTERS = (16, 8, 4, 2)
LANE_REACH = 255        # the prompt roll's most lanes (rem < 256)


def lane_parts(wp: int, cs: int) -> list[tuple[int, int]]:
    """The lane parts [(l0, width), ...] of a cluster of ``cs`` blocks:
    whole 128-lane groups covering [0, wp) once, the first
    (wp / 128) % cs parts one group wider (lane_part in
    csrc/epoch_core.cuh and csrc/track_block_mxu.cu)."""
    g = wp // 128
    base, extra = divmod(g, cs)
    parts, l0 = [], 0
    for r in range(cs):
        w = 128 * (base + (r < extra))
        parts.append((l0, w))
        l0 += w
    return parts


def lane_halo(el_shift: int) -> tuple[int, int]:
    """(before, after): the lanes a part's prompt row reaches past the
    part (csrc/epoch_core.cuh set_lane_fields): lane l reads row index
    (l - rem +- el_shift) mod wp with rem < 256, so 255 + el_shift before
    and el_shift after, each rounded up to 4 lanes (16 bytes)."""
    return ((LANE_REACH + el_shift + 3) // 4 * 4, (el_shift + 3) // 4 * 4)


def single_bytes(wp: int, n_drift: int) -> int:
    """One block a channel: the mbarriers, the replica rows, two window
    slots, the prompt row, the trig factors and the warp sums."""
    return 4 * (4 + n_drift * wp + 4 * (wp + 4) + wp + 256
                + 2 * (wp // 128) + 6 * 8)


def epoch_cluster_bytes(wp: int, n_drift: int, cs: int,
                        el_shift: int) -> int:
    """A lane-cluster block's dynamic shared memory (csrc/epoch_core.cuh
    lanes_smem_floats), laid out from the widest part: the mbarriers, the
    part's replica rows [n_drift, lr] (lr: the part and its halo), two
    window slots [2, 2, widest + 4], the prompt row [lr], the cluster's
    warp sums [2, cs, 8, 8], the B and A factors."""
    widest = max(w for _, w in lane_parts(wp, cs))
    lr = sum(lane_halo(el_shift)) + widest
    return 4 * (8 + n_drift * lr + 4 * (widest + 4) + lr + 128 * cs + 256
                + 2 * (widest // 128))


def epoch_smem_plan(wp: int, n_drift: int, smem: int = SMEM_BLOCK, *,
                    el_shift: int = 1) -> dict:
    """The per-epoch core's layout, which the launchers
    (csrc/epoch_core.cuh ``launch`` and ``launch_lanes``) run as given:
    ``"single"``, one block a channel, where the replica rows and two
    window slots fit in a block's shared memory (to wp 5,760 at 5 rows:
    every main-path shape); else ``"cluster"``, one channel over a
    thread-block cluster of cs blocks. ``"options"`` lists the sizes of
    ``LANE_CLUSTERS`` that fit, largest first, each {"cs", "parts" [(l0,
    width), ...] covering [0, wp) once, "halo" (before, after), "bytes"};
    the wrapper launches them in ``launch_order``, by what the card holds
    at once. The plan's own keys are the first option's ("cs" 0 and one
    part for "single"). Raises ValueError naming ROADMAP C6 for wp >
    MAX_WP or where no layout fits."""
    check_max_wp(wp)
    n = single_bytes(wp, n_drift)
    if n <= smem:
        return {"layout": "single", "cs": 0, "parts": [(0, wp)],
                "halo": (0, 0), "bytes": n, "options": []}
    halo = lane_halo(el_shift)
    options = []
    for cs in (cs for cs in LANE_CLUSTERS if cs <= wp // 128):
        parts = lane_parts(wp, cs)
        n = epoch_cluster_bytes(wp, n_drift, cs, el_shift)
        # a part's row must not wrap onto itself
        if n <= smem and sum(halo) + parts[0][1] <= wp:
            options.append({"cs": cs, "parts": parts, "halo": halo,
                            "bytes": n})
    if not options:
        raise ValueError(f"wp={wp}, {n_drift} rows: no per-epoch layout "
                         f"fits in {smem} bytes of shared memory (ROADMAP "
                         "C6)")
    return dict(options[0], layout="cluster", options=options)


_ACTIVE: dict = {}


def epoch_active_clusters(device, kind: str, wp: int, n_drift: int,
                          el_shift: int, cs: int) -> int:
    """How many lane clusters of ``cs`` blocks the card ``device`` holds
    at once for the kernel of ``kind`` (a feed of track_block_epoch.cu or
    "direct") with every block on an SM of its own
    (cudaOccupancyMaxActiveClusters through the launcher's own set-up),
    or the launcher's negative codes where it cannot run; cached per card
    and layout. On the H100 (132 SMs) B1's lane clusters take 7 of 16,
    15 of 8 (PERF.md section 6)."""
    key = (device.index, kind, wp, n_drift, el_shift, cs)
    if key not in _ACTIVE:
        with torch.cuda.device(device):
            if kind == "direct":
                fn = _build.load_library(
                    "track_block_direct").track_block_direct_clusters
                fn.argtypes, fn.restype = [_I] * 4, _I
                n = fn(wp, n_drift, el_shift, cs)
            else:
                fn = _build.load_library(
                    "track_block_epoch").track_block_epoch_clusters
                fn.argtypes, fn.restype = [_I] * 5, _I
                n = fn(FEEDS[kind], wp, n_drift, el_shift, cs)
        _ACTIVE[key] = n
    return _ACTIVE[key]


def launch_order(options: list[dict], c_channels: int,
                 active) -> list[dict]:
    """Lane options in the order a wrapper launches them: those of which
    the card holds ``c_channels`` clusters at once, each block on an SM of
    its own (``active(option)``: the kernel's cached occupancy,
    ``epoch_active_clusters`` or track_block_fused.lane_active_clusters),
    first (the rest would share SMs or run in waves, each wave as long as
    the whole launch), each group in the given order."""
    return sorted(options, key=lambda o: active(o) < c_channels)


# every rank's final state of each lane-cluster launch, while
# rank_states() is open: [(rank states [C, cs, 12], state [C, 128]), ...]
_RANK_STATES: list | None = None


@contextlib.contextmanager
def rank_states():
    """While open, each lane-cluster launch of the per-epoch kernels also
    writes every rank's final state (each block runs the chain on the
    same sums, so each holds the same state): yields the list of (rank
    states [C, cs, 12], the launch's state [C, 128]) it collects."""
    global _RANK_STATES
    saved, _RANK_STATES = _RANK_STATES, []
    try:
        yield _RANK_STATES
    finally:
        _RANK_STATES = saved


# launches of each CUDA kernel (plain ints, counted by launches.record;
# the plain versions never count): B4a (windows), B4b (seg), B4c (gather) and B6 (resident)
windows_launch_count = 0
seg_launch_count = 0
gather_launch_count = 0
resident_launch_count = 0


def reset_launch_count() -> None:
    global windows_launch_count, seg_launch_count, gather_launch_count, \
        resident_launch_count
    windows_launch_count = seg_launch_count = 0
    gather_launch_count = resident_launch_count = 0


# ---------------------------------------------------------------------------
# geometry glue (counterparts of track_block_fused.py:657, 2112-2116,
# 2170-2244)
# ---------------------------------------------------------------------------

def seg_length(t_epochs: int, n0: int, wp: int) -> int:
    """Lseg for track_block_fused_seg: last window end, 128-padded."""
    last = ((t_epochs - 1) * n0 // 128) * 128 + wp
    return ((last + 127) // 128) * 128


def resident_chunk(t_epochs: int, k_epochs: int) -> int:
    """Epochs per chunk of the resident layout: the largest divisor of
    t_epochs that is <= k_epochs."""
    k = min(k_epochs, t_epochs)
    while t_epochs % k:
        k -= 1
    return k


def _seg_start(t: int, n0: int) -> tuple[int, int]:
    """(128-aligned window start, residue) of seg epoch t."""
    a = (t * n0 // 128) * 128
    return a, t * n0 - a


def _resident_start(t: int, k: int, n0: int) -> tuple[int, int]:
    """(window start in the stream, residue) of resident epoch t."""
    a, rem = _seg_start(t % k, n0)
    return (t // k) * k * n0 + a, rem


def _host_ints(x, name: str) -> np.ndarray:
    """A host int64 copy of ``x`` (array-like or CPU tensor) for a bound
    check; a CUDA tensor raises, since reading it would wait for the
    card."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name} on the card needs its host copy for "
                             "the read-bound check")
        x = x.numpy()
    return np.asarray(x, dtype=np.int64)


def slice_windows(block_re, block_im, offsets, t_epochs: int, n0: int,
                  wp: int, el_pad: int = 0):
    """[T, C, WP] windows at nominal epoch spacing from each channel's
    offset, prerolled by ``el_pad``: window [t, c, l] is block
    sample offsets[c] - el_pad + t*n0 + l. ``offsets`` are host values
    (array-like or a CPU tensor). One unfold per channel and one stack.

    Requires ``min(offsets) >= el_pad`` and
    ``max(offsets) + (t_epochs + 1) * n0 <= len(block)`` (checked: the
    JAX glue's dynamic_slice would clamp silently)."""
    extra = wp - n0
    if extra > n0:
        raise ValueError(f"wp={wp} > 2*n0={2 * n0} unsupported")
    off = _host_ints(offsets, "offsets")
    need = (t_epochs + 1) * n0
    if off.size and (off.min() < el_pad
                     or off.max() + need > block_re.shape[0]):
        raise ValueError(
            f"window read out of bounds: offsets in [{off.min()}, "
            f"{off.max()}] need >= el_pad={el_pad} and offset + "
            f"{need} <= len(block)={block_re.shape[0]}")

    def windows(block):
        return torch.stack([
            block[s - el_pad:s - el_pad + need].unfold(0, wp, n0)[:t_epochs]
            for s in off.tolist()], dim=1).contiguous()

    return windows(block_re), windows(block_im)


def build_replicas_shared(codes4x: torch.Tensor, chip_phase,
                          chips_per_sample, offsets, el_shift: int, n0: int,
                          wp: int, n_drift: int = 5) -> torch.Tensor:
    """[C, n_drift, WP] f32 PROMPT replica rows for the resident layout,
    as one exact index gather: each channel's replica is pre-shifted so
    that window lane ``offsets[c]`` (the channel's epoch start in the
    shared window) lines up with its code phase. Row d, lane l holds
    ``code[s_i - off + 2*n0 - (d - half) + l]`` with
    s_i = floor(chip_phase / chips_per_sample) wrapped into [0, n0).

    ``codes4x``: [C, >= 3*n0 + wp + 2*(el_shift + half)] sampled
    nominal-rate code (tiled); ``chip_phase``, ``chips_per_sample``: [C]
    f32; ``offsets``: [C] ints in [0, n0). A short table or an offset
    out of range raises (the JAX gather would clamp silently)."""
    half = (n_drift - 1) // 2
    margin = half + el_shift
    need = 3 * n0 + wp + 2 * margin
    if codes4x.shape[-1] < need:
        raise ValueError(
            f"codes4x rows too short for build_replicas_shared: have "
            f"{codes4x.shape[-1]}, need >= {need} "
            "(= 3*n0 + wp + 2*(el_shift + half))")
    dev = codes4x.device
    c = codes4x.shape[0]

    def as_dev(x, dt):
        if isinstance(x, torch.Tensor):
            return x.to(device=dev, dtype=dt)
        return torch.from_numpy(np.asarray(x)).to(device=dev, dtype=dt)

    if not isinstance(offsets, torch.Tensor) or offsets.device.type == "cpu":
        off_h = _host_ints(offsets, "offsets")
        if off_h.size and (off_h.min() < 0 or off_h.max() >= n0):
            raise ValueError(f"offsets must lie in [0, n0={n0}), got "
                             f"[{off_h.min()}, {off_h.max()}]")
    off = as_dev(offsets, torch.int64)
    # FLOOR of the f32 quotient, as the JAX glue computes it
    s_i = torch.floor(as_dev(chip_phase, torch.float32)
                      / as_dev(chips_per_sample, torch.float32)
                      ).to(torch.int64)
    s_i = torch.where(s_i >= n0, s_i - n0, s_i)
    s_i = torch.where(s_i < 0, s_i + n0, s_i)
    if s_i.shape != (c,) or off.shape != (c,):
        raise ValueError("chip_phase / chips_per_sample / offsets must be [C]")
    base = s_i - off + 2 * n0 + half
    rows = torch.arange(n_drift, device=dev, dtype=torch.int64)
    lanes = torch.arange(wp, device=dev, dtype=torch.int64)
    idx = base[:, None, None] - rows[None, :, None] + lanes[None, None, :]
    return torch.gather(
        codes4x.to(torch.float32), 1, idx.reshape(c, -1)
    ).reshape(c, n_drift, wp)


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------

def _atan_poly(x: torch.Tensor) -> torch.Tensor:
    """Branchless arctan (Abramowitz-Stegun 4.4.49, max error ~1e-5
    rad) — the TPU kernel's PLL discriminator, kept as is."""
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    ax = torch.abs(x)
    inv = ax > 1.0
    z = torch.where(inv, 1.0 / torch.maximum(ax, f(1e-20)), ax)
    t = z * z
    p = z * (f(0.9998660) + t * (f(-0.3302995) + t * (f(0.1801410)
             + t * (f(-0.0851330) + f(0.0208351) * t))))
    r = torch.where(inv, f(np.pi / 2) - p, p)
    return torch.where(x < 0.0, -r, r)


def _epoch_core_reference(st, wre, wim, reps, start_lane, rem_i, *, wp, n0,
                          fs, code_len, lock_threshold, max_lost, pll_c1,
                          pll_c2, dll_c1, dll_c2, el_shift, aiding_scale,
                          if_freq, lock_mode, costas_thr, interp,
                          lane_parts=None):
    """ONE tracking epoch for all channels (``_epoch_core``): ``wre`` /
    ``wim`` the epoch's [C, wp] or shared [1, wp] window, ``start_lane``
    [C, 1] f32 the epoch's first lane in it, ``rem_i`` the lanes the
    prompt rolls right. ``lane_parts`` [(l0, width), ...]: each
    correlation summed per lane part, then the parts added in rank order
    (a per-part order, not the lane clusters' own). Returns (new state
    [C, 128], telemetry row [C, 17])."""
    dev = st.device
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
    c_channels = st.shape[0]
    n_drift = reps.shape[1]
    half = (n_drift - 1) // 2

    def col(k):
        return st[:, k:k + 1]                                   # [C, 1]

    carr_freq, carr_phase, carr_err = col(0), col(1), col(2)
    code_rate, chip_res, code_err = col(3), col(4), col(5)
    lost, active, drift = col(6), col(7), col(8)
    woff, frac0, lock_ema = col(9), col(10), col(11)

    fs_f = f(fs)
    inv_fs = f(1.0) / fs_f
    if aiding_scale != 0.0:
        code_rate_eff = code_rate + (carr_freq - f(if_freq)) * f(aiding_scale)
    else:
        code_rate_eff = code_rate
    dc = code_rate_eff * inv_fs
    n_t_f = torch.round(fs_f * f(code_len) / code_rate_eff)

    lane = torch.arange(wp, device=dev, dtype=torch.float32)[None, :]
    mask = ((lane >= start_lane) & (lane < start_lane + n_t_f)).to(
        torch.float32)

    # carrier wipe-off from the outer-product trig factors
    step = carr_freq * inv_fs
    phi0 = carr_phase - start_lane * step
    w128 = wp // 128
    q_w = torch.arange(w128, device=dev, dtype=torch.float32)[None, :]
    q128 = torch.arange(128, device=dev, dtype=torch.float32)[None, :]
    th_a = phi0 + (step * f(128.0)) * q_w
    th_a = (th_a - torch.floor(th_a)) * f(TWO_PI)
    th_b = step * q128
    th_b = (th_b - torch.floor(th_b)) * f(TWO_PI)
    a_c, a_s = torch.cos(th_a), torch.sin(th_a)                 # [C, w128]
    b_c, b_s = torch.cos(th_b), torch.sin(th_b)                 # [C, 128]
    ra_c = a_c.repeat_interleave(128, dim=1)                    # lane // 128
    ra_s = a_s.repeat_interleave(128, dim=1)
    tb_c, tb_s = b_c.repeat(1, w128), b_s.repeat(1, w128)       # lane % 128
    cth = ra_c * tb_c - ra_s * tb_s
    sth = ra_s * tb_c + ra_c * tb_s
    re_w = (wre * cth + wim * sth) * mask
    im_w = (wim * cth - wre * sth) * mask

    # prompt select: at most two rows carry weight, so the weighted sum
    # over rows rounds once whatever its order
    q = (chip_res + frac0) / dc
    q_floor = torch.floor(q)
    shift = drift - q_floor
    d_f = torch.arange(n_drift, device=dev,
                       dtype=torch.float32)[None, :] - f(half)   # [1, R]
    sel_d = (shift == d_f).to(torch.float32)                    # [C, R]
    if interp:
        f_sub = q - q_floor
        sel_m = (shift == d_f + 1.0).to(torch.float32)
        w = (1.0 - f_sub) * sel_d + f_sub * sel_m
    else:
        w = sel_d
    prompt = torch.sum(w[:, :, None] * reps, dim=1)             # [C, wp]
    prompt = torch.roll(prompt, rem_i, dims=1)
    early = torch.roll(prompt, -el_shift, dims=1)   # early[l] = p[l+el]
    late = torch.roll(prompt, el_shift, dims=1)     # late[l]  = p[l-el]

    def corr(x, y):
        xy = x * y
        if lane_parts is None:
            return torch.sum(xy, dim=1, keepdim=True)
        sums = [torch.sum(xy[:, l0:l0 + w], dim=1, keepdim=True)
                for l0, w in lane_parts]
        out = sums[0]
        for v in sums[1:]:
            out = out + v
        return out

    i_e, q_e = corr(re_w, early), corr(im_w, early)
    i_p, q_p = corr(re_w, prompt), corr(im_w, prompt)
    i_l, q_l = corr(re_w, late), corr(im_w, late)

    power = i_p * i_p + q_p * q_p
    if lock_mode == "costas":
        metric = (i_p * i_p - q_p * q_p) / torch.maximum(power, f(1e-12))
        alpha = f(0.1)
        new_lock_ema = torch.where(
            active > 0.5, (1.0 - alpha) * lock_ema + alpha * metric,
            lock_ema)
        locked = new_lock_ema > f(costas_thr)
    else:
        new_lock_ema = lock_ema
        locked = power > f(lock_threshold)
    safe_ip = torch.where(torch.abs(i_p) < 1e-12, f(1e-12), i_p)
    pll_err = _atan_poly(q_p / safe_ip) * f(1.0 / TWO_PI)
    carr_nco = pll_err * f(pll_c1) + (pll_err - carr_err) * f(pll_c2)
    pow_e = torch.sqrt(i_e * i_e + q_e * q_e)
    pow_l = torch.sqrt(i_l * i_l + q_l * q_l)
    el_sum = pow_e + pow_l
    dll_err = torch.where(
        el_sum > 0.0, (pow_e - pow_l) / torch.maximum(el_sum, f(1e-12)),
        f(0.0))
    code_nco = dll_err * f(dll_c1) + (dll_err - code_err) * f(dll_c2)

    act = active > 0.5
    upd = act & locked
    new_carr_freq = torch.where(upd, carr_freq + carr_nco, carr_freq)
    new_carr_err = torch.where(upd, pll_err, carr_err)
    new_code_rate = torch.where(upd, code_rate + code_nco, code_rate)
    new_code_err = torch.where(upd, dll_err, code_err)
    zero = torch.zeros_like(lost)
    new_lost = torch.where(act, torch.where(locked, zero, lost + 1.0), lost)
    died = new_lost >= f(max_lost)
    new_active = torch.where(died, zero, active)
    ncp = _fma(step, n_t_f, carr_phase)
    new_carr_phase = ncp - torch.floor(ncp)
    new_chip_res = _fma(dc, n_t_f, chip_res) - f(code_len)
    new_drift = drift + n_t_f - f(n0)

    def sel(new, old):
        return torch.where(act, new, old)

    new = torch.zeros_like(st)
    for k, v in ((0, sel(new_carr_freq, carr_freq)),
                 (1, sel(new_carr_phase, carr_phase)),
                 (2, sel(new_carr_err, carr_err)),
                 (3, sel(new_code_rate, code_rate)),
                 (4, sel(new_chip_res, chip_res)),
                 (5, sel(new_code_err, code_err)), (6, sel(new_lost, lost)),
                 (7, new_active), (8, sel(new_drift, drift)), (9, woff),
                 (10, frac0), (11, torch.where(died, zero, new_lock_ema))):
        new[:, k] = v.reshape(c_channels)
    wr = act.to(torch.float32)
    row = torch.cat([
        i_e * wr, q_e * wr, i_p * wr, q_p * wr, i_l * wr, q_l * wr,
        power * wr, upd.to(torch.float32), pll_err * wr, dll_err * wr,
        sel(new_carr_freq, carr_freq), sel(new_code_rate, code_rate),
        n_t_f, drift, chip_res * wr, (died & act).to(torch.float32), wr,
    ], dim=1)                                                   # [C, 17]
    return new, row


def _core_kw(kw: dict) -> dict:
    """The statics _epoch_core_reference takes, from a wrapper's kw."""
    names = ("wp", "n0", "fs", "code_len", "lock_threshold", "max_lost",
             "pll_c1", "pll_c2", "dll_c1", "dll_c2", "el_shift",
             "aiding_scale", "if_freq", "lock_mode", "costas_thr", "interp",
             "lane_parts")
    return {k: kw[k] for k in names}


def _check_tensors(names, win_re, win_im, replicas, state_in, wp,
                   lock_mode):
    """Types (f32), devices and contiguity of one launch's tensors (the
    window feed's two named ``names``), the [C, 128] state, the
    [C, R, wp] replicas and the wp limit of ROADMAP C6."""
    if wp % 128:
        raise ValueError(f"the fused kernels require wp % 128 == 0, got {wp}")
    check_max_wp(wp)
    if lock_mode not in ("power", "costas"):
        raise ValueError(f"unknown lock_mode {lock_mode!r}")
    dev = state_in.device
    for name, t in zip(names + ("replicas", "state_in"),
                       (win_re, win_im, replicas, state_in)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, state_in on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    c = state_in.shape[0]
    if state_in.shape != (c, N_FIELDS):
        raise ValueError(f"state_in must be [C, {N_FIELDS}], "
                         f"got {tuple(state_in.shape)}")
    if replicas.ndim != 3 or replicas.shape[0] != c or \
            replicas.shape[2] != wp:
        raise ValueError(f"replicas must be [C, R, wp={wp}], "
                         f"got {tuple(replicas.shape)}")


def _check_windows(windows_re, windows_im, replicas, state_in, lock_mode):
    if windows_re.ndim != 3 or windows_im.shape != windows_re.shape:
        raise ValueError("windows_re / windows_im must be matching [T, C, wp]")
    t, c, wp = windows_re.shape
    _check_tensors(("windows_re", "windows_im"), windows_re, windows_im, replicas,
                   state_in, wp, lock_mode)
    if c != state_in.shape[0]:
        raise ValueError(f"windows hold {c} channels, state_in "
                         f"{state_in.shape[0]}")


def _check_seg(seg_re, seg_im, replicas, state_in, *, t_epochs, n0, wp,
               lock_mode, first_epoch=0):
    _check_tensors(("seg_re", "seg_im"), seg_re, seg_im, replicas,
                   state_in, wp, lock_mode)
    c = state_in.shape[0]
    if seg_re.ndim != 2 or seg_re.shape[0] != c or \
            seg_im.shape != seg_re.shape:
        raise ValueError(f"seg_re / seg_im must be matching [C={c}, Lseg]")
    # read bound: the last epoch's window must lie inside the segment
    need = _seg_start(first_epoch + t_epochs - 1, n0)[0] + wp
    if need > seg_re.shape[1]:
        raise ValueError(
            f"window read out of bounds: the last epoch reads to {need} > "
            f"Lseg={seg_re.shape[1]} (seg_length gives "
            f"{seg_length(first_epoch + t_epochs, n0, wp)})")


def _check_resident(block_re, block_im, replicas, state_in, *, t_epochs,
                    n0, wp, lock_mode, first_epoch=0):
    _check_tensors(("block_re", "block_im"), block_re, block_im, replicas,
                   state_in, wp, lock_mode)
    if block_re.ndim != 1 or block_im.shape != block_re.shape:
        raise ValueError("block_re / block_im must be matching [L]")
    need = (first_epoch + t_epochs) * n0 + wp
    if need > block_re.shape[0]:
        raise ValueError(
            f"window read out of bounds: the resident layout needs "
            f"len(stream) >= T*n0 + wp = {need}, got {block_re.shape[0]}")


def track_block_fused_reference(
    windows_re, windows_im, replicas, state_in, *, n0, fs, code_len=1023.0,
    lock_threshold=15.0, max_lost=20, pll_c1=0.0, pll_c2=0.0, dll_c1=0.0,
    dll_c2=0.0, el_shift=1, aiding_scale=0.0, if_freq=0.0,
    lock_mode="power", costas_thr=0.4, interp=False, lane_parts=None,
):
    """The plain PyTorch version of B4a on any device, one Python
    iteration per epoch (``lane_parts`` as _epoch_core_reference). Returns
    (telemetry [T, C, 17], state [C, 128])."""
    _check_windows(windows_re, windows_im, replicas, state_in, lock_mode)
    t_epochs, _, wp = windows_re.shape
    kw = _core_kw(dict(locals(), wp=wp))
    el_pad = el_shift + (replicas.shape[1] - 1) // 2
    st, rows = state_in, []
    for t in range(t_epochs):
        start_lane = st[:, 8:9] + float(el_pad)
        st, row = _epoch_core_reference(st, windows_re[t], windows_im[t],
                                        replicas, start_lane, 0, **kw)
        rows.append(row)
    return torch.stack(rows, dim=0), st


def track_block_fused_seg_reference(
    seg_re, seg_im, replicas, state_in, *, t_epochs, n0, wp, fs,
    code_len=1023.0, lock_threshold=15.0, max_lost=20, pll_c1=0.0,
    pll_c2=0.0, dll_c1=0.0, dll_c2=0.0, el_shift=1, aiding_scale=0.0,
    if_freq=0.0, lock_mode="power", costas_thr=0.4, interp=False,
    first_epoch=0, lane_parts=None,
):
    """The plain PyTorch version of B4b on any device. ``first_epoch`` >
    0 runs epochs ``first_epoch ..`` of a longer block from
    ``state_in`` (their windows in the segment), so a check can hold the
    kernel's block to this version piece by piece, each piece started
    from the kernel's own state; ``lane_parts`` as _epoch_core_reference.
    Returns (telemetry [T, C, 17], state)."""
    _check_seg(seg_re, seg_im, replicas, state_in, t_epochs=t_epochs, n0=n0,
               wp=wp, lock_mode=lock_mode, first_epoch=first_epoch)
    kw = _core_kw(locals())
    st, rows = state_in, []
    for t in range(first_epoch, first_epoch + t_epochs):
        a, rem = _seg_start(t, n0)
        start_lane = (st[:, 9:10] + st[:, 8:9]) + float(rem)
        st, row = _epoch_core_reference(st, seg_re[:, a:a + wp],
                                        seg_im[:, a:a + wp], replicas,
                                        start_lane, rem, **kw)
        rows.append(row)
    return torch.stack(rows, dim=0), st


def track_block_fused_resident_reference(
    block_re, block_im, replicas, state_in, *, t_epochs, k_epochs=128, n0,
    wp, fs, code_len=1023.0, lock_threshold=15.0, max_lost=20, pll_c1=0.0,
    pll_c2=0.0, dll_c1=0.0, dll_c2=0.0, el_shift=1, aiding_scale=0.0,
    if_freq=0.0, lock_mode="power", costas_thr=0.4, interp=False,
    first_epoch=0, lane_parts=None,
):
    """The plain PyTorch version of B6 on any device. ``first_epoch`` and
    ``lane_parts`` as in track_block_fused_seg_reference; the chunk comes from
    ``resident_chunk(t_epochs, k_epochs)``, so a piece of a longer block
    passes that block's chunk as ``k_epochs`` and a multiple of it as
    ``t_epochs``. Returns (telemetry [T, C, 17], state)."""
    _check_resident(block_re, block_im, replicas, state_in,
                    t_epochs=t_epochs, n0=n0, wp=wp, lock_mode=lock_mode,
                    first_epoch=first_epoch)
    k = resident_chunk(t_epochs, k_epochs)
    kw = _core_kw(locals())
    st, rows = state_in, []
    for t in range(first_epoch, first_epoch + t_epochs):
        a, rem = _resident_start(t, k, n0)
        start_lane = (st[:, 9:10] + st[:, 8:9]) + float(rem)
        st, row = _epoch_core_reference(st, block_re[None, a:a + wp],
                                        block_im[None, a:a + wp], replicas,
                                        start_lane, rem, **kw)
        rows.append(row)
    return torch.stack(rows, dim=0), st


def _check_gather(block_re, block_im, starts, l_seg, starts_host):
    for name, t, dt in (("block_re", block_re, torch.float32),
                        ("block_im", block_im, torch.float32),
                        ("starts", starts, torch.int32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != block_re.device:
            raise ValueError(f"{name} is on {t.device}, block_re on "
                             f"{block_re.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_re.ndim != 1 or block_im.shape != block_re.shape:
        raise ValueError("block_re / block_im must be matching [L]")
    if starts.ndim != 1:
        raise ValueError("starts must be [C]")
    if l_seg < 1 or l_seg % 128:
        raise ValueError(f"l_seg must be a positive multiple of 128, "
                         f"got {l_seg}")
    # the bound the JAX kernel leaves to its caller (:2009-2010), checked
    # on the host from the starts' host copy
    host = _host_ints(starts if starts_host is None else starts_host,
                      "starts")
    if host.shape != tuple(starts.shape):
        raise ValueError(f"starts_host must be [C={starts.shape[0]}]")
    if host.size and (host.min() < 0 or (host % 128).any()
                      or host.max() + l_seg > block_re.shape[0]):
        raise ValueError(
            f"segment read out of bounds or unaligned: starts in "
            f"[{host.min()}, {host.max()}] must be >= 0, multiples of 128 "
            f"and start + l_seg={l_seg} <= len(block)={block_re.shape[0]}")


def gather_segments_reference(block_re, block_im, starts, l_seg: int, *,
                              starts_host=None):
    """The plain PyTorch version of B4c on any device: ([C, Lseg],
    [C, Lseg]) with row c = block[starts[c] : starts[c] + Lseg]."""
    _check_gather(block_re, block_im, starts, l_seg, starts_host)
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        l_seg, device=starts.device, dtype=torch.int64)[None, :]
    return block_re[idx], block_im[idx]


# ---------------------------------------------------------------------------
# the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
FEEDS = {"windows": 0, "seg": 1, "resident": 2}


# the launch entry's arguments: the feed, the window feed's, the kernel's
# (as epoch::make_params takes them), the stream, the cluster size (0: one
# block a channel) and every rank's state (or null)
EPOCH_ARGTYPES = [_I, _VP, _VP, ctypes.c_longlong, _I, _VP, _VP, _VP, _VP,
                  _I, _I, _I, _I, _I,
                  _F, _F, _F, _I, _F, _F, _F, _F, _I,
                  _F, _F, _I, _F, _I, _VP, _I, _VP]


def _epoch_lib():
    fn = _build.load_library("track_block_epoch").track_block_epoch_launch
    fn.argtypes, fn.restype = EPOCH_ARGTYPES, _I
    return fn


def _gather_lib():
    fn = _build.load_library("gather_segments").gather_segments_launch
    fn.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _VP]
    fn.restype = _I
    return fn


def _check_aligned(*named):
    """Each (name, tensor) starts 16-byte aligned, as the CUDA tracking
    kernels need: they read the replica rows in 16-byte pieces and copy
    every window by a bulk copy (TMA) from its 4-sample floor, which takes
    16-byte-aligned addresses (a fresh tensor is; a view at an offset
    that is not a multiple of 4 samples is not)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned (the "
                             "kernel reads it in 16-byte pieces)")


def epoch_launch(kind, fn, args, state_out, wp, n_drift, el_shift):
    """Call the launch entry ``fn`` of the kernel of ``kind`` with
    ``args`` (its arguments up to the stream; the launch writes
    ``state_out``, [C, 128]) in the layout of the wrapper's plan
    (epoch_smem_plan): one block a channel, or the first lane-cluster
    size in launch_order; while rank_states() is open every rank's
    final state is collected too. Raises on a refused launch, naming C6;
    a cluster that cannot launch is not replaced by another size, one
    block or the plain version."""
    c, device = state_out.shape[0], state_out.device
    plan = epoch_smem_plan(wp, n_drift, el_shift=el_shift)
    cs = 0
    if plan["layout"] == "cluster":
        cs = launch_order(plan["options"], c, lambda o: epoch_active_clusters(
            device, kind, wp, n_drift, el_shift, o["cs"]))[0]["cs"]
    ranks = None
    if cs and _RANK_STATES is not None:
        ranks = torch.full((c, cs, 12), float("nan"), device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream, cs,
                 ranks.data_ptr() if ranks is not None else None)
    name = {"direct": "track_block_direct"}.get(
        kind, f"track_block_epoch ({kind})")
    if err == -1:
        raise RuntimeError(f"{name}: no cluster of {cs} blocks can run on "
                           "the card (cudaOccupancyMaxActiveClusters = 0 "
                           "or above the sizes it allows; ROADMAP C6)")
    if err == -2:
        raise RuntimeError(f"{name}: the launch needs more shared memory "
                           f"than a block can have (wp {wp}, {n_drift} "
                           f"rows; the plan was {plan['layout']}, cs "
                           f"{cs}, {plan['bytes']} bytes; ROADMAP C6)")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    if ranks is not None:
        _RANK_STATES.append((ranks, state_out))


def _launch_epoch(feed, win_re, win_im, row, k_chunk, replicas, state_in, *,
                  t_epochs, n0, wp, fs, code_len, lock_threshold, max_lost,
                  pll_c1, pll_c2, dll_c1, dll_c2, el_shift, aiding_scale,
                  if_freq, lock_mode, costas_thr, interp):
    """One launch of the epoch kernel on ``feed``; returns (telemetry,
    state) or raises on a refused launch."""
    c, n_drift = replicas.shape[0], replicas.shape[1]
    if n_drift > 8:
        raise ValueError(f"the CUDA kernel takes <= 8 replica rows, got "
                         f"{n_drift}")
    _check_aligned(("window re", win_re), ("window im", win_im),
                   ("replicas", replicas))
    telem = torch.empty((t_epochs, c, N_TELEM), dtype=torch.float32,
                        device=state_in.device)
    state_out = torch.empty_like(state_in)
    args = (FEEDS[feed], win_re.data_ptr(), win_im.data_ptr(), row,
            k_chunk, replicas.data_ptr(), state_in.data_ptr(),
            telem.data_ptr(), state_out.data_ptr(), c, t_epochs, n0, wp,
            n_drift, fs, code_len, lock_threshold, int(max_lost), pll_c1,
            pll_c2, dll_c1, dll_c2, int(el_shift), aiding_scale, if_freq,
            int(lock_mode == "costas"), costas_thr, int(bool(interp)))
    epoch_launch(feed, _epoch_lib(), args, state_out, wp, n_drift,
                 int(el_shift))
    return telem, state_out


def _on_card(state_in) -> bool:
    if state_in.device.type == "cpu":
        return False
    if state_in.device.type != "cuda":
        raise ValueError(f"unsupported device {state_in.device}")
    return True


def track_block_fused(
    windows_re: torch.Tensor,  # [T, C, WP] f32 (slice_windows)
    windows_im: torch.Tensor,  # [T, C, WP] f32
    replicas: torch.Tensor,    # [C, N_DRIFT, WP] f32 (build_replicas)
    state_in: torch.Tensor,    # [C, 128] f32
    *,
    n0: int,
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
):
    """B4a, windows fused tracking: T epochs, ONE kernel launch. Returns
    (telemetry [T, C, 17] f32, state [C, 128] f32). CPU tensors run the
    plain version; CUDA tensors launch the CUDA kernel or raise (failed
    build, refused launch, bad argument: a window tensor that does not
    start 16-byte aligned among them), with no fallback."""
    kw = dict(n0=n0, fs=fs, code_len=code_len, lock_threshold=lock_threshold,
              max_lost=max_lost, pll_c1=pll_c1, pll_c2=pll_c2, dll_c1=dll_c1,
              dll_c2=dll_c2, el_shift=el_shift, aiding_scale=aiding_scale,
              if_freq=if_freq, lock_mode=lock_mode, costas_thr=costas_thr,
              interp=interp)
    if not _on_card(state_in):
        return track_block_fused_reference(windows_re, windows_im, replicas,
                                           state_in, **kw)
    _check_windows(windows_re, windows_im, replicas, state_in, lock_mode)
    t_epochs, _, wp = windows_re.shape
    out = _launch_epoch("windows", windows_re, windows_im, 0, 1, replicas,
                        state_in, t_epochs=t_epochs, wp=wp, **kw)
    launches.record(__name__, "windows_launch_count")
    return out


def track_block_fused_seg(
    seg_re: torch.Tensor,      # [C, Lseg] f32 from gather_segments
    seg_im: torch.Tensor,      # [C, Lseg] f32
    replicas: torch.Tensor,    # [C, N_DRIFT, WP] f32 (build_replicas with
    state_in: torch.Tensor,    # lane_shift); [C, 128] f32, col 9 =
    *,                         # el_pad + rem_c0
    t_epochs: int,
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
):
    """B4b, seg fused tracking: T epochs, ONE kernel launch, each epoch's
    windows read from the per-channel segments at one aligned lane.
    Requires Lseg >= seg_length(T, n0, wp) (checked). Returns (telemetry
    [T, C, 17], state [C, 128]); devices as track_block_fused."""
    kw = dict(t_epochs=t_epochs, n0=n0, wp=wp, fs=fs, code_len=code_len,
              lock_threshold=lock_threshold, max_lost=max_lost,
              pll_c1=pll_c1, pll_c2=pll_c2, dll_c1=dll_c1, dll_c2=dll_c2,
              el_shift=el_shift, aiding_scale=aiding_scale, if_freq=if_freq,
              lock_mode=lock_mode, costas_thr=costas_thr, interp=interp)
    if not _on_card(state_in):
        return track_block_fused_seg_reference(seg_re, seg_im, replicas,
                                               state_in, **kw)
    _check_seg(seg_re, seg_im, replicas, state_in, t_epochs=t_epochs, n0=n0,
               wp=wp, lock_mode=lock_mode)
    out = _launch_epoch("seg", seg_re, seg_im, seg_re.shape[1], 1, replicas,
                        state_in, **kw)
    launches.record(__name__, "seg_launch_count")
    return out


def track_block_fused_resident(
    block_re: torch.Tensor,    # [L] f32, ONE shared stream for all channels
    block_im: torch.Tensor,    # [L]; L >= t_epochs * n0 + wp
    replicas: torch.Tensor,    # [C, N_DRIFT, WP] (build_replicas_shared)
    state_in: torch.Tensor,    # [C, 128] f32; col 9 = channel offset
    *,
    t_epochs: int,
    k_epochs: int = 128,
    n0: int,
    wp: int,                   # >= 2*n0 + margin (+128 if n0 % 128)
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
):
    """B6, shared-stream fused tracking: ONE copy of the stream serves
    every channel, ONE launch for the block (the TPU kernel's chunks of
    ``k_epochs`` were a VMEM limit; their lane residues are kept).
    Requires len(stream) >= T*n0 + wp (checked). Returns (telemetry
    [T, C, 17], state [C, 128]); devices as track_block_fused."""
    kw = dict(t_epochs=t_epochs, n0=n0, wp=wp, fs=fs, code_len=code_len,
              lock_threshold=lock_threshold, max_lost=max_lost,
              pll_c1=pll_c1, pll_c2=pll_c2, dll_c1=dll_c1, dll_c2=dll_c2,
              el_shift=el_shift, aiding_scale=aiding_scale, if_freq=if_freq,
              lock_mode=lock_mode, costas_thr=costas_thr, interp=interp)
    if not _on_card(state_in):
        return track_block_fused_resident_reference(
            block_re, block_im, replicas, state_in, k_epochs=k_epochs, **kw)
    _check_resident(block_re, block_im, replicas, state_in,
                    t_epochs=t_epochs, n0=n0, wp=wp, lock_mode=lock_mode)
    out = _launch_epoch("resident", block_re, block_im, 0,
                        resident_chunk(t_epochs, k_epochs), replicas,
                        state_in, **kw)
    launches.record(__name__, "resident_launch_count")
    return out


def gather_segments(block_re: torch.Tensor, block_im: torch.Tensor,
                    starts: torch.Tensor, l_seg: int, *, starts_host=None):
    """B4c: ([C, Lseg], [C, Lseg]) copies of one stream at per-channel
    128-aligned ``starts`` ([C] int32), one launch. The read bound
    (starts >= 0, multiples of 128, start + Lseg <= len(block)) is
    checked on the host, from ``starts_host`` (the values ``starts`` was
    uploaded from) when ``starts`` lies on the card. Devices as
    track_block_fused."""
    if not _on_card(block_re):
        return gather_segments_reference(block_re, block_im, starts, l_seg,
                                         starts_host=starts_host)
    _check_gather(block_re, block_im, starts, l_seg, starts_host)
    c = starts.shape[0]
    out_re = torch.empty((c, l_seg), dtype=torch.float32,
                         device=block_re.device)
    out_im = torch.empty_like(out_re)
    fn = _gather_lib()
    with torch.cuda.device(block_re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(block_re.data_ptr(), block_im.data_ptr(), starts.data_ptr(),
                 out_re.data_ptr(), out_im.data_ptr(), c, l_seg, stream)
    if err != 0:
        raise RuntimeError(f"gather_segments launch failed: CUDA error {err}")
    launches.record(__name__, "gather_launch_count")
    return out_re, out_im
