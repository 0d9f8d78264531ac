"""Multi-channel DLL/PLL tracking (counterpart of
``gnss_sdr_tpu/receiver/tracking.py``).

Channel state is a structure of arrays ``ChannelState`` [C] with an
exact bookkeeping ledger: uint32 carrier and fractional-chip
accumulators, an int32 integer chip index and block-relative int32
sample offsets. Between blocks the ledger lives on the host as numpy
arrays: the fused path re-anchors it every block
(receiver/fused_runner.py), and the scanned path below uploads it once
per block.

The scanned path (``track_block``): ``n_epochs`` epochs of
``epoch_step`` over one resident sample block, sequential in time,
batched over channels, as torch ops on the block's device. Each epoch
correlates the channels' windows (``params.correlator``: "shift",
"exact", "slice"/"fused" as torch ops on gathered windows, "pallas"
through the CUDA kernel B5, which reads the windows from the block),
runs the discriminators, lock detector and loop filters, and advances
the exact ledger; lock and loss transitions are masked selects. Nothing
in the epoch loop waits for the card: the state goes up in one packed
copy and comes back, with the [T, C] telemetry, in one copy at the end.
On the card, with the "shift" or "pallas" correlator, the whole block of
epochs is ONE launch of kernel B7 (ops/cuda/track_block_scan.py), which
computes epoch_step with B5's sums; the other correlators run the op
loop (run_epoch_ops), about 190 small ops an epoch. Either is captured
once per block shape as a CUDA graph and replayed (track_block_device),
as the JAX package jits its scan.

Arithmetic as the JAX package's jitted graph computes it on the CPU
(checked bit for bit against it on the integer ledger): a division by
the constant fs is a multiplication by ``inv_f32(fs)``, and XLA fuses
the carrier-aided code rate, the chip ramp and the chip estimate into
fused multiply-adds.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from ..config import TrackConfig
from ..models.constellation import SignalSpec
from ..ops import nco
from ..ops.correlator import (
    epl_correlate_one,
    epl_correlate_one_shift,
    epl_correlate_one_slice,
    f32_to_i32,
    fma,
)
from ..ops.cuda import launches
from ..ops.cuda import track_block_scan as b7
from ..ops.cuda.epl_correlator import epl_correlate_block
from ..utils.profiling import StageTimer

_U32_SCALE = 4294967296.0
CORRELATORS = ("shift", "exact", "slice", "fused", "pallas")


class ChannelState(NamedTuple):
    """Per-channel tracking state, all numpy arrays [C].

    offset <-> the reference's next_sample_index (block-relative here),
    carr_acc/chip_int/chip_frac_u32 <-> carrier_phase/code_phase,
    carr_freq includes the IF (do_tracking.rs:88-115)."""

    active: np.ndarray        # bool
    prn_idx: np.ndarray       # i32, row in code table; -1 = idle
    offset: np.ndarray        # i32, next sample index rel. to block buffer
    epochs: np.ndarray        # i32, epochs processed since channel start
    lost_count: np.ndarray    # i32
    carr_freq: np.ndarray     # f32 Hz (IF + Doppler)
    carr_acc: np.ndarray      # u32 carrier phase (cycle fraction)
    carr_err: np.ndarray      # f32, previous PLL discriminator
    code_rate: np.ndarray     # f32 chips/s
    chip_int: np.ndarray      # i32 integer chip index in [0, L)
    chip_frac_u32: np.ndarray  # u32 fractional chip
    code_err: np.ndarray      # f32, previous DLL discriminator
    lock_ema: np.ndarray      # f32, smoothed Costas lock metric


_FIELD_DTYPES = {
    "active": np.bool_, "prn_idx": np.int32, "offset": np.int32,
    "epochs": np.int32, "lost_count": np.int32, "carr_freq": np.float32,
    "carr_acc": np.uint32, "carr_err": np.float32,
    "code_rate": np.float32, "chip_int": np.int32,
    "chip_frac_u32": np.uint32, "code_err": np.float32,
    "lock_ema": np.float32,
}


class EpochTelemetry(NamedTuple):
    """Per-epoch outputs, numpy arrays [T, C]."""

    processed: np.ndarray
    i_e: np.ndarray
    q_e: np.ndarray
    i_p: np.ndarray
    q_p: np.ndarray
    i_l: np.ndarray
    q_l: np.ndarray
    power: np.ndarray
    locked: np.ndarray
    lost_event: np.ndarray
    pll_err: np.ndarray
    dll_err: np.ndarray
    carr_freq: np.ndarray
    code_rate: np.ndarray
    start_offset: np.ndarray  # sample index (block-relative) of epoch start
    epoch_index: np.ndarray   # channel epoch counter at epoch start
    chip_phase: np.ndarray    # f32 code phase (chips) at epoch start


def state_from_numpy(fields: dict) -> ChannelState:
    """ChannelState from a field -> array mapping, e.g. the JAX
    package's ``ChannelState._asdict()`` after ``np.asarray``: both
    receivers can then start from the same exact ledger. Each field is
    cast to its ledger dtype (the u32 accumulators stay uint32)."""
    missing = set(ChannelState._fields) - set(fields)
    if missing:
        raise ValueError(f"state_from_numpy: missing fields {sorted(missing)}")
    return ChannelState(**{
        f: np.array(fields[f], dtype=_FIELD_DTYPES[f], copy=True)
        for f in ChannelState._fields})


def _loop_filter_taus(bw: float, damping: float,
                      gain: float) -> tuple[float, float]:
    """2nd-order loop filter time constants (do_tracking.rs:60-65)."""
    w = bw * 8.0 * damping / (4.0 * damping * damping + 1.0)
    return gain / (w * w), 2.0 * damping / w


@dataclasses.dataclass(frozen=True)
class TrackParams:
    """Static tracking parameters."""

    fs_hz: float
    code_length: int
    oversample: int          # code table sub-chip resolution (BOC)
    window: int              # static epoch window W >= max N_t
    nominal_code_rate: float
    el_space: float
    lock_threshold: float
    max_lost_epochs: int
    pll_tau1: float
    pll_tau2: float
    dll_tau1: float
    dll_tau2: float
    dt: float
    correlator: str = "shift"
    el_shift: int = 1
    interp_code: bool = False
    lock_mode: str = "power"
    costas_lock_threshold: float = 0.4
    carrier_aiding: bool = False
    aiding_scale: float = 0.0     # code_rate / RF carrier frequency
    if_freq_hz: float = 0.0       # IF carried in carr_freq (aiding ref)

    @classmethod
    def create(cls, cfg: TrackConfig, spec: SignalSpec, fs_hz: float,
               if_freq_hz: float = 0.0) -> "TrackParams":
        pll_tau1, pll_tau2 = _loop_filter_taus(
            cfg.pll_bandwidth_hz, cfg.pll_damping, cfg.pll_gain)
        dll_tau1, dll_tau2 = _loop_filter_taus(
            cfg.dll_bandwidth_hz, cfg.dll_damping, cfg.dll_gain)
        n0 = spec.samples_per_code(fs_hz)
        el_chips = cfg.early_late_chips
        if spec.boc_cycles_per_chip:
            # keep the E/L pair inside the BOC main lobe: +-0.5-chip
            # offsets give the envelope discriminator stable false zeros
            # at +-0.25/n chip
            el_chips = min(el_chips, 0.25 / spec.boc_cycles_per_chip)
        return cls(
            fs_hz=fs_hz,
            code_length=spec.code_length_chips,
            oversample=max(1, 2 * spec.boc_cycles_per_chip),
            window=n0 + cfg.window_margin,
            nominal_code_rate=spec.code_rate_hz,
            el_space=el_chips,
            lock_threshold=cfg.lock_threshold,
            max_lost_epochs=cfg.max_lost_epochs,
            pll_tau1=pll_tau1,
            pll_tau2=pll_tau2,
            dll_tau1=dll_tau1,
            dll_tau2=dll_tau2,
            dt=cfg.integration_s * spec.code_period_ms,
            correlator=cfg.correlator,
            el_shift=max(1, int(round(el_chips * fs_hz
                                      / spec.code_rate_hz))),
            interp_code=cfg.interp_code,
            lock_mode=cfg.lock_mode,
            costas_lock_threshold=cfg.costas_lock_threshold,
            carrier_aiding=cfg.carrier_aiding,
            aiding_scale=spec.code_rate_hz / spec.carrier_freq_hz,
            if_freq_hz=if_freq_hz,
        )

    @property
    def samples_per_code_nominal(self) -> int:
        return int(round(self.fs_hz * self.code_length
                         / self.nominal_code_rate))


def make_sampled_code_table(spec: SignalSpec, fs_hz: float,
                            n_prn: int | None = None,
                            window: int | None = None) -> np.ndarray:
    """[P, 2*n0 + W + 768] float32 nominal-rate sampled replicas (BOC
    baked in), tiled so any one-period slice plus the fused path's
    window and E/L margins is contiguous. The 768-sample margin covers
    build_replicas' worst slice end (2*n0 + wp - el_shift, with wp the
    window rounded up after the layout's alignment margins): a shorter
    table would misalign the replica for a whole block."""
    n0 = spec.samples_per_code(fs_hz)
    w = window or (n0 + 64)
    need = 2 * n0 + w + 768
    reps = int(np.ceil(need / n0)) + 1
    rows = []
    for p in range(1, (n_prn or spec.n_prn) + 1):
        one = spec.sample_code(p, spec.code_rate_hz, fs_hz).astype(np.float32)
        rows.append(np.tile(one, reps)[:need])
    return np.stack(rows)


def make_code_table(spec: SignalSpec, n_prn: int | None = None) -> np.ndarray:
    """[n_prn, L * oversample] float32 replica table of the gather
    correlators ("shift", "exact", "pallas"). For BOC signals the
    subcarrier is baked in at half-chip resolution, so one gather covers
    code x subcarrier."""
    table = spec.code_table()[: (n_prn or spec.n_prn)].astype(np.float32)
    if spec.boc_cycles_per_chip:
        os = 2 * spec.boc_cycles_per_chip
        rep = np.repeat(table, os, axis=1)
        sub = np.tile(np.array([1.0, -1.0], np.float32), rep.shape[1] // 2)
        return rep * sub[None, :]
    return table


def init_state(n_channels: int) -> ChannelState:
    z_f = np.zeros(n_channels, np.float32)
    z_i = np.zeros(n_channels, np.int32)
    z_u = np.zeros(n_channels, np.uint32)
    return ChannelState(
        active=np.zeros(n_channels, bool),
        prn_idx=np.full(n_channels, -1, np.int32),
        offset=z_i.copy(), epochs=z_i.copy(), lost_count=z_i.copy(),
        carr_freq=z_f.copy(), carr_acc=z_u.copy(), carr_err=z_f.copy(),
        code_rate=z_f.copy(), chip_int=z_i.copy(),
        chip_frac_u32=z_u.copy(), code_err=z_f.copy(),
        lock_ema=z_f.copy(),
    )


def start_channel(state: ChannelState, channel: int, prn_idx: int,
                  carrier_freq_hz: float, offset: int,
                  code_rate_hz: float) -> ChannelState:
    """Handoff of an acquisition result into a channel slot (a new
    state; the input's arrays are not modified)."""
    values = {
        "active": True, "prn_idx": prn_idx, "offset": offset,
        "epochs": 0, "lost_count": 0, "carr_freq": carrier_freq_hz,
        "carr_acc": 0, "carr_err": 0.0, "code_rate": code_rate_hz,
        "chip_int": 0, "chip_frac_u32": 0, "code_err": 0.0,
        # handoff grace: assume locked until the EMA says otherwise
        "lock_ema": 1.0,
    }
    fields = {}
    for f in ChannelState._fields:
        arr = np.array(getattr(state, f), dtype=_FIELD_DTYPES[f], copy=True)
        arr[channel] = values[f]
        fields[f] = arr
    return ChannelState(**fields)


def rebase(state: ChannelState, advance: int) -> ChannelState:
    """Shift block-relative offsets after the window rolls forward by
    ``advance`` samples."""
    return state._replace(
        offset=(np.asarray(state.offset) - advance).astype(np.int32))


# ---------------------------------------------------------------------------
# the scanned path
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_TELEM_BOOL = ("processed", "locked", "lost_event")
_TELEM_INT = ("start_offset", "epoch_index")


def _pack_inputs(state: ChannelState, limit: int) -> np.ndarray:
    """[13 * C + 1] int32: each ledger field's bits (bool as 0/1), row by
    row, then ``limit`` (the valid samples of the block): the one array
    uploaded per block."""
    rows = []
    for f in ChannelState._fields:
        a = np.asarray(getattr(state, f), dtype=_FIELD_DTYPES[f])
        rows.append(a.astype(np.int32) if a.dtype == np.bool_
                    else a.view(np.int32))
    return np.concatenate(rows + [np.array([limit], np.int32)])


def _device_state(packed: torch.Tensor) -> ChannelState:
    """The packed ledger as tensors: u32 accumulators as masked int64
    (ops/nco.py), the other integers int32, flags bool."""
    fields = {}
    for k, f in enumerate(ChannelState._fields):
        row, dt = packed[k], _FIELD_DTYPES[f]
        if dt is np.float32:
            fields[f] = row.view(torch.float32)
        elif dt is np.uint32:
            fields[f] = row.to(torch.int64) & _MASK32
        elif dt is np.bool_:
            fields[f] = row != 0
        else:
            fields[f] = row
    return ChannelState(**fields)


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int32 bits of a field: f32 reinterpreted, flags 0/1, integers
    (u32 in int64 included) wrapped to int32."""
    if x.dtype == torch.float32:
        return x.contiguous().view(torch.int32)
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    x = x.to(torch.int64)
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def epoch_step(params: TrackParams, codes: torch.Tensor,
               state: ChannelState, block_re: torch.Tensor,
               block_im: torch.Tensor, limit: int
               ) -> tuple[ChannelState, EpochTelemetry]:
    """One tracking epoch for all channels (masked where impossible), on
    ``state``'s tensors (_device_state); returns the new state and [C]
    telemetry tensors. ``limit``: the valid samples in the block."""
    p = params
    block_len = block_re.shape[0]
    inv_fs = nco.inv_f32(p.fs_hz)

    # carrier-aided effective code rate: Doppler scales the chip rate by
    # code_rate / carrier
    if p.carrier_aiding:
        code_rate_eff = fma(state.carr_freq - p.if_freq_hz,
                            float(np.float32(p.aiding_scale)),
                            state.code_rate)
    else:
        code_rate_eff = state.code_rate

    # true epoch length from the current code rate (do_tracking.rs:192-193)
    fs_l = float(np.float32(p.fs_hz) * np.float32(p.code_length))
    n_t_f = torch.round(torch.full_like(code_rate_eff, fs_l)
                        / torch.clamp(code_rate_eff, min=1.0))
    # an idle channel's zero rate gives ~4e9, saturated as XLA does: its
    # (unused) sums are then over the whole window
    n_t = f32_to_i32(n_t_f)
    # the FULL static window must fit: deferred epochs are recovered by
    # the +1 catch-up epoch of the next block
    can = (state.active & (state.offset >= 0)
           & (state.offset + p.window <= limit))
    start = torch.clamp(state.offset, 0, block_len - p.window)

    carr_step = nco.cycles_to_step(state.carr_freq * inv_fs)
    chips_per_sample = code_rate_eff * inv_fs
    chip_frac_f = state.chip_frac_u32.to(torch.float32) * (1.0 / _U32_SCALE)
    per_channel = (n_t, state.carr_acc, carr_step, state.chip_int,
                   chip_frac_f, chips_per_sample, codes)
    if p.correlator == "pallas":
        # B5 reads each window from the block at its start
        sums = epl_correlate_block(block_re, block_im, start, *per_channel,
                                   window=p.window, shift=p.el_shift,
                                   oversample=p.oversample,
                                   interp=p.interp_code,
                                   max_start=block_len - p.window)
    else:
        idx = start.to(torch.int64)[:, None] + torch.arange(
            p.window, device=block_re.device)
        args = (block_re[idx], block_im[idx]) + per_channel
        if p.correlator in ("slice", "fused"):
            sums = epl_correlate_one_slice(*args, shift=p.el_shift,
                                           n0=p.samples_per_code_nominal)
        elif p.correlator == "shift":
            sums = epl_correlate_one_shift(*args, shift=p.el_shift,
                                           oversample=p.oversample,
                                           interp=p.interp_code)
        else:
            sums = epl_correlate_one(*args, el_space=p.el_space,
                                     oversample=p.oversample)

    power = sums.i_p * sums.i_p + sums.q_p * sums.q_p
    if p.lock_mode == "costas":
        # scale-invariant normalized lock metric (I^2-Q^2)/(I^2+Q^2),
        # EMA-smoothed
        nbd = sums.i_p * sums.i_p - sums.q_p * sums.q_p
        metric = nbd / torch.clamp(power, min=1e-12)
        new_lock_ema = torch.where(
            can, (1.0 - 0.1) * state.lock_ema + 0.1 * metric,
            state.lock_ema)
        locked = new_lock_ema > p.costas_lock_threshold
    else:
        new_lock_ema = state.lock_ema
        locked = power > p.lock_threshold

    # PLL: Costas atan discriminator (do_tracking.rs:280-286)
    safe_ip = torch.where(torch.abs(sums.i_p) < 1e-12, 1e-12, sums.i_p)
    pll_err = torch.atan(sums.q_p / safe_ip) * (1.0 / (2.0 * np.pi))
    carr_nco = pll_err * (p.dt / p.pll_tau1) + (
        pll_err - state.carr_err) * (p.pll_tau2 / p.pll_tau1)
    new_carr_freq = state.carr_freq + carr_nco

    # DLL: normalized early-late envelope (do_tracking.rs:288-301)
    pow_e = torch.sqrt(sums.i_e * sums.i_e + sums.q_e * sums.q_e)
    pow_l = torch.sqrt(sums.i_l * sums.i_l + sums.q_l * sums.q_l)
    el_sum = pow_e + pow_l
    dll_err = torch.where(
        el_sum > 0.0, (pow_e - pow_l) / torch.clamp(el_sum, min=1e-12), 0.0)
    code_nco = dll_err * (p.dt / p.dll_tau1) + (
        dll_err - state.code_err) * (p.dll_tau2 / p.dll_tau1)
    new_code_rate = state.code_rate + code_nco

    # loop filters engage only on locked epochs (do_tracking.rs:188-191)
    upd = can & locked
    new_carr_freq = torch.where(upd, new_carr_freq, state.carr_freq)
    new_carr_err = torch.where(upd, pll_err, state.carr_err)
    new_code_rate = torch.where(upd, new_code_rate, state.code_rate)
    new_code_err = torch.where(upd, dll_err, state.code_err)

    # exact phase advance over n_t samples (every processed epoch)
    new_carr_acc = nco.advance(state.carr_acc, carr_step, n_t)
    code_step = nco.cycles_to_step(chips_per_sample)
    new_frac = (state.chip_frac_u32
                + n_t.to(torch.int64) * code_step) & _MASK32
    new_frac_f = new_frac.to(torch.float32) * (1.0 / _U32_SCALE)
    est_total = fma(n_t_f, chips_per_sample, chip_frac_f)
    carry = torch.round(est_total - new_frac_f).to(torch.int32)
    raw_chip = state.chip_int + carry        # < 2L: two select-wraps
    new_chip_int = torch.where(raw_chip >= p.code_length,
                               raw_chip - p.code_length, raw_chip)
    new_chip_int = torch.where(new_chip_int >= p.code_length,
                               new_chip_int - p.code_length, new_chip_int)

    # lock / lost bookkeeping (do_tracking.rs:183-209)
    new_lost = torch.where(locked, 0, state.lost_count + 1)
    lost_event = can & (new_lost >= p.max_lost_epochs)
    survives = can & ~lost_event

    def sel(new, old):
        return torch.where(can, new, old)

    def live(new, old):
        return torch.where(survives, new,
                           torch.where(lost_event, 0.0, old))

    new_state = ChannelState(
        active=state.active & ~lost_event,
        prn_idx=torch.where(lost_event, -1, state.prn_idx),
        offset=sel(state.offset + n_t, state.offset),
        epochs=sel(state.epochs + 1, state.epochs),
        lost_count=torch.where(lost_event, 0,
                               sel(new_lost, state.lost_count)),
        carr_freq=live(new_carr_freq, state.carr_freq),
        carr_acc=sel(new_carr_acc, state.carr_acc),
        carr_err=live(new_carr_err, state.carr_err),
        code_rate=live(new_code_rate, state.code_rate),
        chip_int=sel(new_chip_int, state.chip_int),
        chip_frac_u32=sel(new_frac, state.chip_frac_u32),
        code_err=live(new_code_err, state.code_err),
        lock_ema=torch.where(lost_event, 0.0, new_lock_ema),
    )
    telem = EpochTelemetry(
        processed=can,
        i_e=sums.i_e, q_e=sums.q_e, i_p=sums.i_p, q_p=sums.q_p,
        i_l=sums.i_l, q_l=sums.q_l,
        power=power, locked=upd, lost_event=lost_event,
        pll_err=pll_err, dll_err=dll_err,
        carr_freq=new_state.carr_freq, code_rate=new_state.code_rate,
        start_offset=state.offset, epoch_index=state.epochs,
        chip_phase=state.chip_int.to(torch.float32) + chip_frac_f,
    )
    return new_state, telem


def _run_epochs(params: TrackParams, codes: torch.Tensor, ins: torch.Tensor,
                block_re: torch.Tensor, block_im: torch.Tensor,
                n_epochs: int) -> torch.Tensor:
    """The block's epochs on the inputs' device, from the packed inputs
    ``ins`` (_pack_inputs): with a correlator whose sums kernel B7
    computes ("shift", "pallas") through B7's wrapper, which launches it
    on the card and runs its plain version, the op loop, on the CPU; the
    other correlators run the op loop. Returns the int32 result of
    track_block_device."""
    if params.correlator in b7.CORRELATORS:
        return b7.track_block_scan(params, codes, ins, block_re, block_im,
                                   n_epochs)
    return run_epoch_ops(params, codes, ins, block_re, block_im, n_epochs)


def run_epoch_ops(params: TrackParams, codes: torch.Tensor,
                  ins: torch.Tensor, block_re: torch.Tensor,
                  block_im: torch.Tensor, n_epochs: int) -> torch.Tensor:
    """The block's epochs as torch ops (epoch_step) on the inputs'
    device, from the packed inputs ``ins`` (``limit`` stays a 0-d tensor,
    so a tail block runs the same ops as a full one): B7's plain version,
    and the path of the other correlators. Returns the int32 result of
    track_block_device."""
    c = (ins.shape[0] - 1) // len(ChannelState._fields)
    st = _device_state(ins[:-1].view(-1, c))
    limit = ins[-1]
    rows = []
    for _ in range(n_epochs):
        st, tl = epoch_step(params, codes, st, block_re, block_im, limit)
        rows.append(tl)
    state_bits = torch.stack([_bits32(x) for x in st])
    telem_bits = torch.stack([
        _bits32(torch.stack([getattr(r, f) for r in rows]))
        for f in EpochTelemetry._fields])
    return torch.cat([state_bits.reshape(-1), telem_bits.reshape(-1)])


def graph_key(params: TrackParams, codes, state: ChannelState, block_re,
              n_epochs: int) -> tuple:
    """The static key of a block's CUDA graph (from track_block_device's
    arguments): the parameters, the epoch count, the channels, the block
    length, the codes' width and the device. Not ``valid_len``: the limit
    is an input of the graph, so a tail block replays the full block's
    graph."""
    dev = (block_re.device if isinstance(block_re, torch.Tensor)
           else torch.device("cpu"))
    return (params, int(n_epochs), int(np.asarray(state.active).shape[0]),
            int(block_re.shape[0]), int(codes.shape[1]), dev)


# the graphs by graph_key, the least recently used first, up to
# _GRAPH_CACHE_SIZE per card: a receiver replays one key (its tail block
# too), the second place keeps the previous receiver's graph where two
# take turns in a process, and the shards of a mesh over several cards
# keep theirs on each card (the key holds the card). Per key,
# GRAPH_LOG holds the warm-up's and the capture's seconds (trace_s: the
# epochs' ops recorded; the rest of capture_s instantiates the graph) and
# the device memory the capture reserved for the graph's pool.
_GRAPH_CACHE_SIZE = 2
_GRAPHS: OrderedDict = OrderedDict()
GRAPH_LOG: dict = {}


class _BlockGraph:
    """One key's block of epochs as a CUDA graph: the fixed buffers it
    reads (the packed ledger and limit, the block, the codes) and the
    result buffer it writes. The key's first call runs the epochs
    eagerly on a side stream (PyTorch's warm-up before a capture) and
    returns that result; its second call captures them and replays, and
    so does every later call without the capture. A key used once (a
    stream's short last block) so never pays for a capture. One graph
    holds the whole block, not one epoch, so a block costs the host one
    graph launch instead of one per epoch. Where B7 runs the block (the
    "shift" and "pallas" correlators) the graph holds its one launch; the
    op loop's graph holds some 190 kernels an epoch, and its capture is
    the dearer for it (about 1.4-2.3 s on the H100 at 32 channels,
    PERF.md)."""

    def __init__(self, key: tuple):
        params, n_epochs, c, n, n_code, dev = key
        self.key, self.params, self.n_epochs = key, params, n_epochs
        self.ins = torch.empty(len(ChannelState._fields) * c + 1,
                               dtype=torch.int32, device=dev)
        self.re = torch.empty(n, dtype=torch.float32, device=dev)
        self.im = torch.empty_like(self.re)
        self.codes = torch.empty((c, n_code), dtype=torch.float32,
                                 device=dev)
        self.warm = False
        self.graph = None
        self.out = None

    def load(self, ins, block_re, block_im, codes) -> None:
        """Copy one call's inputs into the fixed buffers (on the current
        stream; ``ins`` from pinned memory)."""
        self.ins.copy_(ins, non_blocking=True)
        self.re.copy_(block_re)
        self.im.copy_(block_im)
        self.codes.copy_(codes)

    def eager(self) -> torch.Tensor:
        return _run_epochs(self.params, self.codes, self.ins, self.re,
                           self.im, self.n_epochs)

    def run(self, ins, block_re, block_im, codes) -> torch.Tensor:
        """With the graph's card current (track_block_device makes it
        so): the warm-up, the capture and the replays all run there."""
        self.load(ins, block_re, block_im, codes)
        dev = self.re.device
        if not self.warm:
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(device=dev)
            side.wait_stream(cur)
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                out = self.eager()
            cur.wait_stream(side)
            out.record_stream(cur)
            self.warm = True
            GRAPH_LOG[self.key] = {"warmup_s": time.perf_counter() - t0}
            return out
        if self.graph is None:
            graph = launches.Graph()
            t0 = time.perf_counter()
            # what torch.cuda.graph does on entry, done first so that the
            # reserved memory's growth is the graph's pool alone
            torch.cuda.synchronize(dev)
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            # thread-local: another thread's CUDA calls (a span collector)
            # cannot break this capture. The capture stream is on the
            # graph's card: torch.cuda.graph's default one lives on the
            # card current at the process's first capture, and a shard's
            # epochs on another card would leave its graph empty
            with graph.capture(stream=torch.cuda.Stream(device=dev),
                               capture_error_mode="thread_local"):
                static_out = self.eager()
                t1 = time.perf_counter()
            self.graph, self.out = graph, static_out
            GRAPH_LOG[self.key].update(
                capture_s=time.perf_counter() - t0, trace_s=t1 - t0,
                pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
                launches={f"{m.rsplit('.', 1)[-1]}.{n}": k
                          for (m, n), k in graph.launches.items()})
        self.graph.replay()
        # a later replay overwrites self.out: the caller gets a copy
        return self.out.clone()


def track_block_device(params: TrackParams, codes, state: ChannelState,
                       block_re, block_im, n_epochs: int,
                       valid_len: int | None = None,
                       graph: bool = True) -> torch.Tensor:
    """``n_epochs`` epochs over one resident sample block, on the
    block's device, from the host ledger ``state``. Returns ONE int32
    tensor on that device: the end state's [13, C] field bits, then the
    [17, T, C] telemetry bits (``unpack_block`` reads it). The ledger and
    the limit go up in one copy from pinned memory, and nothing here
    waits for the card.

    On CUDA the epochs run on the block's card, made current here (one
    launch of kernel B7 with "shift" or "pallas", else the op loop), as
    one CUDA graph per graph_key (the
    counterpart of the JAX package's jitted scan): a key's first call is
    the eager warm-up, its second captures, and every call from the
    second on replays; each call copies its inputs into the graph's
    buffers, and the result is a copy of the graph's. A capture that
    fails raises.
    ``graph=False`` runs the same eagerly (B7's launch, or the loop of
    torch ops), which the checks hold the replay to; on the CPU the op
    loop always runs."""
    if params.correlator not in CORRELATORS:
        raise ValueError(f"unknown correlator {params.correlator!r}; "
                         f"expected one of {CORRELATORS}")
    block_re = torch.as_tensor(block_re, dtype=torch.float32).contiguous()
    block_im = torch.as_tensor(block_im, dtype=torch.float32,
                               device=block_re.device).contiguous()
    dev = block_re.device
    codes = torch.as_tensor(codes, dtype=torch.float32).to(dev).contiguous()
    limit = block_re.shape[0]
    if valid_len is not None:
        limit = min(limit, int(valid_len))
    ins = torch.from_numpy(_pack_inputs(state, limit))
    if dev.type != "cuda":
        return _run_epochs(params, codes, ins, block_re, block_im, n_epochs)
    ins = ins.pin_memory()
    with torch.cuda.device(dev):
        if not graph:
            return _run_epochs(params, codes, ins.to(dev, non_blocking=True),
                               block_re, block_im, n_epochs)
        key = graph_key(params, codes, state, block_re, n_epochs)
        g = _GRAPHS.pop(key, None) or _BlockGraph(key)
        out = g.run(ins, block_re, block_im, codes)
    _GRAPHS[key] = g                    # the newest last
    on_card = [k for k in _GRAPHS if k[-1] == dev]
    for k in on_card[:-_GRAPH_CACHE_SIZE]:
        del _GRAPHS[k]
    return out


def unpack_block(buf, n_channels: int,
                 n_epochs: int) -> tuple[ChannelState, EpochTelemetry]:
    """The host (ChannelState, [T, C] EpochTelemetry) of a
    track_block_device result (a tensor, downloaded here, or its numpy
    copy)."""
    if isinstance(buf, torch.Tensor):
        buf = buf.cpu().numpy()
    n_state = len(ChannelState._fields) * n_channels
    st_rows = buf[:n_state].reshape(-1, n_channels)
    state = ChannelState(**{
        f: (st_rows[k] != 0 if _FIELD_DTYPES[f] is np.bool_
            else st_rows[k].view(_FIELD_DTYPES[f])).copy()
        for k, f in enumerate(ChannelState._fields)})
    tl_rows = buf[n_state:].reshape(-1, n_epochs, n_channels)
    fields = {}
    for k, f in enumerate(EpochTelemetry._fields):
        x = tl_rows[k]
        if f in _TELEM_BOOL:
            fields[f] = x != 0
        elif f in _TELEM_INT:
            fields[f] = x.copy()
        else:
            fields[f] = x.view(np.float32).copy()
    return state, EpochTelemetry(**fields)


def track_block(params: TrackParams, codes, state: ChannelState, block_re,
                block_im, n_epochs: int, valid_len: int | None = None,
                graph: bool = True, timers: StageTimer | None = None
                ) -> tuple[ChannelState, EpochTelemetry]:
    """Run ``n_epochs`` tracking epochs over one resident sample block
    (track_block_device) and download the result in one copy. Returns
    the host ledger and [T, C] telemetry. The caller picks ``n_epochs =
    block_ms / code_period_ms + 1``: the +1 lets a channel that fell
    behind catch up one epoch per block. ``valid_len`` (a Python int)
    bounds processing when the block's tail is zero padding (a short
    final read). ``graph``: as in track_block_device. ``timers``: the
    receiver's StageTimer, in which the launch, the one download and the
    unpack are timed apart (track.launch, track.wait, track.absorb)."""
    t = timers if timers is not None else StageTimer()
    with t.stage("track.launch"):
        buf = track_block_device(params, codes, state, block_re, block_im,
                                 n_epochs, valid_len, graph)
    with t.stage("track.wait"):
        host = buf.cpu().numpy()            # the one download
    with t.stage("track.absorb"):
        return unpack_block(host, np.asarray(state.active).shape[0],
                            n_epochs)
