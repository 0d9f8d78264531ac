"""Receiver-side glue for the fused whole-block tracking kernels
(counterpart of ``gnss_sdr_tpu/receiver/fused_runner.py``).

Bridges the Receiver's exact per-channel ledger (ChannelState: uint32
carrier/chip accumulators, block-relative offsets) to the kernels'
[C, 128] f32 column state and back, once per sample block:

  host ChannelState --anchor--> [C,128] matrix + window starts + anchors
       -> build_replicas + the layout's kernel (one launch; seg: a
          segment gather, then one launch)
       -> EpochTelemetry + re-absorbed ChannelState

Re-anchoring each block keeps the cross-block bookkeeping exact (u32)
while the in-block loop runs in f32 on the card. The multi-block scan
(``run_blocks`` and the span API) does the same re-anchor and absorb as
torch ops on the card, block after block, with the ledger on the card
and one download per span.

Layouts: "mxu" (kernel B1, held-rate supersteps, bf16 contraction),
"direct" (kernel B3, exact per-epoch NCOs, f32), "seg" (B4c gathers each
channel's segment, B4b tracks from it; where a block's epoch count has
no superstep pairing, mxu and direct fall to seg, as in the JAX package)
and "windows" (slice_windows, then B4a). direct, seg and windows give the
same telemetry and state. Telemetry wires of the scan: "f32"
(bit-exact), "slim" and "slim2" (mxu only); the scan runs on mxu and
direct only.

Lifecycle corners handled here, not in the kernels:

  * late handoffs: a channel whose offset leaves no room for T full
    epochs in the buffer is deferred one block (its state passes
    through untouched; after rebase it fits);
  * offset walk: with a fixed T epochs per block, a channel's offset
    moves by its accumulated drift each block. If it lies below the
    el_pad preroll margin the channel skips forward whole code periods
    to the first one past the margin (one, in steady state; more after
    a deferral rebased the offset behind the window).

``epochs`` counts code periods of signal time since the handoff: every
processed epoch and every period the walk skips (ROADMAP C1). Both the
host path (run_block + rebase) and the scan keep this meaning.

``shared_fetch=True`` (mxu only, as in the JAX package) runs kernel B2:
each superstep's windows come from one shared slice of the stream per
thread-block cluster, anchored at base = max(0, max(eligible starts) -
spread_cap); a channel whose start lies below the base defers one block,
as one past ``max_offset`` does. Its results equal B1's bit for bit.

``mesh`` (parallel.make_mesh) shards the channels over the mesh's
channel axis: each shard's kernel runs on its device on its own rows
(parallel.shard_fused_step), in run_block and in the spans alike, and
the shared fetch is off, as in the JAX package (B2's [C + 1] starts do
not shard).

``span_extra`` (the JAX package's hook, which the receiver's in-scan
search sets to the conv engine's search): a function of a span's stream
queued on the card after the span's kernels, its outputs downloaded
with the span's telemetry (``last_span_extra`` after run_blocks;
``collect_span(handle, with_extra=True)`` on the span API).

The per-epoch
layouts (direct, seg, windows) take windows up to 49,152 lanes and
reject wider ones (ROADMAP C6; Galileo E1B at 8.184 MHz is 33,152 on
seg, which the JAX _epoch_core cannot run); B1 and B2 (mxu) run every
width up to their plan's (``mxu_smem_plan``), one channel over a
thread-block cluster where the whole bank does not fit in one block's
shared memory (ROADMAP C15).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import TrackConfig
from ..device import resolve_device
from ..models.constellation import SignalSpec
from ..utils.profiling import StageTimer
from ..ops.cuda import track_block_fused as fused
from . import tracking as trk

_U32 = 4294967296.0
N_DRIFT = 5
MAX_HANDOFFS = 8                          # handoff slots per span


class _SpanHandle(NamedTuple):
    """One submitted span: the device ledger after it (chain it into the
    next submit), its download in flight, its block count, the parts of
    each block in the download (the wire's fields, then the four
    block-entry snapshots) and the span_extra output's type and field
    count (0: none), which follow them."""

    led: tuple
    ys: "_SpanDownload"
    n_blocks: int
    n_parts: int
    extra_type: type = tuple
    n_extra: int = 0


_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
              torch.int16: np.int16, torch.int8: np.int8,
              torch.bool: np.bool_}


class _SpanDownload:
    """One span's outputs packed into a single byte buffer and copied to
    the host in ONE transfer. On the card the copy starts right after
    the span's kernels, non-blocking into pinned memory, with an event
    recorded behind it: ``fetch`` waits on that event only (not on later
    spans queued behind it) and unpacks numpy arrays. bf16 fields cross
    as their bits and widen on the host (bits << 16, exact)."""

    def __init__(self, parts):
        chunks, self.layout, off = [], [], 0
        for t in parts:
            t = t.contiguous()
            b = t.reshape(-1).view(torch.uint8)
            pad = (-b.numel()) % 8
            self.layout.append((t.dtype, tuple(t.shape), off))
            chunks.append(b)
            if pad:
                chunks.append(b.new_zeros(pad))
            off += b.numel() + pad
        flat = torch.cat(chunks)
        self.event = None
        if flat.device.type == "cuda":
            self.host = torch.empty(flat.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def fetch(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        buf = self.host.numpy()
        out = []
        for dt, shape, off in self.layout:
            n = int(np.prod(shape, dtype=np.int64))
            if dt == torch.bfloat16:
                bits = np.frombuffer(buf, np.uint16, n, off)
                arr = (bits.astype(np.uint32) << 16).view(np.float32)
            else:
                arr = np.frombuffer(buf, _NP_DTYPES[dt], n, off).copy()
            out.append(arr.reshape(shape))
        return out


class FusedTracker:
    """Per-receiver instance of the fused block step.

    ``layout``: "mxu" (B1), "direct" (B3), "seg" (B4c + B4b) or
    "windows" (B4a); a block length with no mxu superstep pairing goes
    to direct, and one with no direct pairing to seg. ``wire`` selects the
    scan's telemetry download: "f32" (bit-exact), "slim" (~4.5x fewer
    bytes) or "slim2" (mxu only, ~13x: 5 B/epoch/channel with a host
    replay of the ledger; on direct it becomes "slim").

    The span API (submit_span / collect_span / absorb_led /
    apply_handoffs_device) lets the steady-state receiver chain spans
    on the card and download telemetry from a collector thread
    (Receiver.run(span_pipeline=True)).

    ``timers``: the receiver's StageTimer, in which run_block and
    run_blocks time their steps as sub-stages of its ``track`` stage
    (track.anchor, track.launch, track.wait, track.absorb).
    """

    def __init__(self, params: trk.TrackParams, cfg: TrackConfig,
                 spec: SignalSpec, fs_hz: float, codes_sampled,
                 t_epochs: int, buf_len: int, layout: str = "mxu",
                 mesh=None, wire: str = "f32",
                 shared_fetch: bool = False, device=None,
                 timers: StageTimer | None = None):
        if cfg.lock_mode not in ("power", "costas"):
            raise ValueError(
                f"correlator='fused': unknown lock_mode {cfg.lock_mode!r}")
        if layout not in ("mxu", "direct", "seg", "windows"):
            raise ValueError(f"unknown fused layout {layout!r}")
        if wire not in ("f32", "slim", "slim2"):
            raise ValueError(f"unknown telemetry wire {wire!r}")
        # superstep cap: 8 epochs for the power detector; 2 for Costas,
        # whose phase-sensitive EMA can fall below threshold during the
        # held-rate latency before the first correction lands
        mxu_k_max = 2 if cfg.lock_mode == "costas" else 8
        if layout == "mxu" and fused.choose_k(t_epochs, mxu_k_max) is None:
            layout = "direct"
        if layout == "direct" and fused.choose_k(t_epochs) is None:
            layout = "seg"          # odd t_epochs: no superstep pairing
        if wire == "slim2" and layout != "mxu":
            # slim2's host replay of the ledger rides the mxu kernel's
            # held-rate columns 17-20; direct changes rates per epoch
            wire = "slim"
        self.device = resolve_device(device)
        self.timers = timers if timers is not None else StageTimer()
        self.wire = wire
        # diagnostic-column stride of the slim wire: the largest divisor
        # of t_epochs <= 8
        self.wire_stride = next(
            s for s in (8, 5, 4, 2, 1) if t_epochs % s == 0)
        self.params = params
        self.spec = spec
        self.fs = fs_hz
        self.n0 = params.samples_per_code_nominal
        self.t_epochs = t_epochs
        self.layout = layout
        # window: epoch + the 128-alignment residues (direct: rem_c0 +
        # rem_e + rem_j, +384; seg: rem_c0 + rem_t, +256; windows: none);
        # the mxu bank adds 2*el_shift rows of preroll; rounded to 128
        extra = {"mxu": 384 + 2 * params.el_shift, "direct": 384,
                 "seg": 256, "windows": 0}[layout]
        self.wp = ((params.window + extra + 63 + 127) // 128) * 128
        if layout != "mxu" and self.wp > fused.MAX_WP:
            raise ValueError(
                f"fused layout {layout!r}: wp={self.wp} > {fused.MAX_WP} "
                "(ROADMAP C6: the widest window of the per-epoch kernels, "
                "whose prompt row and trig factors must fit in shared "
                "memory); use layout='mxu'")
        self.n_rows = (fused.mxu_rows(N_DRIFT, params.el_shift)
                       if layout == "mxu" else N_DRIFT)
        self.half = (self.n_rows - 1) // 2
        self.el_pad = params.el_shift + self.half
        self.k_epochs = self.l_seg = None
        if layout in ("mxu", "direct"):
            self.k_epochs = fused.choose_k(
                t_epochs, mxu_k_max if layout == "mxu" else 16)
            # worst window read end: a_c + off_last + span
            #   <= off + (T-1)*n0 + wp - el_pad
            self.max_offset = (buf_len - (t_epochs - 1) * self.n0
                               - self.wp + self.el_pad - 1)
            need = (t_epochs - 1) * self.n0 + self.wp + self.n0
        elif layout == "seg":
            self.l_seg = fused.seg_length(t_epochs, self.n0, self.wp)
            # the gather reads [a_c, a_c + l_seg); a_c <= off - el_pad
            self.max_offset = buf_len - self.l_seg + self.el_pad - 1
            need = self.l_seg + self.n0 + 1 - self.el_pad
        else:
            # the last offset that still fits T+1 nominal epochs + window
            self.max_offset = buf_len - (t_epochs * self.n0 + self.wp)
            need = t_epochs * self.n0 + self.wp + self.n0
        if self.max_offset <= self.el_pad + self.n0:
            raise ValueError(
                f"buffer too short for fused tracking (layout={layout!r}): "
                f"len={buf_len}, need > {need}")
        if layout != "windows" and self.n0 <= self.el_pad + self.half + 128:
            raise ValueError(
                f"n0={self.n0} too small for the {layout} fused layout "
                f"(need > {self.el_pad + self.half + 128})")
        p1, p2, d1, d2 = fused.loop_filter_consts(cfg)
        self.aiding_scale = (float(params.aiding_scale)
                             if cfg.carrier_aiding else 0.0)
        self.if_freq = float(params.if_freq_hz)
        self._kernel = {"mxu": fused.track_block_fused_mxu,
                        "direct": fused.track_block_fused_direct,
                        "seg": self._seg_step,
                        "windows": self._windows_step}[layout]
        self._kernel_kw = dict(
            n0=self.n0, fs=fs_hz, code_len=float(spec.code_length_chips),
            lock_threshold=cfg.lock_threshold,
            max_lost=cfg.max_lost_epochs,
            pll_c1=p1, pll_c2=p2, dll_c1=d1, dll_c2=d2,
            el_shift=params.el_shift,
            aiding_scale=self.aiding_scale, if_freq=self.if_freq,
            lock_mode=cfg.lock_mode,
            costas_thr=cfg.costas_lock_threshold,
            interp=cfg.interp_code,
        )
        # the block's shape, as each layout's kernel takes it (windows:
        # from the windows' shape)
        if layout != "windows":
            self._kernel_kw.update(t_epochs=t_epochs, wp=self.wp)
        if layout in ("mxu", "direct"):
            self._kernel_kw.update(k_epochs=self.k_epochs)
        # shared-fetch window feed (B2, opt-in, mxu only): the cap bounds
        # how far below the highest eligible window start the shared
        # slice reaches (about one code period plus walk and drift
        # margin); a channel further below defers one block, which the
        # steady state never meets (its windows start within
        # [el_pad, el_pad + n0) of the block)
        self.spread_cap = 0
        if shared_fetch and layout == "mxu" and mesh is None:
            self.spread_cap = ((self.n0 + 512 + 127) // 128) * 128
            self._kernel_kw.update(spread_cap=self.spread_cap)
        if mesh is not None:
            # each shard's kernel on its own channel rows (no exchange)
            from ..parallel import sharding

            sharding.shard_rows(cfg.n_channels, mesh)
            self._kernel = sharding.shard_fused_step(mesh, self._kernel)
        self.mesh = mesh
        # optional work queued after a span's kernels:
        # span_extra(stream_re, stream_im, *extra_args) -> a tuple (or
        # NamedTuple) of tensors on the card, which come down with the
        # span's telemetry; run_blocks leaves them in last_span_extra
        self.span_extra = None
        self.last_span_extra = None

    # ------------------------------------------------------------------
    def _seg_step(self, block_re, block_im, starts, reps, mat, *,
                  starts_host, **kw):
        """The seg layout's block: B4c gathers each channel's [Lseg]
        segment at its 128-aligned start, then B4b tracks T epochs."""
        seg_re, seg_im = fused.gather_segments(
            block_re, block_im, starts, self.l_seg, starts_host=starts_host)
        return fused.track_block_fused_seg(seg_re, seg_im, reps, mat, **kw)

    def _windows_step(self, block_re, block_im, offsets, reps, mat, *,
                      starts_host, **kw):
        """The windows layout's block: slice_windows cuts [T, C, wp]
        windows at the channels' offsets (their host values), then B4a
        tracks them."""
        wre, wim = fused.slice_windows(block_re, block_im, starts_host,
                                       self.t_epochs, self.n0, self.wp,
                                       self.el_pad)
        return fused.track_block_fused(wre, wim, reps, mat, **kw)

    def _replicas(self, codes_rows, anchor, lane_shift):
        """The kernel's replica rows: the mxu bank in bf16, the per-epoch
        layouts' N_DRIFT prompt rows in f32 (windows: no lane shift)."""
        if self.layout == "windows":
            lane_shift = None
        reps = fused.build_replicas(
            codes_rows, self.params.el_shift, self.n0, self.wp,
            self.n_rows, anchor, lane_shift=lane_shift)
        if self.layout == "mxu":
            reps = reps.to(torch.bfloat16)
        return reps.contiguous()

    def anchor_block(self, state: trk.ChannelState) -> dict:
        """The host re-anchor of one block: from the exact ledger, the
        kernel's [C, 128] state matrix, the 128-aligned window starts,
        the replica anchors and lane shifts, plus the block-entry
        snapshot the absorb step needs."""
        c = int(np.asarray(state.active).shape[0])
        active0 = np.asarray(state.active)
        offset0 = np.asarray(state.offset).astype(np.int64).copy()
        epochs0 = np.asarray(state.epochs).astype(np.int64)
        cp0 = (np.asarray(state.chip_int).astype(np.float64)
               + np.asarray(state.chip_frac_u32).astype(np.float64) / _U32)

        # offset walk: skip whole code periods to the first past the
        # preroll; each skipped period still advances signal time, so it
        # counts in the epoch base (nav bit grid and transmit-time
        # anchors; module docstring)
        low = active0 & (offset0 < self.el_pad)
        n_skip = np.where(low, -((offset0 - self.el_pad) // self.n0), 0)
        offset0 = offset0 + n_skip * self.n0
        epochs0 = epochs0 + n_skip
        # defer channels that cannot fit T epochs this block
        eligible = active0 & (offset0 <= self.max_offset)

        mat = np.zeros((c, fused.N_FIELDS), np.float32)
        mat[:, 0] = np.asarray(state.carr_freq)
        mat[:, 1] = np.asarray(state.carr_acc).astype(np.float64) / _U32
        mat[:, 2] = np.asarray(state.carr_err)
        rate = np.asarray(state.code_rate).astype(np.float32)
        mat[:, 3] = np.where(rate > 0, rate,
                             np.float32(self.spec.code_rate_hz))
        mat[:, 5] = np.asarray(state.code_err)
        mat[:, 6] = np.asarray(state.lost_count)
        mat[:, 7] = eligible.astype(np.float32)
        mat[:, 11] = np.asarray(state.lock_ema)
        # replica rounding residual (state col 10), in the kernel's exact
        # f32 arithmetic and at the EFFECTIVE (aided) rate: an f64 host
        # rate the f32 kernel cannot represent would put frac0 in another
        # sample-equivalence class near a sample boundary
        rate_eff = mat[:, 3].astype(np.float32)
        if self.aiding_scale:
            rate_eff = rate_eff + (
                mat[:, 0] - np.float32(self.if_freq)
            ) * np.float32(self.aiding_scale)
        dc0 = (rate_eff / np.float32(self.fs)).astype(np.float32)
        # anchor and frac0 from ONE floor: build_replicas consumes the
        # anchor verbatim, so host and card never disagree about the
        # block-start replica's sample class
        s_anchor = np.floor(cp0.astype(np.float32) / dc0)
        frac0 = cp0.astype(np.float32) - s_anchor.astype(np.float32) * dc0
        mat[:, 10] = frac0
        anchor = np.mod(s_anchor, self.n0).astype(np.int32)
        if self.layout == "windows":
            # the windows start el_pad before each offset (an ineligible
            # channel's at 0, the JAX glue's clamped slice); col 12
            # carries the offset, col 9 stays 0
            starts = np.where(eligible, offset0, self.el_pad)
            mat[:, 12] = np.where(eligible, offset0, 0).astype(np.float32)
        else:
            # 128-aligned window starts; the residue rides col 9 (as
            # el_pad + rem_c0 = off - a_c, the kernel's mask base) and
            # shifts the replica (build_replicas lane_shift)
            a_c = ((offset0 - self.el_pad) // 128) * 128
            starts = np.where(eligible, np.maximum(a_c, 0), 0)
            if self.spread_cap:
                # B2's guard: the shared base anchors to the highest
                # eligible start, so the slice never reads past it by
                # more than the kernel's window span; a channel more than
                # the cap below it defers one block (state passes
                # through), an idle one reads at the base; the base rides
                # last in the kernel's [C + 1] starts
                mx = int(starts[eligible].max()) if eligible.any() else 0
                base = max(0, mx - self.spread_cap)
                eligible = eligible & (starts >= base)
                starts = np.append(np.where(eligible, starts, base), base)
                mat[:, 7] = eligible.astype(np.float32)
            a_own = starts[:c]
            mat[:, 9] = np.where(eligible, offset0 - a_own,
                                 self.el_pad).astype(np.float32)
            mat[:, 12] = a_own.astype(np.float32)
        mat[:, 13] = anchor.astype(np.float32)
        return dict(mat=mat, starts=starts.astype(np.int32), anchor=anchor,
                    lane_shift=(mat[:, 9] - np.float32(self.el_pad)
                                ).astype(np.int32),
                    eligible=eligible, offset0=offset0, epochs0=epochs0,
                    cp0=cp0)

    def kernel_args(self, anchored: dict, block_re, block_im, codes_rows):
        """(tensors, statics) of one block's kernel call on this
        tracker's device: stream, starts (windows: the offsets; shared
        fetch: [C + 1], the base last), replicas, state. The statics carry
        the host starts, so the launch checks its read bound without
        waiting for the card."""
        dev = self.device
        as_dev = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
        reps = self._replicas(as_dev(codes_rows), anchored["anchor"],
                              anchored["lane_shift"])
        args = (as_dev(block_re).to(torch.float32).contiguous(),
                as_dev(block_im).to(torch.float32).contiguous(),
                as_dev(anchored["starts"]), reps, as_dev(anchored["mat"]))
        return args, dict(self._kernel_kw, starts_host=anchored["starts"])

    def run_block(self, state: trk.ChannelState, block_re, block_im,
                  codes_rows) -> tuple[trk.ChannelState, trk.EpochTelemetry]:
        """One fused block: T epochs for every eligible channel.

        ``epochs`` comes back as code periods of signal time since the
        handoff (processed epochs plus the periods the offset walk
        skipped; a deferred channel keeps its count), the meaning the
        scan (run_blocks) keeps too."""
        t = self.timers
        with t.stage("track.anchor"):
            anc = self.anchor_block(state)
        with t.stage("track.launch"):
            args, kw = self.kernel_args(anc, block_re, block_im, codes_rows)
            telem, st = self._kernel(*args, **kw)
        with t.stage("track.wait"):
            # one download of both results
            flat = torch.cat([telem.reshape(-1), st.reshape(-1)]
                             ).cpu().numpy()
        with t.stage("track.absorb"):
            return self._absorb_block(state, anc, flat, tuple(telem.shape))

    def _absorb_block(self, state: trk.ChannelState, anc: dict,
                      flat: np.ndarray, telem_shape: tuple
                      ) -> tuple[trk.ChannelState, trk.EpochTelemetry]:
        """run_block's host step after the download: the kernel's state
        absorbed back into the exact ledger, and the block's
        EpochTelemetry."""
        c = int(np.asarray(state.active).shape[0])
        n_tel = int(np.prod(telem_shape))
        telem_m = flat[:n_tel].reshape(telem_shape)
        mat_out = flat[n_tel:].reshape(c, fused.N_FIELDS)
        eligible, offset0 = anc["eligible"], anc["offset0"]
        epochs0, cp0 = anc["epochs0"], anc["cp0"]

        # ---- absorb kernel state back into the exact ledger ----------
        el = eligible
        cp_out = np.mod(cp0 + mat_out[:, 4].astype(np.float64),
                        float(self.spec.code_length_chips))
        chip_int = np.asarray(state.chip_int).copy()
        chip_frac = np.asarray(state.chip_frac_u32).copy()
        chip_int[el] = np.floor(cp_out[el]).astype(np.int32)
        chip_frac[el] = np.minimum(
            (cp_out[el] - np.floor(cp_out[el])) * _U32, _U32 - 1.0
        ).astype(np.uint32)
        processed = telem_m[:, :, 16] > 0.5           # [T, C]
        n_proc = processed.sum(axis=0).astype(np.int64)

        def merge(old, new, cast=None):
            out = np.asarray(old).copy()
            out[el] = new[el] if cast is None else new[el].astype(cast)
            return out

        new_state = state._replace(
            active=merge(state.active, mat_out[:, 7] > 0.5),
            offset=merge(
                offset0.astype(np.int32),
                (offset0 + self.t_epochs * self.n0
                 + mat_out[:, 8]).astype(np.int64), np.int32),
            epochs=np.where(el, epochs0 + n_proc, epochs0).astype(np.int32),
            lost_count=merge(state.lost_count, mat_out[:, 6], np.int32),
            carr_freq=merge(state.carr_freq, mat_out[:, 0]),
            carr_acc=merge(
                state.carr_acc,
                np.mod(mat_out[:, 1].astype(np.float64), 1.0) * _U32,
                np.uint32),
            carr_err=merge(state.carr_err, mat_out[:, 2]),
            code_rate=merge(state.code_rate, mat_out[:, 3]),
            chip_int=chip_int.astype(np.int32),
            chip_frac_u32=chip_frac.astype(np.uint32),
            code_err=merge(state.code_err, mat_out[:, 5]),
            lock_ema=merge(state.lock_ema, mat_out[:, 11]),
        )
        telem = self._telem_from(telem_m, offset0, epochs0, cp0)
        return new_state, telem

    # ------------------------------------------------------------------
    def _telem_from(self, telem_m, offset0, epochs0, cp0
                    ) -> trk.EpochTelemetry:
        """EpochTelemetry [T, C] from one block's kernel telemetry and
        the block-entry ledger snapshot (offsets post-walk, epoch
        counts, chip phases)."""
        processed = telem_m[:, :, 16] > 0.5           # [T, C]
        t_idx = np.arange(self.t_epochs, dtype=np.int64)[:, None]
        start_offset = offset0[None, :].astype(np.int64) \
            + t_idx * self.n0 + telem_m[:, :, 13].astype(np.int64)
        epoch_index = epochs0[None, :].astype(np.int64) \
            + np.cumsum(processed, axis=0) - processed
        chip_phase = np.mod(cp0[None, :] + telem_m[:, :, 14],
                            float(self.spec.code_length_chips))
        return trk.EpochTelemetry(
            processed=processed,
            i_e=telem_m[:, :, 0],
            q_e=telem_m[:, :, 1],
            i_p=telem_m[:, :, 2],
            q_p=telem_m[:, :, 3],
            i_l=telem_m[:, :, 4],
            q_l=telem_m[:, :, 5],
            power=telem_m[:, :, 6],
            locked=telem_m[:, :, 7] > 0.5,
            lost_event=telem_m[:, :, 15] > 0.5,
            pll_err=telem_m[:, :, 8],
            dll_err=telem_m[:, :, 9],
            carr_freq=telem_m[:, :, 10],
            code_rate=telem_m[:, :, 11],
            start_offset=start_offset.astype(np.int32),
            epoch_index=epoch_index.astype(np.int32),
            chip_phase=chip_phase.astype(np.float32),
        )

    # ------------------------------------------------------------------
    # telemetry wires of the scan, packed on the card
    # ------------------------------------------------------------------
    def _pack_wire(self, telem_m):
        """slim wire of one block's [T, C, >=17] f32 telemetry: per-epoch
        prompt I/Q (bf16), packed lifecycle flags (int8), drift (int16)
        and chip_res (f32, pseudorange-critical); E/L correlators, loop
        errors and NCO rates at the wire stride (diagnostics)."""
        s = self.wire_stride
        iq_p = telem_m[:, :, 2:4].to(torch.bfloat16)
        flags = (telem_m[:, :, 16] + 2.0 * telem_m[:, :, 7]
                 + 4.0 * telem_m[:, :, 15]).to(torch.int8)
        drift = telem_m[:, :, 13].to(torch.int16)
        cp = telem_m[:, :, 14]
        sub = telem_m[::s]
        sub_el = torch.cat([sub[:, :, 0:2], sub[:, :, 4:6]],
                           dim=2).to(torch.bfloat16)
        sub_errs = sub[:, :, 8:10].to(torch.bfloat16)
        sub_rates = sub[:, :, 10:12]
        return (iq_p, flags, drift, cp, sub_el, sub_errs, sub_rates)

    def _telem_from_wire(self, wire_b, offset0, epochs0, cp0
                         ) -> trk.EpochTelemetry:
        """EpochTelemetry from one block's slim wire (numpy): exact for
        everything the nav path consumes (prompt signs, flags, epoch
        timing, chip phase); E/L, loop errors and rates are stride
        samples repeated across their stride."""
        iq_p, flags, drift, cp, sub_el, sub_errs, sub_rates = wire_b
        t = self.t_epochs
        s = self.wire_stride

        def rep(a):
            return np.repeat(np.asarray(a, np.float32), s, axis=0)[:t]

        i_p = iq_p[:, :, 0].astype(np.float32)
        q_p = iq_p[:, :, 1].astype(np.float32)
        fl = flags.astype(np.int32)
        processed = (fl & 1) > 0
        locked = (fl & 2) > 0
        lost_event = (fl & 4) > 0
        t_idx = np.arange(t, dtype=np.int64)[:, None]
        start_offset = offset0[None, :].astype(np.int64) \
            + t_idx * self.n0 + drift.astype(np.int64)
        epoch_index = epochs0[None, :].astype(np.int64) \
            + np.cumsum(processed, axis=0) - processed
        chip_phase = np.mod(cp0[None, :] + cp,
                            float(self.spec.code_length_chips))
        return trk.EpochTelemetry(
            processed=processed,
            i_e=rep(sub_el[:, :, 0]), q_e=rep(sub_el[:, :, 1]),
            i_p=i_p, q_p=q_p,
            i_l=rep(sub_el[:, :, 2]), q_l=rep(sub_el[:, :, 3]),
            power=i_p * i_p + q_p * q_p,
            locked=locked, lost_event=lost_event,
            pll_err=rep(sub_errs[:, :, 0]),
            dll_err=rep(sub_errs[:, :, 1]),
            carr_freq=rep(sub_rates[:, :, 0]),
            code_rate=rep(sub_rates[:, :, 1]),
            start_offset=start_offset.astype(np.int32),
            epoch_index=epoch_index.astype(np.int32),
            chip_phase=chip_phase.astype(np.float32),
        )

    def _pack_wire2(self, telem_m):
        """slim2: the mxu-exact wire. Per epoch only prompt I/Q (bf16)
        and packed flags (int8) cross; the per-epoch chip/drift ledger is
        replayed on the host from the superstep's held rates and the
        kernel's own increments (cols 17-20, one row per superstep). E/L
        correlators and loop errors ride at 2K stride. Fed by the lean
        telemetry mode, whose col 16 already holds the packed flags."""
        k = self.k_epochs
        iq_p = telem_m[:, :, 2:4].to(torch.bfloat16)
        flags = (telem_m[:, :, 16] + 2.0 * telem_m[:, :, 7]
                 + 4.0 * telem_m[:, :, 15]).to(torch.int8)
        held = telem_m[::k, :, 17:21]                  # [U, C, 4] f32
        sub = telem_m[::2 * k]
        sub_el = torch.cat([sub[:, :, 0:2], sub[:, :, 4:6]],
                           dim=2).to(torch.bfloat16)
        sub_errs = sub[:, :, 8:10].to(torch.bfloat16)
        return (iq_p, flags, held, sub_el, sub_errs)

    def _telem_from_wire2(self, wire_b, offset0, epochs0, cp0
                          ) -> trk.EpochTelemetry:
        """EpochTelemetry from one block's slim2 wire: the chip/drift
        ledger (chip_phase, start_offset) replays the kernel's held-rate
        arithmetic from its own per-epoch increments (cols 19/20,
        constant within a superstep) in f64: drift exactly, chip to
        ~1e-5 chips over a block. Prompt I/Q is bf16; E/L, loop errors
        and rate traces repeat their superstep samples."""
        iq_p, flags, held, sub_el, sub_errs = wire_b
        t = self.t_epochs
        k = self.k_epochs
        u_count = t // k
        c = iq_p.shape[1]
        s2 = 2 * k

        i_p = iq_p[:, :, 0].astype(np.float32)
        q_p = iq_p[:, :, 1].astype(np.float32)
        fl = flags.astype(np.int32)
        processed = (fl & 1) > 0
        locked = (fl & 2) > 0
        lost_event = (fl & 4) > 0

        cf_held = held[:, :, 0]                        # [U, C] f32
        cr_held = held[:, :, 1]
        d_chip = held[:, :, 2].astype(np.float64)
        d_drift = held[:, :, 3].astype(np.float64)
        n_act = processed.reshape(u_count, k, c).sum(1).astype(np.float64)
        ef = np.arange(k, dtype=np.float64)[None, :, None]  # [1, K, 1]
        # superstep-start values: sequential f64 prefix sums
        inc_c = n_act * d_chip                         # [U, C]
        inc_d = n_act * d_drift
        chip0 = np.zeros((u_count, c), np.float64)
        drift0 = np.zeros((u_count, c), np.float64)
        np.cumsum(inc_c[:-1], axis=0, out=chip0[1:])
        np.cumsum(inc_d[:-1], axis=0, out=drift0[1:])
        chip_e = (chip0[:, None, :] + ef * d_chip[:, None, :]
                  ).reshape(t, c)
        drift_e = (drift0[:, None, :] + ef * d_drift[:, None, :]
                   ).reshape(t, c)

        def rep(a, s):
            return np.repeat(np.asarray(a, np.float32), s, axis=0)[:t]

        t_idx = np.arange(t, dtype=np.int64)[:, None]
        start_offset = offset0[None, :].astype(np.int64) \
            + t_idx * self.n0 + drift_e.astype(np.int64)
        epoch_index = epochs0[None, :].astype(np.int64) \
            + np.cumsum(processed, axis=0) - processed
        chip_phase = np.mod(
            cp0[None, :] + np.where(processed, chip_e, 0.0),
            float(self.spec.code_length_chips))
        return trk.EpochTelemetry(
            processed=processed,
            i_e=rep(sub_el[:, :, 0], s2), q_e=rep(sub_el[:, :, 1], s2),
            i_p=i_p, q_p=q_p,
            i_l=rep(sub_el[:, :, 2], s2), q_l=rep(sub_el[:, :, 3], s2),
            power=i_p * i_p + q_p * q_p,
            locked=locked, lost_event=lost_event,
            pll_err=rep(sub_errs[:, :, 0], s2),
            dll_err=rep(sub_errs[:, :, 1], s2),
            carr_freq=rep(cf_held, k),
            code_rate=rep(cr_held, k),
            start_offset=start_offset.astype(np.int32),
            epoch_index=epoch_index.astype(np.int32),
            chip_phase=chip_phase.astype(np.float32),
        )

    # ------------------------------------------------------------------
    # Multi-block scan: the per-block re-anchor and absorb run as torch
    # ops on the card, so the host waits once per span.
    # ------------------------------------------------------------------
    def run_blocks(self, state: trk.ChannelState, stream_re, stream_im,
                   codes_rows, n_blocks: int, extra_args=()
                   ) -> tuple[trk.ChannelState, list[trk.EpochTelemetry]]:
        """Process ``n_blocks`` consecutive blocks with the ledger on the
        card.

        ``stream_re``/``stream_im`` cover ``[history | n_blocks * block]``
        samples (history = the single-block window's history). The
        cross-block ledger stays on the card, chip phase as (int32
        chips, f32 fraction) so per-block rounding stays ~2^-22 chips,
        and the exact u32 host ledger re-absorbs once at the end.
        Telemetry and ledger of all blocks come down in ONE transfer.

        Block b's telemetry offsets are relative to window b (global
        start advances by one block per b); the returned state's offsets
        are already rebased past the whole span (the caller must NOT
        rebase again). ``span_extra``'s output, if set (called with the
        span's stream and ``extra_args``), lands in ``last_span_extra``.
        """
        t = self.timers
        with t.stage("track.launch"):
            handle = self.submit_span(state, stream_re, stream_im,
                                      codes_rows, n_blocks, with_ledger=True,
                                      extra_args=extra_args)
        with t.stage("track.wait"):
            arrays = handle.ys.fetch()
        with t.stage("track.absorb"):
            telems = self._telems_from_arrays(handle, arrays)
            self.last_span_extra = self._extra_from_arrays(handle, arrays)
            return self.absorb_led(state, tuple(arrays[-6:])), telems

    # ------------------------------------------------------------------
    # Pipelined span API: submit_span queues a span without waiting for
    # the card, and the ledger can chain on the card (pass handle.led as
    # the next submit's state); the host downloads telemetry
    # (collect_span) and absorbs the ledger (absorb_led) when it needs
    # them.
    # ------------------------------------------------------------------
    def _led_from_state(self, state: trk.ChannelState):
        """The device ledger (active, offset, epochs, chip_int,
        chip_frac, [C, 7] f32 columns) from a host ChannelState."""
        rate = np.asarray(state.code_rate).astype(np.float32)
        fcols = np.stack([
            np.asarray(state.carr_freq, dtype=np.float32),
            (np.asarray(state.carr_acc).astype(np.float64)
             / _U32).astype(np.float32),
            np.asarray(state.carr_err, dtype=np.float32),
            np.where(rate > 0, rate, np.float32(self.spec.code_rate_hz)),
            np.asarray(state.code_err, dtype=np.float32),
            np.asarray(state.lost_count, dtype=np.float32),
            np.asarray(state.lock_ema, dtype=np.float32),
        ], axis=1)                                     # [C, 7]
        host = (
            np.asarray(state.active).astype(np.float32),
            np.asarray(state.offset).astype(np.int32),
            np.asarray(state.epochs).astype(np.int32),
            np.asarray(state.chip_int).astype(np.int32),
            (np.asarray(state.chip_frac_u32)
             .astype(np.float64) / _U32).astype(np.float32),
            fcols,
        )
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, non_blocking=True) for x in host)

    def _as_stream(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return x.to(self.device, torch.float32,
                    non_blocking=True).contiguous()

    def submit_span(self, led_or_state, stream_re, stream_im, codes_rows,
                    n_blocks: int, with_ledger: bool = False,
                    extra_args=()):
        """Queue one span of ``n_blocks`` blocks. ``led_or_state`` is a
        host ChannelState OR a previous handle's ``led`` (device tuple,
        the chaining path). Nothing here waits for the card: the kernels'
        starts stay on the card, the read bound is checked once for the
        span from the static bound the eligibility rule gives every
        start, ``span_extra`` (if set) is queued after the span's kernels
        on the span's stream, and the span's telemetry (then
        span_extra's outputs and, ``with_ledger``, its final ledger)
        leaves in one non-blocking copy. Returns a handle."""
        if self.layout not in ("direct", "mxu"):
            raise ValueError("run_blocks and the span API require "
                             "layout='direct' or 'mxu'")
        led = (self._led_from_state(led_or_state)
               if hasattr(led_or_state, "_fields") else led_or_state)
        stream_re = self._as_stream(stream_re)
        stream_im = self._as_stream(stream_im)
        block_len = self.t_epochs * self.n0
        # every start of block b is <= b*block + max_offset - el_pad
        # (eligibility: offset_w <= max_offset; a = floor128(off - el_pad));
        # the shared slice reads from base = max(0, max start - spread_cap)
        # to spread_cap past it (ROADMAP C3: with the base clamped at 0,
        # past every window)
        bound = (n_blocks - 1) * block_len + self.max_offset - self.el_pad
        span = fused.direct_span(self.k_epochs, self.n0, self.wp)
        last = ((self.t_epochs - self.k_epochs) * self.n0 // 128) * 128
        end = max(bound, self.spread_cap) + last + span
        if end > stream_re.shape[0]:
            raise ValueError(
                f"span stream too short: {stream_re.shape[0]} samples for "
                f"{n_blocks} blocks (reads to {end})")
        codes_rows = torch.as_tensor(codes_rows).to(self.device)
        outs = []
        for b in range(n_blocks):
            led, y = self._scan_block(led, b, stream_re, stream_im,
                                      codes_rows)
            outs.append(y)
        parts = [torch.stack([y[i] for y in outs])
                 for i in range(len(outs[0]))]
        extra = ()
        if self.span_extra is not None:
            extra = self.span_extra(stream_re, stream_im, *extra_args)
            parts += list(extra)
        if with_ledger:
            parts += list(led)
        return _SpanHandle(led=led, ys=_SpanDownload(parts),
                           n_blocks=n_blocks, n_parts=len(outs[0]),
                           extra_type=type(extra),
                           n_extra=len(extra))

    def _scan_block(self, led, b, stream_re, stream_im, codes_rows):
        """Block b of a span: run_block's re-anchor, kernel and absorb as
        torch ops on the ledger's device, with no host sync. Returns
        (ledger after the block, the block's wire + entry snapshot)."""
        n0, el_pad = self.n0, self.el_pad
        block_len = self.t_epochs * n0
        code_len_i = int(self.spec.code_length_chips)
        active, offset, epochs, ci, cf, fc = led
        act = active > 0.5
        # offset walk (whole periods) + eligibility: run_block's rules
        low = act & (offset < el_pad)
        n_skip = torch.where(
            low, torch.div(el_pad - offset + n0 - 1, n0,
                           rounding_mode="floor"), 0)
        offset_w = offset + n_skip * n0
        epochs = epochs + n_skip
        eligible = act & (offset_w <= self.max_offset)
        # block-start anchor in the kernel's f32 arithmetic, as XLA
        # computes the JAX scan's: x / fs is x * (1/fs), and frac0 one
        # fused multiply-add
        rate = fc[:, 3]
        rate_eff = rate + (fc[:, 0] - float(np.float32(self.if_freq))) \
            * float(np.float32(self.aiding_scale))
        # python floats holding f32 values: the ops round once in f32
        dc0 = rate_eff * float(np.float32(1.0) / np.float32(self.fs))
        cp0 = ci.to(torch.float32) + cf
        s_anchor = torch.floor(cp0 / dc0)
        frac0 = fused._fma(-s_anchor, dc0, cp0)
        anchor = torch.remainder(s_anchor, float(n0))
        # absolute window starts of block b (int32, outside the f32 state
        # columns: they pass 2^24 on long spans)
        off_abs = offset_w + b * block_len
        a_abs = torch.where(
            eligible, torch.clamp(((off_abs - el_pad) >> 7) << 7, min=0), 0)
        starts_arg = a_abs
        if self.spread_cap:
            # B2's guard (anchor_block's), as torch ops: no host sync
            mx = torch.where(eligible, a_abs, 0).max()
            sh_base = torch.clamp(mx - self.spread_cap, min=0)
            eligible = eligible & (a_abs >= sh_base)
            a_abs = torch.where(eligible, a_abs, sh_base)
            starts_arg = torch.cat([a_abs, sh_base[None]])
        col9 = torch.where(eligible, (off_abs - a_abs).to(torch.float32),
                           float(el_pad))
        zero = torch.zeros_like(rate)
        cols = torch.stack([
            fc[:, 0], fc[:, 1], fc[:, 2], rate, zero, fc[:, 4], fc[:, 5],
            eligible.to(torch.float32), zero, col9, frac0, fc[:, 6], zero,
            anchor], dim=1)
        mat = torch.nn.functional.pad(cols, (0, fused.N_FIELDS - 14))
        reps = self._replicas(codes_rows, anchor.to(torch.int64),
                              (col9 - float(el_pad)).to(torch.int64))
        kw = dict(self._kernel_kw,
                  starts_bound=b * block_len + self.max_offset - el_pad)
        if self.layout == "mxu" and self.wire == "slim2":
            # slim2 reads diagnostics at superstep starts only
            kw["telem_mode"] = "lean"
        telem, mat_out = self._kernel(stream_re, stream_im,
                                      starts_arg.to(torch.int32).contiguous(),
                                      reps, mat.contiguous(), **kw)
        # ---- absorb (run_block's numpy, as torch ops) -----------------
        s = cf + mat_out[:, 4]          # |cf| < 1, |delta| < ~4: the
        k = torch.floor(s)              # f32 carry split is exact
        cf_n = torch.where(eligible, s - k, cf)
        ci_raw = ci + k.to(torch.int32)
        ci_wrap = torch.where(ci_raw < 0, ci_raw + code_len_i,
                              torch.where(ci_raw >= code_len_i,
                                          ci_raw - code_len_i, ci_raw))
        ci_n = torch.where(eligible, ci_wrap, ci)
        n_proc = (telem[:, :, 16] > 0.5).sum(dim=0, dtype=torch.int32)
        epochs_n = torch.where(eligible, epochs + n_proc, epochs)
        # rebase folded in: eligible offsets advance by T*n0 + drift and
        # rebase by -block_len (= T*n0)
        offset_n = torch.where(
            eligible, offset_w + mat_out[:, 8].to(torch.int32),
            offset_w - block_len)
        active_n = torch.where(eligible, mat_out[:, 7] > 0.5, act)
        fc_n = torch.where(eligible[:, None], torch.stack([
            mat_out[:, 0], mat_out[:, 1] - torch.floor(mat_out[:, 1]),
            mat_out[:, 2], mat_out[:, 3], mat_out[:, 5], mat_out[:, 6],
            mat_out[:, 11]], dim=1), fc)
        led_n = (active_n.to(torch.float32), offset_n, epochs_n, ci_n,
                 cf_n, fc_n)
        pack = {"slim": self._pack_wire, "slim2": self._pack_wire2,
                "f32": lambda x: (x,)}[self.wire]
        return led_n, (*pack(telem), offset_w, epochs, ci, cf)

    def _telems_from_arrays(self, handle, arrays):
        """Per-block EpochTelemetry from a span's downloaded arrays (the
        wire fields, then the block-entry snapshots, each [B, ...])."""
        n_wire = handle.n_parts - 4
        wire = arrays[:n_wire]
        aux_off, aux_ep, aux_ci, aux_cf = arrays[n_wire:handle.n_parts]
        from_wire = {"slim2": self._telem_from_wire2,
                     "slim": self._telem_from_wire,
                     "f32": lambda w, *a: self._telem_from(w[0], *a)
                     }[self.wire]
        telems = []
        for b in range(handle.n_blocks):
            cp0 = aux_ci[b].astype(np.float64) + aux_cf[b]
            telems.append(from_wire(
                tuple(w[b] for w in wire), aux_off[b].astype(np.int64),
                aux_ep[b].astype(np.int64), cp0))
        return telems

    def _extra_from_arrays(self, handle, arrays):
        """span_extra's downloaded outputs (numpy, in its own tuple
        type), or None when the span ran none."""
        if not handle.n_extra:
            return None
        fields = arrays[handle.n_parts:handle.n_parts + handle.n_extra]
        make = getattr(handle.extra_type, "_make", tuple)
        return make(fields)

    def collect_span(self, handle, with_extra: bool = False):
        """Wait for one span's download (its own event only) and build
        the per-block EpochTelemetry list (``with_extra``: and
        span_extra's outputs, None when it ran none). The ledger stays
        on the card for chaining."""
        arrays = handle.ys.fetch()
        telems = self._telems_from_arrays(handle, arrays)
        if with_extra:
            return telems, self._extra_from_arrays(handle, arrays)
        return telems

    def absorb_led(self, state: trk.ChannelState, led
                   ) -> trk.ChannelState:
        """Fold a ledger (device tensors, downloaded here in one
        transfer, or host arrays) back into the exact host ChannelState
        (the end-of-pipeline / checkpoint sync)."""
        if isinstance(led[0], torch.Tensor):
            led = tuple(_SpanDownload(list(led)).fetch())
        active_f, offset_f, epochs_f, ci_f, cf_f, fc_f = led
        return state._replace(
            active=active_f > 0.5,
            offset=offset_f.astype(np.int32),
            epochs=epochs_f.astype(np.int32),
            lost_count=fc_f[:, 5].astype(np.int32),
            carr_freq=fc_f[:, 0].astype(np.float32),
            carr_acc=np.minimum(
                fc_f[:, 1].astype(np.float64) * _U32, _U32 - 1.0
            ).astype(np.uint32),
            carr_err=fc_f[:, 2].astype(np.float32),
            code_rate=fc_f[:, 3].astype(np.float32),
            chip_int=ci_f.astype(np.int32),
            chip_frac_u32=np.minimum(
                cf_f.astype(np.float64) * _U32, _U32 - 1.0
            ).astype(np.uint32),
            code_err=fc_f[:, 4].astype(np.float32),
            lock_ema=fc_f[:, 6].astype(np.float32),
        )

    def apply_handoffs_device(self, led, channels, carr_freqs, offsets):
        """Start up to MAX_HANDOFFS channels IN the device ledger (the
        pipelined path's start_channel: the next span chains off the
        result without a host sync), as row masks with the host values
        as scalars, so nothing is uploaded. Mirrors trk.start_channel's
        field init; the caller keeps the codes and PRN bookkeeping."""
        active, offset, epochs, ci, cf, fc = led
        row = torch.arange(active.shape[0], device=active.device)
        nominal = float(np.float32(self.spec.code_rate_hz))
        cols = list(fc.unbind(dim=1))
        for ch, fr, off in list(zip(channels, carr_freqs,
                                    offsets))[:MAX_HANDOFFS]:
            m = row == int(ch)
            active = torch.where(m, 1.0, active)
            offset = torch.where(m, int(off), offset)
            epochs = torch.where(m, 0, epochs)
            ci = torch.where(m, 0, ci)
            cf = torch.where(m, 0.0, cf)
            # carr_freq, carr_acc, carr_err, code_rate, code_err, lost,
            # and the handoff lock-EMA grace of 1
            for i, v in enumerate((float(np.float32(fr)), 0.0, 0.0, nominal,
                                   0.0, 0.0, 1.0)):
                cols[i] = torch.where(m, v, cols[i])
        return (active, offset, epochs, ci, cf, torch.stack(cols, dim=1))
