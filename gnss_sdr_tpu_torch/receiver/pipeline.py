"""The receiver: streaming orchestration of acquisition + tracking
(counterpart of ``gnss_sdr_tpu/receiver/pipeline.py``).

  per block:  read + front-end conditioning -> advance window ->
              (paced) PCPS search + handoff -> tracking -> rebase ->
              telemetry / nav / lifecycle

Tracking runs one of two paths, as the JAX package chooses them: with
``correlator="fused"`` the fused whole-block kernel (one launch per full
block, on the seg layout after a segment gather; receiver/fused_runner.py:
mxu, direct, seg or windows, and seg for a block whose epoch count has
no superstep pairing), and otherwise (the default "shift", "exact",
"slice", "pallas") the scanned tracker (tracking.track_block,
``epochs_per_block + 1`` epochs of torch ops on the card, replayed as one
CUDA graph per block shape, "pallas" with one launch of kernel B5 per
epoch). A partial last block (a short final
read, zero-padded) always takes the scanned tracker with the slice
correlator, over its valid samples only.

The digital front end (IF mixing, decimation, DC removal, pulse
blanking, AGC; ops/frontend.py) conditions each raw block on the
receiver's device, its state carried from block to block on the card.

In steady state (``run(scan_blocks=k)``, fused tracker on the mxu or
direct layout; seg and windows run single blocks) spans of k blocks run
through the multi-block scan, the ledger on the card and one download
per span; ``span_pipeline=True``
chains the spans' ledger on the card and downloads each span's telemetry
from a collector thread while the next span runs.

The in-scan search: with the conv acquisition engine (``AcqConfig(
engine="conv")``), the fused tracker on mxu or direct, no FDMA and the
peak_avg detector, the steady re-search is queued inside each span
(``FusedTracker.span_extra``: the conv search over the span stream's
last ``acq_len`` samples, on the 8-row bucket of the scheduler's
candidates) and its results come down with the span's telemetry, so a
steady search costs no separate host round trip. Synchronous spans hand
its candidates off at once; pipelined spans queue them and apply them
to the ledger on the card before the next span (one span late).

Channel lifecycle (Idle -> Tracking -> Lost -> re-search) is a set of
state transitions plus a host-side PRN <-> channel map.

Observables stream while it runs (``enable_observables``): a RINEX 3
OBS file and/or the EKF navigation filter, at most once per ``every_ms``
and attempted once per block, inside spans too.

Every signal of models/constellation.py runs (GPS L1 C/A, Galileo E1B/C,
BeiDou B1I, GLONASS L1OF), each with its nav chain (receiver/navproc.py);
receiver/multi.py runs several over one stream.

A device mesh (``cfg.parallel``, parallel/) shards the tracking
channels: the fused kernel per shard, and the scanned tracker (a fused
receiver's partial tail block too) through
``parallel.sharded_track_block``; on the card over the visible cards, on
the CPU as logical shards of the one CPU device.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Optional

import numpy as np
import torch

from ..config import ReceiverConfig
from ..device import resolve_device
from ..models.constellation import get_signal
from ..ops.frontend import condition_block
from ..utils.profiling import StageTimer
from ..utils.telemetry import TelemetryLog
from . import tracking as trk
from .acquisition import AcquisitionEngine, SearchMode, SearchScheduler
from .fused_runner import FusedTracker
from .navproc import NavProcessor
from .stream import DeviceStreamWindow, SampleSource, StreamWindow


def _on_device(t: torch.Tensor, device: torch.device) -> bool:
    """Whether ``t`` lies on ``device`` (``cuda`` without an index means
    the current card)."""
    if t.device.type != device.type:
        return False
    if device.type == "cpu":
        return True
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return t.device.index == index


class Receiver:
    def __init__(self, cfg: ReceiverConfig, source: SampleSource,
                 device=None, scan_graph: bool = True):
        """``scan_graph=False`` runs the scanned tracker's block eagerly
        on the card instead of as its CUDA graph
        (tracking.track_block_device), for checks that hold the two to
        each other."""
        self.cfg = cfg
        self.scan_graph = scan_graph
        self.source = source
        self.device = resolve_device(device)
        self.spec = get_signal(cfg.acq.signal)

        # digital front end: mixes out the IF and/or decimates before the
        # window, so everything downstream runs at baseband and the
        # (lower) output rate
        self.fs_in = float(source.fs_hz)
        stream_if = float(cfg.f_if_hz)
        self.decim = max(1, cfg.rf.decimation)
        self.mix = cfg.rf.enable_mixing and stream_if != 0.0
        self.dc = cfg.rf.enable_dc_removal
        self.blank_sigma = cfg.rf.pulse_blank_sigma
        self.agc = cfg.rf.enable_digital_agc
        self.conditioning = (self.mix or self.dc or self.decim > 1
                             or self.blank_sigma > 0 or self.agc)
        self.mix_freq = stream_if if self.mix else 0.0
        self.fs = self.fs_in / self.decim
        # downstream timing (code epochs, pseudoranges) uses the derived
        # rate, so a silent mismatch would corrupt every observable
        if abs(cfg.rf.output_sample_rate_hz - self.fs) > 1e-6 * self.fs:
            raise ValueError(
                f"rf.output_sample_rate_hz={cfg.rf.output_sample_rate_hz:g}"
                f" != source fs / decimation = {self.fs_in:g}/{self.decim}"
                f" = {self.fs:g}")
        self.f_if = 0.0 if self.mix else stream_if
        # front-end state carried across blocks: the mixer's u32 phase
        # (a host int), the DC biases and AGC gain (0-dim tensors on the
        # device once the first block is conditioned)
        self._fe_phase = np.uint32(0)
        self._fe_bias_re = np.float32(0.0)
        self._fe_bias_im = np.float32(0.0)
        self._fe_agc_gain = np.float32(1.0)
        # optional device mesh: tracking channels shard as a data-
        # parallel axis (parallel/); on the card over the visible cards,
        # on the CPU as logical shards of the one CPU device
        mesh = None
        par = cfg.parallel
        if par.channel_axis > 1 or par.time_axis > 1:
            from .. import parallel

            mesh = parallel.make_mesh(
                n_time=par.time_axis, n_channel=par.channel_axis,
                devices=self.device if self.device.type == "cpu" else None)
        if cfg.track.correlator not in trk.CORRELATORS:
            raise ValueError(
                f"unknown correlator {cfg.track.correlator!r}; expected "
                f"one of {trk.CORRELATORS}")

        n0 = self.spec.samples_per_code(self.fs)
        self.n0 = n0
        period = self.spec.code_period_ms
        if cfg.block_ms % period:
            raise ValueError(
                f"block_ms={cfg.block_ms} must be a multiple of the "
                f"code period ({period} ms)")
        self.epochs_per_block = cfg.block_ms // period
        self.block = self.epochs_per_block * n0
        if self.spec.name.startswith("galileo_e1"):
            from ..models.codes import galileo_e1 as _gal

            comp = "E1B" if self.spec.name.endswith("b") else "E1C"
            if _gal.using_surrogate_codes(comp):
                import warnings

                warnings.warn(
                    f"signal={self.spec.name!r} is running on SURROGATE "
                    "Galileo E1 codes (the ICD memory codes are data, not "
                    "generatable); real-sky captures will acquire nothing. "
                    "Load the ICD hex tables via "
                    "models.codes.galileo_e1.load_codes_hex().",
                    stacklevel=2,
                )
        self.engine = AcquisitionEngine(cfg.acq, self.spec, self.fs,
                                        self.f_if, device=self.device)
        self.acq_len = self.engine.samples_needed
        # history: the acquisition chunk plus tracking window slack stay
        # addressable behind the frontier
        self.history = self.acq_len + 2 * n0
        self.params = trk.TrackParams.create(cfg.track, self.spec, self.fs,
                                             if_freq_hz=self.f_if)
        if cfg.track.correlator in ("slice", "fused"):
            table = trk.make_sampled_code_table(
                self.spec, self.fs, cfg.acq.n_prn, window=self.params.window)
        else:
            table = trk.make_code_table(self.spec, cfg.acq.n_prn)
        self.codes_full = torch.from_numpy(table).to(self.device)
        self.state = trk.init_state(cfg.track.n_channels)
        if self.device.type == "cpu":
            self.window = StreamWindow(self.history, self.block)
        else:
            self.window = DeviceStreamWindow(self.history, self.block,
                                             self.device)
        self.scheduler = SearchScheduler(cfg.acq)
        # the stages' wall times, each a profiler range named after the
        # signal while a profiler records; the trackers and the nav
        # processor time their sub-steps here
        self.timers = StageTimer(self.spec.name)
        self._span_rowmap = None
        self._pipeline_handoffs: list = []
        self._pipeline_active_mask = None
        self._use_mesh(mesh)
        self.telemetry = TelemetryLog(cfg.track.n_channels)
        self.nav = NavProcessor(
            self.fs, self.spec.code_period_s, self.spec.code_length_chips,
            signal=self.spec.name, timers=self.timers)
        self.active: dict[int, int] = {}   # prn -> channel
        self._codes_key = None
        self._codes_ch = None
        self.time_ms = 0.0
        self.acq_events: list = []
        # streaming observables (enable_observables)
        self._obs_writer = None
        self._obs_every_ms = 0
        self._obs_last_ms = 0.0
        self._obs_last_update_ms = None
        self._obs_week = 0
        self.nav_filter = None

    def _use_mesh(self, mesh) -> None:
        """Give the receiver ``mesh`` (None: no mesh) and build its fused
        tracker with it: the scanned tracker and a fused receiver's
        partial tail block then run channel-sharded
        (parallel.sharded_track_block), the fused kernel per shard
        (parallel.shard_fused_step). The constructor calls it with the
        mesh of ``cfg.parallel``."""
        cfg = self.cfg
        if mesh is not None:
            from ..parallel import sharding

            sharding.shard_rows(cfg.track.n_channels, mesh)
        self.mesh = mesh
        self.fused = None
        if cfg.track.correlator == "fused":
            # "auto" as the JAX package resolves it: the mxu layout and
            # the slim wires on an accelerator, the exact direct layout
            # and the bit-exact f32 wire on the CPU
            layout = cfg.track.fused_layout
            if layout == "auto":
                layout = "direct" if self.device.type == "cpu" else "mxu"
            wire = cfg.track.telemetry_wire
            if wire == "auto":
                if self.device.type == "cpu":
                    wire = "f32"
                else:
                    wire = "slim2" if layout == "mxu" else "slim"
            self.fused = FusedTracker(
                self.params, cfg.track, self.spec, self.fs, self.codes_full,
                self.epochs_per_block, self.history + self.block,
                layout=layout, wire=wire, mesh=mesh, device=self.device,
                timers=self.timers)
        # the in-scan search (the JAX package's conditions): the conv
        # engine's search queued inside each span; FDMA (a search per
        # frequency channel) and the two_peak / cfar detectors keep the
        # boundary search
        self._span_acq = False
        if (self.fused is not None and self.engine.engine == "conv"
                and self.fused.layout in ("direct", "mxu")
                and not cfg.acq.fdma_spacing_hz
                and cfg.acq.detector == "peak_avg"):
            eng, n_acq = self.engine, self.acq_len

            def _span_search(sre, sim, sel):
                # the chunk the boundary search would take: the span
                # stream's last acq_len samples
                return eng.conv_search_device(sre[-n_acq:], sim[-n_acq:],
                                              sel)

            self.fused.span_extra = _span_search
            self._span_acq = True

    # ------------------------------------------------------------------
    def _run_acquisition(self) -> None:
        w0 = self.history + self.block - self.acq_len
        chunk = (self.window.re[w0:], self.window.im[w0:])
        allowed = set(self.scheduler.candidates(set(self.active)))
        if not allowed:
            return
        cands = self.engine.search(chunk, window_offset=w0,
                                   allowed_prns=allowed)
        self.scheduler.mark_run(self.time_ms)
        self._handoff(cands)

    def _handoff(self, cands) -> None:
        """Hand acquisition candidates to idle tracking channels."""
        for cand in cands:
            if cand.prn in self.active:
                continue
            idle = np.where(~np.asarray(self.state.active))[0]
            if idle.size == 0:
                break  # no free channel (the reference drops it too)
            ch = int(idle[0])
            self.state = trk.start_channel(
                self.state, ch, cand.prn - 1, cand.carrier_freq_hz,
                cand.sample_local_index, self.spec.code_rate_hz)
            self.active[cand.prn] = ch
            self.telemetry.open_channel(ch, cand.prn)
            self.nav.open_channel(ch, cand.prn)
            self.acq_events.append((self.time_ms, cand))

    # ------------------------------------------------------------------
    def _pull_block(self):
        """Read one raw block, zero-pad a short read to a full block, and
        run the front-end conditioning on the receiver's device (the raw
        block uploads once; a padded block is conditioned whole, so the
        front-end state advances through the zeros, as in the JAX
        package). A planar pair of tensors on the receiver's device (the
        device sources) is taken as it is and padded there: no host round
        trip. Returns ((re, im), n_valid output samples), or None at end
        of stream."""
        need = self.block * self.decim
        raw = self.source.read(need)
        if raw is None:
            return None
        if isinstance(raw, tuple) and isinstance(raw[0], torch.Tensor):
            re, im = raw
            if not (_on_device(re, self.device)
                    and _on_device(im, self.device)):
                raise ValueError(
                    f"source block on {re.device}/{im.device}, receiver on "
                    f"{self.device}")
            size = int(re.shape[0])
            if size and size < need:
                re = torch.nn.functional.pad(re, (0, need - size))
                im = torch.nn.functional.pad(im, (0, need - size))
        elif isinstance(raw, tuple):
            re, im = (np.asarray(x, dtype=np.float32) for x in raw)
            size = int(re.shape[0])
        else:
            size = raw.size
            re = np.ascontiguousarray(np.real(raw), dtype=np.float32)
            im = np.ascontiguousarray(np.imag(raw), dtype=np.float32)
        if size == 0:
            return None
        if isinstance(re, np.ndarray) and size < need:
            re = np.pad(re, (0, need - size))
            im = np.pad(im, (0, need - size))
        n_valid = -(-size // self.decim)
        dev = self.device
        if not self.conditioning:
            if dev.type == "cpu" and isinstance(re, torch.Tensor):
                re, im = re.numpy(), im.numpy()    # the host window's type
            return (re, im), n_valid
        (re, im, self._fe_phase, self._fe_bias_re, self._fe_bias_im,
         self._fe_agc_gain) = condition_block(
            torch.as_tensor(re).to(dev), torch.as_tensor(im).to(dev),
            np.float32(self.mix_freq), self._fe_phase, self._fe_bias_re,
            self._fe_bias_im, self._fe_agc_gain, fs_hz=self.fs_in,
            alpha=self.cfg.rf.dc_alpha, decimation=self.decim,
            enable_dc=self.dc, enable_mix=self.mix,
            blank_sigma=self.blank_sigma, enable_agc=self.agc)
        if dev.type == "cpu":
            re, im = re.numpy(), im.numpy()
        return (re, im), n_valid

    def step(self) -> bool:
        """Process one block; returns False at end of stream."""
        with self.timers.stage("ingest", self.block * self.decim):
            pulled = self._pull_block()
            if pulled is None:
                return False
        samples, n_valid = pulled
        return self._process_block(samples, n_valid)

    def _process_block(self, samples, n_valid) -> bool:
        t = self.timers
        with t.stage("window", self.block):
            n_fresh = self.window.advance(samples)
        if n_fresh is None:
            return False
        self.time_ms += self.cfg.block_ms

        # paced satellite search over the freshest samples
        with t.stage("lifecycle"):
            self.scheduler.update_mode(len(self.active))
        have_enough = self.window.blocks_fed * self.block >= self.acq_len
        if have_enough and self.scheduler.due(self.time_ms):
            with t.stage("acquire", self.acq_len):
                self._run_acquisition()

        with t.stage("track", self.block):
            # each tracker times its own anchor, launch, wait and absorb
            with t.stage("track.launch"):
                codes = self._codes_for_state()
            if self.fused is not None and n_valid == self.block:
                # the fused kernel: one launch for the block's T epochs
                self.state, telem = self.fused.run_block(
                    self.state, self.window.re, self.window.im, codes)
            elif self.mesh is not None:
                # the scanned tracker channel-sharded over the mesh
                from .. import parallel

                self.state, telem = parallel.sharded_track_block(
                    self.mesh, self.params, codes, self.state,
                    self.window.re, self.window.im,
                    self.epochs_per_block + 1,
                    valid_len=self.history + n_valid, graph=self.scan_graph,
                    timers=t)
            else:
                # the scanned tracker (+1 catch-up epoch); a fused
                # receiver's partial last block lands here too, where
                # "fused" selects the slice correlator
                self.state, telem = trk.track_block(
                    self.params, codes, self.state, self.window.re,
                    self.window.im, self.epochs_per_block + 1,
                    valid_len=self.history + n_valid, graph=self.scan_graph,
                    timers=t)

        with t.stage("nav", self.block):
            self.telemetry.append_block(telem, self.window.global_start)
            if self.cfg.pvt.enable:
                self.nav.feed_block(telem, self.window.global_start)

        with t.stage("lifecycle"):
            # channels lost during this block free their PRN
            lost = np.asarray(telem.lost_event).any(axis=0)
            if lost.any():
                for prn, ch in list(self.active.items()):
                    if lost[ch]:
                        del self.active[prn]
                        self.telemetry.close_channel(ch)
                        self.nav.close_channel(ch)
            self._emit_observables()
            self.state = trk.rebase(self.state, self.block)
        return True

    # ------------------------------------------------------------------
    def _codes_for_state(self) -> torch.Tensor:
        return self._codes_for_prns(np.asarray(self.state.prn_idx))

    def _codes_for_prns(self, prn_idx) -> torch.Tensor:
        """Per-channel replica rows on the device for these PRN rows,
        cached on channel (re)assignment; the index upload does not wait
        for the card."""
        key = tuple(prn_idx.tolist())
        if key != self._codes_key:
            self._codes_key = key
            rows = torch.from_numpy(np.maximum(prn_idx, 0).astype(np.int64))
            self._codes_ch = self.codes_full[
                rows.to(self.device, non_blocking=True)].contiguous()
        return self._codes_ch

    # ------------------------------------------------------------------
    def step_scan(self, k: int) -> int:
        """Process up to ``k`` blocks as one span (FusedTracker.run_blocks:
        the ledger on the card, one download per span). Acquisition never
        runs inside a span; ``run(scan_blocks=...)`` searches at span
        boundaries. A short read (end of stream) takes the single-block
        path. Returns the number of blocks processed (0 at end of
        stream)."""
        full, tail = [], None
        for _ in range(k):
            with self.timers.stage("ingest", self.block * self.decim):
                pulled = self._pull_block()
            if pulled is None:
                break
            samples, n_valid = pulled
            if n_valid == self.block:
                full.append(samples)
            else:
                tail = (samples, n_valid)
                break
        done = 0
        if len(full) == k:
            done += self._process_span(full)
        else:
            for s in full:
                if self._process_block(s, self.block):
                    done += 1
        if tail is not None and self._process_block(*tail):
            done += 1
        return done

    def _emit_span(self, telems, g0) -> None:
        """Telemetry, nav and lifecycle of a span's blocks, block by block
        (block b's window starts at g0 + (b + 1) * block)."""
        for b, telem in enumerate(telems):
            gs = g0 + (b + 1) * self.block
            self.telemetry.append_block(telem, gs)
            if self.cfg.pvt.enable:
                self.nav.feed_block(telem, gs)
            lost = np.asarray(telem.lost_event).any(axis=0)
            if lost.any():
                for prn, ch in list(self.active.items()):
                    if lost[ch]:
                        del self.active[prn]
                        self.telemetry.close_channel(ch)
                        self.nav.close_channel(ch)
            # observables keep their cadence inside a span: all of its
            # telemetry is here
            self.time_ms += self.cfg.block_ms
            self._emit_observables()

    def _span_sel(self):
        """The in-scan search's argument for the next span (its 8-row
        bucket of the scheduler's candidates) and the bucket's rowmap."""
        if not self._span_acq:
            return (), None
        sel, rowmap = self.engine.steady_sel(
            self.scheduler.candidates(set(self.active)))
        return (torch.from_numpy(sel).to(self.device, non_blocking=True),
                ), rowmap

    def _span_candidates(self, extra, rowmap):
        """Candidates from a span's in-scan search when a search is due
        (the scheduler then records it); None when none is due."""
        allowed = set(self.scheduler.candidates(set(self.active)))
        if not allowed:
            return None
        cands = self.engine.candidates_from_conv(
            extra, window_offset=self.history + self.block - self.acq_len,
            allowed_prns=allowed, rowmap=rowmap)
        self.scheduler.mark_run(self.time_ms)
        return cands

    def _process_span(self, blocks: list) -> int:
        """Run ``len(blocks)`` full fresh blocks through the multi-block
        scan; mirrors _process_block's bookkeeping (telemetry, nav,
        lifecycle) from the one downloaded span, then hands off the
        in-scan search's candidates when a search is due."""
        k = len(blocks)
        with self.timers.stage("track", self.block * k):
            # the window rolls past the whole span (state offsets come
            # back already rebased: no trk.rebase here)
            stream_re, stream_im, g0 = self._advance_span_window(blocks)
            extra_args, self._span_rowmap = self._span_sel()
            self.state, telems = self.fused.run_blocks(
                self.state, stream_re, stream_im, self._codes_for_state(),
                k, extra_args=extra_args)
        with self.timers.stage("nav", self.block * k):
            self._emit_span(telems, g0)
        # the in-scan paced re-search: the span already searched the
        # chunk the boundary search would take; mark_run keeps run()'s
        # boundary search from running again
        if self._span_acq and self.fused.last_span_extra is not None:
            have_enough = (self.window.blocks_fed * self.block
                           >= self.acq_len)
            if have_enough and self.scheduler.due(self.time_ms):
                with self.timers.stage("acquire", self.acq_len):
                    cands = self._span_candidates(
                        self.fused.last_span_extra, self._span_rowmap)
                    if cands is not None:
                        self._handoff(cands)
        with self.timers.stage("lifecycle"):
            self.scheduler.update_mode(len(self.active))
        return k

    # ------------------------------------------------------------------
    def _pipeline_quick(self, extra, rowmap=None):
        """The cheap step after a span that must come before the next
        submit: the in-scan search's candidates, queued as handoffs."""
        if (self._span_acq and extra is not None
                and self.scheduler.due(self.time_ms)):
            cands = self._span_candidates(extra, rowmap)
            if cands:
                self._pipeline_handoffs.extend(cands)

    def _collect_pipelined(self, handle, g0, on_block, telems):
        """Consume one collected span: telemetry, nav and lifecycle (a
        lost channel frees its slot in the pipeline's active mask).
        Returns (n_blocks, stop_requested)."""
        with self.timers.stage("nav", self.block * handle.n_blocks):
            lost_before = set(self.active.values())
            self._emit_span(telems, g0)
            if self._pipeline_active_mask is not None:
                for ch in lost_before - set(self.active.values()):
                    self._pipeline_active_mask[ch] = False
        with self.timers.stage("lifecycle"):
            self.scheduler.update_mode(len(self.active))
        stop = bool(on_block is not None and on_block(self))
        return handle.n_blocks, stop

    def _apply_pipeline_handoffs(self, ft, led, prn_idx, k):
        """Start the queued handoffs in the ledger on the card
        (apply_handoffs_device): each detected code boundary re-mapped to
        the window position [n0, 2 n0) of the same code phase (a block
        is a whole number of code periods). Returns the ledger."""
        chans, freqs, offs = [], [], []
        for cand in self._pipeline_handoffs[:8]:
            if cand.prn in self.active:
                continue
            idle = np.where(~self._pipeline_active_mask)[0]
            if idle.size == 0:
                break
            ch = int(idle[0])
            delta = cand.sample_local_index - k * self.block
            chans.append(ch)
            freqs.append(cand.carrier_freq_hz)
            offs.append(self.n0 + delta % self.n0)
            prn_idx[ch] = cand.prn - 1
            self._pipeline_active_mask[ch] = True
            self.active[cand.prn] = ch
            self.telemetry.open_channel(ch, cand.prn)
            self.nav.open_channel(ch, cand.prn)
            self.acq_events.append((self.time_ms, cand))
        self._pipeline_handoffs = []
        if chans:
            led = ft.apply_handoffs_device(led, chans, freqs, offs)
        return led

    def _run_pipelined(self, k: int, budget, on_block):
        """Steady-state span pipeline: spans chain their ledger ON THE
        CARD (FusedTracker.submit_span / handle.led), so span n+1 is
        queued before span n's telemetry is read; the download and the
        host nav overlap the next span's kernels, and the host waits once
        per span for telemetry only. Lost-channel bookkeeping trails by
        one span. Cold and warm acquisition never run pipelined; the
        in-scan search's handoffs are queued when a span lands and
        applied to the ledger on the card before the next submit
        (FusedTracker.apply_handoffs_device), one span late.
        Returns (blocks, eos)."""
        ft = self.fused
        led = self.state                  # first submit uploads host state
        pending = None                    # (handle, g0, rowmap) collected
        done = 0
        leftovers = []
        eos = False
        stop = False
        prn_idx = np.asarray(self.state.prn_idx).copy()
        self._pipeline_handoffs = []
        self._pipeline_active_mask = np.asarray(self.state.active).copy()

        # collector thread: ONLY the download wait and the numpy unpack
        # (FusedTracker.collect_span waits on the span's own event); all
        # receiver-state mutation stays on this thread
        in_q: queue.Queue = queue.Queue(maxsize=1)
        out_q: queue.Queue = queue.Queue(maxsize=1)

        def _collector():
            while True:
                item = in_q.get()
                if item is None:
                    return
                try:
                    out_q.put((ft.collect_span(item, with_extra=True),
                               None))
                except Exception as e:  # noqa: BLE001 - re-raised below
                    out_q.put((None, e))

        th = threading.Thread(target=_collector, daemon=True)
        th.start()

        def pop_pending():
            """Wait for the collector's result for the pending span.
            Returns (handle, g0, telems, the in-scan search's output,
            its rowmap)."""
            nonlocal pending
            handle, g0, rowmap = pending
            with self.timers.stage("track", self.block * handle.n_blocks), \
                    self.timers.stage("track.wait"):
                # the collector's download and unpack of the span
                result, err = out_q.get()
            if err is not None:
                raise err
            pending = None
            return (handle, g0, *result, rowmap)

        try:
            while (not stop
                   and self.scheduler.mode == SearchMode.STEADY
                   and (budget is None
                        or budget - done - (k if pending else 0) >= k)):
                full = []
                for _ in range(k):
                    with self.timers.stage("ingest",
                                           self.block * self.decim):
                        pulled = self._pull_block()
                    if pulled is None:
                        eos = True
                        break
                    samples, n_valid = pulled
                    if n_valid == self.block:
                        full.append(samples)
                    else:
                        leftovers.append((samples, n_valid))
                        eos = True
                        break
                if len(full) < k:
                    # not a full span: the blocks flush through the
                    # single-block path after the pipeline drains
                    leftovers = [(s, self.block) for s in full] + leftovers
                    break
                prev = None
                if pending is not None:
                    # only the cheap step (search -> handoff queue) runs
                    # before the next submit; the span's nav runs after
                    # it, overlapping the next span's kernels
                    prev = pop_pending()
                    self._pipeline_quick(*prev[3:])
                with self.timers.stage("track"):
                    if self._pipeline_handoffs:
                        led = self._apply_pipeline_handoffs(ft, led,
                                                            prn_idx, k)
                    codes_rows = self._codes_for_prns(prn_idx)
                    extra_args, rowmap = self._span_sel()
                    stream_re, stream_im, g0 = \
                        self._advance_span_window(full)
                    with self.timers.stage("track.launch"):
                        handle = ft.submit_span(led, stream_re, stream_im,
                                                codes_rows, k,
                                                extra_args=extra_args)
                led = handle.led
                pending = (handle, g0, rowmap)
                in_q.put(handle)          # the collector waits for it
                if prev is not None:
                    # nav of span n-1 overlaps span n's kernels and copy
                    n_done, s = self._collect_pipelined(*prev[:2], on_block,
                                                        prev[2])
                    done += n_done
                    stop = stop or s
            if pending is not None:
                handle, g0, telems, extra, rowmap = pop_pending()
                n_done, s = self._collect_pipelined(handle, g0, on_block,
                                                    telems)
                self._pipeline_quick(extra, rowmap)
                done += n_done
                stop = stop or s
        finally:
            # shut the collector down on every path (a blocked thread
            # would pin the pending span's buffers)
            try:
                in_q.put_nowait(None)
            except queue.Full:
                pass
            th.join(timeout=30.0)
        # sync the exact host ledger once at pipeline exit (led is still
        # the host state if no span was submitted)
        if led is not self.state:
            self.state = ft.absorb_led(self.state, led)._replace(
                prn_idx=prn_idx.copy())
        self._pipeline_active_mask = None
        if self._pipeline_handoffs:
            # the last span's candidates landed after the last submit:
            # hand them to the synced host ledger (the search is already
            # recorded), each boundary re-mapped into [n0, 2 n0)
            remapped = [dataclasses.replace(
                c, sample_local_index=self.n0 + c.sample_local_index
                % self.n0) for c in self._pipeline_handoffs]
            self._pipeline_handoffs = []
            self._handoff(remapped)
        if not stop:
            for samples, n_valid in leftovers:
                if self._process_block(samples, n_valid):
                    done += 1
                    if on_block is not None and on_block(self):
                        stop = True
                        break
        return done, eos or stop

    def _advance_span_window(self, full):
        """Span framing shared by the synchronous and pipelined paths:
        concatenate [window tail | len(full) fresh blocks] and roll the
        window to the new frontier. On the card the fresh blocks upload
        without waiting. Returns (stream_re, stream_im, g0 = the span's
        window global start)."""
        keep = self.history + self.block
        if isinstance(self.window, DeviceStreamWindow):
            def up(x):
                return torch.as_tensor(x, dtype=torch.float32).to(
                    self.device, non_blocking=True)
            cat = torch.cat
        else:
            def up(x):
                return np.asarray(x, dtype=np.float32)
            cat = np.concatenate
        stream_re = cat([self.window.re[self.block:]]
                        + [up(re) for re, _ in full])
        stream_im = cat([self.window.im[self.block:]]
                        + [up(im) for _, im in full])
        g0 = self.window.global_start
        self.window.load(stream_re[-keep:], stream_im[-keep:])
        self.window.global_start = g0 + len(full) * self.block
        self.window.blocks_fed += len(full)
        return stream_re, stream_im, g0

    # ------------------------------------------------------------------
    def run(self, max_blocks: Optional[int] = None, on_block=None,
            scan_blocks: int = 1, span_pipeline: bool = False) -> dict:
        """Drive the stream; ``on_block(receiver)`` fires after every
        processed block or span, and a truthy return stops the run.

        ``scan_blocks > 1`` enables the steady state of the fused tracker
        (mxu or direct layout; other receivers run single blocks): once
        the scheduler is in steady search mode, spans of that many blocks
        run through the multi-block scan (step_scan), one host wait per
        span, with the paced re-search at span boundaries. Cold and warm
        starts keep single-block steps. ``span_pipeline=True`` also chains the spans'
        ledger on the card (_run_pipelined): span n+1 is queued before
        span n's telemetry is read, and lost-channel bookkeeping trails
        by one span.
        """
        blocks = 0
        can_scan = (scan_blocks > 1 and self.fused is not None
                    and self.fused.layout in ("direct", "mxu"))
        while max_blocks is None or blocks < max_blocks:
            k = 1
            if can_scan and self.scheduler.mode == SearchMode.STEADY:
                k = scan_blocks
                if max_blocks is not None and max_blocks - blocks < k:
                    # a remainder shorter than a span takes single blocks
                    k = 1
            if k > 1 and span_pipeline:
                budget = (None if max_blocks is None
                          else max_blocks - blocks)
                done, stop = self._run_pipelined(k, budget, on_block)
                blocks += done
                if stop or done == 0:
                    break
                continue
            if k > 1:
                done = self.step_scan(k)
                if done == 0:
                    break
                blocks += done
                # paced re-search at the span boundary (the in-span
                # blocks are search-free by construction)
                have_enough = (self.window.blocks_fed * self.block
                               >= self.acq_len)
                if have_enough and self.scheduler.due(self.time_ms):
                    with self.timers.stage("acquire", self.acq_len):
                        self._run_acquisition()
            else:
                if not self.step():
                    break
                blocks += 1
            if on_block is not None and on_block(self):
                break
        return self.summary()

    def enable_observables(self, rinex_path: Optional[str] = None,
                           every_ms: int = 1000, week: int = 0,
                           ekf: bool = False) -> None:
        """Stream per-epoch observables while running: write a RINEX 3
        OBS file and/or run the EKF navigation filter, at most once per
        ``every_ms`` of signal (config ladder 5: observables at streaming
        rate)."""
        from ..nav.rinex_obs import RinexObsWriter

        if rinex_path:
            self._obs_writer = RinexObsWriter(rinex_path)
        self._obs_every_ms = every_ms
        self._obs_week = week
        if ekf:
            from ..nav.filter import NavigationFilter

            self.nav_filter = NavigationFilter()

    def _emit_observables(self) -> None:
        if not self._obs_every_ms:
            return
        if self.time_ms - self._obs_last_ms < self._obs_every_ms:
            return
        obs = self.nav.observables()
        if obs is None:
            return
        self._obs_last_ms = self.time_ms
        dopplers = {}
        for prn, ch in self.active.items():
            tr = self.telemetry.traces.get(ch)
            if tr is not None and tr.carr_freq.size:
                dopplers[prn] = float(np.mean(tr.carr_freq[-20:])) - self.f_if
        if self._obs_writer is not None:
            # live traces only: closed traces of re-acquired PRNs would
            # shadow the current channel's C/N0
            cn0s = {
                t.prn: t.cn0_dbhz(coherent_s=self.spec.code_period_s)
                for t in self.telemetry.traces.values()
            }
            self._obs_writer.write_epoch(
                self._obs_week, obs["rx_time_nominal_s"],
                {prn: (pr, dopplers.get(prn, 0.0), cn0s.get(prn))
                 for prn, pr in zip(obs["prns"], obs["pseudoranges_m"])})
        if self.nav_filter is not None:
            if self.nav_filter.epochs and self._obs_last_update_ms is not None:
                # the time since the last update (observables skip epochs
                # when channels dip)
                self.nav_filter.predict(
                    (self.time_ms - self._obs_last_update_ms) / 1000.0)
            # Doppler makes velocity and clock drift observable;
            # pseudoranges alone let the weak vertical axis drift
            dop = ([dopplers.get(p, 0.0) for p in obs["prns"]]
                   if all(p in dopplers for p in obs["prns"]) else None)
            self.nav_filter.update(
                obs["pseudoranges_m"], obs["ephemerides"],
                obs["transmit_times_s"], dopplers_hz=dop,
                carrier_freq_hz=self.spec.carrier_freq_hz)
            self._obs_last_update_ms = self.time_ms

    def compute_pvt(self, smooth_epochs: int = 0):
        """Single-point PVT from decoded ephemerides + code timing; None
        until >= 4 channels hold ephemeris + TOW, or when the geometry
        exceeds the configured GDOP gate."""
        sol = self.nav.compute_pvt(
            smooth_epochs, self.f_if, self.spec.carrier_freq_hz)
        if sol is not None and sol.gdop > self.cfg.pvt.max_gdop:
            return None
        return sol

    def compute_velocity(self, position=None):
        """Velocity solution from per-channel carrier Doppler (needs a
        position: pass one or have compute_pvt succeed first)."""
        if position is None:
            sol = self.compute_pvt()
            if sol is None:
                return None
            position = sol.position_ecef_m
        dopplers = {}
        for trace_ch, trace in self.telemetry.traces.items():
            if trace.carr_freq.size:
                # settled loop average: the instantaneous PLL output
                # jitters by a few Hz
                recent = trace.carr_freq[-50:]
                dopplers[trace_ch] = float(np.mean(recent)) - self.f_if
        return self.nav.compute_velocity(
            position, dopplers, self.spec.carrier_freq_hz)

    def summary(self) -> dict:
        traces = self.telemetry.all_traces()
        out = {
            "blocks": self.window.blocks_fed,
            "time_ms": self.time_ms,
            "stage_timing": self.timers.report(),
            "tracked_prns": sorted(self.active),
            "nav": self.nav.status(),
            "ephemerides": sorted(self.nav.ephemerides),
            "channels": [
                {
                    "prn": t.prn,
                    "epochs": len(t.i_p),
                    "locked_fraction": (
                        float(np.mean(t.locked)) if t.locked.size else 0.0),
                    "cn0_dbhz": t.cn0_dbhz(
                        coherent_s=self.spec.code_period_s),
                    "last_carr_freq": (
                        float(t.carr_freq[-1]) if t.carr_freq.size else None),
                    "last_doppler_hz": (
                        float(t.carr_freq[-1]) - self.f_if
                        if t.carr_freq.size else None),
                }
                for t in traces
            ],
        }
        if self.spec.name.startswith("galileo_e1"):
            from ..models.codes import galileo_e1 as _gal

            comp = "E1B" if self.spec.name.endswith("b") else "E1C"
            # surfaced so an operator can tell at a glance whether the
            # run used real ICD memory codes or the documented
            # surrogate family (real-sky captures need the ICD tables,
            # models/codes/galileo_e1.load_codes_hex)
            out["code_status"] = {
                "surrogate_codes": _gal.using_surrogate_codes(comp)}
        return out
