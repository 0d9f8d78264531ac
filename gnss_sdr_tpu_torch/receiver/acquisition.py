"""Acquisition engine + adaptive search scheduler (counterpart of
``gnss_sdr_tpu/receiver/acquisition.py``): the FFT engine (circular, or
power-of-two linear with ``pad_fft``) and the conv engine
(``engine="conv"``: pcps.acquire_conv, whose search the receiver can
also queue inside a span, ``conv_search_device``). ``engine="auto"`` is
the FFT engine on the CPU and on the card, as the JAX package resolves
it on cpu and gpu.

The scheduling policy mirrors the reference's AcquisitionManager
(do_acquisition.rs:33-74): cold/warm/steady modes by tracked-satellite
count, per-mode pacing interval and candidate-list size. The whole PRN
batch is searched in one batch of torch ops on the engine's device; the
candidate list gates handoff eligibility.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..config import AcqConfig
from ..device import resolve_device
from ..models.constellation import SignalSpec
from ..ops import nco, pcps


class SearchMode(enum.Enum):
    COLD = "cold"
    WARM = "warm"
    STEADY = "steady"


@dataclasses.dataclass
class Candidate:
    """One acquisition verdict eligible for tracking handoff, with the
    carrier already fine-refined (reference AcquisitionResult,
    do_acquisition.rs:94-102)."""

    prn: int
    code_phase_samples: int
    code_phase_chips: float
    carrier_freq_hz: float      # includes IF
    ratio: float
    peak_power: float
    sample_local_index: int     # code-boundary sample, window-relative


class SearchScheduler:
    """Cold/warm/steady pacing (reference do_acquisition.rs:50-73)."""

    def __init__(self, cfg: AcqConfig):
        self.cfg = cfg
        self.mode = SearchMode.COLD
        self.last_run_ms: Optional[float] = None

    def update_mode(self, tracked_count: int) -> None:
        if tracked_count >= self.cfg.steady_threshold:
            self.mode = SearchMode.STEADY
        elif tracked_count >= self.cfg.warm_threshold:
            self.mode = SearchMode.WARM
        else:
            self.mode = SearchMode.COLD

    def pacing(self) -> tuple[int, int]:
        return {
            SearchMode.COLD: self.cfg.cold_pacing,
            SearchMode.WARM: self.cfg.warm_pacing,
            SearchMode.STEADY: self.cfg.steady_pacing,
        }[self.mode]

    def candidates(self, active_prns: set[int]) -> list[int]:
        """First ``search_size`` untracked PRNs (do_acquisition.rs:65-68)."""
        _, search_size = self.pacing()
        out = [prn for prn in range(1, self.cfg.n_prn + 1)
               if prn not in active_prns]
        return out[:search_size]

    def due(self, now_ms: float) -> bool:
        interval_ms, _ = self.pacing()
        return (self.last_run_ms is None
                or now_ms - self.last_run_ms >= interval_ms)

    def mark_run(self, now_ms: float) -> None:
        self.last_run_ms = now_ms


class AcquisitionEngine:
    """Precomputed replicas (FFTs, or the conv engine's sampled and
    boxcar-decimated codes) + one-batch search on ``device``."""

    def __init__(self, cfg: AcqConfig, spec: SignalSpec, fs_hz: float,
                 f_if_hz: float = 0.0, device=None):
        self.cfg = cfg
        self.spec = spec
        self.fs_hz = fs_hz
        self.f_if_hz = f_if_hz
        self.device = resolve_device(device)
        self.n_fft = spec.samples_per_code(fs_hz)
        n_code_rows = 1 if cfg.fdma_spacing_hz else cfg.n_prn
        engine = "fft" if cfg.engine == "auto" else cfg.engine
        if engine not in ("fft", "conv"):
            raise ValueError(f"unknown acquisition engine {engine!r}")
        self.engine = engine
        if engine == "conv" and cfg.detector != "peak_avg":
            raise ValueError(
                "engine='conv' supports the peak_avg detector only")
        self.code_ffts = None
        if engine == "fft":
            replica_ffts = (pcps.code_replica_ffts_padded if cfg.pad_fft
                            else pcps.code_replica_ffts)
            self.code_ffts = replica_ffts(spec, fs_hz, n_code_rows,
                                          device=self.device)
        base = pcps.doppler_grid(cfg.doppler_span_hz, cfg.doppler_step_hz)
        self._base_grid_len = base.shape[0]
        self.grid = base + np.float32(f_if_hz)
        self.code_samples = np.stack(
            [spec.sample_code(p, spec.code_rate_hz, fs_hz)
             for p in range(1, n_code_rows + 1)]
        ).astype(np.float32)
        self._code_samples_dev = torch.from_numpy(self.code_samples).to(
            self.device)
        self.decim = 1
        if engine == "conv":
            self.decim = self._pick_decim()
            # boxcar-decimated replicas: the matched filter of
            # boxcar-decimated samples
            coarse = (self.code_samples.reshape(
                n_code_rows, self.n_fft // self.decim, self.decim
            ).mean(axis=-1) if self.decim > 1 else self.code_samples)
            self._codes_coarse_dev = torch.from_numpy(np.ascontiguousarray(
                coarse, dtype=np.float32)).to(self.device)
            self._sel_identity = torch.eye(n_code_rows, dtype=torch.float32,
                                           device=self.device)
            self._grid_dev = torch.from_numpy(np.ascontiguousarray(
                self.grid, dtype=np.float32)).to(self.device)

    def _pick_decim(self) -> int:
        """Coarse-stage decimation (AcqConfig.coarse_decim; 0 picks the
        largest power-of-two divisor of the period's samples that keeps
        >= 1 sample per chip, 2 for BOC)."""
        cfg = self.cfg
        if cfg.coarse_decim:
            r = cfg.coarse_decim
            if r > 1 and self.n_fft % r:
                raise ValueError(f"coarse_decim={r} does not divide "
                                 f"samples/code ({self.n_fft})")
            return r
        floor = self.spec.code_length_chips * (
            2 if self.spec.boc_cycles_per_chip else 1)
        r, k = 1, 2
        while self.n_fft % k == 0 and self.n_fft // k >= floor:
            r, k = k, k * 2
        return r

    @property
    def _fine_squaring(self) -> bool:
        """Square before the fine-Doppler line search when any BPSK
        modulation flips within the coherent window (secondary codes or
        data symbols shorter than 20 ms)."""
        if self.spec.secondary_code is not None:
            return True
        symbol_ms = self.spec.symbols_per_bit * self.spec.code_period_ms
        return symbol_ms < 20

    @property
    def _fine_n_sub(self) -> int:
        """Sub-period split of the squaring fine search's unambiguous
        first stage (pcps._fine_doppler_despread; the JAX package's
        ``_fine_n_sub``): the smallest divisor of the period's sample
        count giving >= 2 parts whose unambiguous range n_sub / (2 *
        T_period) covers half a coarse Doppler bin plus margin."""
        if not self._fine_squaring:
            return 1
        t_period = self.n_fft / self.fs_hz
        need = max(2.0, 2.0 * t_period * (self.cfg.doppler_step_hz / 2.0
                                          + 150.0))
        for s in range(int(np.ceil(need)), 65):
            if self.n_fft % s == 0:
                return s
        return 1

    @property
    def samples_needed(self) -> int:
        n_int = self.cfg.non_coherent_ms // self.spec.code_period_ms
        # the pow2 and conv linear paths correlate two-period blocks: +1
        # trailing period
        extra = 1 if (self.cfg.pad_fft or self.engine == "conv") else 0
        return (n_int + extra) * self.n_fft

    def _planar_chunk(self, samples):
        """(re, im) f32 tensors on the engine's device from a complex
        array or a planar pair of numpy arrays or tensors (tensors
        already there pass through)."""
        if isinstance(samples, tuple):
            return tuple(torch.as_tensor(x, dtype=torch.float32).to(
                self.device) for x in samples)
        x = np.asarray(samples, np.complex64)
        return (torch.from_numpy(np.ascontiguousarray(x.real)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(x.imag)).to(self.device))

    def _complex_chunk(self, samples) -> torch.Tensor:
        """complex64 tensor on the engine's device from a complex array
        or a planar ``(re, im)`` pair of numpy arrays or tensors."""
        if isinstance(samples, tuple):
            re, im = (torch.as_tensor(x, dtype=torch.float32).to(self.device)
                      for x in samples)
            return torch.complex(re, im)
        return torch.as_tensor(np.asarray(samples, np.complex64)).to(
            self.device)

    def search(self, samples, window_offset: int = 0,
               allowed_prns: Optional[set[int]] = None) -> list[Candidate]:
        """Run PCPS (+ fine Doppler) over a ``samples_needed`` chunk.
        ``window_offset`` is the chunk's position inside the caller's
        window, so candidates carry window-relative boundary indices.

        FDMA mode (cfg.fdma_spacing_hz != 0): one search per frequency
        channel, reported as pseudo-PRN = channel-list index + 1. The conv
        engine with a coarse decimation mixes each channel's centre out at
        the full rate first and searches the base grid around it (ROADMAP
        C4: the boxcar decimation ahead of the search would otherwise
        attenuate a channel k * 562.5 kHz off by its response there, -21
        dB at channel +2 with 8.184 MHz / 8, nulls at multiples of
        fs / decim, and the search found nothing)."""
        x = (self._planar_chunk(samples) if self.engine == "conv"
             else self._complex_chunk(samples))
        if self.cfg.fdma_spacing_hz:
            out = []
            base = self.grid[:self._base_grid_len]
            for i, k in enumerate(self.cfg.fdma_channels):
                shift = np.float32(k * self.cfg.fdma_spacing_hz)
                if self.engine == "conv" and self.decim > 1:
                    cands = self._search_grid(self._mix(x, shift), base,
                                              window_offset)
                    for c in cands:
                        c.carrier_freq_hz = float(
                            np.float32(c.carrier_freq_hz) + shift)
                else:
                    cands = self._search_grid(x, base + shift,
                                              window_offset)
                for c in cands:
                    c.prn = i + 1
                    if allowed_prns is None or c.prn in allowed_prns:
                        out.append(c)
            out.sort(key=lambda c: -c.ratio)
            return out
        return self._search_grid(x, self.grid, window_offset, allowed_prns)

    def _threshold(self, n_int: int, grid) -> tuple[float, int]:
        cfg = self.cfg
        if cfg.detector == "two_peak":
            return cfg.two_peak_threshold, int(round(
                cfg.two_peak_exclusion_chips * self.fs_hz
                / self.spec.code_rate_hz))
        if cfg.detector == "cfar":
            return cfg.cfar_scale, 0
        threshold = cfg.detection_threshold
        k = max(1, cfg.coherent_ms // self.spec.code_period_ms)
        if cfg.threshold_auto_scale and (k > 1
                                         or cfg.bit_edge_hypotheses > 1):
            # coherent grouping / hypothesis max-combine change the
            # noise-only peak/avg floor; keep the same margin over it
            threshold = pcps.peak_avg_threshold(
                threshold,
                n_groups=pcps.coherent_group_count(
                    n_int, k, cfg.bit_edge_hypotheses),
                n_cells=float(len(grid)) * self.n_fft,
                hypotheses=cfg.bit_edge_hypotheses)
        return threshold, 0

    def _mix(self, x, freq_hz: float):
        """Planar samples mixed down by ``freq_hz`` (the u32 NCO from
        phase 0, as the searches mix their Doppler bins)."""
        step = nco.freq_to_step(torch.tensor([freq_hz], dtype=torch.float32,
                                             device=self.device), self.fs_hz)
        c, s = nco.cis(nco.phase_ramp(torch.zeros_like(step), step,
                                      x[0].shape[-1]))
        return x[0] * c[0] + x[1] * s[0], x[1] * c[0] - x[0] * s[0]

    def _conv_kw(self, n_int: int, threshold: float) -> dict:
        cfg = self.cfg
        return dict(fs_hz=self.fs_hz, n_int=n_int, decim=self.decim,
                    threshold=threshold, seg_width=cfg.seg_width,
                    fine=cfg.fine_doppler,
                    fine_window_hz=float(cfg.doppler_step_hz),
                    fine_squaring=self._fine_squaring,
                    fine_n_sub=self._fine_n_sub)

    def conv_search_device(self, s_re, s_im, sel=None) -> pcps.AcqResults:
        """The conv search as tensors in and out, with no host sync: the
        in-scan search queues it behind a span's kernels
        (FusedTracker.span_extra) and forms candidates once the span's
        download lands (candidates_from_conv). ``sel`` selects replica
        rows ([B, n_prn] 0/1, default the identity; the steady re-search
        passes the 8-row bucket of steady_sel)."""
        if self.engine != "conv":
            raise ValueError("conv_search_device requires engine='conv'")
        n_int = self.cfg.non_coherent_ms // self.spec.code_period_ms
        sel = (self._sel_identity if sel is None
               else torch.as_tensor(sel, dtype=torch.float32).to(self.device))
        return pcps.acquire_conv(
            s_re, s_im, self._code_samples_dev, self._codes_coarse_dev, sel,
            self._grid_dev,
            **self._conv_kw(n_int, self._default_threshold(n_int,
                                                           self.grid)))

    def steady_sel(self, allowed_prns, rows: int = 8
                   ) -> tuple[np.ndarray, list]:
        """A selection bucket of ``rows`` rows over ``allowed_prns`` and
        its rowmap: the in-scan steady re-search's 8 rows (one shape for
        every span). Zero rows select a zero replica, have zero power and
        are never detected."""
        n_rows = self.code_samples.shape[0]
        rowmap = [p for p in sorted(allowed_prns)
                  if 1 <= p <= n_rows][:rows]
        sel = np.zeros((rows, n_rows), np.float32)
        for i, p in enumerate(rowmap):
            sel[i, p - 1] = 1.0
        return sel, rowmap + [None] * (rows - len(rowmap))

    def candidates_from_conv(self, res, window_offset: int,
                             allowed_prns: Optional[set[int]],
                             rowmap=None) -> list[Candidate]:
        """Candidates from a conv_search_device result (tensors, or the
        numpy arrays of a span's download): the back half of
        _search_conv_grid."""
        res = pcps.AcqResults(*(np.asarray(
            x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
            for x in res))
        if not res.detected.any():
            return []
        if rowmap is None:
            rowmap = list(range(1, self.code_samples.shape[0] + 1))
        return self._build_candidates(res, res.carrier_freq_hz, rowmap,
                                      window_offset, allowed_prns)

    def _default_threshold(self, n_int: int, grid) -> float:
        """The peak_avg threshold with the coherent-grouping rescale (the
        conv engine takes the peak_avg detector only)."""
        return self._threshold(n_int, grid)[0]

    def _search_conv_grid(self, x, grid: np.ndarray, window_offset: int,
                          allowed_prns: Optional[set[int]], *, n_int: int,
                          threshold: float) -> list[Candidate]:
        """One acquire_conv over the candidate list bucketed into the
        replica batch by a selection matmul: 8 rows for up to 8
        candidates (the steady re-search), else every row."""
        n_rows = self.code_samples.shape[0]
        if (allowed_prns is None or self.cfg.fdma_spacing_hz
                or len(allowed_prns) >= n_rows):
            sel = self._sel_identity
            rowmap: list = list(range(1, n_rows + 1))
        else:
            n_sel = sum(1 <= p <= n_rows for p in allowed_prns)
            if not n_sel:
                return []
            sel_np, rowmap = self.steady_sel(
                allowed_prns, 8 if n_sel <= 8 else n_rows)
            sel = torch.from_numpy(sel_np).to(self.device)
        grid_t = torch.from_numpy(
            np.ascontiguousarray(grid, dtype=np.float32)).to(self.device)
        res = pcps.acquire_conv(
            x[0], x[1], self._code_samples_dev, self._codes_coarse_dev, sel,
            grid_t, **self._conv_kw(n_int, threshold))
        return self.candidates_from_conv(res, window_offset, allowed_prns,
                                         rowmap)

    def _search_grid(self, x, grid: np.ndarray, window_offset: int,
                     allowed_prns: Optional[set[int]] = None
                     ) -> list[Candidate]:
        cfg = self.cfg
        n_int = cfg.non_coherent_ms // self.spec.code_period_ms
        threshold, excl = self._threshold(n_int, grid)
        if self.engine == "conv":
            return self._search_conv_grid(
                x, grid, window_offset, allowed_prns, n_int=n_int,
                threshold=threshold)
        grid_t = torch.from_numpy(
            np.ascontiguousarray(grid, dtype=np.float32)).to(self.device)
        res = pcps.pcps_search(
            x, self.code_ffts, grid_t, fs_hz=self.fs_hz, n_int=n_int,
            threshold=threshold, mode=cfg.detector,
            exclusion_samples=excl, pad_fft=cfg.pad_fft,
            n_fft=self.n_fft if cfg.pad_fft else None,
            coherent=max(1, cfg.coherent_ms // self.spec.code_period_ms),
            bit_edge_hypotheses=cfg.bit_edge_hypotheses)
        detected = res.detected.cpu().numpy()
        if not detected.any():
            return []
        freqs = res.carrier_freq_hz
        if cfg.fine_doppler:
            fine = pcps.fine_doppler(
                x, self._code_samples_dev, res.code_phase_samples,
                res.carrier_freq_hz, fs_hz=self.fs_hz, n_int=n_int,
                zero_pad=cfg.fine_doppler_zero_pad,
                window_hz=cfg.doppler_step_hz,
                squaring=self._fine_squaring, n_sub=self._fine_n_sub)
            freqs = torch.where(res.detected, fine, freqs)
        rowmap = list(range(1, self.code_samples.shape[0] + 1))
        return self._build_candidates(res, freqs.cpu().numpy(), rowmap,
                                      window_offset, allowed_prns)

    def _build_candidates(self, res, freqs: np.ndarray, rowmap: list,
                          window_offset: int,
                          allowed_prns: Optional[set[int]]
                          ) -> list[Candidate]:
        detected, ratios, peaks, lags = (
            np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else x)
            for x in (res.detected, res.ratio, res.peak_power,
                      res.code_phase_samples))
        out = []
        for idx in np.where(detected)[0]:
            prn = rowmap[int(idx)]
            if prn is None:
                continue
            if allowed_prns is not None and prn not in allowed_prns:
                continue
            lag = int(lags[idx])
            out.append(Candidate(
                prn=prn,
                code_phase_samples=lag,
                code_phase_chips=lag * self.spec.code_rate_hz / self.fs_hz,
                carrier_freq_hz=float(freqs[idx]),
                ratio=float(ratios[idx]),
                peak_power=float(peaks[idx]),
                sample_local_index=window_offset + lag,
            ))
        out.sort(key=lambda c: -c.ratio)
        return out
