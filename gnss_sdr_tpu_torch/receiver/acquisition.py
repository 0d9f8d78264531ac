"""Acquisition engine + adaptive search scheduler (counterpart of
``gnss_sdr_tpu/receiver/acquisition.py``, FFT engine only: circular,
or power-of-two linear with ``pad_fft``).

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
from ..ops import pcps


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
    """Precomputed replica FFTs + one-batch search on ``device``."""

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
        if engine == "conv":
            raise NotImplementedError(
                "engine='conv' (FFT-free matched-filter search) is not "
                "ported yet (ROADMAP A11)")
        if engine != "fft":
            raise ValueError(f"unknown acquisition engine {engine!r}")
        self.engine = engine
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
        # the pow2 linear path correlates two-period blocks: +1 trailing
        # period
        return (n_int + (1 if self.cfg.pad_fft else 0)) * self.n_fft

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
        channel, reported as pseudo-PRN = channel-list index + 1."""
        x = self._complex_chunk(samples)
        if self.cfg.fdma_spacing_hz:
            out = []
            for i, k in enumerate(self.cfg.fdma_channels):
                shift = np.float32(k * self.cfg.fdma_spacing_hz)
                cands = self._search_grid(
                    x, self.grid[:self._base_grid_len] + shift,
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

    def _search_grid(self, x: torch.Tensor, grid: np.ndarray,
                     window_offset: int,
                     allowed_prns: Optional[set[int]] = None
                     ) -> list[Candidate]:
        cfg = self.cfg
        n_int = cfg.non_coherent_ms // self.spec.code_period_ms
        threshold, excl = self._threshold(n_int, grid)
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
        detected = res.detected.cpu().numpy()
        ratios = res.ratio.cpu().numpy()
        peaks = res.peak_power.cpu().numpy()
        lags = res.code_phase_samples.cpu().numpy()
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
