"""Plain reference of the PCPS acquisition search (FFT circular
correlation, peak/average detector, zero-padded FFT fine Doppler),
the benchmark's own version in float64.

For each searched PRN and Doppler bin: the chunk mixed down by an NCO
whose per-sample step is the bin frequency as a uint32 cycle fraction,
split into ``n_int`` code periods, each circularly correlated with the
sampled code by FFT and its power summed non-coherently. The bin with
the highest peak is kept; ratio = peak / mean of the bin's other lags;
detected where ratio > threshold. A detection's carrier is refined by a
zero-padded FFT of the code-wiped chunk, searched within one Doppler
step of the bin.

``rnd`` rounds every intermediate result: identity for the reference,
bfloat16 for the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

U32 = 4294967296.0
MASK32 = 0xFFFFFFFF


def as_is(x):
    return x


def bf16(x):
    """Round to bfloat16 (complex: each part), kept in float32."""
    if x.is_complex():
        return torch.complex(bf16(x.real), bf16(x.imag))
    return x.to(torch.bfloat16).to(torch.float32)


def _step_u32(freq_hz: float, fs_hz: float) -> int:
    """The search NCO's step: f32(f) / f32(fs) in f32, its fraction as
    a rounded uint32."""
    c = np.float32(np.float32(freq_hz) / np.float32(fs_hz))
    frac = np.float32(c - np.floor(c))
    return int(min(max(np.round(np.float64(frac) * U32), 0), MASK32))


def doppler_grid(span_hz: float, step_hz: float) -> np.ndarray:
    n = int(span_hz / step_hz) + 1
    return (-span_hz / 2.0 + np.arange(n) * step_hz).astype(np.float32)


def fine_plan(fs_hz: float, n_fft: int, step_hz: float, squaring: bool
              ) -> int:
    """The squaring search's split of a code period: the smallest
    divisor of its samples giving >= 2 parts whose unambiguous range
    covers half a Doppler step plus margin (1: no split)."""
    if not squaring:
        return 1
    need = max(2.0, 2.0 * (n_fft / fs_hz) * (step_hz / 2.0 + 150.0))
    for s in range(int(np.ceil(need)), 65):
        if n_fft % s == 0:
            return s
    return 1


def search(x: torch.Tensor, codes: dict, fs_hz: float, acq: dict,
           n_int: int, f_offset_hz: float = 0.0, squaring: bool = False,
           rnd=as_is) -> dict:
    """Search ``codes`` ({PRN: [N] sampled code}) in the complex chunk
    ``x`` ([n_int * N], on the device the search runs on); returns {PRN: (detected, ratio, lag, carrier
    Hz)}. ``f_offset_hz`` shifts the Doppler grid (an FDMA channel);
    ``squaring`` refines the carrier on squared despread period sums
    (a signal whose symbols or secondary code flip inside the search)."""
    hi = rnd is as_is
    cdt = torch.complex128 if hi else torch.complex64
    rdt = torch.float64 if hi else torch.float32
    n_fft = next(iter(codes.values())).shape[0]
    length = n_int * n_fft
    grid = doppler_grid(acq["doppler_span_hz"], acq["doppler_step_hz"]) \
        + np.float32(f_offset_hz)
    dev = x.device
    xs = rnd(x[:length].to(cdt))
    i = torch.arange(length, dtype=torch.int64, device=dev)
    lo = []
    for f in grid:
        phase = (i * _step_u32(float(f), fs_hz)) & MASK32
        th = phase.to(rdt) * (2.0 * math.pi / U32)
        lo.append(torch.complex(torch.cos(th), -torch.sin(th)))
    lo = rnd(torch.stack(lo))                                   # [D, L]
    spectra = rnd(torch.fft.fft(rnd(xs[None, :] * lo).reshape(
        len(grid), n_int, n_fft), dim=-1))
    out = {}
    for prn, code in codes.items():
        cf = rnd(torch.conj(torch.fft.fft(torch.from_numpy(
            code.astype(np.float64)).to(dev, cdt))))
        power = torch.zeros((len(grid), n_fft), dtype=rdt, device=dev)
        for g in range(n_int):
            corr = rnd(torch.fft.ifft(rnd(spectra[:, g, :] * cf), dim=-1))
            power = rnd(power + rnd(corr.abs() ** 2))
        best = int(torch.argmax(power.amax(dim=-1)))
        row = power[best]
        lag = int(torch.argmax(row))
        peak = row[lag]
        avg = rnd((row.sum() - peak) / (n_fft - 1))
        ratio = float(peak / max(float(avg), 1e-20))
        det = ratio > acq["detection_threshold"]
        freq = float(grid[best])
        if det and acq.get("fine_doppler", True):
            if squaring:
                freq = _fine_squared(
                    xs, code, lag, freq, fs_hz, n_int,
                    acq["doppler_step_hz"],
                    fine_plan(fs_hz, n_fft, acq["doppler_step_hz"], True),
                    rnd, cdt, rdt)
            else:
                freq = _fine(xs, code, lag, freq, fs_hz, n_int,
                             acq["fine_doppler_zero_pad"],
                             acq["doppler_step_hz"], rnd, cdt, rdt)
        out[prn] = (det, ratio, lag, freq)
    return out


def _fine(xs, code, lag, f0, fs_hz, n_int, zero_pad, window_hz, rnd, cdt,
          rdt):
    n_fft = code.shape[0]
    length = n_int * n_fft
    rep = torch.from_numpy(np.roll(code.astype(np.float64), lag)).to(
        xs.device, cdt)
    wiped = rnd(xs[:length] * rep.repeat(n_int))
    pad = zero_pad * length
    spec = rnd(torch.fft.fft(wiped, n=pad))
    freqs = torch.fft.fftfreq(pad, d=1.0 / fs_hz, dtype=rdt,
                              device=xs.device)
    mag = torch.where(torch.abs(freqs - f0) <= window_hz, spec.abs(),
                      torch.full_like(freqs, -math.inf))
    return float(freqs[int(torch.argmax(mag))])


def _fine_squared(xs, code, lag, f0, fs_hz, n_int, window_hz, n_sub, rnd,
                  cdt, rdt, n_steps=129):
    """The squaring fine search: the code-wiped chunk mixed to the coarse
    carrier and summed per code period (in ``n_sub`` parts, whose phase
    slope gives a first estimate delta1, the parts then derotated and
    summed), the period sums squared, the residual tone searched on
    ``n_steps`` offsets; f0 + delta1 + half the tone's offset."""
    n_fft = code.shape[0]
    length = n_int * n_fft
    two_pi = 2.0 * math.pi
    dev = xs.device
    rep = torch.from_numpy(np.roll(code.astype(np.float64), lag)).to(
        dev, cdt)
    wiped = rnd(xs[:length] * rep.repeat(n_int))
    i = torch.arange(length, dtype=rdt, device=dev)
    theta = float(f0) / float(fs_hz) * i
    theta = (theta - torch.floor(theta)) * two_pi
    w = rnd(wiped * torch.polar(torch.ones_like(theta), -theta))
    delta1 = 0.0
    if n_sub > 1:
        t_sub = n_fft / n_sub / fs_hz
        span = min(2.0 * window_hz, 0.45 * fs_hz / n_fft)
        sub = rnd(w.reshape(n_int, n_sub, n_fft // n_sub).sum(-1))
        xprod = (sub[:, 1:] * sub[:, :-1].conj()).sum()
        delta1 = float(torch.angle(xprod)) / (two_pi * t_sub)
        ts = (torch.arange(n_int, dtype=rdt, device=dev)[:, None] * n_fft
              + torch.arange(n_sub, dtype=rdt, device=dev)[None, :]
              * (n_fft // n_sub)) / float(fs_hz)
        ang = two_pi * delta1 * ts
        z = rnd((sub * torch.polar(torch.ones_like(ang), -ang)).sum(-1))
    else:
        span = 2.0 * window_hz
        z = rnd(w.reshape(n_int, n_fft).sum(-1))
    z = rnd(z * z)
    deltas = torch.linspace(-span, span, n_steps, dtype=rdt, device=dev)
    t_m = torch.arange(n_int, dtype=rdt, device=dev) * (n_fft / fs_hz)
    ph = two_pi * deltas[:, None] * t_m[None, :]
    tone = (z[None, :] * torch.polar(torch.ones_like(ph), -ph)).sum(-1).abs()
    pick = (tone == tone.max()).to(rdt)
    d_star = float((pick * deltas).sum() / pick.sum())
    return float(f0) + delta1 + 0.5 * d_star

