"""Plain reference of the conv acquisition engine's search, in float64:
a coarse search on boxcar-decimated samples, the code phase refined at
the full rate, and a line search of the fine carrier.

Coarse: the chunk's samples averaged in groups of ``decim`` (the
replicas likewise), mixed down per Doppler bin by the uint32 NCO at the
decimated rate, each of ``n_int`` code periods correlated LINEARLY with
the replica over two periods of samples (lags 0..N-1; by FFT of twice
the period), the powers summed; the best bin's peak over the mean of
its other lags is the ratio, detected above the threshold. The mixed
samples are the correlation's operands, rounded by ``rnd`` (bfloat16
is the configuration's stated precision; the control passes float8).

Full rate: the power at the 2 decim + 1 lags around decim times the
coarse lag (the code periodic), the chunk mixed at the best bin's
carrier; the largest is the code phase. Fine carrier: the chunk wiped
by the replica at that phase, mixed to the coarse carrier and summed
per code period; the residual tone searched on ``n_steps`` offsets
within +-``window_hz``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .acquisition import MASK32, U32, _step_u32, as_is, doppler_grid


def bf16(x):
    """Round to bfloat16, kept in the input's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def f8(x):
    """Round to float8 (e4m3), kept in the input's type."""
    return x.to(torch.float8_e4m3fn).to(x.dtype)


def _mixed(re, im, freq_hz: float, fs_hz: float):
    """Planar samples mixed down by the uint32 NCO from phase 0."""
    i = torch.arange(re.shape[-1], dtype=torch.int64, device=re.device)
    phase = (i * _step_u32(float(freq_hz), fs_hz)) & MASK32
    th = phase.to(torch.float64) * (2.0 * math.pi / U32)
    c, s = torch.cos(th), torch.sin(th)
    return re * c + im * s, im * c - re * s


def _decimate(x: torch.Tensor, r: int) -> torch.Tensor:
    if r == 1:
        return x
    n = (x.shape[-1] // r) * r
    return x[..., :n].reshape(*x.shape[:-1], -1, r).mean(dim=-1)


def search(re: torch.Tensor, im: torch.Tensor, codes: dict, fs_hz: float,
           acq: dict, n_int: int, decim: int, threshold: float,
           rnd=as_is, n_steps: int = 129) -> dict:
    """Search ``codes`` ({PRN: [N] sampled code}) in the planar chunk
    ``re``/``im`` ([(n_int + 1) * N] float64, on the device the search
    runs on); returns {PRN: (detected, ratio, lag, carrier Hz)}."""
    if acq["fdma_spacing_hz"] or max(1, acq["coherent_ms"]) > 1 \
            or acq["bit_edge_hypotheses"] > 1:
        raise ValueError("the conv reference searches CDMA signals with "
                         "1 ms coherent groups")
    dev = re.device
    n = next(iter(codes.values())).shape[0]
    nd = n // decim
    fs_c = fs_hz / decim
    grid = doppler_grid(acq["doppler_span_hz"], acq["doppler_step_hz"])
    red, imd = _decimate(re, decim), _decimate(im, decim)
    length = (n_int + 1) * nd
    red, imd = red[:length], imd[:length]
    seg = (torch.arange(n_int, device=dev)[:, None] * nd
           + torch.arange(2 * nd, device=dev)[None, :])
    spectra = []
    for f in grid:
        xr, xi = _mixed(red, imd, float(f), fs_c)
        y = torch.complex(rnd(xr), rnd(xi))[seg]             # [K, 2N']
        spectra.append(torch.fft.fft(y, dim=-1))
    spectra = torch.stack(spectra)                          # [D, K, 2N']
    out = {}
    for prn, code in codes.items():
        full = torch.from_numpy(np.asarray(code, np.float64)).to(dev)
        coarse = rnd(_decimate(full, decim))
        cf = torch.conj(torch.fft.fft(coarse, n=2 * nd))
        corr = torch.fft.ifft(spectra * cf, dim=-1)[..., :nd]
        power = (corr.real ** 2 + corr.imag ** 2).sum(dim=1)  # [D, N']
        best = int(torch.argmax(power.amax(dim=-1)))
        row = power[best]
        lag_c = int(torch.argmax(row))
        peak = float(row[lag_c])
        avg = (float(row.sum()) - peak) / (nd - 1)
        ratio = peak / max(avg, 1e-20)
        freq0 = float(grid[best])
        lag = _refine(re, im, full, lag_c * decim, freq0, fs_hz, n_int,
                      decim) if decim > 1 else lag_c
        freq = freq0
        if acq.get("fine_doppler", True):
            freq = _fine(re, im, full, lag, freq0, fs_hz, n_int,
                         float(acq["doppler_step_hz"]), n_steps)
        out[prn] = (ratio > threshold, ratio, lag, freq)
    return out


def _refine(re, im, code, lag0_c: int, freq: float, fs_hz: float,
            n_int: int, half_width: int) -> int:
    n = code.shape[0]
    w = 2 * half_width + 1
    pad = torch.zeros(w, dtype=re.dtype, device=re.device)
    mr, mi = _mixed(torch.cat([re, pad]), torch.cat([im, pad]), freq, fs_hz)
    lag0 = lag0_c - half_width
    lag0 = lag0 + n if lag0 < 0 else lag0
    k = torch.arange(n_int, device=re.device)[:, None] * n
    powers = []
    for v in range(w):
        idx = k + lag0 + v + torch.arange(n, device=re.device)[None, :]
        cr, ci = (mr[idx] * code).sum(-1), (mi[idx] * code).sum(-1)
        powers.append(float((cr * cr + ci * ci).sum()))
    lag = lag0 + int(np.argmax(powers))
    return lag % n


def _fine(re, im, code, lag: int, f0: float, fs_hz: float, n_int: int,
          window_hz: float, n_steps: int) -> float:
    n = code.shape[0]
    length = n_int * n
    rep = torch.roll(code, lag).repeat(n_int)
    x = torch.complex(re[:length], im[:length]) * rep
    i = torch.arange(length, dtype=torch.float64, device=re.device)
    th = f0 / fs_hz * i
    th = (th - torch.floor(th)) * (2.0 * math.pi)
    z = (x * torch.polar(torch.ones_like(th), -th)).reshape(n_int, n).sum(-1)
    deltas = torch.linspace(-window_hz, window_hz, n_steps,
                            dtype=torch.float64, device=re.device)
    t_m = torch.arange(n_int, dtype=torch.float64, device=re.device) * (
        n / fs_hz)
    ph = 2.0 * math.pi * deltas[:, None] * t_m[None, :]
    tone = (z[None, :] * torch.polar(torch.ones_like(ph), -ph)).sum(-1).abs()
    return f0 + float(deltas[int(torch.argmax(tone))])
