"""Batched PCPS (parallel code phase search) acquisition on torch tensors
(counterpart of ``gnss_sdr_tpu/ops/pcps.py``): the FFT engine and the
FFT-free conv engine.

The whole PRN x Doppler x integration cube is one batch of plain torch
ops (``torch.fft`` runs on cuFFT on the card):

    power[p, d, n] = sum_c | ifft( fft(x_c * e^{-j2pi f_d i/fs})
                                   * conj(CODE_FFT_p) ) |^2

The JAX package's ``lax.scan`` over coherent groups becomes a Python
loop. Detection is the reference detector: peak power / average power of
the best Doppler bin (peak excluded) > threshold. ``pad_fft=True`` takes
the power-of-two linear-correlation path (``pcps_power_padded``: plain
XLA FFTs in the JAX package, ``torch.fft`` here). The fine Doppler's
squaring search despreads before it squares, where the JAX FFT engine
does not (``fine_doppler``; ROADMAP C16).

The conv engine (``acquire_conv``: a coarse search on boxcar-decimated
samples, full-rate lag refinement and a line-search fine Doppler) is
the JAX package's matched filter as a convolution: its
``conv_general_dilated`` is a plain XLA op outside any Pallas kernel,
here ``torch.nn.functional.conv1d`` (a cross-correlation, as the JAX
op), and its selection matmul ``sel @ codes`` is ``torch.matmul``. It
runs as one function of tensor ops, with no host sync and no host
branch on the data, so the receiver can queue it behind a span's
kernels (the in-scan search, ``FusedTracker.span_extra``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.constellation import SignalSpec
from . import nco


class AcqResults(NamedTuple):
    """Structure-of-arrays acquisition verdict over the PRN batch;
    ``carrier_freq_hz`` includes the IF."""

    detected: torch.Tensor          # [P] bool, ratio > threshold
    ratio: torch.Tensor             # [P] f32 peak/avg statistic
    peak_power: torch.Tensor        # [P] f32
    code_phase_samples: torch.Tensor  # [P] i32 lag of the peak
    carrier_freq_hz: torch.Tensor   # [P] f32, f_if + doppler of best bin


def doppler_grid(span_hz: float, step_hz: float) -> np.ndarray:
    """Symmetric Doppler grid: span/step + 1 bins from -span/2."""
    n = int(span_hz / step_hz) + 1
    return (-span_hz / 2.0 + np.arange(n) * step_hz).astype(np.float32)


def code_replica_ffts(spec: SignalSpec, fs_hz: float, n_prn: int,
                      device=None) -> torch.Tensor:
    """[P, N] complex64 FFTs of the sampled code replicas (numpy FFT in
    float64, rounded once, exactly as the JAX package builds them)."""
    reps = np.stack(
        [spec.sample_code(p, spec.code_rate_hz, fs_hz)
         for p in range(1, n_prn + 1)]
    ).astype(np.float32)
    return torch.from_numpy(
        np.fft.fft(reps, axis=-1).astype(np.complex64)).to(device)


def _ramp_start(step: torch.Tensor, sample_offset: int) -> torch.Tensor:
    """The u32 NCO phase at global sample ``sample_offset`` of a ramp
    that starts at phase 0 at sample 0: ``step * sample_offset`` mod
    2**32 (the offset taken mod 2**32 first, as the JAX package's uint32
    cast; int64 masked, the product's low 32 bits exact)."""
    return (step * (int(sample_offset) & nco.MASK32)) & nco.MASK32


def _lo(carrier_freqs: torch.Tensor, fs_hz: float, n: int,
        sample_offset: int = 0) -> torch.Tensor:
    """[D, n] complex64 local oscillator e^{-j theta} from the exact
    uint32 NCO ramp, its first sample the global sample
    ``sample_offset``: time shards of one chunk keep its exact phase."""
    step = nco.freq_to_step(carrier_freqs, fs_hz)              # [D]
    c, s = nco.cis(nco.phase_ramp(_ramp_start(step, sample_offset), step,
                                  n))
    return torch.complex(c, -s)


def pcps_power(
    samples: torch.Tensor,        # [n_int * N] complex64
    code_ffts: torch.Tensor,      # [P, N] complex64
    carrier_freqs: torch.Tensor,  # [D] f32
    *,
    fs_hz: float,
    n_int: int,
    coherent: int = 1,
    bit_edge_hypotheses: int = 1,
    sample_offset: int = 0,
) -> torch.Tensor:
    """Integrated correlation power cube [P, D, N].

    ``coherent=k`` sums k consecutive 1-period spectra before the IFFT
    and squaring (FFT linearity); ``bit_edge_hypotheses=H > 1``
    re-anchors the k-period grouping at H offsets over one coherent
    length and max-combines the cubes (see the JAX package's docstring
    for the detection trade-offs). ``sample_offset``: the global index of
    ``samples[0]``, where the Doppler mix's phase ramp starts, so a time
    shard of a longer chunk mixes exactly as the whole chunk would
    (parallel.time_sharded_pcps_search)."""
    n_fft = code_ffts.shape[-1]
    if n_int % coherent:
        raise ValueError(f"n_int={n_int} not divisible by coherent={coherent}")
    lo = _lo(carrier_freqs, fs_hz, n_int * n_fft, sample_offset)
    shifted = (samples[None, :] * lo).reshape(-1, n_int, n_fft)
    spectra = torch.fft.fft(shifted, dim=-1)                 # [D, n_int, N]
    conj_codes = torch.conj(code_ffts)
    d = spectra.shape[0]

    def integrate(grouped):                                  # [D, G, N]
        power = torch.zeros((code_ffts.shape[0], d, n_fft),
                            dtype=torch.float32, device=samples.device)
        for g in range(grouped.shape[1]):
            prod = grouped[None, :, g, :] * conj_codes[:, None, :]
            power = power + torch.abs(torch.fft.ifft(prod, dim=-1)) ** 2
        return power

    if bit_edge_hypotheses <= 1 or coherent <= 1:
        n_groups = n_int // coherent
        return integrate(
            spectra.reshape(d, n_groups, coherent, n_fft).sum(dim=2))

    k = coherent
    h_n = min(bit_edge_hypotheses, k)
    offsets = sorted({(j * k) // h_n for j in range(h_n)})
    g_min = min((n_int - h) // k for h in offsets)
    if g_min < 1:
        raise ValueError(
            f"n_int={n_int} too short for coherent={k} with "
            f"bit-edge offsets up to {offsets[-1]}")
    best = None
    for h in offsets:
        cube = integrate(spectra[:, h:h + g_min * k].reshape(
            d, g_min, k, n_fft).sum(dim=2))
        best = cube if best is None else torch.maximum(best, cube)
    return best


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def pcps_power_padded(
    samples: torch.Tensor,          # [(n_int + 1) * N] complex64
    code_fft_padded: torch.Tensor,  # [P, M] complex64, M = next_pow2(2N)
    carrier_freqs: torch.Tensor,    # [D] f32
    *,
    fs_hz: float,
    n_int: int,
    n_fft: int,
    coherent: int = 1,
    sample_offset: int = 0,
) -> torch.Tensor:
    """Power cube [P, D, N] via power-of-two FFTs: each integration
    correlates a two-period block against the zero-padded code with
    M-point transforms, so lags 0..N-1 are exact linear correlations
    (noise does not wrap; peak locations equal the circular path's).
    Needs one extra code period of trailing samples. ``coherent`` groups
    sum their spectra, and ``sample_offset`` starts the mix's phase ramp,
    as in pcps_power."""
    if n_int % coherent:
        raise ValueError(f"n_int={n_int} not divisible by coherent={coherent}")
    m = code_fft_padded.shape[-1]
    shifted = samples[None, :] * _lo(carrier_freqs, fs_hz,
                                     samples.shape[-1],
                                     sample_offset)         # [D, L + N]
    conj_codes = torch.conj(code_fft_padded)
    power = torch.zeros((code_fft_padded.shape[0], shifted.shape[0], n_fft),
                        dtype=torch.float32, device=samples.device)
    for g in range(n_int // coherent):
        spec = 0
        for j in range(coherent):
            start = (g * coherent + j) * n_fft
            spec = spec + torch.fft.fft(shifted[:, start:start + 2 * n_fft],
                                        n=m, dim=-1)        # [D, M]
        prod = spec[None, :, :] * conj_codes[:, None, :]    # [P, D, M]
        corr = torch.fft.ifft(prod, dim=-1)[..., :n_fft]
        power = power + torch.abs(corr) ** 2
    return power


def code_replica_ffts_padded(spec: SignalSpec, fs_hz: float, n_prn: int,
                             device=None) -> torch.Tensor:
    """[P, M] FFTs of the code replicas zero-padded to M = next_pow2(2N)
    (numpy FFT in float64, rounded once, as the JAX package builds
    them)."""
    n = spec.samples_per_code(fs_hz)
    reps = np.zeros((n_prn, _next_pow2(2 * n)), np.float32)
    for p in range(1, n_prn + 1):
        reps[p - 1, :n] = spec.sample_code(p, spec.code_rate_hz, fs_hz)
    return torch.from_numpy(
        np.fft.fft(reps, axis=-1).astype(np.complex64)).to(device)


def coherent_group_count(n_int: int, coherent: int,
                         bit_edge_hypotheses: int = 1) -> int:
    """Number of non-coherent groups the power cube integrates (mirrors
    pcps_power's grouping)."""
    if bit_edge_hypotheses <= 1 or coherent <= 1:
        return max(1, n_int // max(1, coherent))
    k = coherent
    h_n = min(bit_edge_hypotheses, k)
    offsets = sorted({(j * k) // h_n for j in range(h_n)})
    return min((n_int - h) // k for h in offsets)


def _gamma_sf(n: int, x: float) -> float:
    """Survival function Q(n, x) of Gamma(n, 1) for integer n, in log
    space."""
    if x <= 0.0:
        return 1.0
    terms = [-x + i * math.log(x) - math.lgamma(i + 1) for i in range(n)]
    m = max(terms)
    return math.exp(m) * sum(math.exp(t - m) for t in terms)


def _max_ratio_median(n_groups: int, n_cells: float) -> float:
    """Median of the noise-only peak/avg statistic: n_cells iid
    Gamma(n_groups) cells, solved by bisection."""
    target = math.log(2.0) / max(n_cells, 1.0)
    lo, hi = 1.0, 400.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _gamma_sf(n_groups, n_groups * mid) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def peak_avg_threshold(
    t_ref: float,
    *,
    n_groups: int,
    n_cells: float,
    hypotheses: int = 1,
    ref_groups: int = 10,
    ref_cells: float = 29.0 * 2046.0,
) -> float:
    """Scale the reference peak/avg threshold (7.0 at 10 x 1 ms
    non-coherent) to another integration mode, keeping the margin over
    the noise-floor median."""
    margin = t_ref / _max_ratio_median(ref_groups, ref_cells)
    return margin * _max_ratio_median(n_groups,
                                      n_cells * max(1, hypotheses))


def detect(
    power: torch.Tensor,          # [P, D, N]
    carrier_freqs: torch.Tensor,  # [D]
    threshold: float,
    mode: str = "peak_avg",
    exclusion_samples: int = 0,
) -> AcqResults:
    """Detector over the power cube: ``peak_avg`` (peak / mean of the
    rest of the best bin), ``two_peak`` (first / second peak outside a
    circular guard band) or ``cfar`` (peak / mean)."""
    n_fft = power.shape[-1]
    peak_per_bin = power.amax(dim=-1)                         # [P, D]
    best_bin = torch.argmax(peak_per_bin, dim=-1)             # [P]
    bin_power = torch.gather(
        power, 1, best_bin[:, None, None].expand(-1, 1, n_fft))[:, 0, :]
    code_phase = torch.argmax(bin_power, dim=-1).to(torch.int32)
    peak = bin_power.amax(dim=-1)
    floor = torch.tensor(1e-20, dtype=torch.float32, device=power.device)
    if mode == "two_peak":
        lag = torch.arange(n_fft, dtype=torch.int32,
                           device=power.device)[None, :]
        dist = torch.abs(lag - code_phase[:, None])
        dist = torch.minimum(dist, n_fft - dist)
        masked = torch.where(dist <= exclusion_samples,
                             torch.full_like(bin_power, -math.inf),
                             bin_power)
        ratio = peak / torch.maximum(masked.amax(dim=-1), floor)
    elif mode == "cfar":
        ratio = peak / torch.maximum(bin_power.mean(dim=-1), floor)
    elif mode == "peak_avg":
        avg = (bin_power.sum(dim=-1) - peak) / torch.tensor(
            n_fft - 1, dtype=torch.float32, device=power.device)
        ratio = peak / torch.maximum(avg, floor)
    else:
        raise ValueError(f"unknown detector {mode!r}")
    return AcqResults(
        detected=ratio > threshold,
        ratio=ratio,
        peak_power=peak,
        code_phase_samples=code_phase,
        carrier_freq_hz=carrier_freqs[best_bin],
    )


def pcps_search(
    samples: torch.Tensor,        # [n_int * N] complex64 (circular) or
                                  # [(n_int + 1) * N] (pad_fft)
    code_ffts: torch.Tensor,      # [P, N] (circular) or [P, M] (pad_fft)
    carrier_freqs: torch.Tensor,  # [D] f32 = f_if + doppler grid
    *,
    fs_hz: float,
    n_int: int,
    threshold: float = 7.0,
    mode: str = "peak_avg",
    exclusion_samples: int = 0,
    pad_fft: bool = False,
    n_fft: int | None = None,
    coherent: int = 1,
    bit_edge_hypotheses: int = 1,
) -> AcqResults:
    """Search all PRNs over all Doppler bins in one batch: circular
    correlation over ``n_int`` code periods, or with ``pad_fft=True`` the
    power-of-two linear path (``code_ffts`` from
    code_replica_ffts_padded, ``n_fft`` one code period in samples;
    ``bit_edge_hypotheses`` applies to the circular path only)."""
    if pad_fft:
        if n_fft is None:
            raise ValueError("pad_fft path requires n_fft")
        if samples.shape[-1] != (n_int + 1) * n_fft:
            raise ValueError(
                f"pad_fft needs {n_int + 1}x{n_fft} samples, "
                f"got {samples.shape[-1]}")
        power = pcps_power_padded(
            samples, code_ffts, carrier_freqs, fs_hz=fs_hz, n_int=n_int,
            n_fft=n_fft, coherent=coherent)
    else:
        n_fft = code_ffts.shape[-1]
        if samples.shape[-1] != n_int * n_fft:
            raise ValueError(
                f"need {n_int}x{n_fft} samples, got {samples.shape[-1]}")
        power = pcps_power(
            samples, code_ffts, carrier_freqs, fs_hz=fs_hz, n_int=n_int,
            coherent=coherent, bit_edge_hypotheses=bit_edge_hypotheses)
    return detect(power, carrier_freqs, threshold, mode=mode,
                  exclusion_samples=exclusion_samples)


def fine_doppler(
    samples: torch.Tensor,        # [n_int * N] complex64
    code_samples: torch.Tensor,   # [P, N] f32 +/-1 sampled replicas
    code_phase: torch.Tensor,     # [P] i32 from pcps_search
    coarse_freq: torch.Tensor,    # [P] f32 carrier estimate
    *,
    fs_hz: float,
    n_int: int,
    zero_pad: int = 8,
    window_hz: float = 500.0,
    squaring: bool = False,
    n_sub: int = 1,
) -> torch.Tensor:
    """Refine the carrier frequency with a long zero-padded FFT of the
    code-stripped signal, searched within +/- ``window_hz`` of the
    coarse estimate. Returns [P] f32.

    ``squaring`` wipes residual BPSK modulation (secondary codes, data
    symbols within the window). The JAX package's FFT engine squares the
    code-wiped signal sample by sample; that squares away every other
    satellite's code as well (+-1 chips square to 1), so each one leaves a
    line at twice its own Doppler, and with several satellites of a
    system within a coarse bin every PRN picks the strongest of them
    (ROADMAP C16: the BeiDou and Galileo handoffs of ladder 4's mixed
    scene all land on one Doppler). Here the squared series is the
    despread one, as the JAX conv engine's ``fine_doppler_conv`` forms
    it (``_fine_doppler_despread``): only the PRN's own signal survives
    the per-period sums."""
    p, n_fft = code_samples.shape
    length = n_int * n_fft
    pad_len = zero_pad * length
    dev = samples.device
    # rep[p, i] = code[p, (i - cp) mod N]  (== jnp.roll(code, cp))
    i = torch.arange(n_fft, device=dev, dtype=torch.int64)
    idx = (i[None, :] - code_phase.to(torch.int64)[:, None]) % n_fft
    rep = torch.gather(code_samples, 1, idx)
    wiped = samples[None, :length] * rep.repeat(1, n_int)
    if squaring:
        return _fine_doppler_despread(
            wiped, coarse_freq, fs_hz=fs_hz, n_int=n_int, n_fft=n_fft,
            window_hz=window_hz, n_sub=n_sub)
    freqs = torch.fft.fftfreq(pad_len, d=1.0 / fs_hz, device=dev,
                              dtype=torch.float32)
    f0 = coarse_freq.to(torch.float32)[:, None]
    neg = torch.tensor(-math.inf, dtype=torch.float32, device=dev)
    spec = torch.fft.fft(wiped, n=pad_len, dim=-1)
    mag = torch.where(torch.abs(freqs[None, :] - f0) <= window_hz,
                      torch.abs(spec), neg)
    return freqs[torch.argmax(mag, dim=-1)]


def _fine_doppler_despread(wiped, coarse_freq, *, fs_hz, n_int, n_fft,
                           window_hz, n_sub, n_steps=129, squaring=True):
    """The fine search on despread sums (the arithmetic of the JAX
    package's ``fine_doppler_conv``, ``gnss_sdr_tpu/ops/pcps.py:631``,
    batched over the PRNs; the FFT engine's squaring search and the conv
    engine's both run here): the code-wiped samples [P, n_int * N] mixed
    to the coarse carrier and summed per code period; with ``squaring``
    and ``n_sub`` > 1 each period in n_sub parts, whose within-period
    phase slope gives an unambiguous first estimate delta1 (the
    modulation is constant within a period), the parts derotated by it
    and summed; with ``squaring`` the period sums squared; the residual
    tone searched on n_steps offsets within +-window_hz (squaring: an
    alias-free span). Returns f0 + delta1 + the tone's offset (half of
    it when squared), [P] f32."""
    p = wiped.shape[0]
    dev = wiped.device
    length = n_int * n_fft
    two_pi = 2.0 * math.pi
    i = torch.arange(length, device=dev, dtype=torch.float32)
    f0 = coarse_freq.to(torch.float32)
    theta = f0[:, None] / float(fs_hz) * i[None, :]
    theta = (theta - torch.floor(theta)) * two_pi
    w = wiped * torch.polar(torch.ones_like(theta), -theta)
    delta1 = torch.zeros(p, device=dev, dtype=torch.float32)
    if squaring and n_sub > 1 and n_fft % n_sub == 0:
        t_sub = n_fft / n_sub / fs_hz
        # the doubled domain's alias spacing is 1 / T_period: stay well
        # inside it around the first estimate
        span = min(2.0 * window_hz, 0.45 * fs_hz / n_fft)
        sub = w.reshape(p, n_int, n_sub, n_fft // n_sub).sum(-1)
        xprod = (sub[:, :, 1:] * sub[:, :, :-1].conj()).sum((1, 2))
        delta1 = torch.angle(xprod) / (two_pi * t_sub)
        ts = (torch.arange(n_int, device=dev, dtype=torch.float32)[:, None]
              * n_fft + torch.arange(n_sub, device=dev,
                                     dtype=torch.float32)[None, :]
              * (n_fft // n_sub)) / float(fs_hz)
        ang = two_pi * delta1[:, None, None] * ts[None]
        z = (sub * torch.polar(torch.ones_like(ang), -ang)).sum(-1)
    else:
        span = 2.0 * window_hz if squaring else window_hz
        z = w.reshape(p, n_int, n_fft).sum(-1)
    if squaring:
        z = z * z
    deltas = torch.linspace(-span, span, n_steps, device=dev,
                            dtype=torch.float32)
    t_m = torch.arange(n_int, device=dev, dtype=torch.float32) * (
        n_fft / fs_hz)
    ph = two_pi * deltas[:, None] * t_m[None, :]                 # [K, M]
    tone = (z @ torch.polar(torch.ones_like(ph), -ph).T).abs()   # [P, K]
    # the peak offset; ties (a zero replica row) resolve to their mean,
    # as the JAX engine's mask pick does
    pick = (tone == tone.amax(dim=-1, keepdim=True)).to(torch.float32)
    pick = pick / pick.sum(-1, keepdim=True)
    d_star = (pick * deltas).sum(-1)
    return f0 + delta1 + (d_star * 0.5 if squaring else d_star)


# ---------------------------------------------------------------------------
# the conv engine (JAX ops/pcps.py:314-746)
# ---------------------------------------------------------------------------

def _bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 operands rounded to bf16 values, kept in f32 (the JAX engine
    feeds bf16 to a convolution with f32 accumulation; a bf16 conv1d in
    torch would round its output too)."""
    return x.to(torch.bfloat16).to(torch.float32)


def pcps_power_conv(
    samples_re: torch.Tensor,     # [(n_int + 1) * N] f32
    samples_im: torch.Tensor,     # [(n_int + 1) * N] f32
    codes: torch.Tensor,          # [P, N] f32 +/-1 sampled replicas
    carrier_freqs: torch.Tensor,  # [D] f32
    *,
    fs_hz: float,
    n_int: int,
    sample_offset: int = 0,
    seg_width: int = 128,
) -> torch.Tensor:
    """FFT-free PCPS power cube [P, D, N]: every lag of every PRN as one
    convolution (the PRN replicas as output channels, Doppler x
    integration as the batch). The N-tap filter is cut into n_seg =
    ceil(N / seg_width) segments presented as input channels (filter [P,
    n_seg, seg_width] over blocks [B, n_seg, N + seg_width - 1]): the
    same sums, the JAX engine's shape. Linear correlation over
    two-period blocks: one extra code period of trailing samples; lags
    0..N-1 exact.

    bf16 operands, f32 sums, as the JAX engine's conv: the operands are
    rounded to bf16 values and convolved in f32. On the card cuDNN runs
    an f32 convolution in TF32 by default (``torch.backends.cudnn.
    allow_tf32``, left as it is): a bf16 value is exact in TF32 (8
    mantissa bits of its 11) and the sums stay f32, so nothing is lost
    and only the order of the sums differs from the JAX engine's."""
    n_fft = codes.shape[-1]
    n_prn = codes.shape[0]
    d = carrier_freqs.shape[0]
    length = (n_int + 1) * n_fft
    step = nco.freq_to_step(carrier_freqs, fs_hz)               # [D]
    c, s = nco.cis(nco.phase_ramp(_ramp_start(step, sample_offset), step,
                                  length))         # [D, L + N]
    xre = samples_re[None, :length] * c + samples_im[None, :length] * s
    xim = samples_im[None, :length] * c - samples_re[None, :length] * s
    n_seg = -(-n_fft // seg_width)
    pad = n_seg * seg_width - n_fft
    if pad:
        xre = torch.nn.functional.pad(xre, (0, pad))
        xim = torch.nn.functional.pad(xim, (0, pad))
    filt = _bf16(torch.nn.functional.pad(codes, (0, pad)).reshape(
        n_prn, n_seg, seg_width))
    win = n_fft + seg_width - 1
    # row (k, j) of the blocks holds m[kN + Sj : kN + Sj + N + S - 1]: a
    # VALID correlation with segment j sums code[Sj + m'] x[kN + l + Sj +
    # m'] over m', and over the input channels j the N-tap correlation at
    # lags l = 0..N-1
    dev = samples_re.device
    idx = (torch.arange(n_int, device=dev)[:, None, None] * n_fft
           + torch.arange(n_seg, device=dev)[None, :, None] * seg_width
           + torch.arange(win, device=dev)[None, None, :])

    def correlate(m):
        blocks = _bf16(m[:, idx].reshape(d * n_int, n_seg, win))
        return torch.nn.functional.conv1d(blocks, filt)       # [B, P, N]

    cr = correlate(xre).reshape(d, n_int, n_prn, n_fft)
    ci = correlate(xim).reshape(d, n_int, n_prn, n_fft)
    power = (cr * cr + ci * ci).sum(dim=1)                     # [D, P, N]
    return power.movedim(0, 1)                                 # [P, D, N]


def decimate_mean(samples_re: torch.Tensor, samples_im: torch.Tensor,
                  r: int):
    """Boxcar (integrate-and-dump) decimation by ``r`` of planar IQ: the
    conv engine's coarse front end (the code's main lobe survives at ~1
    sample per chip; the full-rate refinement recovers the loss)."""
    if r == 1:
        return samples_re, samples_im
    n = (samples_re.shape[-1] // r) * r
    return (samples_re[..., :n].reshape(-1, r).mean(dim=-1),
            samples_im[..., :n].reshape(-1, r).mean(dim=-1))


def _mask_pick(values: torch.Tensor, peak: torch.Tensor) -> torch.Tensor:
    """The JAX engine's argmax without argmax: the mean position of the
    entries equal to ``peak`` along the last axis, [...] f32 (ties, as on
    a zero replica row, land at the middle)."""
    mask = (values == peak[..., None]).to(torch.float32)
    mask = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    iota = torch.arange(values.shape[-1], device=values.device,
                        dtype=torch.float32)
    return (mask * iota).sum(-1)


def refine_lags(
    samples_re: torch.Tensor,     # [(n_int + 1) * N] f32, full rate
    samples_im: torch.Tensor,
    codes: torch.Tensor,          # [P, N] f32 full-rate replicas
    coarse_lags: torch.Tensor,    # [P] i32 full-rate lag estimates
    carrier_freqs: torch.Tensor,  # [P] f32 per-PRN carrier
    *,
    fs_hz: float,
    n_int: int,
    half_width: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-rate code-phase refinement around the coarse lags: the
    correlation at the 2 * half_width + 1 lags around each (window
    starts wrapped into [0, N): the code is periodic; a zero tail of w
    samples shaves the last window of boundary lags, as in the JAX
    engine). Returns (refined lags [P] i32, their power [P] f32)."""
    n_fft = codes.shape[-1]
    w = 2 * half_width + 1
    dev = samples_re.device
    xre = torch.nn.functional.pad(samples_re, (0, w))
    xim = torch.nn.functional.pad(samples_im, (0, w))
    step = nco.freq_to_step(carrier_freqs, fs_hz)               # [P]
    c, s = nco.cis(nco.phase_ramp(torch.zeros_like(step), step,
                                  xre.shape[-1]))
    mre = xre[None, :] * c + xim[None, :] * s                   # [P, L]
    mim = xim[None, :] * c - xre[None, :] * s
    lag0 = coarse_lags.to(torch.int64) - half_width
    lag0 = torch.where(lag0 < 0, lag0 + n_fft, lag0)
    win = n_fft + w - 1
    idx = (torch.arange(n_int, device=dev)[None, :, None] * n_fft
           + lag0[:, None, None]
           + torch.arange(win, device=dev)[None, None, :])      # [P, K, win]
    flat = idx.reshape(idx.shape[0], -1)
    wre = torch.gather(mre, 1, flat).reshape(idx.shape)
    wim = torch.gather(mim, 1, flat).reshape(idx.shape)
    powers = []
    for v in range(w):
        cr = torch.einsum("pkn,pn->pk", wre[..., v:v + n_fft], codes)
        ci = torch.einsum("pkn,pn->pk", wim[..., v:v + n_fft], codes)
        powers.append((cr * cr + ci * ci).sum(dim=1))
    power = torch.stack(powers, dim=1)                          # [P, W]
    peak = power.amax(dim=-1)
    lags = lag0 + _mask_pick(power, peak).to(torch.int64)
    lags = torch.where(lags < 0, lags + n_fft, lags)
    lags = torch.where(lags >= n_fft, lags - n_fft, lags)
    return lags.to(torch.int32), peak


def detect_real(power: torch.Tensor, carrier_freqs: torch.Tensor,
                threshold: float) -> AcqResults:
    """The conv engine's peak/avg detector from max, compare and dot
    (the JAX engine's, whose ties resolve to the mean position)."""
    n_fft = power.shape[-1]
    peak_per_bin = power.amax(dim=-1)                          # [P, D]
    bin_peak = peak_per_bin.amax(dim=-1, keepdim=True)
    bin_mask = (peak_per_bin == bin_peak).to(torch.float32)
    bin_mask = bin_mask / torch.clamp(bin_mask.sum(-1, keepdim=True),
                                      min=1.0)
    bin_power = torch.einsum("pdn,pd->pn", power, bin_mask)
    peak = bin_power.amax(dim=-1)
    code_phase = _mask_pick(bin_power, peak).to(torch.int32)
    freq = torch.einsum("d,pd->p", carrier_freqs, bin_mask)
    avg = (bin_power.sum(dim=-1) - peak) / float(n_fft - 1)
    ratio = peak / torch.clamp(avg, min=1e-20)
    return AcqResults(detected=ratio > threshold, ratio=ratio,
                      peak_power=peak, code_phase_samples=code_phase,
                      carrier_freq_hz=freq)


def pcps_search_conv(samples_re, samples_im, codes, carrier_freqs, *,
                     fs_hz: float, n_int: int, threshold: float = 7.0,
                     seg_width: int = 128) -> AcqResults:
    """The FFT-free search: the conv power cube and its detector."""
    power = pcps_power_conv(samples_re, samples_im, codes, carrier_freqs,
                            fs_hz=fs_hz, n_int=n_int, seg_width=seg_width)
    return detect_real(power, carrier_freqs, threshold)


def acquire_conv(
    samples_re: torch.Tensor,     # [(n_int + 1) * N] f32, full rate
    samples_im: torch.Tensor,
    codes: torch.Tensor,          # [P, N] f32 full-rate replicas
    codes_coarse: torch.Tensor,   # [P, N / decim] f32 boxcar-decimated
    sel: torch.Tensor,            # [B, P] f32 row selection
    carrier_freqs: torch.Tensor,  # [D] f32 = f_if + doppler grid
    *,
    fs_hz: float,
    n_int: int,
    decim: int,
    threshold: float,
    seg_width: int = 128,
    fine: bool = True,
    fine_window_hz: float = 500.0,
    fine_steps: int = 129,
    fine_squaring: bool = False,
    fine_n_sub: int = 1,
) -> AcqResults:
    """The whole conv acquisition: the coarse search on samples and
    replicas boxcar-decimated by ``decim`` (its MACs scale as N^2), with
    ``decim`` > 1 the full-rate lags refined within +-decim, and the
    fine Doppler, over the replica rows ``sel @ codes`` (the steady
    re-search passes an 8-row bucket; a zero row is never detected).
    The ratio is the coarse statistic; the peak power and lags are the
    full-rate ones. One function of tensor ops with no host sync, so it
    can be queued behind a span's kernels."""
    codes_b = sel @ codes                                      # [B, N]
    if decim > 1:
        codes_cb = sel @ codes_coarse
        red, imd = decimate_mean(samples_re, samples_im, decim)
    else:
        codes_cb, red, imd = codes_b, samples_re, samples_im
    res = pcps_search_conv(red, imd, codes_cb, carrier_freqs,
                           fs_hz=fs_hz / decim, n_int=n_int,
                           threshold=threshold, seg_width=seg_width)
    if decim > 1:
        lags, peak = refine_lags(
            samples_re, samples_im, codes_b,
            res.code_phase_samples * decim, res.carrier_freq_hz,
            fs_hz=fs_hz, n_int=n_int, half_width=decim)
        res = res._replace(code_phase_samples=lags, peak_power=peak)
    if fine:
        res = res._replace(carrier_freq_hz=fine_doppler_conv(
            samples_re, samples_im, codes_b, res.code_phase_samples,
            res.carrier_freq_hz, fs_hz=fs_hz, n_int=n_int,
            window_hz=fine_window_hz, n_steps=fine_steps,
            squaring=fine_squaring, n_sub=fine_n_sub))
    return res


def fine_doppler_conv(
    samples_re: torch.Tensor,     # [>= n_int * N] f32
    samples_im: torch.Tensor,
    code_samples: torch.Tensor,   # [P, N] f32 +/-1 sampled replicas
    code_phase: torch.Tensor,     # [P] i32 from the search
    coarse_freq: torch.Tensor,    # [P] f32 carrier estimate
    *,
    fs_hz: float,
    n_int: int,
    window_hz: float = 500.0,
    n_steps: int = 129,
    squaring: bool = False,
    n_sub: int = 1,
) -> torch.Tensor:
    """FFT-free fine Doppler: the code wiped at the acquired phase, one
    sum per code period at the coarse carrier, and the residual tone
    searched on ``n_steps`` offsets within +-``window_hz`` (squaring and
    ``n_sub``: see ``_fine_doppler_despread``, whose arithmetic this is).
    Returns [P] f32."""
    p, n_fft = code_samples.shape
    length = n_int * n_fft
    i = torch.arange(n_fft, device=code_samples.device, dtype=torch.int64)
    idx = (i[None, :] - code_phase.to(torch.int64)[:, None]) % n_fft
    rep = torch.gather(code_samples, 1, idx).repeat(1, n_int)  # roll(code, cp)
    x = torch.complex(samples_re[:length], samples_im[:length])
    return _fine_doppler_despread(
        x[None, :] * rep, coarse_freq, fs_hz=fs_hz, n_int=n_int,
        n_fft=n_fft, window_hz=window_hz, n_sub=n_sub, n_steps=n_steps,
        squaring=squaring)
