"""Digital front end: pulse blanking, AGC, DC removal, IF mixing and
polyphase decimation, as torch ops on the block's device (counterpart of
``gnss_sdr_tpu/ops/frontend.py``).

  * DC removal: the reference's per-sample one-pole IIR (dc_remove.rs:
    23-29) is an affine recurrence, evaluated over the whole block by a
    log-depth doubling scan over the affine maps (c, d) (the JAX package
    uses lax.associative_scan; the two sum in different orders, so they
    differ by ulps). The composed slope (1-a)^(i+1) underflows to 0
    within a block, which is harmless: 0 * bias0 and 0 * d are 0;
  * mixing: the exact uint32 NCO (ops/nco.py); the step is
    ``freq * inv_f32(fs)``, as XLA computes the JAX package's jitted
    ``freq / fs``;
  * decimation: a Hamming-windowed-sinc FIR and strided sampling, as a
    sum over the taps of shifted strided views. It stays float32
    whatever the TF32 settings (no matmul, no convolution library).
"""
from __future__ import annotations

import numpy as np
import torch

from . import nco


def _f32(x):
    """A carried scalar as an operand: a tensor stays on its device, a
    host number becomes a Python float holding its f32 value (no copy to
    the device)."""
    return x if isinstance(x, torch.Tensor) else float(np.float32(x))


def dc_offset_scan(re: torch.Tensor, im: torch.Tensor, alpha: float,
                   bias0_re=0.0, bias0_im=0.0):
    """Exact one-pole DC tracker over a block:
    bias[i] = (1-a) * bias[i-1] + a * x[i]; out[i] = x[i] - bias[i].
    Maps y -> c*y + d compose as (c1*c2, c2*d1 + d2); after the doubling
    steps, map i is the composition of maps 0..i. Returns (out_re,
    out_im, final_bias_re, final_bias_im); the biases are 0-dim f32
    tensors on the block's device."""
    a = float(np.float32(alpha))
    c_const = float(np.float32(1.0) - np.float32(alpha))

    def run(x, bias0):
        c = torch.full_like(x, c_const)
        d = a * x
        k = 1
        while k < x.shape[0]:
            c_new = c.clone()
            d_new = d.clone()
            c_new[k:] = c[:-k] * c[k:]
            d_new[k:] = c[k:] * d[:-k] + d[k:]
            c, d = c_new, d_new
            k *= 2
        bias = c * _f32(bias0) + d
        return x - bias, bias[-1]

    out_re, b_re = run(re, bias0_re)
    out_im, b_im = run(im, bias0_im)
    return out_re, out_im, b_re, b_im


def pulse_blank(re: torch.Tensor, im: torch.Tensor, threshold_sigma: float):
    """Zero samples whose envelope exceeds ``threshold_sigma`` times the
    block RMS (impulsive-interference suppression). Returns (re, im,
    blanked fraction as a 0-dim tensor)."""
    power = re * re + im * im
    keep = (power <= float(np.float32(threshold_sigma ** 2))
            * power.mean()).to(torch.float32)
    return re * keep, im * keep, 1.0 - keep.mean()


def digital_agc(re: torch.Tensor, im: torch.Tensor, gain,
                target_rms: float = 1.0, alpha: float = 0.1):
    """Block-wise digital AGC: smooth the gain toward target_rms /
    block_rms. Returns (re, im, new gain as a 0-dim tensor)."""
    rms = torch.sqrt((re * re + im * im).mean() + 1e-20)
    desired = float(np.float32(target_rms)) / rms
    new_gain = (1.0 - alpha) * _f32(gain) + alpha * desired
    return re * new_gain, im * new_gain, new_gain


def design_lowpass_fir(num_taps: int, cutoff_norm: float) -> np.ndarray:
    """Hamming-windowed-sinc low-pass (cutoff as fraction of Nyquist)."""
    n = np.arange(num_taps) - (num_taps - 1) / 2.0
    h = np.sinc(cutoff_norm * n) * cutoff_norm
    h *= np.hamming(num_taps)
    return (h / h.sum()).astype(np.float32)


def polyphase_decimate(re: torch.Tensor, im: torch.Tensor, taps, factor: int):
    """Decimate by ``factor`` with an anti-alias FIR:
    y[k] = sum_t h[t] x[k*m - t], zero before the block's start; the
    output has len(x) // factor samples. Evaluated as a float32 sum over
    the taps of strided views of the left-padded block (t ascending)."""
    taps = np.asarray(taps, dtype=np.float32)
    n_taps, m = taps.shape[0], factor
    n_out = re.shape[0] // m
    rev = taps[::-1]

    def one(x):
        xp = torch.cat([x.new_zeros(n_taps - 1), x])
        acc = torch.zeros(n_out, dtype=torch.float32, device=x.device)
        for t in range(n_taps):
            acc = acc + float(rev[t]) * xp[t:t + n_out * m:m]
        return acc

    return one(re), one(im)


def condition_block(re, im, mix_freq_hz, phase_acc, bias_re, bias_im,
                    agc_gain=1.0, *, fs_hz: float, alpha: float = 0.001,
                    decimation: int = 1, n_taps: int = 64,
                    enable_dc: bool = True, enable_mix: bool = True,
                    blank_sigma: float = 0.0, enable_agc: bool = False):
    """Full conditioning chain for one block, on the device of ``re``;
    returns (re, im, new_phase_acc, new_bias_re, new_bias_im,
    new_agc_gain). ``phase_acc`` is the mixer's uint32 phase, a host
    int (its step is one number, so the phase advances exactly on the
    host); the DC biases and AGC gain come back as 0-dim tensors on the
    block's device, so the next block reuses them without a host round
    trip."""
    re = torch.as_tensor(re, dtype=torch.float32)
    im = torch.as_tensor(im, dtype=torch.float32, device=re.device)
    dev = re.device
    if blank_sigma > 0.0:
        re, im, _ = pulse_blank(re, im, blank_sigma)
    if enable_agc:
        re, im, agc_gain = digital_agc(re, im, agc_gain)
    if enable_dc:
        re, im, bias_re, bias_im = dc_offset_scan(re, im, alpha, bias_re,
                                                  bias_im)
    if enable_mix:
        # the step from the host's f32 arithmetic (as the graph's), an int
        cycles = torch.tensor(np.float32(mix_freq_hz)
                              * np.float32(nco.inv_f32(fs_hz)))
        step = int(nco.cycles_to_step(cycles))
        n = re.shape[0]
        phase_acc = int(phase_acc)
        ramp = torch.arange(n, dtype=torch.int64, device=dev) * step
        re, im = nco.mix_down(re, im, (ramp + phase_acc) & nco.MASK32)
        phase_acc = (phase_acc + ((n * step) & nco.MASK32)) & nco.MASK32
    if decimation > 1:
        re, im = polyphase_decimate(
            re, im, design_lowpass_fir(n_taps, 0.8 / decimation), decimation)
    return re, im, phase_acc, bias_re, bias_im, agc_gain
