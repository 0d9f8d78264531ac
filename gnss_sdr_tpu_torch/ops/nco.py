"""Fixed-point numerically-controlled oscillator (NCO) primitives on
torch tensors (counterpart of ``gnss_sdr_tpu/ops/nco.py``).

Phase is a uint32 fraction of a cycle: ``phase_cycles = acc / 2**32``.
Torch has no full uint32 arithmetic, so accumulators live in int64
tensors masked with ``& 0xFFFFFFFF`` after every add and multiply. The
low 32 bits of an int64 sum or product are exact even where the int64
itself wraps, so the result is bit-exact mod 2**32. Conversions to
float32 go from the masked int64, as the JAX package converts from
uint32 (both round to nearest).
"""
from __future__ import annotations

import numpy as np
import torch

TWO_PI = 6.283185307179586
_SCALE = 4294967296.0  # 2**32
MASK32 = 0xFFFFFFFF


def freq_to_step(freq_hz, fs_hz: float, device=None) -> torch.Tensor:
    """Per-sample phase step as a uint32 cycle fraction (int64 tensor).

    Only the fractional part of f/fs matters. ``torch.round`` is
    half-to-even like ``jnp.round``."""
    f = torch.as_tensor(freq_hz, dtype=torch.float32, device=device)
    return cycles_to_step(
        f / torch.tensor(fs_hz, dtype=torch.float32, device=f.device))


def inv_f32(x: float) -> float:
    """f32(1) / f32(x), rounded to f32, as a Python float: the factor by
    which XLA replaces a division by the f32 constant x inside a jitted
    graph (a torch op with a Python float scalar rounds it to f32, which
    leaves this value exact)."""
    return float(np.float32(1.0) / np.float32(x))


def cycles_to_step(cycles: torch.Tensor) -> torch.Tensor:
    """uint32 cycle-fraction step (int64 tensor) from f32 cycles per
    sample. The JAX package's jitted graphs (track_block,
    condition_block) form the cycles as ``freq * inv_f32(fs)``, eager
    code as ``freq / fs``; both end here."""
    frac = cycles - torch.floor(cycles)
    # a fraction that rounds up to 2**32 saturates to 2**32 - 1, as
    # XLA's float -> uint32 conversion does in the JAX package
    return torch.clamp(torch.round(frac * _SCALE).to(torch.int64), 0, MASK32)


def phase_ramp(acc_u32, step_u32, n: int) -> torch.Tensor:
    """``[..., n]`` uint32 phase ramp ``acc + i * step`` (wrapping),
    as int64 in [0, 2**32)."""
    acc = torch.as_tensor(acc_u32, dtype=torch.int64)
    step = torch.as_tensor(step_u32, dtype=torch.int64, device=acc.device)
    i = torch.arange(n, dtype=torch.int64, device=acc.device)
    return (acc[..., None] + i * step[..., None]) & MASK32


def advance(acc_u32, step_u32, n) -> torch.Tensor:
    """Accumulator after ``n`` samples (wrapping)."""
    acc = torch.as_tensor(acc_u32, dtype=torch.int64)
    step = torch.as_tensor(step_u32, dtype=torch.int64, device=acc.device)
    n = torch.as_tensor(n, dtype=torch.int64, device=acc.device) & MASK32
    return (acc + ((n * step) & MASK32)) & MASK32


def to_radians(phase_u32: torch.Tensor) -> torch.Tensor:
    """uint32 cycle fraction -> radians in [0, 2*pi). The factor enters
    as a Python float holding its f32 value (the op rounds it to f32),
    so nothing is copied to the device."""
    return phase_u32.to(torch.float32) * float(np.float32(TWO_PI / _SCALE))


def cis(phase_u32: torch.Tensor):
    """(cos, sin) pair of the phase — e^{+j theta} components."""
    theta = to_radians(phase_u32)
    return torch.cos(theta), torch.sin(theta)


def mix_down(re, im, phase_u32):
    """Multiply planar IQ by e^{-j theta(phase)} (downconversion):
    (I + jQ)(cos - j sin) = (I cos + Q sin) + j(Q cos - I sin)."""
    c, s = cis(phase_u32)
    return re * c + im * s, im * c - re * s
