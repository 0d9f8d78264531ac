"""Early/Prompt/Late correlators of the scanned tracking path
(counterpart of ``gnss_sdr_tpu/ops/correlator.py``), as torch ops over
``[C, W]`` windows and ``[C]`` per-channel scalars: the channel axis
takes the place of the JAX package's ``vmap``.

Per sample: carrier wipe-off from the exact uint32 NCO (ops/nco.py, the
u32 accumulators as masked int64), a masked epoch of ``n_valid``
samples inside the static window W, three code lookups at the
early/prompt/late chip phases, six dot products. The chip phase inside
the epoch is ``chip_frac + i * chips_per_sample`` in f32, formed as ONE
fused multiply-add: XLA:CPU contracts the JAX package's multiply and
add into an fma, and a lane sitting on a chip boundary floors to the
same chip only with the same rounding (``fma`` below rounds once, from
the exact f64 product).

Three formulations, as in the JAX package:
  * ``epl_correlate_one`` ("exact"): three gathers at +-el_space chips;
  * ``epl_correlate_one_shift`` ("shift", and the plain version of the
    CUDA kernel B5, ops/cuda/epl_correlator.py): one gather over a chip
    ramp extended by ``shift`` samples each side, early/late as slices;
  * ``epl_correlate_one_slice`` ("slice"/"fused"): one slice of a
    pre-sampled nominal-rate code table at the sample anchor.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import nco


class EplSums(NamedTuple):
    i_e: torch.Tensor
    q_e: torch.Tensor
    i_p: torch.Tensor
    q_p: torch.Tensor
    i_l: torch.Tensor
    q_l: torch.Tensor


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (f32 operands, tensors or a Python
    float holding an f32 value: the f64 product is exact, so only the
    sum rounds before the final rounding)."""
    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)
    return (f64(a) * f64(b) + f64(c)).float()


def f32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 as XLA converts: saturating, NaN to 0 (an idle
    channel's zero rate makes NaN and huge values here)."""
    x = torch.nan_to_num(x.double(), nan=0.0, posinf=2.0 ** 31,
                         neginf=-2.0 ** 31)
    return x.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)


def _wipe(re, im, n_valid, carr_acc, carr_step):
    """Carrier wipe-off of [C, W] windows, zero outside each channel's
    first ``n_valid`` samples."""
    w = re.shape[1]
    phase = nco.phase_ramp(carr_acc, carr_step, w)
    wre, wim = nco.mix_down(re, im, phase)
    mask = torch.arange(w, device=re.device)[None, :] < n_valid[:, None]
    return torch.where(mask, wre, 0.0), torch.where(mask, wim, 0.0)


def _sums(wre, wim, early, prompt, late) -> EplSums:
    return EplSums(
        i_e=(wre * early).sum(-1), q_e=(wim * early).sum(-1),
        i_p=(wre * prompt).sum(-1), q_p=(wim * prompt).sum(-1),
        i_l=(wre * late).sum(-1), q_l=(wim * late).sum(-1))


def epl_correlate_one(re, im, n_valid, carr_acc, carr_step, chip_int,
                      chip_frac, chips_per_sample, codes, *,
                      el_space: float = 0.5,
                      oversample: int = 1) -> EplSums:
    """Correlate each channel's epoch window against E/P/L replicas at
    +-``el_space`` chips (floor(cp +- el_space) mod L, reference
    do_tracking.rs:251-263). ``codes``: [C, L * oversample]."""
    w = re.shape[1]
    n_code = codes.shape[1]
    dev = re.device
    i_f = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    cp = fma(i_f, chips_per_sample[:, None], chip_frac[:, None])
    base = chip_int.to(torch.int64)[:, None] * oversample

    def chips_at(offset_chips: float):
        x = (cp + offset_chips) * float(oversample)
        idx = base + torch.floor(x).to(torch.int64)
        return torch.gather(codes, 1, torch.remainder(idx, n_code))

    wre, wim = _wipe(re, im, n_valid, carr_acc, carr_step)
    return _sums(wre, wim, chips_at(el_space), chips_at(0.0),
                 chips_at(-el_space))


def epl_correlate_one_shift(re, im, n_valid, carr_acc, carr_step, chip_int,
                            chip_frac, chips_per_sample, codes, *,
                            shift: int, oversample: int = 1,
                            interp: bool = False) -> EplSums:
    """Single-gather E/P/L correlator: the early replica is the prompt
    advanced by ``shift`` samples, the late one delayed by it, so ONE
    gather over the chip ramp extended by ``shift`` on each side serves
    all three. ``interp`` blends adjacent chips by the fractional chip
    (a fused multiply-add, as XLA contracts it)."""
    w = re.shape[1]
    n_code = codes.shape[1]
    dev = re.device
    # ramp index j maps to epoch sample i = j - shift
    j_f = torch.arange(w + 2 * shift, dtype=torch.float32,
                       device=dev)[None, :] - float(shift)
    cp = fma(j_f, chips_per_sample[:, None], chip_frac[:, None])
    x = cp * float(oversample)
    base = torch.floor(x)
    idx = torch.remainder(chip_int.to(torch.int64)[:, None] * oversample
                          + base.to(torch.int64), n_code)
    chips = torch.gather(codes, 1, idx)
    if interp:
        nxt = torch.gather(codes, 1, torch.remainder(idx + 1, n_code))
        chips = fma(x - base, nxt - chips, chips)
    wre, wim = _wipe(re, im, n_valid, carr_acc, carr_step)
    return _sums(wre, wim, chips[:, 2 * shift:2 * shift + w],
                 chips[:, shift:shift + w], chips[:, :w])


def epl_correlate_one_slice(re, im, n_valid, carr_acc, carr_step, chip_int,
                            chip_frac, chips_per_sample, code3x, *,
                            shift: int, n0: int) -> EplSums:
    """Gather-free E/P/L correlator: the replicas are ONE slice of a
    pre-sampled nominal-rate code table (``code3x`` [C, >= 2*n0 + W +
    2*shift], make_sampled_code_table) at the sample FLOOR of the
    tracked chip phase; the u32/chip ledger stays exact, so the +-0.5
    sample quantization appears only as replica wander."""
    w = re.shape[1]
    dev = re.device
    cp = chip_int.to(torch.float32) + chip_frac
    s_i = f32_to_i32(torch.floor(cp / chips_per_sample)).to(torch.int64)
    s_i = torch.where(s_i >= n0, s_i - n0, s_i)          # wrap into [0, n0)
    s_i = torch.where(s_i < 0, s_i + n0, s_i)
    # [s_i - shift, s_i + W + shift), offset by +n0 in the tiled table so
    # the start is never negative; clamped as dynamic_slice clamps
    n = w + 2 * shift
    start = torch.clamp(s_i + n0 - shift, 0, code3x.shape[1] - n)
    base = torch.gather(code3x, 1, start[:, None] + torch.arange(
        n, device=dev)[None, :])
    wre, wim = _wipe(re, im, n_valid, carr_acc, carr_step)
    return _sums(wre, wim, base[:, 2 * shift:2 * shift + w],
                 base[:, shift:shift + w], base[:, :w])


# the JAX package's names for the batched correlator: the functions above
# already take the channel axis
epl_correlate = epl_correlate_one


def epl_correlate_batch(re, im, n_valid, carr_acc, carr_step, chip_int,
                        chip_frac, chips_per_sample, codes,
                        el_space: float = 0.5,
                        oversample: int = 1) -> EplSums:
    """The exact correlator over [C, W] windows (the JAX package's jitted
    convenience wrapper)."""
    return epl_correlate_one(re, im, n_valid, carr_acc, carr_step, chip_int,
                             chip_frac, chips_per_sample, codes,
                             el_space=el_space, oversample=oversample)
