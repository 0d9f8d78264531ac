"""One epoch's E/P/L correlations on Hopper: kernel B5, ONE launch per
tracking epoch for every channel.

Replaces the Pallas TPU kernel ``epl_correlate_pallas``
(``gnss_sdr_tpu/ops/pallas/epl_correlator.py:104``, body ``_kernel``
:36). The CUDA source is ``gnss_sdr_tpu_torch/csrc/epl_correlator.cu``;
its header states the arithmetic, the design and what bounds it. The
Pallas kernel computes the single-gather shift formulation, so the plain
version is the port's ``epl_correlate_one_shift`` (ops/correlator.py).

The wrapper takes the Pallas wrapper's arguments in the port's types:
``re``, ``im`` [C, W] f32; ``n_valid``, ``chip_int`` [C] int32;
``carr_acc``, ``carr_step`` [C] int64 holding uint32 values (the port's
NCO convention, ops/nco.py); ``chip_frac``, ``chips_per_sample`` [C]
f32; ``codes`` [C, L * oversample] f32. It returns ``EplSums`` of [C]
f32. CPU tensors take the plain version; CUDA tensors launch the kernel
or raise, and never reach the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..correlator import EplSums, epl_correlate_one_shift
from . import _build

# launches of the CUDA kernel (a plain int; the plain version never counts)
launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load_library("epl_correlator").epl_correlator_launch
    fn.argtypes = [_VP] * 10 + [_I] * 6 + [_VP]
    fn.restype = _I
    return fn


def _check_args(re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac,
                chips_per_sample, codes, *, shift, oversample):
    """Types, shapes, devices and contiguity of one call."""
    dev = re.device
    named = (("re", re, torch.float32), ("im", im, torch.float32),
             ("n_valid", n_valid, torch.int32),
             ("carr_acc", carr_acc, torch.int64),
             ("carr_step", carr_step, torch.int64),
             ("chip_int", chip_int, torch.int32),
             ("chip_frac", chip_frac, torch.float32),
             ("chips_per_sample", chips_per_sample, torch.float32),
             ("codes", codes, torch.float32))
    for name, t, dt in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, re on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if re.ndim != 2 or im.shape != re.shape:
        raise ValueError("re / im must be matching [C, W]")
    c = re.shape[0]
    for name, t, _ in named[2:8]:
        if t.shape != (c,):
            raise ValueError(f"{name} must be [C={c}], got {tuple(t.shape)}")
    if codes.ndim != 2 or codes.shape[0] != c:
        raise ValueError(f"codes must be [C={c}, L*os], "
                         f"got {tuple(codes.shape)}")
    if shift < 0 or oversample < 1:
        raise ValueError(f"need shift >= 0 and oversample >= 1, got "
                         f"{shift} and {oversample}")


def epl_correlate_pallas(re, im, n_valid, carr_acc, carr_step, chip_int,
                         chip_frac, chips_per_sample, codes, *, shift: int,
                         oversample: int = 1,
                         interp: bool = False) -> EplSums:
    """Batched fused correlator; returns EplSums of [C] f32 (module
    docstring). The name is the JAX package's: ``correlator="pallas"``
    selects this kernel."""
    _check_args(re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac,
                chips_per_sample, codes, shift=shift, oversample=oversample)
    if re.device.type == "cpu":
        return epl_correlate_one_shift(
            re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac,
            chips_per_sample, codes, shift=shift, oversample=oversample,
            interp=interp)
    if re.device.type != "cuda":
        raise ValueError(f"unsupported device {re.device}")
    fn = _lib()
    c, w = re.shape
    out = torch.empty((c, 6), dtype=torch.float32, device=re.device)
    with torch.cuda.device(re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(re.data_ptr(), im.data_ptr(), n_valid.data_ptr(),
                 carr_acc.data_ptr(), carr_step.data_ptr(),
                 chip_int.data_ptr(), chip_frac.data_ptr(),
                 chips_per_sample.data_ptr(), codes.data_ptr(),
                 out.data_ptr(), c, w, codes.shape[1], int(shift),
                 int(oversample), int(bool(interp)), stream)
    if err != 0:
        raise RuntimeError(f"epl_correlator launch failed: CUDA error {err}")
    global launch_count
    launch_count += 1
    return EplSums(*out.unbind(1))
