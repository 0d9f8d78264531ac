"""One epoch's E/P/L correlations on Hopper: kernel B5, ONE launch per
tracking epoch for every channel.

Replaces the Pallas TPU kernel ``epl_correlate_pallas``
(``gnss_sdr_tpu/ops/pallas/epl_correlator.py:104``, body ``_kernel``
:36). The CUDA source is ``gnss_sdr_tpu_torch/csrc/epl_correlator.cu``;
its header states the arithmetic, the design and what bounds it. The
Pallas kernel computes the single-gather shift formulation, so the plain
version is the port's ``epl_correlate_one_shift`` (ops/correlator.py).

Two entry points, one kernel:
  * ``epl_correlate_block`` reads each channel's window straight from
    the sample block: ``block_re``, ``block_im`` [N] f32 and the windows'
    first samples ``start`` [C] int32. The scanned tracker calls it
    (``correlator="pallas"``). Its plain version gathers the windows and
    calls ``epl_correlate_one_shift``.
  * ``epl_correlate_pallas`` takes the Pallas wrapper's arguments: ``re``,
    ``im`` [C, W] f32; on the card it is the same kernel over the
    flattened windows with starts ``c * W``.
The per-channel arguments, in the port's types: ``n_valid``, ``chip_int``
[C] int32; ``carr_acc``, ``carr_step`` [C] int64 holding uint32 values
(the port's NCO convention, ops/nco.py); ``chip_frac``,
``chips_per_sample`` [C] f32; ``codes`` [C, L * oversample] f32. Both
return ``EplSums`` of [C] f32. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise, and never reach the plain version.

On the card each channel's lanes are split over a thread-block cluster
of ``cluster_size(C)`` blocks (8 at 32 channels), reduced in a fixed
order: the same inputs give the same bits on every run.
"""
from __future__ import annotations

import ctypes

import torch

from ..correlator import EplSums, epl_correlate_one_shift
from . import _build, launches

# launches of the CUDA kernel on the card (a plain int, counted by
# launches.record: a replayed graph adds the launches captured into it;
# the plain version never counts)
launch_count = 0

_FITS: dict = {}                    # (device, c, cluster, n_code)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load_library("epl_correlator")
    fn = lib.epl_correlator_launch
    fn.argtypes = [_VP] * 11 + [_I] * 8 + [_VP]
    fn.restype = _I
    fits = lib.epl_correlator_max_clusters
    fits.argtypes = [_I] * 3
    fits.restype = _I
    return fn, fits


def wrap_code_index(base_idx: torch.Tensor, fl: torch.Tensor,
                    n_code: int) -> torch.Tensor:
    """The kernel's chip index, ``(base_idx + fl) mod n_code`` without a
    modulo (``wrap_index`` in csrc/epl_correlator.cu). ``base_idx`` =
    chip_int * oversample is in [0, n_code) and the ramp's floors ``fl``
    (f32) in [-n_code, 2 n_code) for any code rate below twice the
    nominal, so the sum is in [-n_code, 3 n_code): at most two
    conditional adds or subtracts wrap it, equal to ``torch.remainder``.
    Outside that range (a corrupt ledger) the index is clamped into the
    row, so the kernel never reads outside it."""
    k = torch.nan_to_num(fl.float(), nan=-float(n_code)).clamp(
        -n_code, 3 * n_code).to(torch.int64)
    idx = base_idx.to(torch.int64) + k
    neg = idx < 0
    idx = torch.where(neg, idx + n_code, idx)
    idx = torch.where(~neg & (idx >= n_code), idx - n_code, idx)
    idx = torch.where(~neg & (idx >= n_code), idx - n_code, idx)
    return idx.clamp(0, n_code - 1)


def cluster_size(c_channels: int, n_sm: int) -> int:
    """The blocks per channel: the largest of 8, 4, 2, 1 that keeps the
    C x S blocks within two per SM of the card's ``n_sm`` (8 at 32
    channels on the H100, the fastest there; PERF.md), 1 where C alone
    fills that."""
    for s in (8, 4, 2):
        if c_channels * s <= 2 * n_sm:
            return s
    return 1


def _fits(fits_fn, dev, c, cluster, n_code) -> bool:
    key = (dev, c, cluster, n_code)
    if key not in _FITS:
        n = fits_fn(c, cluster, n_code)
        if n < 0:
            raise RuntimeError(f"epl_correlator: cluster query failed: CUDA "
                               f"error {-n}")
        _FITS[key] = n > 0
    return _FITS[key]


_PER_CHANNEL = (("n_valid", torch.int32), ("carr_acc", torch.int64),
                ("carr_step", torch.int64), ("chip_int", torch.int32),
                ("chip_frac", torch.float32),
                ("chips_per_sample", torch.float32))


def _check_args(samples, per_channel, codes, shift, oversample,
                start=None) -> torch.device:
    """One call's arguments: the f32 sample tensors (``samples``, (name,
    tensor) pairs, whose shapes each entry checks), the six [C]
    per-channel arguments in _PER_CHANNEL's order, the [C] int32 starts
    where given, the [C, L*os] codes and the statics. Types, devices,
    contiguity and the [C] shapes, C being the codes' rows. Returns the
    device of the first sample tensor."""
    named = [(name, t, torch.float32) for name, t in samples]
    channel = [(name, t, dt) for (name, dt), t in zip(_PER_CHANNEL,
                                                       per_channel)]
    if start is not None:
        channel.insert(0, ("start", start, torch.int32))
    named += channel + [("codes", codes, torch.float32)]
    dev = None
    for name, t, dt in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        dev = t.device if dev is None else dev
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, {named[0][0]} on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.ndim != 2:
        raise ValueError(f"codes must be [C, L*os], got {tuple(codes.shape)}")
    c = codes.shape[0]
    for name, t, _ in channel:
        if t.shape != (c,):
            raise ValueError(f"{name} must be [C={c}], got {tuple(t.shape)}")
    if shift < 0 or oversample < 1:
        raise ValueError(f"need shift >= 0 and oversample >= 1, got "
                         f"{shift} and {oversample}")
    return dev


def _launch(block_re, block_im, start, window, n_valid, carr_acc, carr_step,
            chip_int, chip_frac, chips_per_sample, codes, shift, oversample,
            interp) -> EplSums:
    """One launch of the kernel on the card (the arguments checked)."""
    dev = block_re.device
    fn, fits_fn = _lib()
    c, n_code = codes.shape
    out = torch.empty((c, 6), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        sizes = [s for s in (8, 4, 2, 1) if s <= cluster_size(c, n_sm)]
        cluster = next((s for s in sizes if _fits(
            fits_fn, dev, c, s, n_code)), None)
        if cluster is None:
            raise RuntimeError(
                f"epl_correlator: no cluster of {sizes} blocks with a "
                f"{n_code}-float code row fits on the card")
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(block_re.data_ptr(), block_im.data_ptr(), start.data_ptr(),
                 n_valid.data_ptr(), carr_acc.data_ptr(),
                 carr_step.data_ptr(), chip_int.data_ptr(),
                 chip_frac.data_ptr(), chips_per_sample.data_ptr(),
                 codes.data_ptr(), out.data_ptr(), c, block_re.shape[0],
                 int(window), n_code, int(shift), int(oversample),
                 int(bool(interp)), cluster, stream)
        if err != 0:
            raise RuntimeError(f"epl_correlator launch failed: CUDA error "
                               f"{err}")
        launches.record(__name__, "launch_count")
    return EplSums(*out.unbind(1))


def epl_correlate_block(block_re, block_im, start, n_valid, carr_acc,
                        carr_step, chip_int, chip_frac, chips_per_sample,
                        codes, *, window: int, shift: int,
                        oversample: int = 1, interp: bool = False,
                        max_start: int | None = None) -> EplSums:
    """B5 over windows read from the block: channel c correlates
    ``block[start[c] : start[c] + window]`` (module docstring).

    Every window must lie inside the block, ``0 <= start`` and ``start +
    window <= N``, checked on the host before the launch: with
    ``max_start`` the caller states a bound of the starts that it holds
    by construction (the tracker clamps them into [0, N - window] on the
    card, so nothing waits for it), and the wrapper checks ``max_start +
    window <= N``; without it the wrapper reads the starts (on the card,
    a wait for it)."""
    dev = _check_args((("block_re", block_re), ("block_im", block_im)),
                      (n_valid, carr_acc, carr_step, chip_int, chip_frac,
                       chips_per_sample), codes, shift, oversample,
                      start=start)
    if block_re.ndim != 1 or block_im.shape != block_re.shape:
        raise ValueError("block_re / block_im must be matching [N]")
    c = codes.shape[0]
    n = block_re.shape[0]
    if window < 1 or window > n:
        raise ValueError(f"window {window} must be in [1, N={n}]")
    if max_start is not None:
        if max_start < 0 or max_start + window > n:
            raise ValueError(f"windows out of bounds: starts up to "
                             f"{max_start} + window {window} > N={n}")
    elif c:
        lo, hi = (int(v) for v in torch.aminmax(start))
        if lo < 0 or hi + window > n:
            raise ValueError(f"windows out of bounds: starts in [{lo}, "
                             f"{hi}] with window {window}, N={n}")
    if dev.type == "cpu":
        idx = start.to(torch.int64)[:, None] + torch.arange(window)
        return epl_correlate_one_shift(
            block_re[idx], block_im[idx], n_valid, carr_acc, carr_step,
            chip_int, chip_frac, chips_per_sample, codes, shift=shift,
            oversample=oversample, interp=interp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(block_re, block_im, start, window, n_valid, carr_acc,
                   carr_step, chip_int, chip_frac, chips_per_sample, codes,
                   shift, oversample, interp)


def epl_correlate_pallas(re, im, n_valid, carr_acc, carr_step, chip_int,
                         chip_frac, chips_per_sample, codes, *, shift: int,
                         oversample: int = 1,
                         interp: bool = False) -> EplSums:
    """Batched fused correlator over [C, W] windows; returns EplSums of
    [C] f32 (module docstring). The name is the JAX package's."""
    dev = _check_args((("re", re), ("im", im)),
                      (n_valid, carr_acc, carr_step, chip_int, chip_frac,
                       chips_per_sample), codes, shift, oversample)
    c = codes.shape[0]
    if re.ndim != 2 or re.shape[0] != c or im.shape != re.shape:
        raise ValueError(f"re / im must be matching [C={c}, W], got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    w = re.shape[1]
    if dev.type == "cpu":
        return epl_correlate_one_shift(
            re, im, n_valid, carr_acc, carr_step, chip_int, chip_frac,
            chips_per_sample, codes, shift=shift, oversample=oversample,
            interp=interp)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if w < 1:
        raise ValueError("windows must hold at least one sample")
    start = torch.arange(c, dtype=torch.int32, device=dev) * w
    return _launch(re.reshape(-1), im.reshape(-1), start, w, n_valid,
                   carr_acc, carr_step, chip_int, chip_frac,
                   chips_per_sample, codes, shift, oversample, interp)
