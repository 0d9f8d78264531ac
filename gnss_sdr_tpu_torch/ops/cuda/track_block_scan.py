"""The scanned tracker's block of epochs on Hopper: kernel B7, ONE launch
per block for every channel and every epoch.

Replaces no TPU kernel: the JAX package runs the epoch as XLA ops around
its Pallas correlator. The CUDA source is
``gnss_sdr_tpu_torch/csrc/track_block_scan.cu``; its header states the
arithmetic, the design and what bounds it. It computes
``receiver/tracking.py``'s ``epoch_step`` with the sums of kernel B5
(the "shift" and "pallas" correlators, which define the same sums) for
``n_epochs`` epochs, and returns what the op loop returns: ONE int32
tensor, the end state's [13, C] field bits then the [17, T, C] telemetry
bits (``tracking.unpack_block`` reads it).

``track_block_scan(params, codes, ins, block_re, block_im, n_epochs)``:
``params`` a ``tracking.TrackParams`` with the "shift" or "pallas"
correlator; ``codes`` [C, L * oversample] f32 (the channels' code rows);
``ins`` the packed ledger and limit, [13 C + 1] int32
(``tracking._pack_inputs``); ``block_re``, ``block_im`` [N] f32 with N at
least the window. CPU tensors take the plain version, the op loop
(``tracking.run_epoch_ops``); CUDA tensors launch the kernel or raise,
and never reach the plain version.

On the card each channel's lanes are split over a thread-block cluster
of ``pick_cluster`` blocks (8 up to 33 channels on the H100), reduced in
a fixed order: the same inputs give the same bits on every run.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import nco
from . import _build, launches
from .epl_correlator import cluster_size

# launches of the CUDA kernel on the card (a plain int, counted by
# launches.record: a replayed graph adds the launches captured into it;
# the plain version never counts)
launch_count = 0

# the correlators whose sums the kernel computes (B5's)
CORRELATORS = ("shift", "pallas")
# the f32 constants and the integers the kernel takes, in its order
# (enum Const and enum Static in csrc/track_block_scan.cu)
CONSTS = ("inv_fs", "fs_l", "if_freq", "aiding_scale", "lock_threshold",
          "costas_threshold", "pll_k1", "pll_k2", "dll_k1", "dll_k2")
STATICS = ("n_block", "window", "n_code", "shift", "oversample", "interp",
           "costas", "aiding", "code_length", "max_lost", "n_epochs")
N_FIELDS = 13                       # ChannelState's fields
N_TELEM = 17                        # EpochTelemetry's fields
CLUSTER_SIZES = (8, 4, 2, 1)
# a block's shared memory on the H100 (227 KB), less the kernel's static
# sums
SMEM_BYTES = 232_448 - 1024

_FITS: dict = {}                    # (device, c, cluster, n_code, part)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load_library("track_block_scan")
    fn = lib.track_block_scan_launch
    fn.argtypes = [_VP] * 7 + [_I, _I, _VP]
    fn.restype = _I
    fits = lib.track_block_scan_max_clusters
    fits.argtypes = [_I] * 4
    fits.restype = _I
    return fn, fits


def scan_constants(params) -> dict[str, float]:
    """The f32 constants of ``epoch_step``, as its ops round them: a
    Python float times an f32 tensor is that float rounded to f32 (the
    loop filters' gains, the thresholds), a division by the constant fs is
    a multiplication by ``inv_f32(fs)``, and the code period in samples is
    f32(fs) x f32(L)."""
    f32 = np.float32
    return {
        "inv_fs": nco.inv_f32(params.fs_hz),
        "fs_l": float(f32(params.fs_hz) * f32(params.code_length)),
        "if_freq": float(f32(params.if_freq_hz)),
        "aiding_scale": float(f32(params.aiding_scale)),
        "lock_threshold": float(f32(params.lock_threshold)),
        "costas_threshold": float(f32(params.costas_lock_threshold)),
        "pll_k1": float(f32(params.dt / params.pll_tau1)),
        "pll_k2": float(f32(params.pll_tau2 / params.pll_tau1)),
        "dll_k1": float(f32(params.dt / params.dll_tau1)),
        "dll_k2": float(f32(params.dll_tau2 / params.dll_tau1)),
    }


def scan_statics(params, n_block: int, n_code: int,
                 n_epochs: int) -> dict[str, int]:
    """The kernel's integers for one block shape."""
    return {
        "n_block": int(n_block), "window": int(params.window),
        "n_code": int(n_code), "shift": int(params.el_shift),
        "oversample": int(params.oversample),
        "interp": int(bool(params.interp_code)),
        "costas": int(params.lock_mode == "costas"),
        "aiding": int(bool(params.carrier_aiding)),
        "code_length": int(params.code_length),
        "max_lost": int(params.max_lost_epochs), "n_epochs": int(n_epochs),
    }


def lane_part(window: int, cluster: int) -> int:
    """The window lanes each block of a channel's cluster takes."""
    return -(-window // cluster)


def smem_bytes(n_code: int, window: int, cluster: int) -> int:
    """A block's dynamic shared memory: the code row and two slots of its
    lane part's re and im."""
    return 4 * (n_code + 4 * lane_part(window, cluster))


def _check_args(params, codes, ins, block_re, block_im,
                n_epochs) -> torch.device:
    """Types, devices, contiguity and shapes; C is the codes' rows."""
    if params.correlator not in CORRELATORS:
        raise ValueError(f"track_block_scan computes B5's sums: correlator "
                         f"must be one of {CORRELATORS}, got "
                         f"{params.correlator!r}")
    named = (("block_re", block_re, torch.float32),
             ("block_im", block_im, torch.float32),
             ("codes", codes, torch.float32), ("ins", ins, torch.int32))
    dev = block_re.device if isinstance(block_re, torch.Tensor) else None
    for name, t, dt in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, block_re on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block_re.ndim != 1 or block_im.shape != block_re.shape:
        raise ValueError("block_re / block_im must be matching [N]")
    if codes.ndim != 2 or codes.shape[0] < 1 or codes.shape[1] < 1:
        raise ValueError(f"codes must be [C >= 1, L*os >= 1], got "
                         f"{tuple(codes.shape)}")
    c, n_code = codes.shape
    if ins.shape != (N_FIELDS * c + 1,):
        raise ValueError(f"ins must be [13 * C + 1 = {N_FIELDS * c + 1}] "
                         f"(C={c}), got {tuple(ins.shape)}")
    if params.window < 1 or params.window > block_re.shape[0]:
        raise ValueError(f"window {params.window} must be in [1, "
                         f"N={block_re.shape[0]}]")
    if int(n_epochs) < 1:
        raise ValueError(f"n_epochs must be >= 1, got {n_epochs}")
    need = smem_bytes(n_code, params.window, CLUSTER_SIZES[0])
    if need > SMEM_BYTES:
        raise ValueError(f"a {n_code}-float code row and a window of "
                         f"{params.window} lanes need {need} bytes of "
                         f"shared memory a block at cluster "
                         f"{CLUSTER_SIZES[0]}, over {SMEM_BYTES}")
    return dev


def _fits(fits_fn, dev, c, cluster, n_code, part) -> int:
    key = (dev, c, cluster, n_code, part)
    if key not in _FITS:
        n = fits_fn(c, cluster, n_code, part)
        if n < 0:
            raise RuntimeError(f"track_block_scan: cluster query failed: "
                               f"CUDA error {-n}")
        _FITS[key] = n
    return _FITS[key]


def pick_cluster(fits: dict[int, bool], c: int, n_sm: int) -> int | None:
    """The cluster size: the largest of CLUSTER_SIZES within
    ``epl_correlator.cluster_size(c, n_sm)`` (B5's rule: C x S blocks
    within two an SM, so 8 up to 33 channels on the H100, and the same at
    a mesh's shard widths, whose sums then match the unsharded run's bit
    for bit) that ``fits`` on the card; None where none does."""
    top = cluster_size(c, n_sm)
    return next((s for s in CLUSTER_SIZES if s <= top and fits.get(s)),
                None)


def _launch(params, codes, ins, block_re, block_im, n_epochs) -> torch.Tensor:
    """One launch of the kernel on the card (the arguments checked)."""
    dev = block_re.device
    fn, fits_fn = _lib()
    c, n_code = codes.shape
    w = params.window
    out = torch.empty((N_FIELDS + N_TELEM * int(n_epochs)) * c,
                      dtype=torch.int32, device=dev)
    consts = scan_constants(params)
    statics = scan_statics(params, block_re.shape[0], n_code, n_epochs)
    k = (ctypes.c_float * len(CONSTS))(*(consts[n] for n in CONSTS))
    s = (ctypes.c_int * len(STATICS))(*(statics[n] for n in STATICS))
    with torch.cuda.device(dev):
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        cluster = pick_cluster(
            {cs: _fits(fits_fn, dev, c, cs, n_code, lane_part(w, cs)) > 0
             for cs in CLUSTER_SIZES if cs <= w}, c, n_sm)
        if cluster is None:
            raise RuntimeError(
                f"track_block_scan: no cluster of {CLUSTER_SIZES} blocks "
                f"with a {n_code}-float code row and window {w} fits on "
                "the card")
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(block_re.data_ptr(), block_im.data_ptr(), ins.data_ptr(),
                 codes.data_ptr(), out.data_ptr(),
                 ctypes.cast(k, _VP), ctypes.cast(s, _VP), c, cluster,
                 stream)
        if err != 0:
            raise RuntimeError(f"track_block_scan launch failed: CUDA error "
                               f"{err}")
        launches.record(__name__, "launch_count")
    return out


def track_block_scan(params, codes, ins, block_re, block_im,
                     n_epochs: int) -> torch.Tensor:
    """``n_epochs`` epochs of every channel over one resident block
    (module docstring)."""
    dev = _check_args(params, codes, ins, block_re, block_im, n_epochs)
    if dev.type == "cpu":
        # the plain version: the op loop (imported here: the tracker
        # imports this module)
        from ...receiver.tracking import run_epoch_ops
        return run_epoch_ops(params, codes, ins, block_re, block_im,
                             n_epochs)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(params, codes, ins, block_re, block_im, n_epochs)
