"""Sample sources and the streaming windows (counterpart of
``gnss_sdr_tpu/receiver/stream.py``).

A pull-based ``SampleSource`` protocol (file, synthetic and in-memory
sources) feeds a rolling ``[history | block]`` window: ``StreamWindow``
keeps it in host memory (numpy, the CPU receiver), ``DeviceStreamWindow``
keeps it in torch tensors on the receiver's device and uploads only the
fresh block each step. ``global_start`` is the absolute sample index of
the window's first sample (a host Python int), while tracking offsets
stay block-relative int32.
"""
from __future__ import annotations

from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from ..models.signal import SatelliteScenario, synthesize


class SampleSource(Protocol):
    """Pull-based complex-sample source."""

    fs_hz: float

    def read(self, n: int) -> Optional[np.ndarray]:
        """Return up to ``n`` complex64 samples, or None at end-of-stream."""
        ...


class FileSource:
    """Reads IQ captures from disk.

    Formats (``SdrConfig.file_format``):
      * ``int8_real`` — the bundled-capture wire format: one int8 per real
        sample at IF (reference do_acquisition.rs:420-424)
      * ``int8_iq``   — interleaved int8 I,Q pairs (RTL-SDR style, after
        the reference's deinterleave at frontend.rs:34-40)
      * ``f32_iq``    — interleaved float32 I,Q pairs
    """

    def __init__(self, path: str, fs_hz: float, file_format: str = "int8_real"):
        self.fs_hz = fs_hz
        self.format = file_format
        self._f = open(path, "rb")

    def read(self, n: int) -> Optional[np.ndarray]:
        if self.format == "int8_real":
            raw = np.frombuffer(self._f.read(n), dtype=np.int8)
            if raw.size == 0:
                return None
            return raw.astype(np.float32).astype(np.complex64)
        if self.format == "int8_iq":
            raw = np.frombuffer(self._f.read(2 * n), dtype=np.int8)
            if raw.size < 2:
                return None
            raw = raw[: (raw.size // 2) * 2].astype(np.float32)
            return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
        if self.format == "f32_iq":
            raw = np.frombuffer(self._f.read(8 * n), dtype=np.float32)
            if raw.size < 2:
                return None
            raw = raw[: (raw.size // 2) * 2]
            return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
        raise ValueError(f"unknown file format {self.format!r}")

    def close(self):
        self._f.close()


class SyntheticSource:
    """Streams the synthetic oracle scene with exact phase continuity."""

    def __init__(
        self,
        sats: Sequence[SatelliteScenario],
        fs_hz: float,
        f_if_hz: float = 0.0,
        noise_std: float = 0.0,
        seed: int = 0,
        total_samples: Optional[int] = None,
    ):
        self.fs_hz = fs_hz
        self.sats = list(sats)
        self.f_if_hz = f_if_hz
        self.noise_std = noise_std
        self.seed = seed
        self.total = total_samples
        self._pos = 0

    def read(self, n: int) -> Optional[np.ndarray]:
        if self.total is not None:
            n = min(n, self.total - self._pos)
            if n <= 0:
                return None
        out = synthesize(
            self.sats, n, self.fs_hz,
            f_if_hz=self.f_if_hz, noise_std=self.noise_std,
            # per-chunk seed keeps noise i.i.d. across chunks yet
            # deterministic for a given stream position
            seed=self.seed + self._pos,
            start_sample=self._pos,
        )
        self._pos += n
        return out


class ArraySource:
    """Wraps an in-memory array (the mock-device role of the reference's
    MockDevice, src/sdr_mock/device_mock.rs:7-69)."""

    def __init__(self, samples: np.ndarray, fs_hz: float):
        self.fs_hz = fs_hz
        self._samples = np.asarray(samples, dtype=np.complex64)
        self._pos = 0

    def read(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= self._samples.size:
            return None
        out = self._samples[self._pos:self._pos + n]
        self._pos += out.size
        return out


class StreamWindow:
    """Rolling history+block sample window fed to the device each step.

    Layout: ``[history | block]`` of ``h + b`` samples. ``advance()``
    rolls the block into history and appends fresh samples; short final
    blocks are zero-padded and reported so the pipeline can mask them.

    Storage is PLANAR float32 (``re``/``im``): every on-device consumer
    (conv acquisition, all tracking paths) wants planar f32, so keeping
    the window complex forced two full-window ``np.real``/``np.imag``
    copies per block. The ``buf`` property materializes the complex view
    for the (host/CPU) FFT acquisition path and diagnostics.
    """

    def __init__(self, history: int, block: int):
        self.h = history
        self.b = block
        self.re = np.zeros(history + block, dtype=np.float32)
        self.im = np.zeros(history + block, dtype=np.float32)
        self.global_start = -history  # global index of buf[0]
        self.blocks_fed = 0

    @property
    def buf(self) -> np.ndarray:
        """Complex view of the window (materialized on access)."""
        return (self.re + 1j * self.im).astype(np.complex64)

    def advance(self, fresh) -> Optional[int]:
        """Roll in one block of samples; returns the valid sample count,
        or None at end-of-stream. ``fresh``: complex array or an
        ``(re, im)`` planar float32 pair."""
        if fresh is None:
            return None
        if isinstance(fresh, tuple):
            fre, fim = fresh
        elif fresh.size == 0:
            return None
        else:
            fre = np.real(fresh).astype(np.float32)
            fim = np.imag(fresh).astype(np.float32)
        n = int(fre.size)
        if n == 0:
            return None
        h, b = self.h, self.b
        for buf, f in ((self.re, fre), (self.im, fim)):
            buf[:h] = buf[b:b + h].copy()
            buf[h:] = 0.0
            buf[h:h + n] = f
        self.global_start += self.b
        self.blocks_fed += 1
        return n

    def load(self, re: np.ndarray, im: np.ndarray) -> None:
        """Overwrite the window contents (checkpoint restore, span
        framing)."""
        self.re[:] = re
        self.im[:] = im

    def to_global(self, local_index: int) -> int:
        return self.global_start + local_index

    def to_local(self, global_index: int) -> int:
        return global_index - self.global_start


class DeviceStreamWindow:
    """Device-resident rolling window (same surface as StreamWindow):
    ``re``/``im`` are float32 tensors on ``device``; ``advance()``
    uploads only the fresh block and rolls the window on the device."""

    def __init__(self, history: int, block: int, device):
        self.h = history
        self.b = block
        self.device = torch.device(device)
        self.re = torch.zeros(history + block, dtype=torch.float32,
                              device=self.device)
        self.im = torch.zeros_like(self.re)
        self.global_start = -history
        self.blocks_fed = 0

    def advance(self, fresh) -> Optional[int]:
        if fresh is None:
            return None
        if isinstance(fresh, tuple):
            fre, fim = fresh
        elif fresh.size == 0:
            return None
        else:
            fre = np.real(fresh).astype(np.float32)
            fim = np.imag(fresh).astype(np.float32)
        n = int(fre.shape[0])
        if n == 0:
            return None
        new_re = torch.zeros(self.b, dtype=torch.float32, device=self.device)
        new_im = torch.zeros_like(new_re)
        new_re[:n] = torch.as_tensor(fre, dtype=torch.float32).to(self.device)
        new_im[:n] = torch.as_tensor(fim, dtype=torch.float32).to(self.device)
        self.re = torch.cat([self.re[self.b:], new_re])
        self.im = torch.cat([self.im[self.b:], new_im])
        self.global_start += self.b
        self.blocks_fed += 1
        return n

    def load(self, re, im) -> None:
        """Overwrite the window contents: tensors on the window's device
        pass straight through (the span path reloads the window from the
        span stream it built on the card), host arrays upload."""
        for name, x in (("re", re), ("im", im)):
            x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
            if x.shape != (self.h + self.b,):
                raise ValueError(f"window load: {name} has shape "
                                 f"{tuple(x.shape)}, not ({self.h + self.b},)")
            setattr(self, name, x)
