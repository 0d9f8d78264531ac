"""Sample sources and the streaming windows (counterpart of
``gnss_sdr_tpu/receiver/stream.py``).

A pull-based ``SampleSource`` protocol (file, synthetic and in-memory
sources) feeds a rolling ``[history | block]`` window: ``StreamWindow``
keeps it in host memory (numpy, the CPU receiver), ``DeviceStreamWindow``
keeps it in torch tensors on the receiver's device and uploads only the
fresh block each step. ``global_start`` is the absolute sample index of
the window's first sample (a host Python int), while tracking offsets
stay block-relative int32.

Two sources hand the receiver planar ``(re, im)`` float32 tensors that
already lie on its device, so a block makes no host round trip:
``DeviceArraySource`` uploads a whole stream once, and
``StreamingDeviceSource`` stages a host source's blocks through pinned
buffers on a copy stream of its own, ahead of the consumer. Both can
carry the samples as int8 (the RTL-SDR wire precision, +-4 sigma at full
scale) and dequantize on the device per read.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from ..device import resolve_device
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


def _planar_f32(samples) -> tuple[np.ndarray, np.ndarray]:
    """Host float32 (re, im) from a complex array or a planar pair."""
    if isinstance(samples, tuple):
        return tuple(np.ascontiguousarray(
            x.cpu().numpy() if isinstance(x, torch.Tensor) else x,
            dtype=np.float32) for x in samples)
    samples = np.asarray(samples)
    return (np.ascontiguousarray(np.real(samples), dtype=np.float32),
            np.ascontiguousarray(np.imag(samples), dtype=np.float32))


def _int8_scale(re: np.ndarray, im: np.ndarray) -> np.float32:
    """The int8 step that puts +-4 sigma of the larger rail at +-127."""
    sigma = float(max(np.std(re), np.std(im), 1e-12))
    return np.float32(4.0 * sigma / 127.0)


def _quantize(x: np.ndarray, scale: np.float32) -> np.ndarray:
    return np.clip(np.round(x / scale), -127, 127).astype(np.int8)


class DeviceArraySource:
    """In-memory source staged in DEVICE memory (planar f32 or int8).

    Uploads the whole stream to ``device`` (default the card) once at
    construction; ``read`` returns ``(re, im)`` float32 slices on that
    device, with no per-block transfer. ``store="int8"`` quantizes on the
    host with one scale for the stream (+-4 sigma at +-127, 4x less
    upload) and dequantizes on the device per read."""

    def __init__(self, samples, fs_hz: float, store: str = "f32",
                 device=None):
        if store not in ("f32", "int8"):
            raise ValueError(f"unknown store {store!r}")
        self.fs_hz = fs_hz
        self.device = resolve_device(device)
        re, im = _planar_f32(samples)
        self._scale = None
        if store == "int8":
            self._scale = _int8_scale(re, im)
            re, im = _quantize(re, self._scale), _quantize(im, self._scale)
        self._re = torch.from_numpy(re).to(self.device)
        self._im = torch.from_numpy(im).to(self.device)
        self._n = int(self._re.shape[0])
        self._pos = 0

    def read(self, n: int):
        if self._pos >= self._n:
            return None
        end = min(self._pos + n, self._n)
        re = self._re[self._pos:end]
        im = self._im[self._pos:end]
        if self._scale is not None:
            re = re.to(torch.float32) * float(self._scale)
            im = im.to(torch.float32) * float(self._scale)
        self._pos = end
        return (re, im)


class StreamingDeviceSource:
    """Host -> device ingest ahead of the consumer (the reference's SDR
    reader thread feeding its ring, sdr_thread.rs:9-37).

    A feeder thread pulls blocks from a host ``SampleSource``, stages each
    into pinned host buffers (int8 with a per-chunk scale, or f32) and
    copies it to ``device`` on a CUDA stream of its own, recording an
    event per block; up to ``depth`` blocks wait in the queue. ``read``
    makes the consumer's stream wait on the block's event (the host does
    not wait for the copy) and dequantizes there. On the CPU device the
    blocks are plain CPU tensors.

    The consumer must read one block size throughout (the Receiver does);
    the feeder runs ahead of it by up to ``depth`` blocks. ``stats()``
    says whether it kept ahead: ``consumer_wait_s`` (time ``read`` spent
    blocked after the first block) near 0 and a mean queue depth above 0.
    """

    def __init__(self, source, depth: int = 3, store: str = "int8",
                 device=None):
        if store not in ("int8", "f32"):
            raise ValueError(f"unknown store {store!r}")
        self.fs_hz = source.fs_hz
        self.device = resolve_device(device)
        self._source = source
        self._depth = depth
        self._store = store
        self._queue = None
        self._thread = None
        self._block_n = None
        self._stopping = False
        self._eos = False
        self._copy_stream = None
        self.reads = 0
        self.consumer_wait_s = 0.0
        self.cold_wait_s = 0.0
        self.max_queue_depth = 0
        self._depth_sum = 0
        self._depth_n = 0

    def _stage(self, raw):
        """One block, staged: (re, im, size, scale, event) with re/im on
        the device (int8 or f32) and the copy's event (None on the CPU)."""
        re, im = _planar_f32(raw)
        scale = None
        if self._store == "int8":
            # a per-chunk scale: one frozen from the first block would
            # lock onto a silent or settling stream start
            scale = _int8_scale(re, im)
            re, im = _quantize(re, scale), _quantize(im, scale)
        host = (torch.from_numpy(re), torch.from_numpy(im))
        if self.device.type == "cpu":
            return host + (re.shape[0], scale, None)
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(h.pin_memory().to(self.device, non_blocking=True)
                        for h in host)
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return dev + (re.shape[0], scale, event)

    def _put(self, item) -> bool:
        """Bounded put that yields to close(): the consumer may stop
        reading mid-stream and the feeder must not block forever."""
        while not self._stopping:
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _feeder(self):
        try:
            while not self._stopping:
                raw = self._source.read(self._block_n)
                if raw is None:
                    break
                size = (raw[0].shape[0] if isinstance(raw, tuple)
                        else raw.size)
                if size == 0:
                    break
                if not self._put(self._stage(raw)):
                    return
                if size < self._block_n:
                    break             # short tail = end of stream
            self._put(None)
        except BaseException as e:  # noqa: BLE001 - handed to the reader
            self._put(e)

    def read(self, n: int):
        if self._eos:
            return None
        if self._thread is None:
            self._block_n = n
            self._queue = queue.Queue(maxsize=self._depth)
            if self.device.type == "cuda":
                self._copy_stream = torch.cuda.Stream(self.device)
            self._thread = threading.Thread(target=self._feeder,
                                            daemon=True)
            self._thread.start()
        if n != self._block_n:
            raise ValueError(
                f"StreamingDeviceSource block size changed: "
                f"{self._block_n} -> {n}")
        d = self._queue.qsize()
        self.max_queue_depth = max(self.max_queue_depth, d)
        self._depth_sum += d
        self._depth_n += 1
        t0 = time.perf_counter()
        item = self._queue.get()
        wait = time.perf_counter() - t0
        if self.reads == 0:
            self.cold_wait_s += wait
        else:
            self.consumer_wait_s += wait
        self.reads += 1
        if item is None or isinstance(item, BaseException):
            # end of stream is sticky: the feeder has stopped, and the
            # receiver may read again after a short span
            self._eos = True
            if item is not None:
                raise RuntimeError("StreamingDeviceSource feeder failed") \
                    from item
            return None
        re, im, size, scale, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            # the blocks were allocated on the copy stream: keep the
            # allocator from reusing them before the consumer is done
            re.record_stream(consumer)
            im.record_stream(consumer)
        if scale is not None:
            re = re.to(torch.float32) * float(scale)
            im = im.to(torch.float32) * float(scale)
        return (re[:size], im[:size])

    def stats(self) -> dict:
        """Overlap counters: did the feeder keep the device fed?"""
        return {
            "reads": self.reads,
            "consumer_wait_s": round(self.consumer_wait_s, 4),
            "cold_fill_s": round(self.cold_wait_s, 4),
            "max_queue_depth": self.max_queue_depth,
            "mean_queue_depth": round(
                self._depth_sum / max(self._depth_n, 1), 2),
        }

    def close(self):
        """Stop the feeder (its bounded put sees the flag) and join it
        with a bounded wait: close() never hangs, even with the consumer
        stopped early on an unbounded source."""
        self._stopping = True
        if self._thread is not None:
            self._thread.join(timeout=5.0)


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

    @property
    def buf(self) -> np.ndarray:
        """Complex numpy copy of the window (downloads from the card; for
        diagnostics and checkpoints only)."""
        return (self.re.cpu().numpy() + 1j * self.im.cpu().numpy()).astype(
            np.complex64)

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

    def to_global(self, local_index: int) -> int:
        return self.global_start + local_index

    def to_local(self, global_index: int) -> int:
        return global_index - self.global_start
