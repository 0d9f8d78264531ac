"""ctypes bindings for the native host-ingest runtime (counterpart of
``gnss_sdr_tpu/io/native.py``, over the same ``native/ingest.cpp``).

The reader thread and the SPSC ring that drain a capture file, and the
wire-format converters, are the repository's C++ (native/ingest.cpp).
The port compiles that source itself, with ``native/Makefile``'s flags,
into ``gnss_sdr_tpu_torch/_build/`` (one library per source hash), and
leaves ``native/`` untouched. Where no C++ compiler exists the native
path is unavailable (``native_available()`` is False) and ``convert``
takes its NumPy fallback; a library that fails to build or to load
raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SOURCE = os.path.join(_REPO, "native", "ingest.cpp")
_BUILD_DIR = os.path.join(_REPO, "gnss_sdr_tpu_torch", "_build")
# native/Makefile: CXXFLAGS and the link line
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall"]

_BYTES_PER_SAMPLE = {
    "int8_real": 1, "int8_iq": 2, "uint8_iq": 2, "int16_iq": 4,
}

_lib = None


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def _build_library() -> Optional[str]:
    """Compile native/ingest.cpp into _build/ (skipped when the library
    for this source and these flags exists); returns its path, or None
    where no compiler (or no source) exists. A failed build raises with
    the compiler's output."""
    cxx = _compiler()
    if cxx is None or not os.path.exists(_SOURCE):
        return None             # no compiler, or an install without native/
    with open(_SOURCE, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode())
    path = os.path.join(_BUILD_DIR, f"libgnss_ingest-{key.hexdigest()[:12]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # build beside the target and rename: concurrent builds (test
    # workers, a CLI subprocess) each publish a whole library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(
            [cxx, *_CXXFLAGS, "-shared", "-o", tmp, _SOURCE, "-lpthread"],
            capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise RuntimeError(
                f"building {_SOURCE} failed ({cxx}, exit {out.returncode}):"
                f"\n{out.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_library():
    """Load (building if needed) the native library; None where no
    compiler exists."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    for name in ("convert_int8_real", "convert_int8_iq", "convert_uint8_iq"):
        getattr(lib, name).argtypes = [u8p, f32p, f32p, ctypes.c_size_t]
        getattr(lib, name).restype = None
    lib.convert_int16_iq.argtypes = [
        ctypes.POINTER(ctypes.c_int16), f32p, f32p, ctypes.c_size_t]
    lib.convert_int16_iq.restype = None
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_size_t]
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    lib.ring_destroy.restype = None
    lib.ring_eos.restype = ctypes.c_int
    lib.ring_eos.argtypes = [ctypes.c_void_p]
    lib.ring_pop.restype = ctypes.c_size_t
    lib.ring_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.reader_start.restype = ctypes.c_void_p
    lib.reader_start.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.reader_stop.argtypes = [ctypes.c_void_p]
    lib.reader_stop.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return load_library() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _convert_numpy(raw_bytes: np.ndarray, wire_format: str) -> np.ndarray:
    if wire_format == "int8_real":
        return raw_bytes.view(np.int8).astype(np.float32).astype(np.complex64)
    if wire_format == "int8_iq":
        f = raw_bytes.view(np.int8).astype(np.float32)
    elif wire_format == "uint8_iq":
        f = raw_bytes.astype(np.float32) - 127.5
    else:
        f = raw_bytes.view(np.int16).astype(np.float32)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def convert(raw: np.ndarray, wire_format: str) -> np.ndarray:
    """Wire bytes -> complex64 via the native converters (NumPy where no
    compiler exists)."""
    if wire_format not in _BYTES_PER_SAMPLE:
        raise ValueError(f"unknown wire format {wire_format!r}")
    lib = load_library()
    # count samples by BYTES: callers pass uint8 wire buffers or
    # already-typed arrays
    bps = _BYTES_PER_SAMPLE[wire_format]
    raw_bytes = np.ascontiguousarray(raw).view(np.uint8).reshape(-1)
    n = raw_bytes.size // bps
    raw_bytes = raw_bytes[: n * bps]
    if lib is None:
        return _convert_numpy(raw_bytes, wire_format)
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    c_f = ctypes.c_float
    if wire_format == "int16_iq":
        lib.convert_int16_iq(_ptr(raw_bytes.view(np.int16), ctypes.c_int16),
                             _ptr(re, c_f), _ptr(im, c_f), n)
    else:
        getattr(lib, f"convert_{wire_format}")(
            _ptr(raw_bytes, ctypes.c_uint8), _ptr(re, c_f), _ptr(im, c_f), n)
    return (re + 1j * im).astype(np.complex64)


class NativeFileSource:
    """SampleSource backed by the native reader thread + SPSC ring: the
    file or FIFO drains on a C++ thread, so block pulls never stall on
    IO (the reference's sdr_thread pumping a ring, main.rs:186-191)."""

    def __init__(self, path: str, fs_hz: float,
                 wire_format: str = "int8_real", ring_bytes: int = 1 << 24):
        self._ring = None
        self._reader = None
        if wire_format not in _BYTES_PER_SAMPLE:
            raise ValueError(f"unknown wire format {wire_format!r}")
        lib = load_library()
        if lib is None:
            raise RuntimeError(
                "native ingest needs a C++ compiler to build "
                "native/ingest.cpp, and none was found")
        self._lib = lib
        self.fs_hz = fs_hz
        self.format = wire_format
        self._bps = _BYTES_PER_SAMPLE[wire_format]
        ring = lib.ring_create(ring_bytes)
        reader = lib.reader_start(path.encode(), ring, 1 << 18)
        if not reader:
            lib.ring_destroy(ring)
            raise FileNotFoundError(path)
        self._ring = ring
        self._reader = reader

    def read(self, n: int) -> Optional[np.ndarray]:
        want = n * self._bps
        buf = np.empty(want, np.uint8)
        got = 0
        eos = False
        while got < want:
            chunk = self._lib.ring_pop(
                self._ring, _ptr(buf[got:], ctypes.c_uint8), want - got)
            got += chunk
            if chunk == 0:
                if eos:
                    break
                # the reader sets end of stream after its last push: one
                # more pop once it is seen drains that push
                eos = bool(self._lib.ring_eos(self._ring))
                if not eos:
                    time.sleep(0.001)
        if got == 0:
            return None
        usable = (got // self._bps) * self._bps
        return convert(buf[:usable], self.format)

    def close(self):
        if self._reader:
            self._lib.reader_stop(self._reader)
            self._reader = None
        if self._ring:
            self._lib.ring_destroy(self._ring)
            self._ring = None

    def __del__(self):
        self.close()
