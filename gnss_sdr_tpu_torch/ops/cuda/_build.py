"""Build-at-first-use of the port's CUDA sources into shared libraries
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``gnss_sdr_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads from the cache. ``build_all`` builds every source, one ``nvcc``
each, all at once. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# --fmad=false: no multiply-add contraction, so every f32 scalar step of
# a kernel rounds as the plain PyTorch version's separate ops do; the
# kernels call fmaf explicitly where they want a fused multiply-add.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    # PyTorch's lookup: $CUDA_HOME / $CUDA_PATH, nvcc on PATH, the
    # default toolkit location
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _target(name: str, src: Path | None = None) -> tuple[Path, Path]:
    src = src or CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"CUDA source {src} missing")
    # the shared headers are part of every source's key
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load_library(name: str, src: Path | None = None) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, or from the
    source ``src`` (built now if it is not cached)."""
    if name in _LIBS:
        return _LIBS[name]
    src, out = _target(name, src)
    t0 = time.perf_counter()
    # nvcc's output (ptxas' registers and stack) is kept beside the
    # library, so a cached build still reports it
    log_path = out.with_suffix(".log")
    log, cached = "", out.exists()
    if cached and log_path.exists():
        log = log_path.read_text()
    if not cached:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                             capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} "
                               f"(exit {res.returncode}):\n{log}")
        tmp_log = tmp.with_suffix(".log")
        tmp_log.write_text(log)
        os.replace(tmp_log, log_path)
        os.replace(tmp, out)          # atomic: concurrent builders agree
    BUILD_LOG[name] = {"so": str(out), "seconds": time.perf_counter() - t0,
                       "cached": cached, "ptxas": log}
    _LIBS[name] = ctypes.CDLL(str(out))
    return _LIBS[name]


def build_all(extra: dict[str, Path] | None = None) -> dict[str, dict]:
    """Build every ``csrc/*.cu`` and the sources of ``extra`` ({name:
    path}), one nvcc each, all started together, and load them; returns
    the build log per source."""
    jobs = {p.stem: None for p in sorted(CSRC_DIR.glob("*.cu"))}
    jobs.update(extra or {})
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        list(pool.map(lambda kv: load_library(*kv), jobs.items()))
    return {n: BUILD_LOG[n] for n in jobs}
