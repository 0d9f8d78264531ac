#!/usr/bin/env python3
"""Kernels B1 and B2 of the PyTorch port on the card (one CUDA source,
``gnss_sdr_tpu_torch/csrc/track_block_mxu.cu``): an earlier version of
the source against the current one, in one process and in turns, with
the per-stage split of each.

    python3 tools/port_b1_probe.py --old-src OLD/track_block_mxu.cu

``--old-src`` is a version of the source with the same C entry point
(``track_block_mxu_launch``; e.g. the file at an earlier commit,
unpacked with ``git archive``). The script builds it with nvcc beside
the current one and drives both through the port's wrapper at the
receiver's operating point (chip_smoke.full_width_inputs: 32 channels,
24 tracking and 8 idle, 500 ms blocks at 2.046 MHz, T=500, K=5, R=8,
wp=2560). First each is held to the plain version: B1 full and lean
open loop (chip_smoke.open_loop_compare), B2 at each cluster size equal
to the same source's B1 bit for bit. Then the split: a copy of each
source, written into a temporary directory, with ``clock64()`` stamps
that thread 0 takes around every barrier of the superstep loop and
before every stage comment (``// ---- stage``); it runs B1 full, B1
lean and B2 once each and reports, per stretch between two stamps, the
cycles per superstep averaged over the blocks and their share of the
block's cycles. The stamps cost a few cycles each, so the stamped
kernel's time is reported beside the share. Then the times per 500 ms
block (CUDA events around queued launches, the L2 flushed before each,
chip_smoke.KERNEL_PASSES per turn) in the order: each variant once, then
the same backwards (old and current B1 full, B1 lean, B2 at cluster
sizes 2, 4, 8, 1). ``--only old`` or ``--only new`` probes one version
alone. Prints one JSON line. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

CLUSTERS = (2, 4, 8, 1)
_BARRIER = re.compile(r"__syncthreads\(\);|this_cluster\(\)\.sync\(\);|"
                      r"mbar_wait\(|cluster_wait\(\);")
_STAGE = re.compile(r"^\s*// ---- (stages? [\w-]+)")
_LOOP = re.compile(r"for \(int j = 0; j < n_super; \+\+j\) \{")


def instrument(text: str, kernel: str = "track_block_mxu_kernel"
               ) -> tuple[str, list[str]]:
    """A copy of the mxu source with thread 0's clock64 stamps in the
    superstep loop of ``kernel`` (the whole-width kernel, or
    ``track_block_mxu_lanes``; module docstring), the stamps' stretches
    summed per block (blockIdx.y * gridDim.x + blockIdx.x) into
    ``g_probe`` and read by ``probe_read``. Returns (source, the label of
    each stretch)."""
    lines = text.splitlines()
    i_k = next(i for i, ln in enumerate(lines)
               if re.search(rf"\b{kernel}\(Params p\)", ln))
    # the stamps' state at the kernel's top
    i_sm = next(i for i in range(i_k, len(lines))
                if re.search(r"extern __shared__[^;]*smem\[\];", lines[i]))
    lines[i_sm + 1:i_sm + 1] = [
        "  __shared__ long long _pacc[kProbeN];",
        "  if (threadIdx.x == 0) for (int _i = 0; _i < kProbeN; ++_i)"
        " _pacc[_i] = 0;",
        "  long long _pt = clock64();"]
    i_loop = next(i for i in range(i_k, len(lines)) if _LOOP.search(lines[i]))
    depth, i_end = 0, None
    for i in range(i_loop, len(lines)):
        depth += lines[i].count("{") - lines[i].count("}")
        if depth == 0:
            i_end = i
            break
    labels: list[str] = []

    def stamp(label):
        labels.append(label)
        k = len(labels) - 1
        # every stamp sits where whole warps run; the warp reconverges
        # after it, before an aligned barrier that may follow
        return ("{ if (threadIdx.x == 0) { long long _t = clock64(); "
                f"_pacc[{k}] += _t - _pt; _pt = _t; }} __syncwarp(); }}")

    out = lines[:i_loop + 1]
    out.append(stamp("loop top (the first superstep: the prologue)"))
    current = "loop top"
    for ln in lines[i_loop + 1:i_end]:
        m = _STAGE.search(ln)
        if m:
            out.append(stamp(current))
            current = m.group(1)
            out.append(ln)
        elif _BARRIER.search(ln):
            out.append(stamp(current))
            out.append(ln)
            out.append(stamp(f"wait: {ln.strip()} (after {current})"))
        else:
            out.append(ln)
    out.append(stamp(current))
    out.append(lines[i_end])
    out.append("  if (threadIdx.x == 0) for (int _i = 0; _i < kProbeN; ++_i)"
               " g_probe[(blockIdx.y * gridDim.x + blockIdx.x) * kProbeN"
               " + _i] = _pacc[_i];")
    out += lines[i_end + 1:]
    src = "\n".join(out) + "\n"
    # the sums' home after the includes, and the reader at the end
    n = len(labels)
    src = src.replace(
        "namespace {",
        f"namespace {{\nconstexpr int kProbeN = {n};\n"
        f"__device__ long long g_probe[1024 * {n}];", 1)
    src += ('extern "C" int probe_read(void* dst, int n_blocks) {\n'
            "  return (int)cudaMemcpyFromSymbol(dst, g_probe, "
            "(size_t)n_blocks * kProbeN * sizeof(long long));\n}\n")
    return src, labels


def build(src: Path, so: Path):
    """nvcc with the port's flags; returns (the library, ptxas summary)."""
    from gnss_sdr_tpu_torch.ops.cuda import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return ctypes.CDLL(str(so)), chip_smoke.ptxas_summary(
        res.stdout + res.stderr)


def _typed(lib, text=None):
    """The library's track_block_mxu_launch, typed as the wrapper's. A
    source ``text`` from before the lane clusters ends its parameters
    with the lane chunk (no window staging or warps): its entry point is
    typed so and called without the wrapper's last two arguments (the
    whole-width layout, where the chunk is 0)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    fn = lib.track_block_mxu_launch
    if text is None or "int warps)" in text:
        fn.argtypes, fn.restype = fused.MXU_ARGTYPES, ctypes.c_int
        return fn
    fn.argtypes, fn.restype = fused.MXU_ARGTYPES[:-2], ctypes.c_int
    return lambda *args: fn(*args[:-2])


@contextlib.contextmanager
def using(fn, clusters=None):
    """The wrapper launches ``fn`` (and B2 at ``clusters`` only)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    lib, sizes = fused._lib, fused.shared_cluster_sizes
    fused._lib = lambda: fn  # noqa: E731
    if clusters is not None:
        fused.shared_cluster_sizes = lambda c: clusters  # noqa: E731
    try:
        yield
    finally:
        fused._lib, fused.shared_cluster_sizes = lib, sizes


def main() -> int:
    import torch

    from gnss_sdr_tpu_torch.ops.cuda import _build
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-src", type=Path, required=True)
    ap.add_argument("--only", choices=("old", "new"),
                    help="probe one version alone")
    args_cli = ap.parse_args()
    versions = (args_cli.only,) if args_cli.only else ("old", "new")
    if not torch.cuda.is_available():
        print("port_b1_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    tmp = Path(tempfile.mkdtemp(prefix="b1_probe_"))
    new_src = _build.CSRC_DIR / "track_block_mxu.cu"
    sources = {"old": args_cli.old_src.read_text(),
               "new": new_src.read_text()}
    sources = {k: sources[k] for k in versions}
    jobs, labels = {}, {}
    for name, text in sources.items():
        (tmp / f"{name}.cu").write_text(text)
        stamped, labels[name] = instrument(text)
        (tmp / f"{name}_split.cu").write_text(stamped)
    with ThreadPoolExecutor(max_workers=4) as pool:
        for name in [v + s for v in versions for s in ("", "_split")]:
            jobs[name] = pool.submit(build, tmp / f"{name}.cu",
                                     tmp / f"{name}.so")
        built = {k: v.result() for k, v in jobs.items()}
    fns = {k: _typed(lib, sources[k.split("_")[0]])
           for k, (lib, _) in built.items()}

    _, b1_args, b1_kw = chip_smoke.full_width_inputs(torch, "cuda", {})
    _, b2_args, b2_kw = chip_smoke.full_width_inputs(torch, "cuda", {},
                                                     shared_fetch=True)
    lean_kw = dict(b1_kw, telem_mode="lean")
    n_super = b1_kw["t_epochs"] // b1_kw["k_epochs"]
    c = b1_args[4].shape[0]

    # ---- each version against the plain version, B2 against B1 -------
    checks = {}
    for ver in versions:
        with using(fns[ver]):
            for mode, kw in (("full", b1_kw), ("lean", lean_kw)):
                _, _, err = chip_smoke.open_loop_compare(torch, b1_args, kw)
                checks[f"{ver}_b1_{mode}"] = err
            ref = fused.track_block_fused_mxu(*b1_args, **b1_kw)
        for cs in CLUSTERS:
            with using(fns[ver], (cs,)):
                got = fused.track_block_fused_mxu(*b2_args, **b2_kw)
            assert all(torch.equal(x, y) for x, y in zip(got, ref)), (ver, cs)
    torch.cuda.synchronize()

    # ---- the split -----------------------------------------------------
    split = {}
    for ver in versions:
        lib = built[f"{ver}_split"][0]
        n_lab = len(labels[ver])
        buf = (ctypes.c_longlong * (c * n_lab))()
        for case, run_args, kw, cs in (
                ("b1_full", b1_args, b1_kw, None),
                ("b1_lean", b1_args, lean_kw, None),
                ("b2_cluster2", b2_args, b2_kw, (2,))):
            with using(fns[f"{ver}_split"], cs):
                flush = torch.empty(64 << 20, dtype=torch.uint8,
                                    device="cuda")
                ms = statistics.median(chip_smoke._time_queued(
                    torch, lambda: fused.track_block_fused_mxu(
                        *run_args, **kw), 5, flush))
                torch.cuda.synchronize()
                assert lib.probe_read(buf, c) == 0
            cyc = [[buf[b * n_lab + k] for k in range(n_lab)]
                   for b in range(c)]
            total = statistics.mean(sum(row) for row in cyc)
            split[f"{ver}_{case}"] = {
                "stamped_kernel_ms": ms,
                "cycles_per_block": total,
                "clock_ghz": total / (ms * 1e6),
                "stretches": [{
                    "label": f"{k}: {labels[ver][k]}",
                    "cycles_per_superstep":
                        statistics.mean(row[k] for row in cyc) / n_super,
                    "share": statistics.mean(row[k] for row in cyc) / total,
                } for k in range(n_lab)
                    if any(row[k] for row in cyc)],
            }

    # ---- the times, in turns ---------------------------------------------
    variants = {}
    for ver in versions:
        variants[f"{ver}_b1_full"] = (fns[ver], None, b1_args, b1_kw)
        variants[f"{ver}_b1_lean"] = (fns[ver], None, b1_args, lean_kw)
        for cs in CLUSTERS:
            variants[f"{ver}_b2_cluster{cs}"] = (fns[ver], (cs,), b2_args,
                                                 b2_kw)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def timed(name):
        fn, cs, run_args, kw = variants[name]
        with using(fn, cs):
            return chip_smoke._time_queued(
                torch, lambda: fused.track_block_fused_mxu(*run_args, **kw),
                chip_smoke.KERNEL_PASSES, flush)

    for name in variants:
        timed(name)                     # warm-up
    times = {name: [] for name in variants}
    order = list(variants)
    for name in order + order[::-1]:
        times[name] += timed(name)
    res = {
        "device": smi,
        "ms_per_block": {k: statistics.median(v) for k, v in times.items()},
        "ms_min": {k: min(v) for k, v in times.items()},
        "ms_max": {k: max(v) for k, v in times.items()},
        "us_per_superstep": {k: statistics.median(v) / n_super * 1e3
                             for k, v in times.items()},
        "split": split,
        "checks_vs_plain": checks,
        "ptxas": {k: v for k, (_, v) in built.items()},
    }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
