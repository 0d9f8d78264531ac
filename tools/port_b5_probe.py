#!/usr/bin/env python3
"""Kernel B5 of the PyTorch port on the card: an earlier version of its
CUDA source against the current one at each cluster size, in one process
and in turns.

    python3 tools/port_b5_probe.py --old-src OLD/epl_correlator.cu

``--old-src`` is a B5 source with the [C, W] interface of the port's
first version (one thread block per channel; e.g. the file at an earlier
commit, unpacked with ``git archive``). The script builds it with nvcc
beside the current one, holds both to the plain version at the operating
point (32 channels, 2.046 MHz, 24 tracking and 8 idle masks), then times
per 500 ms block (501 launches, fresh inputs, the L2 flushed before each
launch; the kernel's device time from the profiler) in the order old,
current variants..., current variants reversed, old: the current kernel
through its C launcher at cluster sizes 4, 1, 2 and 8 (each within
B5_TOL of the plain version; the sums' order, so their ulps, follow the
size); the wrapper's own launch is checked equal to the size it picks,
bit for bit. Prints one JSON line. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

def build_old(src: Path, out_dir: Path):
    """The old source as a ctypes function with its [C, W] interface."""
    from gnss_sdr_tpu_torch.ops.cuda import _build

    so = out_dir / "old_epl_correlator.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).epl_correlator_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptxas = [line.strip() for line in (res.stdout + res.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return fn, ptxas


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnss_sdr_tpu_torch.ops import correlator as corr
    from gnss_sdr_tpu_torch.ops.correlator import EplSums
    from gnss_sdr_tpu_torch.ops.cuda import _build
    from gnss_sdr_tpu_torch.ops.cuda import epl_correlator as b5

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-src", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_b5_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    _build.load_library("epl_correlator")
    tmp = Path(tempfile.mkdtemp(prefix="b5_probe_"))
    old_fn, old_ptxas = build_old(args.old_src, tmp)

    t_epochs = chip_smoke.BLOCK_MS + 1
    inputs, st = chip_smoke.b5_inputs(torch, "gps_l1ca", chip_smoke.FS,
                                      n_epochs=t_epochs, seed=7)
    kw = dict(shift=st["shift"], oversample=st["oversample"])
    blocks = [chip_smoke.b5_block_form(torch, a, seed=k)
              for k, a in enumerate(inputs)]
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def old(k):
        re, im, n_valid, acc, step, chip_int, frac, cps, codes = inputs[k]
        c, w = re.shape
        out = torch.empty((c, 6), dtype=torch.float32, device="cuda")
        err = old_fn(re.data_ptr(), im.data_ptr(), n_valid.data_ptr(),
                     acc.data_ptr(), step.data_ptr(), chip_int.data_ptr(),
                     frac.data_ptr(), cps.data_ptr(), codes.data_ptr(),
                     out.data_ptr(), c, w, codes.shape[1], kw["shift"],
                     kw["oversample"], 0,
                     torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return EplSums(*out.unbind(1))

    launch, fits = b5._lib()
    c, n_code = inputs[0][8].shape

    def current(cluster):
        """The current kernel through its C launcher, at this cluster size
        (the wrapper picks cluster_size's)."""
        assert fits(c, cluster, n_code) > 0, cluster

        def run(k):
            block_re, block_im, starts, _ = blocks[k]
            out = torch.empty((c, 6), dtype=torch.float32, device="cuda")
            ptrs = [t.data_ptr() for t in (block_re, block_im, starts,
                                           *inputs[k][2:], out)]
            err = launch(*ptrs, c, block_re.shape[0], st["window"], n_code,
                         kw["shift"], kw["oversample"], 0, cluster,
                         torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            return EplSums(*out.unbind(1))
        return run

    variants = {"old": old}
    for cluster in (4, 1, 2, 8):
        variants[f"cluster{cluster}"] = current(cluster)

    # each against the plain version, and the variants' bits
    ref = corr.epl_correlate_one_shift(*inputs[0], **kw)
    first = {}
    check = {}
    for name, run in variants.items():
        got = run(0)
        torch.cuda.synchronize()
        rel = max(float((a.double() - b.double()).abs().max())
                  / max(float(b.double().abs().max()), 1e-30)
                  for a, b in zip(got, ref))
        assert rel < chip_smoke.B5_TOL, (name, rel)
        check[name] = rel
        first[name] = got
    # the wrapper launches the kernel at cluster_size's pick
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    pick = b5.cluster_size(c, n_sm)
    block_re, block_im, starts, max_start = blocks[0]
    wrapped = b5.epl_correlate_block(block_re, block_im, starts,
                                     *inputs[0][2:], window=st["window"],
                                     max_start=max_start, **kw)
    assert all(torch.equal(x, y) for x, y in
               zip(wrapped, first[f"cluster{pick}"])), pick

    def profiled(run):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for k in range(t_epochs):
                flush.zero_()
                run(k)
            torch.cuda.synchronize()
        per = [e for e in prof.key_averages()
               if "epl_correlator_kernel" in e.key]
        n = sum(e.count for e in per)
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in per)
        return us / 1e3, n

    for run in variants.values():
        for k in range(3):
            run(k)
    torch.cuda.synchronize()
    order = list(variants) + list(reversed(variants))
    times = {name: [] for name in variants}
    for name in order:
        for _ in range(3):             # a pass that lost launches again
            ms, n = profiled(variants[name])
            if n == t_epochs:
                times[name].append(ms)
                break
        else:
            raise AssertionError(f"{name}: the profiler saw {n} launches")
    res = {
        "device": smi,
        "wrapper_cluster": pick,
        "ms_per_block": {k: sum(v) / len(v) for k, v in times.items()},
        "ms_per_block_turns": times,
        "us_per_launch": {k: sum(v) / len(v) / t_epochs * 1e3
                          for k, v in times.items()},
        "rel_err_vs_plain": check,
        "old_ptxas": old_ptxas,
    }
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
