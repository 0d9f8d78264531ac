#!/usr/bin/env python3
"""The per-epoch kernels of the PyTorch port on the card (B4a, B4b and B6
in ``gnss_sdr_tpu_torch/csrc/track_block_epoch.cu``, B3 in
``csrc/track_block_direct.cu``, all over ``csrc/epoch_core.cuh``): an
earlier version of the three sources against the current one, in one
process and in turns, with the per-stretch split of each.

    python3 tools/port_epoch_probe.py --old-src OLD_DIR

``OLD_DIR`` holds an earlier ``epoch_core.cuh``, ``track_block_epoch.cu``
and ``track_block_direct.cu`` with the same C entry points (e.g. the
files at an earlier commit, unpacked with ``git archive``). The script
builds them with nvcc beside the current ones and drives both through
the port's wrappers on chip_smoke's own inputs at full width (32
channels, 24 tracking and 8 idle, 2.046 MHz): windows at 500 ms blocks
(T=500, wp=2176), seg at 125 ms (T=125, wp=2432) and resident (T=500,
wp=4352) from ``chip_smoke.epoch_inputs``; direct (T=500, K=10,
wp=2560) from ``chip_smoke.full_width_inputs``. First each version is
held to the plain version open loop (``chip_smoke.epoch_open_loop`` and
``open_loop_compare``). Then the split: a copy of the sources, written
into a temporary directory, whose header has ``clock64()`` stamps that
thread 0 takes at the top and bottom of ``run_epoch``, around each of
its barriers (``__syncthreads();``, ``mbar_wait(``) and before each of
its stage comments (``// ---- stage``; keep those comments when editing
the kernel); it runs each feed once and reports, per stretch between two
stamps, the cycles per epoch averaged over the blocks and their share of
the block's cycles. The stamps cost a few cycles each, so the stamped
kernel's time is reported beside the share. Then the times per block
(CUDA events around queued launches, the L2 flushed before each,
chip_smoke.KERNEL_PASSES per turn) in the order: each variant once (old
and current, each feed), then the same backwards. ``--receivers N``
then drives chip_smoke's phase 17 receivers (the 24-satellite scene, 5
s: 125 ms blocks on seg, 500 ms blocks on windows and on direct) with
each version's kernels, after one warm-up run each, N times in the
order old, new, new, old, and reports each layout's ``track`` stage per
block (the receiver's StageTimer, host clock). ``--only old`` or
``--only new`` probes one version alone. At the main path's shapes each
version's telemetry and state are also held to the other's bit for bit
(``bit_for_bit``), where the current core keeps one block a channel.

``--wide`` takes the wide shapes instead (``chip_smoke.epoch_wide_inputs``
at 8.184 MHz): B4b at wp 33,152 (Galileo E1B, 20 ms blocks) and B3 at wp
33,280 (96 ms), each at 4 and 8 channels, and B4a (wp 8,320) and B6 (wp
16,640) on GPS at 8 channels; the current core runs them in lane
clusters (the size the wrapper launches), an earlier one as it did. The
split then stamps ``run_epoch_lanes`` of the current header (its cluster
barrier's wait a stretch of its own) and reports it per rank as well
(the blocks' flat index is rank + cs x channel).
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

HEADER = "epoch_core.cuh"
SOURCES = ("track_block_epoch", "track_block_direct")
_BARRIER = re.compile(r"__syncthreads\(\);|mbar_wait\(|cluster_wait\(\);")
_STAGE = re.compile(r"^\s*// ---- (stage .*?)\s*-*$")


def _body(lines, pattern):
    """(index of the line that opens the body of the function whose
    definition matches ``pattern``, index of its closing line)."""
    i0 = next(i for i, ln in enumerate(lines) if re.search(pattern, ln))
    while "{" not in lines[i0]:
        i0 += 1
    depth = 0
    for i in range(i0, len(lines)):
        depth += lines[i].count("{") - lines[i].count("}")
        if depth == 0:
            return i0, i
    raise ValueError(f"no body for {pattern}")


def instrument(text: str, fn: str = "run_epoch",
               load: str = "load_channel",
               store: str = "store_channel") -> tuple[str, list[str]]:
    """A copy of the header with thread 0's clock64 stamps in ``fn``
    (module docstring), the stretches summed per block in shared memory
    from ``load`` on and written to ``g_probe`` by ``store`` at the
    block's flat index. Returns (header, the label of each stretch)."""
    lines = text.splitlines()
    labels: list[str] = []

    def stamp(label):
        labels.append(label)
        k = len(labels) - 1
        # every stamp sits where whole warps run; the warp reconverges
        # after it, before an aligned barrier that may follow
        return ("{ if (threadIdx.x == 0) { long long _t = clock64(); "
                f"_pacc[{k}] += _t - _pt; _pt = _t; }} __syncwarp(); }}")

    i0, i1 = _body(lines, rf"__device__.*\b{fn}\(")
    out = lines[:i0 + 1]
    out.append(stamp("between epochs: the feed's loop (the first epoch: "
                     "the prologue)"))
    current = "the epoch's NCO quantities"
    for ln in lines[i0 + 1:i1]:
        m = _STAGE.search(ln)
        if m:
            out.append(stamp(current))
            current = m.group(1).strip()
            out.append(ln)
        elif _BARRIER.search(ln):
            out.append(stamp(current))
            out.append(ln)
            out.append(stamp(f"wait: {ln.strip()} (after {current})"))
        else:
            out.append(ln)
    out.append(stamp(current))
    out += lines[i1:]
    n = len(labels)
    # the sums start in `load` and leave in `store`
    flat = "(blockIdx.x + blockIdx.y * gridDim.x)"
    for pattern, code in (
            (rf"__device__.*\b{load}\(",
             "  if (threadIdx.x == 0) { for (int _i = 0; _i < kProbeN; ++_i)"
             " _pacc[_i] = 0; _pt = clock64(); }"),
            (rf"__device__.*\b{store}\(",
             "  if (threadIdx.x == 0) for (int _i = 0; _i < kProbeN; ++_i) "
             f"g_probe[{flat} * kProbeN + _i] = _pacc[_i];")):
        j0, _ = _body(out, pattern)
        out.insert(j0 + 1, code)
    src = "\n".join(out) + "\n"
    src = src.replace(
        "namespace epoch {",
        f"namespace epoch {{\nconstexpr int kProbeN = {n};\n"
        "__shared__ long long _pacc[kProbeN];\n__shared__ long long _pt;\n"
        f"__device__ long long g_probe[1024 * kProbeN];", 1)
    return src, labels


_READER = ('\nextern "C" int probe_read(void* dst, int n_blocks) {\n'
           "  return (int)cudaMemcpyFromSymbol(dst, epoch::g_probe, "
           "(size_t)n_blocks * epoch::kProbeN * sizeof(long long));\n}\n")


def build(src: Path, so: Path):
    """nvcc with the port's flags; returns (the library, ptxas summary)."""
    from gnss_sdr_tpu_torch.ops.cuda import _build

    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return ctypes.CDLL(str(so)), chip_smoke.ptxas_summary(
        res.stdout + res.stderr)


def _typed(libs):
    """The two libraries' launch entries, typed as the wrappers'; an
    earlier source's entries, which end at the stream (no cluster size,
    no rank states), drop the two arguments the wrappers add."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    fns = []
    for lib, name, types in (
            (libs["track_block_epoch"], "track_block_epoch_launch",
             ep.EPOCH_ARGTYPES),
            (libs["track_block_direct"], "track_block_direct_launch",
             fused.DIRECT_ARGTYPES)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        if hasattr(lib, name.replace("_launch", "_clusters")):
            fn.argtypes = types
            fns.append(fn)
        else:
            fn.argtypes = types[:-2]
            fns.append(lambda *a, _fn=fn: _fn(*a[:-2]))
    return tuple(fns)


@contextlib.contextmanager
def using(fns):
    """The wrappers launch the kernels of ``fns`` (epoch, direct)."""
    from gnss_sdr_tpu_torch.ops.cuda import track_block_epoch as ep
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    saved = ep._epoch_lib, fused._direct_lib
    ep._epoch_lib = lambda: fns[0]  # noqa: E731
    fused._direct_lib = lambda: fns[1]  # noqa: E731
    try:
        yield
    finally:
        ep._epoch_lib, fused._direct_lib = saved


def _cases(torch, wide):
    """{name: (kernel kind, args, kw, epochs a block)}: chip_smoke's
    full-width inputs at the main path's shapes, or its wide ones."""
    out = {}
    if wide:
        for kind, chans in (("seg", (4, 8)), ("direct", (4, 8)),
                            ("windows", (8,)), ("resident", (8,))):
            for c in chans:
                inp = chip_smoke.epoch_wide_inputs(torch, kind, {}, c)
                kw = inp["kw"]
                out[f"{kind}_{c}ch"] = (kind, inp["args"], kw, kw.get(
                    "t_epochs", inp["args"][0].shape[0]))
        return out
    for feed in ("windows", "seg", "resident"):
        inp = chip_smoke.epoch_inputs(torch, feed, {})
        out[feed] = (feed, inp["args"], inp["kw"], inp["ft"].t_epochs)
    _, d_args, d_kw = chip_smoke.full_width_inputs(torch, "cuda", {},
                                                   layout="direct")
    out["direct"] = ("direct", d_args, d_kw, d_kw["t_epochs"])
    return out


def _open_loop(torch, kind, args, kw, wide):
    """One case against its plain version, open loop."""
    if kind == "direct":
        return chip_smoke.open_loop_compare(torch, args, kw,
                                            layout="direct")[2]
    piece = (chip_smoke.EPOCH_WIDE_PIECE[kind] if wide else
             25 if kind == "seg" else chip_smoke.EPOCH_PIECE)
    return chip_smoke.epoch_open_loop(torch, kind, args, kw,
                                      piece=piece)[2]


def main() -> int:
    import torch

    from gnss_sdr_tpu_torch.ops.cuda import _build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-src", type=Path, required=True)
    ap.add_argument("--only", choices=("old", "new"),
                    help="probe one version alone")
    ap.add_argument("--wide", action="store_true",
                    help="the 8.184 MHz shapes (lane clusters)")
    ap.add_argument("--receivers", type=int, default=0, metavar="N",
                    help="also time the phase 17 receivers, N turns")
    args_cli = ap.parse_args()
    versions = (args_cli.only,) if args_cli.only else ("old", "new")
    wide = args_cli.wide
    if not torch.cuda.is_available():
        print("port_epoch_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    tmp = Path(tempfile.mkdtemp(prefix="epoch_probe_"))
    dirs = {"old": args_cli.old_src, "new": _build.CSRC_DIR}
    labels, jobs = {}, {}
    for ver in versions:
        for kind in ("", "_split"):
            d = tmp / (ver + kind)
            d.mkdir()
            header = (dirs[ver] / HEADER).read_text()
            if kind:
                lanes = wide and "run_epoch_lanes" in header
                header, labels[ver] = instrument(
                    header, *(("run_epoch_lanes", "load_channel_lanes",
                               "store_channel_lanes") if lanes else ()))
            (d / HEADER).write_text(header)
            for name in SOURCES:
                text = (dirs[ver] / f"{name}.cu").read_text()
                (d / f"{name}.cu").write_text(text + (_READER if kind
                                                      else ""))
    with ThreadPoolExecutor(max_workers=8) as pool:
        for ver in versions:
            for kind in ("", "_split"):
                for name in SOURCES:
                    d = tmp / (ver + kind)
                    jobs[(ver + kind, name)] = pool.submit(
                        build, d / f"{name}.cu", d / f"{name}.so")
        built = {k: v.result() for k, v in jobs.items()}
    fns, libs, ptxas = {}, {}, {}
    for ver in versions:
        for kind in ("", "_split"):
            libs[ver + kind] = {n: built[(ver + kind, n)][0] for n in SOURCES}
            fns[ver + kind] = _typed(libs[ver + kind])
            ptxas[ver + kind] = {n: built[(ver + kind, n)][1]
                                 for n in SOURCES}

    cases = _cases(torch, wide)

    def call(name):
        kind, f_args, f_kw, _ = cases[name]
        return chip_smoke._epoch_fns(kind)[0](*f_args, **f_kw)

    # ---- each version against the plain version, open loop; and against
    # each other bit for bit --------------------------------------------
    checks, outs = {}, {}
    for ver in versions:
        with using(fns[ver]):
            for name, (kind, f_args, f_kw, _) in cases.items():
                checks[f"{ver}_{name}"] = _open_loop(torch, kind, f_args,
                                                     f_kw, wide)
                outs[(ver, name)] = call(name)
    torch.cuda.synchronize()
    bit_for_bit = {}
    if len(versions) == 2:
        bit_for_bit = {name: all(torch.equal(a, b) for a, b in zip(
            outs[("old", name)], outs[("new", name)])) for name in cases}

    # ---- the split -----------------------------------------------------
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    split = {}
    for ver in versions:
        n_lab = len(labels[ver])
        for name, (kind, f_args, f_kw, t_epochs) in cases.items():
            c = f_args[4 if kind == "direct" else 3].shape[0]
            launched = chip_smoke.launched_epoch(kind, f_args, f_kw)
            cs = launched["cs"] if ver == "new" and launched["cs"] else 1
            buf = (ctypes.c_longlong * (c * cs * n_lab))()
            lib = libs[f"{ver}_split"]["track_block_direct" if kind ==
                                       "direct" else "track_block_epoch"]
            with using(fns[f"{ver}_split"]):
                ms = statistics.median(chip_smoke._time_queued(
                    torch, lambda: call(name), 5, flush))
                torch.cuda.synchronize()
            assert lib.probe_read(buf, c * cs) == 0
            cyc = [[buf[b * n_lab + k] for k in range(n_lab)]
                   for b in range(c * cs)]
            total = statistics.mean(sum(row) for row in cyc)

            def stretches(rows, total=total):
                return [{
                    "label": f"{k}: {labels[ver][k]}",
                    "cycles_per_epoch":
                        statistics.mean(row[k] for row in rows) / t_epochs,
                    "share": statistics.mean(row[k] for row in rows) / total,
                } for k in range(n_lab) if any(row[k] for row in rows)]

            split[f"{ver}_{name}"] = {
                "cs": cs,
                "stamped_kernel_ms": ms,
                "cycles_per_block": total,
                "cycles_per_epoch": total / t_epochs,
                "clock_ghz": total / (ms * 1e6),
                "stretches": stretches(cyc),
            }
            if cs > 1:
                # blocks at flat index rank + cs x channel
                split[f"{ver}_{name}"]["by_rank"] = {
                    r: stretches(cyc[r::cs]) for r in range(cs)}

    # ---- the times, in turns ---------------------------------------------
    variants = [(ver, name) for ver in versions for name in cases]

    def timed(variant):
        ver, name = variant
        with using(fns[ver]):
            return chip_smoke._time_queued(
                torch, lambda: call(name), chip_smoke.KERNEL_PASSES, flush)

    for v in variants:
        timed(v)                        # warm-up
    times = {v: [] for v in variants}
    for v in variants + variants[::-1]:
        times[v] += timed(v)
    times = {f"{ver}_{name}": t for (ver, name), t in times.items()}
    # ---- the receivers on the per-epoch layouts, in turns ----------------
    track = {}
    if args_cli.receivers:
        sats, sig = chip_smoke._scene(chip_smoke.SEG_S)
        runs = {"seg": dict(block_ms=chip_smoke.SEG_BLOCK_MS),
                "windows": dict(layout="windows"),
                "direct": dict(layout="direct")}

        def drive(ver):
            out = {}
            with using(fns[ver]):
                for name, kw in runs.items():
                    _, summary, _ = chip_smoke._run_receiver(
                        torch, sats, sig, f"{ver} {name}", **kw)
                    t = summary["stage_timing"]["track"]
                    out[name] = t["total_s"] / t["calls"] * 1e3
            return out

        for ver in versions:
            drive(ver)                  # warm-up
        for _ in range(args_cli.receivers):
            for ver in versions + versions[::-1]:
                for name, ms in drive(ver).items():
                    track.setdefault(f"{ver}_{name}", []).append(ms)
    res = {
        "device": smi,
        "wide": wide,
        "layouts": {name: chip_smoke._epoch_label(chip_smoke.launched_epoch(
            kind, a, k)) for name, (kind, a, k, _) in cases.items()},
        "track_ms_per_block": {k: statistics.median(v)
                               for k, v in track.items()},
        "track_ms_per_block_runs": track,
        "ms_per_block": {k: statistics.median(v) for k, v in times.items()},
        "ms_min": {k: min(v) for k, v in times.items()},
        "ms_max": {k: max(v) for k, v in times.items()},
        "us_per_epoch": {k: statistics.median(v)
                         / cases[k.split("_", 1)[1]][3] * 1e3
                         for k, v in times.items()},
        "bit_for_bit": bit_for_bit,
        "split": split,
        "checks_vs_plain": checks,
        "ptxas": ptxas,
    }
    shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
