#!/usr/bin/env python3
"""The fused receiver's steady state on the card (chip_smoke.py phase
9 (b) and its single-block reference) with the current mxu kernel (B1),
an earlier version of its source and, with ``--plain``, the kernel's
plain PyTorch version, in one process:

    python3 tools/port_steady_probe.py --old-src OLD/track_block_mxu.cu [--plain]

The 10 s 24-satellite scene (chip_smoke._scene) runs through
``Receiver.run()`` single-block and in synchronous 8-block spans, for
each variant in turns (current, old, current, old, then the plain
version). Per variant: the two runs' wall seconds and ``track`` stage
seconds (the end-to-end effect of the kernel, compared within this
call), and per PRN the epochs and the last Doppler of the spans run
against the single-block run's. The two runs mix each window on another
128-sample grid (a span's blocks sit 24 samples apart on it), so their
bf16 roundings differ and their closed loops may part; the plain
version shows how far the contract itself lets them part. Prints one
JSON line. Needs one CUDA device and nvcc.

Beside each PRN's last Doppler (the held rate at the start of the last
superstep) it reports its mean over the last 50 epochs (the settled
average ``Receiver.compute_velocity`` takes) and over the last block
(500 epochs, the quantity chip_smoke.py phase 9 holds per PRN), each as
the spans run against the single-block run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke  # noqa: E402
import port_b1_probe  # noqa: E402


def run_pair(torch, sats, sig, label):
    """Single-block and 8-block synchronous spans on ``sig``: wall and
    track seconds of each, per-PRN epoch and last-Doppler differences."""
    out, settled = {}, {}
    for name, kw in (("single", {}),
                     ("spans", dict(scan_blocks=chip_smoke.STEADY_SPAN))):
        rx, summary, _ = chip_smoke._run_receiver(torch, sats, sig,
                                                  f"{label} {name}", **kw)
        out[name] = summary
        settled[name] = {n: chip_smoke.settled_doppler(rx, n)
                         for n in (50, chip_smoke.SETTLED_EPOCHS)}
    ch1 = {c["prn"]: c for c in out["single"]["channels"]}
    chb = {c["prn"]: c for c in out["spans"]["channels"]}
    diff = {p: abs(chb[p]["last_doppler_hz"] - ch1[p]["last_doppler_hz"])
            for p in ch1}
    res = {}
    for n, a in settled["single"].items():
        d = {p: abs(settled["spans"][n][p] - a[p]) for p in a}
        res[f"settled_{n}_diff_hz"] = d
        res[f"settled_{n}_diff_max_hz"] = max(d.values())
    return {
        **res,
        "wall_s": {k: v["wall_s"] for k, v in out.items()},
        "track_s": {k: v["stage_timing"]["track"]["total_s"]
                    for k, v in out.items()},
        "epochs_equal": all(chb[p]["epochs"] == ch1[p]["epochs"]
                            for p in ch1),
        "doppler_diff_hz": diff,
        "doppler_diff_median_hz": statistics.median(diff.values()),
        "doppler_diff_max_hz": max(diff.values()),
    }


def main() -> int:
    import torch

    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-src", type=Path, required=True)
    ap.add_argument("--plain", action="store_true",
                    help="also run the plain version (~40 s)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_steady_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    tmp = Path(tempfile.mkdtemp(prefix="steady_probe_"))
    old_lib, _ = port_b1_probe.build(args.old_src, tmp / "old.so")
    fns = {"current": fused._lib(),
           "old": port_b1_probe._typed(old_lib, args.old_src.read_text())}
    sats, sig = chip_smoke._scene(chip_smoke.STEADY_S)
    res = {}
    for turn, name in enumerate(("current", "old", "current", "old")):
        with port_b1_probe.using(fns[name]):
            res[f"{name}_{turn}"] = run_pair(torch, sats, sig, name)
    if args.plain:
        kernel = fused.track_block_fused_mxu
        # the trackers bind the wrapper when they are built
        fused.track_block_fused_mxu = fused.track_block_fused_mxu_reference
        try:
            res["plain"] = run_pair(torch, sats, sig, "plain")
        finally:
            fused.track_block_fused_mxu = kernel
    print(json.dumps({"device": smi, "runs": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
