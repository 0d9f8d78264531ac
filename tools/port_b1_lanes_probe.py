#!/usr/bin/env python3
"""Kernel B1 in lane clusters on the card (csrc/track_block_mxu.cu
``track_block_mxu_lanes``): where its supersteps' time goes, per block
rank.

    python3 tools/port_b1_lanes_probe.py

Builds a copy of the current source with ``clock64()`` stamps that each
block's thread 0 takes around every barrier of the lane kernel's
superstep loop and before every ``// ---- stage`` comment
(``port_b1_probe.instrument``), and runs it through the port's wrapper
at the mixed row's four 96 ms shapes (chip_smoke.wide_inputs: GPS,
BeiDou, GLONASS and Galileo E1B at 8.184 MHz, power lock, full
telemetry) at the cluster size and warps the wrapper picks
(chip_smoke.launched_lane). Reports, per stretch between two stamps, the
cycles per superstep of rank 0 (which adds the ranks' partial sums and
runs the chain) and the mean of the other ranks, and their share of the
block's cycles; the stamped kernel's time (5 queued launches, the L2
flushed) beside the unstamped one's, since the stamps cost a few cycles
each. Prints one JSON line. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
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


def main() -> int:
    import torch

    from gnss_sdr_tpu_torch.ops.cuda import _build
    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    if not torch.cuda.is_available():
        print("port_b1_lanes_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    tmp = Path(tempfile.mkdtemp(prefix="b1_lanes_probe_"))
    text = (_build.CSRC_DIR / "track_block_mxu.cu").read_text()
    stamped, labels = port_b1_probe.instrument(text, "track_block_mxu_lanes")
    (tmp / "lanes_split.cu").write_text(stamped)
    lib, ptxas = port_b1_probe.build(tmp / "lanes_split.cu",
                                     tmp / "lanes_split.so")
    fn = port_b1_probe._typed(lib, stamped)
    n_lab = len(labels)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {"device": smi, "labels": labels, "shapes": {}}
    for system in chip_smoke.WIDE_MXU_SHAPES:
        inp = chip_smoke.wide_inputs(torch, "cuda", system, {})
        args, kw = inp["args"], inp["kw"]
        opt = chip_smoke.launched_lane(args, kw)
        n_super = kw["t_epochs"] // kw["k_epochs"]
        c = args[4].shape[0]

        def run():
            return fused.track_block_fused_mxu(*args, **kw)

        run()
        plain_ms = statistics.median(chip_smoke._time_queued(
            torch, run, 5, flush))
        with port_b1_probe.using(fn):
            run()
            ms = statistics.median(chip_smoke._time_queued(
                torch, run, 5, flush))
            torch.cuda.synchronize()
            n_blocks = c * opt["cs"]
            buf = (ctypes.c_longlong * (n_blocks * n_lab))()
            assert lib.probe_read(buf, n_blocks) == 0
        cyc = [[buf[b * n_lab + k] for k in range(n_lab)]
               for b in range(n_blocks)]
        groups = {"rank0": [r for b, r in enumerate(cyc)
                            if b % opt["cs"] == 0],
                  "others": [r for b, r in enumerate(cyc)
                             if b % opt["cs"] != 0]}
        out = {"cs": opt["cs"], "warps": opt["warps"],
               "staged": opt["staged"], "ms": plain_ms,
               "stamped_ms": ms, "supersteps": n_super}
        for name, rows in groups.items():
            if not rows:
                continue
            total = statistics.mean(sum(r) for r in rows)
            out[name] = {
                "cycles_per_superstep": total / n_super,
                "stretches": [{
                    "label": f"{k}: {labels[k]}",
                    "cycles_per_superstep":
                        statistics.mean(r[k] for r in rows) / n_super,
                    "share": statistics.mean(r[k] for r in rows) / total,
                } for k in range(n_lab) if any(r[k] for r in rows)]}
        res["shapes"][system] = out
    res["ptxas"] = ptxas
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
