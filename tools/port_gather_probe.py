#!/usr/bin/env python3
"""Kernel B4c of the PyTorch port (``gather_segments``,
``gnss_sdr_tpu_torch/csrc/gather_segments.cu``) against the PyTorch
indexing call that computes the same copy, in turns on the card.

    python3 tools/port_gather_probe.py [--rounds N]

The inputs are chip_smoke's phase 16 ones (``chip_smoke.epoch_inputs``,
seg feed: 32 channels, 125 ms blocks at 2.046 MHz): B4c copies each
channel's segment out of the block's stream, and the indexing call is
``block[idx]`` for each component with ``idx`` precomputed, as phase 16
times it. Each round runs B4c, indexing, indexing, B4c; each turn is
chip_smoke.KERNEL_PASSES calls, the L2 flushed before each, CUDA events
around each, all queued before one synchronise, and is made twice:

* ``queued``: with no head start; an interval then holds the card's
  work, or the host's work to launch the call where the host is the
  slower of the two;
* ``head_start``: behind a spin kernel (``torch.cuda._sleep``) that
  holds the card until the host has queued every call, as chip_smoke's
  ``_time_queued`` times kernels now, so each interval holds the card's
  work alone.

Prints one JSON line: each variant's median, min and max per round and
over all rounds, and the card's name and power limit. Needs one CUDA
device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    from gnss_sdr_tpu_torch.ops.cuda import track_block_fused as fused

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    args_cli = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_gather_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    inp = chip_smoke.epoch_inputs(torch, "seg", {})
    (sre, sim, starts, l_seg), g_kw = inp["gather"]
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        l_seg, device="cuda")[None, :]
    fns = {"gather": lambda: fused.gather_segments(sre, sim, starts, l_seg,
                                                   **g_kw),
           "indexing": lambda: (sre[idx], sim[idx])}
    seg = fns["gather"]()
    ref = fns["indexing"]()
    assert all(torch.equal(a, b) for a, b in zip(seg, ref)), "B4c differs"
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def turn(name, head_start):
        return chip_smoke._time_queued(torch, fns[name],
                                       chip_smoke.KERNEL_PASSES, flush,
                                       head_start=head_start)

    for name in fns:                    # warm-up
        turn(name, False)
    variants = [f"{n}_{m}" for n in fns for m in ("queued", "head_start")]
    rounds = {v: [] for v in variants}
    for _ in range(args_cli.rounds):
        times = {v: [] for v in variants}
        for name in ("gather", "indexing", "indexing", "gather"):
            for mode in ("queued", "head_start"):
                times[f"{name}_{mode}"] += turn(name, mode == "head_start")
        for v in variants:
            rounds[v].append(times[v])
    res = {"device": smi, "passes_per_turn": chip_smoke.KERNEL_PASSES}
    for v in variants:
        every = [x for r in rounds[v] for x in r]
        res[v] = {"ms": statistics.median(every), "ms_min": min(every),
                  "ms_max": max(every),
                  "ms_per_round": [statistics.median(r) for r in rounds[v]]}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
