#!/usr/bin/env python3
"""Kernel B7 of the PyTorch port on the card against the op loop it
replaced: the scanned tracker's block of epochs as one launch, in turns
with the op loop's CUDA graph replay, in one process.

    python3 tools/port_scan_probe.py [--passes N]

At chip_smoke's SCAN_TIMED shapes (15 channels, 100 ms at 2.048 MHz, the
rtlsdr default; 32 channels, 500 ms at 2.046 MHz, the main path) it
captures the op loop (``tracking.run_epoch_ops``, about 190 PyTorch ops
an epoch) into one CUDA graph, as the tracker did before B7, and times
the replay, then B7 (``chip_smoke.scan_timing``: its time, its plain
version's eager time and its bounds), then the replay again: CUDA events
around each replay or launch, the calls queued back to back behind a
head start, the block L2-resident as the receiver leaves it.

Before the timing, B7, the op graph and the op loop on the CPU (the same
ops as the graph, summed in another order) each run the whole block from
one ledger, every channel's loops closed over its epochs, and the probe
holds B7 to its two plain versions channel by channel: the flags, starts
and epoch counts equal, and each channel's largest prompt-sum gap over
the block's largest prompt within PROMPT_GAP_LIMIT of the nearer plain
version. Where the two plain versions part on a channel (a negative
Doppler's carrier step moves in grains of 256 counts, and carrier rates
an ulp apart can fall on either side of a grain's edge:
chip_smoke.SCAN_CLOSED_ON_CPU), it prints that channel's first epoch
whose carrier step differs between the op graph and the CPU's op loop,
the two steps and the carrier rates they came from. Prints one JSON line
with the card's name and power limit. Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# each channel's largest prompt-sum gap over the block's largest prompt,
# B7 against the nearer of the op graph on the card and the op loop on
# the CPU, every epoch of one block with the loops closed (the plain
# versions differ by up to 7.4e-4 where they do not part)
PROMPT_GAP_LIMIT = 1e-3
_FLAGS = ("processed", "locked", "lost_event", "start_offset",
          "epoch_index")


def channel_gaps(ta, tb, prn, label):
    """Per channel: the largest prompt-sum gap over the block's largest
    |prompt| (both sums, processed epochs), the largest carrier gap (Hz)
    and the first epoch whose prompt gap passes 1e-6 of that largest
    (``first_gap_epoch``, None where none does). The flags, starts and
    epoch counts must be equal."""
    for f in _FLAGS:
        assert np.array_equal(getattr(ta, f), getattr(tb, f)), (label, f)
    proc = tb.processed
    scale = max(float(np.abs(tb.i_p).max()), float(np.abs(tb.q_p).max()),
                1e-30)
    gap = np.maximum(np.abs(ta.i_p.astype("f8") - tb.i_p),
                     np.abs(ta.q_p.astype("f8") - tb.q_p)) / scale
    gap = np.where(proc, gap, 0.0)
    carr = np.where(proc, np.abs(ta.carr_freq.astype("f8") - tb.carr_freq),
                    0.0)
    out = []
    for ch in range(gap.shape[1]):
        late = np.nonzero(gap[:, ch] > 1e-6)[0]
        out.append(dict(channel=ch, prn=int(prn[ch]),
                        epochs=int(proc[:, ch].sum()),
                        prompt_gap=float(gap[:, ch].max()),
                        carr_gap_hz=float(carr[:, ch].max()),
                        first_gap_epoch=(int(late[0]) if late.size
                                         else None)))
    return out


def probe(torch, name, passes):
    from gnss_sdr_tpu_torch.ops import nco
    from gnss_sdr_tpu_torch.ops.cuda import track_block_scan as b7
    from gnss_sdr_tpu_torch.receiver import tracking as trk

    inputs = chip_smoke.scan_inputs(torch, name)
    params, codes, ins, re, im, t_epochs, _ = inputs
    c = codes.shape[0]
    prn = ins[c:2 * c].cpu().numpy() + 1      # the ledger's prn_idx row

    # the op loop as one CUDA graph, warmed up on a side stream first
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trk.run_epoch_ops(params, codes, ins, re, im, t_epochs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = trk.run_epoch_ops(params, codes, ins, re, im, t_epochs)
    graph.replay()
    _, tg = trk.unpack_block(static, c, t_epochs)
    _, tk = trk.unpack_block(
        b7.track_block_scan(params, codes, ins, re, im, t_epochs), c,
        t_epochs)
    _, tc = trk.unpack_block(trk.run_epoch_ops(
        params, codes.cpu(), ins.cpu(), re.cpu(), im.cpu(), t_epochs), c,
        t_epochs)
    b7_gaps = channel_gaps(tk, tg, prn, (name, "b7"))
    b7_cpu_gaps = channel_gaps(tk, tc, prn, (name, "b7 vs cpu"))
    cpu_gaps = channel_gaps(tc, tg, prn, (name, "cpu"))
    held = [min(a["prompt_gap"], b["prompt_gap"])
            for a, b in zip(b7_gaps, b7_cpu_gaps)]
    apart = {}
    for ch, g in enumerate(cpu_gaps):
        if g["prompt_gap"] <= PROMPT_GAP_LIMIT:
            continue
        # epoch e + 1's carrier step, from epoch e's carrier rate as the
        # op loop forms it
        steps = {side: nco.cycles_to_step(torch.from_numpy(
            x.carr_freq[:, ch]) * nco.inv_f32(params.fs_hz)).numpy()
            for side, x in (("graph", tg), ("cpu", tc))}
        e = int(np.argmax(steps["graph"] != steps["cpu"]))
        apart[ch] = dict(prn=g["prn"], epoch=e + 1, **{
            side: dict(carr_freq=float(x.carr_freq[e, ch]),
                       step=int(steps[side][e]))
            for side, x in (("graph", tg), ("cpu", tc))})

    no_flush = torch.empty(0, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    g1 = chip_smoke._time_queued(torch, graph.replay, passes, no_flush)
    kernel = chip_smoke.scan_timing(torch, name, passes, inputs)
    g2 = chip_smoke._time_queued(torch, graph.replay, passes, no_flush)
    g_ms = statistics.median(g1 + g2)
    res = dict(b7=kernel, op_graph_ms=g_ms,
               op_graph_ms_turns=[statistics.median(g1),
                                  statistics.median(g2)],
               speedup=g_ms / kernel["ms"],
               prompt_gap=max(g["prompt_gap"] for g in b7_gaps),
               prompt_gap_to_cpu=max(g["prompt_gap"] for g in b7_cpu_gaps),
               prompt_gap_held=max(held),
               prompt_gap_cpu_to_graph=max(g["prompt_gap"]
                                           for g in cpu_gaps),
               apart=apart, channels_b7=b7_gaps, channels_b7_cpu=b7_cpu_gaps,
               channels_cpu=cpu_gaps)
    return res


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--passes", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.phase_device(torch)
    res = {name: probe(torch, name, args.passes)
           for name in chip_smoke.SCAN_TIMED}
    print(json.dumps({"probe": "port_scan_probe", "device": smi,
                      "shapes": res}))
    for name, r in res.items():
        assert r["prompt_gap_held"] <= PROMPT_GAP_LIMIT, (name, r["apart"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
