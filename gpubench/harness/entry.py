"""One run of a cell, from its arguments to the result's last line.

``execute`` runs the cell on ``device``, reads the metrics, checks the
answers against the reference, and prints (stdout's last line) the one
JSON object of the result, and before it on stderr each compared number
beside its limit (the numbers the configuration does not compare go
under ``readings``, before ``compared``). ``gpubench/run.py`` calls it on the card after its
checks for one; the tests call it on the CPU.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import tempfile

import torch

from . import checks, spec
from .cell import run_cell

FORBIDDEN = ("jax", "jaxlib", "flax", "gnss_sdr_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that this process must not
    hold (compared whole: gnss_sdr_tpu_torch is not gnss_sdr_tpu)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _metrics(bench, run, trace: bool) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    out = {}
    for m in spec.metrics_for(bench, run.cell, kind):
        v = spec.metric_reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def execute(bench: dict, workload: str, seed: int, seconds: float,
            trace: bool, device="cuda", t_process=None, out=None,
            err=None) -> dict | None:
    """Run, measure, check and print one cell; returns the result (None
    where the run must print none)."""
    out = out or sys.stdout
    err = err or sys.stderr

    def log(msg):
        print(msg, file=err, flush=True)

    device = torch.device(device)
    cell = spec.cell(bench, workload)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    with tempfile.TemporaryDirectory(prefix="gpubench_") as tmp:
        run = run_cell(bench, workload, seed, seconds, trace, device=device,
                       t_process=t_process, tmp_dir=tmp, log=log)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        log(f"refused: modules loaded in this process: {bad}")
        return None
    metrics = _metrics(bench, run, trace)
    steps = sum(len(br.step_s) for br in run.branches.values())
    log(f"block steps in the window: {steps} "
        f"({len(run.branches)} branches x {run.window_blocks} blocks)")
    for br in run.branches.values():
        log(f"  {br.name}: stages in the window "
            + json.dumps({k: round(br.stage_s(k), 6)
                          for k in sorted(br.stages1)}))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": steps, "failed": 0,
              "metrics": metrics, "device": dev}
    t = run.trace_summary
    if trace and t:
        dev["busy_s"] = t["busy_s"]
        dev["window_s"] = t["window_s"]
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in t["device_ops"][:10]],
            "idle_gaps": [[k, v] for k, v in t["idle_gaps"][:10]]}
        log(f"generator device s in the traced stretch: "
            f"{t['generator_s']}; graph launches {t['graph_launches']}, "
            f"their kernels {t['graph_kernels']}")
        for k, tot in run.rooflines.items():
            log(f"roofline {k}: {json.dumps(tot)}")
    if device.type == "cuda":
        log(f"card: {power_limit()}")
    # the reference runs once the window has closed and the program's
    # state is freed (it reads the program's answers, kept on the host)
    for br in run.branches.values():
        br.rx = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = {}
    correct, numbers = checks.check(run, log=log, readings=readings)
    result["correct"] = bool(correct)
    result["readings"] = readings
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in numbers.items()}
    for k, (v, lim) in numbers.items():
        log(f"{k} {v!r} limit {lim!r}")
    print(json.dumps(result), file=out, flush=True)
    return result
