"""The readers that the metric files under ``gpubench/metrics`` are
made of. Each takes the Run and returns a number, or None where the run
holds nothing to read (then the metric is left out of the line)."""
from __future__ import annotations

from .stats import percentile, rate
from .trace import kernel_seconds

# published peaks of one H100 SXM (dense): HBM bytes/s, bf16 and f32
# (outside the tensor cores) operations/s
H100_BYTES_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12


def rtf(run) -> float:
    """Signal seconds completed per wall second over the window."""
    return rate(run.signal_s, run.window_s)


def setup_s(run) -> float:
    return run.setup_s


def block_p95_ms(run) -> float:
    """95th percentile of every branch's block steps in the window, ms
    (a step: the block's pull, search when due, tracking with its
    telemetry on the host, nav)."""
    steps = [s for br in run.branches.values() for s in br.step_s]
    return percentile(steps, 95.0) * 1e3


def stage_ms_per_s(run, stage: str) -> float:
    """The receivers' time in ``stage`` over the window, summed over the
    branches, per signal second."""
    total = sum(br.stage_s(stage) for br in run.branches.values())
    return total * 1e3 / run.signal_s


def card_ms_per_s(run):
    """The program's busy time on the card over the window, ms per
    signal second (None where the card clock did not run)."""
    if run.card_busy_s is None:
        return None
    return run.card_busy_s * 1e3 / run.signal_s


def device_idle_pct(run):
    t = run.trace_summary
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def graph_kernels_per_epoch(run):
    """Device kernels per tracking epoch inside the traced graph
    replays (each replay runs one block's epochs, catch-up epoch
    included)."""
    t = run.trace_summary
    if not t or not t["graph_launches"] or not t["graph_kernels"]:
        return None
    (d,) = run.config["branches"].values()
    epochs = d["block_ms"] + 1            # 1 ms code periods, +1 catch-up
    return t["graph_kernels"] / (t["graph_launches"] * epochs)


def bound_s(tot: dict) -> float:
    """The least time of the work counted in ``tot``: its bytes at the
    HBM rate against its operations at their peak rates."""
    return max(tot["bytes"] / H100_BYTES_S,
               tot["bf16_ops"] / H100_BF16_FLOPS,
               tot["f32_ops"] / H100_F32_FLOPS)


def roofline_pct(run, kernel: str, match: str):
    """The kernel's bound time over its device time in the traced
    window, as a percentage."""
    tot = run.rooflines.get(kernel)
    t = run.trace_summary
    if not tot or not tot["launches"] or not t:
        return None
    n, dev_s = kernel_seconds(t, match)
    if n == 0 or dev_s <= 0:
        return None
    return 100.0 * bound_s(tot) / dev_s
