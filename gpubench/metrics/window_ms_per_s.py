"""The receivers' `window` stage (StageTimer), the stream window's advance
over each fresh block, over the window, summed over the branches, ms per
signal second; None where the program has no such stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("window" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "window")
