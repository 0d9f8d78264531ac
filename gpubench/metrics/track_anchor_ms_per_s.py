"""The receivers' `track.anchor` stage (StageTimer), the fused tracker's
re-anchor of the exact ledger on the host (FusedTracker.anchor_block),
over the window, summed over the branches, ms per signal second; None
where the program has no such stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("track.anchor" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "track.anchor")
