"""The receivers' `track.absorb` stage (StageTimer), the host's work on a
block's downloaded results: the ledger and the telemetry, over the
window, summed over the branches, ms per signal second; None where the
program has no such stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("track.absorb" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "track.absorb")
