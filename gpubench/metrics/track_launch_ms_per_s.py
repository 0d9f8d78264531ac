"""The receivers' `track.launch` stage (StageTimer), the work that puts a
block on the card: the replica rows, uploads and kernels of the fused
tracker, or the scanned tracker's packed ledger and graph replay, over
the window, summed over the branches, ms per signal second; None where
the program has no such stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("track.launch" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "track.launch")
