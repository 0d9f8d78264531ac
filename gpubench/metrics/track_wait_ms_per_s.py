"""The receivers' `track.wait` stage (StageTimer), the one download of a
block's results, which waits for the card, over the window, summed over
the branches, ms per signal second; None where the program has no such
stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("track.wait" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "track.wait")
