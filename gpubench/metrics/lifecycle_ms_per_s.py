"""The receivers' `lifecycle` stage (StageTimer), the search mode, the lost
channels, the observables and the ledger's rebase, over the window,
summed over the branches, ms per signal second; None where the program
has no such stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("lifecycle" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "lifecycle")
