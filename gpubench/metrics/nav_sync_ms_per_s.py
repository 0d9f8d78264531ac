"""The receivers' `nav.sync` stage (StageTimer), the nav layer's feed of
the channels whose chain has not bit-synced yet, over the window, summed
over the branches, ms per signal second; None where the program has no
such stage."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    if not any("nav.sync" in br.stages1 for br in run.branches.values()):
        return None
    return stage_ms_per_s(run, "nav.sync")
