"""The receivers' `ingest` stage (StageTimer) over the window, summed
over the branches, ms per signal second."""
from gpubench.harness.readers import stage_ms_per_s


def read(run):
    return stage_ms_per_s(run, "ingest")
