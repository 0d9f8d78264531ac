"""Kernel B1 (track_block_mxu): its bound time (bytes or operations at
the H100's peaks, rooflines/b1.py) over its device time, summed over the
traced launches, percent."""
from gpubench.harness.readers import roofline_pct

ROOFLINE = "b1"


def read(run):
    return roofline_pct(run, ROOFLINE, "track_block_mxu")
