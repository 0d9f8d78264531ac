"""Kernel B4b (track_block_epoch on the seg feed): its bound time
(rooflines/b4b.py) over its device time, summed over the traced
launches, percent."""
from gpubench.harness.readers import roofline_pct

ROOFLINE = "b4b"


def read(run):
    return roofline_pct(run, ROOFLINE, "track_block_epoch")
