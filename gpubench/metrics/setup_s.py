"""Seconds from process start to the window's start: the port loaded
(and its CUDA sources built where not yet cached), the receiver built
and warmed up on the cell's stream."""
from gpubench.harness.readers import setup_s as read  # noqa: F401
