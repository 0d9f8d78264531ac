"""Device kernels per tracking epoch inside the scanned tracker's CUDA
graph replays in the traced stretch (a count)."""
from gpubench.harness.readers import graph_kernels_per_epoch as read  # noqa: F401
