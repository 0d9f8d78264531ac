"""``block_p95_ms.<config>``: the 95th percentile of every branch's
block steps in the window, ms; a live receiver keeps real time while it
stays under the block length."""
from gpubench.harness.readers import block_p95_ms as read  # noqa: F401
