"""The share of the traced stretch in which no kernel, copy or set of
the program ran on the card, percent (the generator's are left out)."""
from gpubench.harness.readers import device_idle_pct as read  # noqa: F401
