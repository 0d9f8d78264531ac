"""Real-time factor (``rtf.<config>``): signal seconds of every block
completed in the window over the window's wall seconds."""
from gpubench.harness.readers import rtf as read  # noqa: F401
