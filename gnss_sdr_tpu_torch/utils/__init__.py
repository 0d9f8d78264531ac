from . import checkpoint  # noqa: F401
from .profiling import StageTimer, trace  # noqa: F401
from .telemetry import ChannelTrace, TelemetryLog  # noqa: F401
from .view import acquisition_heatmap, plot_psd, plot_receiver_state, power_spectrum  # noqa: F401
