from .acquisition import AcquisitionEngine, Candidate, SearchMode, SearchScheduler  # noqa: F401
from .pipeline import Receiver  # noqa: F401
from .stream import ArraySource, DeviceArraySource, DeviceStreamWindow, FileSource, SampleSource, StreamingDeviceSource, StreamWindow, SyntheticSource  # noqa: F401
from .tracking import (  # noqa: F401
    ChannelState,
    EpochTelemetry,
    TrackParams,
    init_state,
    make_code_table,
    make_sampled_code_table,
    rebase,
    start_channel,
    state_from_numpy,
    track_block,
)
from .navproc import ChannelNav, NavProcessor  # noqa: F401
from .multi import MultiConstellationReceiver, TeeSource  # noqa: F401
