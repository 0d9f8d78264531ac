"""Device meshes for the port (counterpart of ``gnss_sdr_tpu/parallel``):
channel-sharded tracking, PRN- and time-sharded acquisition, and the
multi-process glue on ``torch.distributed``. Importing it starts no
process group."""
from .sharding import (  # noqa: F401
    CHANNEL_AXIS,
    TIME_AXIS,
    Mesh,
    make_mesh,
    shard_channel_state,
    shard_fused_step,
    sharded_pcps_search,
    sharded_track_block,
    time_sharded_pcps_search,
)
from .distributed import (  # noqa: F401
    TimeShard,
    global_mesh,
    initialize_from_env,
    local_devices,
    merge_shard_results,
    partition_stream,
)
