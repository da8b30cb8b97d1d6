from gym_fishing_tpu.shard.mesh import (
    ENVS_AXIS,
    constrain_envs,
    distributed_init,
    env_sharding,
    host_local_to_global,
    is_distributed_initialized,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
    state_checksum,
)
from gym_fishing_tpu.shard.check import compare_sharded
