"""Configuration- and sample-axis sharding over several devices and processes."""

from collide2d_tpu_torch.parallel.sharding import (
    make_mesh,
    shard_configs,
    sharded_mc_round,
    sample_sharded_probability,
)
from collide2d_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_multihost,
    process_batch_range,
)

__all__ = [
    "make_mesh",
    "shard_configs",
    "sharded_mc_round",
    "sample_sharded_probability",
    "global_mesh",
    "initialize_multihost",
    "process_batch_range",
]
