"""Band-parallel subband training and the sharded paths over a (band, batch)
grid of ranks (``torch.distributed``)."""

from .band_parallel import BandParallelTrainer
from .collectives import all_reduce_grads, broadcast_tensors, Shard, shard_of
from .freq_parallel import make_freq_sharded_step
from .mesh import (
    band_slice,
    batch_slice,
    init_process_group_from_env,
    make_mesh,
    Mesh,
    shard_batch_dict,
    spawn,
)

__all__ = [
    "BandParallelTrainer",
    "Mesh",
    "Shard",
    "all_reduce_grads",
    "band_slice",
    "batch_slice",
    "broadcast_tensors",
    "init_process_group_from_env",
    "make_freq_sharded_step",
    "make_mesh",
    "shard_batch_dict",
    "shard_of",
    "spawn",
]
