"""Several cards (counterpart of `pasta_gan_tpu/parallel/`): `torch.distributed`, one process per card."""

from .mesh import (
    BACKENDS,
    all_reduce_mean,
    check_replication_consistency,
    data_parallel_devices,
    initialize_distributed,
    rank,
    rank_seed,
    replicate_module,
    replicate_tensors,
    shard_batch,
    world,
)

__all__ = ["BACKENDS", "all_reduce_mean", "check_replication_consistency", "data_parallel_devices",
           "initialize_distributed", "rank", "rank_seed", "replicate_module", "replicate_tensors", "shard_batch",
           "world"]
