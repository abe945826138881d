"""Data parallelism over ``torch.distributed`` (the JAX package's
``parallel`` data axis): ``mesh`` holds the per-rank helpers and
collectives, ``launch`` starts the ranks of a training command."""
from creste_public_tpu_torch.parallel.mesh import (  # noqa: F401
    Group,
    all_gather_rows,
    all_gather_with_grad,
    all_reduce_mean,
    backend_for,
    broadcast_module,
    launched_world,
    pad_to_multiple,
    rank,
    rank_device,
    shard_batch,
    world_size,
)
