"""Data and spatial parallelism over ``torch.distributed`` (the JAX
package's ``parallel`` axes): ``mesh`` holds the data-parallel per-rank
helpers and collectives, ``spatial`` one frame's width split across ranks
(``SPATIAL_AXIS``, ``make_spatial_mesh``, ``spatial_inference_shardings``),
``launch`` starts the ranks."""
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
from creste_public_tpu_torch.parallel.spatial import (  # noqa: F401
    SPATIAL_AXIS,
    SpatialMesh,
    make_spatial_mesh,
    spatial_inference_shardings,
)
