"""Meshes, sharding rules and process groups on ``torch.distributed``
(counterpart of ``fetode_tpu/parallel``)."""

from fetode_tpu_torch.parallel.collectives import (  # noqa: F401
    shard_map_rows,
)
from fetode_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Placement,
    Sharding,
    batch_sharding,
    driver_mesh,
    is_rank0,
    kan_param_specs,
    kan_stack_param_specs,
    make_mesh,
    model_param_specs,
    parse_mesh_flag,
    place_params,
    replicated,
    shard_batch_leaves,
    shard_params,
    shard_rows,
    world,
)
from fetode_tpu_torch.parallel.multihost import (  # noqa: F401
    global_batch_sharding,
    initialize_distributed,
    make_multislice_mesh,
    shutdown_distributed,
    spawn_local,
)
