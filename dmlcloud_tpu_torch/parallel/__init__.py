"""dmlcloud_tpu_torch.parallel — process groups, meshes and pipeline stages.

Counterpart of ``dmlcloud_tpu/parallel/__init__.py``, with the same names
bound: the submodules ``mesh``, ``runtime`` and ``pipeline_parallel``, the
axis constants and mesh helpers, the pipeline schedule and the runtime's
bootstrap, rank accessors and collectives. The reference's ``NamedSharding``
helpers (``batch_sharding``, ``replicated``, ``shard_pytree``) have no
counterpart: ``mesh.shard_module`` lays a module out on a mesh instead
(ROADMAP, "By design"). ``resolve_device`` is the port's own.
"""

from . import mesh, pipeline_parallel, runtime
from .mesh import (
    DATA,
    EXPERT,
    FSDP,
    MODEL,
    PIPE,
    SEQ,
    auto_mesh,
    batch_pspec,
    create_mesh,
    make_global_batch,
    parse_mesh_axes,
    sharding_for,
)
from .pipeline_parallel import microbatch, pipeline_apply, stack_pytrees, stage_sharding, unmicrobatch
from .runtime import (
    BarrierTimeout,
    CollectiveMismatchError,
    all_gather_array,
    all_gather_object,
    barrier,
    broadcast_object,
    deinitialize,
    gather_object,
    init_auto,
    init_from_env,
    init_mpi,
    init_single,
    init_slurm,
    is_initialized,
    is_root,
    local_rank,
    local_world_size,
    print_root,
    print_worker,
    rank,
    resolve_device,
    root_first,
    root_only,
    world_size,
)

__all__ = [
    "mesh",
    "pipeline_parallel",
    "runtime",
    "microbatch",
    "pipeline_apply",
    "stack_pytrees",
    "stage_sharding",
    "unmicrobatch",
    "DATA",
    "EXPERT",
    "FSDP",
    "MODEL",
    "PIPE",
    "SEQ",
    "auto_mesh",
    "batch_pspec",
    "create_mesh",
    "parse_mesh_axes",
    "make_global_batch",
    "sharding_for",
    "all_gather_object",
    "BarrierTimeout",
    "CollectiveMismatchError",
    "all_gather_array",
    "barrier",
    "broadcast_object",
    "deinitialize",
    "gather_object",
    "init_auto",
    "init_from_env",
    "init_mpi",
    "init_single",
    "init_slurm",
    "is_initialized",
    "is_root",
    "local_rank",
    "local_world_size",
    "print_root",
    "print_worker",
    "rank",
    "resolve_device",
    "root_first",
    "root_only",
    "world_size",
]
