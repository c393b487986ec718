from .pipeline_parallel import microbatch, pipeline_apply, stack_pytrees, stage_sharding, unmicrobatch
from .runtime import init_auto, init_single, is_root, rank, resolve_device, world_size

__all__ = ["init_auto", "init_single", "is_root", "rank", "resolve_device", "world_size", "microbatch",
           "pipeline_apply", "stack_pytrees", "stage_sharding", "unmicrobatch"]
