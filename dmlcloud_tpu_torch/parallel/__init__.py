from .runtime import init_auto, init_single, is_root, rank, resolve_device, world_size

__all__ = ["init_auto", "init_single", "is_root", "rank", "resolve_device", "world_size"]
