from .sharded_moe import resolve_grouped_params

__all__ = ["resolve_grouped_params"]
