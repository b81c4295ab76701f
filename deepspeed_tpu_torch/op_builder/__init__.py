from .builder import CUDAOpBuilder, PagedAttentionBuilder

__all__ = ["CUDAOpBuilder", "PagedAttentionBuilder"]
