from .builder import (CUDAOpBuilder, FlashAttentionBuilder, FusedCEBuilder,
                      PagedAttentionBuilder, build_all)

__all__ = ["CUDAOpBuilder", "FlashAttentionBuilder", "FusedCEBuilder",
           "PagedAttentionBuilder", "build_all"]
