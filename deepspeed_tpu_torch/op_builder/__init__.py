from .builder import (CUDAOpBuilder, FlashAttentionBuilder, FusedCEBuilder,
                      GroupedMatmulBuilder, PagedAttentionBuilder, build_all)

__all__ = ["CUDAOpBuilder", "FlashAttentionBuilder", "FusedCEBuilder",
           "GroupedMatmulBuilder", "PagedAttentionBuilder", "build_all"]
