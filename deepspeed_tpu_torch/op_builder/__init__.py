from .builder import (CUDAOpBuilder, FlashAttentionBuilder, FusedCEBuilder,
                      GroupedMatmulBuilder, MlpMatmulBuilder,
                      PagedAttentionBuilder, build_all)

__all__ = ["CUDAOpBuilder", "FlashAttentionBuilder", "FusedCEBuilder",
           "GroupedMatmulBuilder", "MlpMatmulBuilder", "PagedAttentionBuilder",
           "build_all"]
