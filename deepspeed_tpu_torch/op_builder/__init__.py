from .builder import (CUDAOpBuilder, FlashAttentionBuilder, FusedCEBuilder,
                      GroupedMatmulBuilder, LayerNormBuilder,
                      MlpMatmulBuilder, PagedAttentionBuilder, build_all)

__all__ = ["CUDAOpBuilder", "FlashAttentionBuilder", "FusedCEBuilder",
           "GroupedMatmulBuilder", "LayerNormBuilder", "MlpMatmulBuilder",
           "PagedAttentionBuilder", "build_all"]
