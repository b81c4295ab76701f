from .builder import (BlockSparseAttentionBuilder, CUDAOpBuilder,
                      FlashAttentionBuilder, FusedCEBuilder,
                      GroupedMatmulBuilder, LayerNormBuilder,
                      MlpMatmulBuilder, PagedAttentionBuilder,
                      QuantizationBuilder, build_all)

__all__ = ["BlockSparseAttentionBuilder", "CUDAOpBuilder",
           "FlashAttentionBuilder", "FusedCEBuilder", "GroupedMatmulBuilder",
           "LayerNormBuilder", "MlpMatmulBuilder", "PagedAttentionBuilder",
           "QuantizationBuilder", "build_all"]
