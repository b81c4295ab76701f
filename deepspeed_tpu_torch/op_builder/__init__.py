from .builder import (BlockSparseAttentionBuilder, CkptWriterBuilder,
                      CUDAOpBuilder, FlashAttentionBuilder, FusedCEBuilder,
                      GroupedMatmulBuilder, HostOpBuilder, LayerNormBuilder,
                      MlpMatmulBuilder, PagedAttentionBuilder,
                      QuantizationBuilder, build_all)

__all__ = ["BlockSparseAttentionBuilder", "CkptWriterBuilder",
           "CUDAOpBuilder", "FlashAttentionBuilder", "FusedCEBuilder",
           "GroupedMatmulBuilder", "HostOpBuilder", "LayerNormBuilder",
           "MlpMatmulBuilder", "PagedAttentionBuilder", "QuantizationBuilder",
           "build_all"]
