from .builder import (BlockSparseAttentionBuilder, CkptWriterBuilder,
                      CUDAOpBuilder, FlashAttentionBuilder,
                      FlashAttentionF16Builder, FusedCEBuilder,
                      GroupedMatmulBuilder, HostOpBuilder, LayerNormBuilder,
                      MlpMatmulBuilder, PagedAttentionBuilder,
                      QuantizationBuilder, build_all)

__all__ = ["BlockSparseAttentionBuilder", "CkptWriterBuilder",
           "CUDAOpBuilder", "FlashAttentionBuilder",
           "FlashAttentionF16Builder", "FusedCEBuilder",
           "GroupedMatmulBuilder", "HostOpBuilder", "LayerNormBuilder",
           "MlpMatmulBuilder", "PagedAttentionBuilder", "QuantizationBuilder",
           "build_all"]
