from .sparsity_config import (SparsityConfig, DenseSparsityConfig,
                              FixedSparsityConfig, BigBirdSparsityConfig,
                              BSLongformerSparsityConfig)
from .sparse_self_attention import SparseSelfAttention, sparse_attention
