"""Sequence/context parallelism for long sequences: Ulysses
(``layer.py``) and zigzag ring attention (``ring.py``) over the ``seq``
process group; counterpart of ``deepspeed_tpu/sequence/``."""

from .layer import DistributedAttention, single_all_to_all, ulysses_attention
from .ring import ring_attention, ring_attention_sharded

__all__ = ["DistributedAttention", "single_all_to_all", "ulysses_attention",
           "ring_attention", "ring_attention_sharded"]
