"""Bloom model family — ALiBi position bias, LN everywhere, tied head.

Counterpart of ``deepspeed_tpu/models/bloom.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class BloomConfig(LlamaConfig):
    alibi: bool = True                   # the family's defining knob
    embed_norm: bool = True              # word_embeddings_layernorm
    norm_type: str = "ln"
    mlp_gated: bool = False              # plain gelu MLP
    qkv_bias: bool = True
    proj_bias: bool = True
    tie_embeddings: bool = True
    vocab_size: int = 250880


BLOOM_TINY = BloomConfig(n_layer=2, n_head=4, n_kv_heads=4, d_model=128,
                         max_seq_len=128, vocab_size=512, remat=False)
# bloom-560m point (config.json: 24 layers, 16 heads, hidden 1024)
BLOOM_560M = BloomConfig(n_layer=24, n_head=16, n_kv_heads=16,
                         d_model=1024, d_ff=4096, max_seq_len=2048)
# bloom-7b1 point (30 layers, 32 heads, hidden 4096)
BLOOM_7B1 = BloomConfig(n_layer=30, n_head=32, n_kv_heads=32,
                        d_model=4096, d_ff=16384, max_seq_len=2048)

BLOOM_PRESETS = {"tiny": BLOOM_TINY, "bloom-560m": BLOOM_560M,
                 "bloom-7b1": BLOOM_7B1}


class Bloom(Llama):
    """Bloom: ALiBi LN model on the shared Llama machinery (see module
    docstring)."""

    def __init__(self, config: BloomConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        if not config.alibi or not config.embed_norm:
            raise ValueError(
                "Bloom requires alibi=True and embed_norm=True")
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
