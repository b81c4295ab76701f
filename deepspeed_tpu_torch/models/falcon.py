"""Falcon model family — parallel block, LayerNorm, multi-query attention.

Counterpart of ``deepspeed_tpu/models/falcon.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class FalconConfig(LlamaConfig):
    parallel_block: bool = True
    mlp_gated: bool = False              # plain gelu MLP
    mlp_act: str = "gelu"                # HF FalconMLP: exact-erf nn.GELU
    norm_type: str = "ln"                # LayerNorm with bias
    n_kv_heads: int = 1                  # multi-query attention
    vocab_size: int = 65024


FALCON_TINY = FalconConfig(n_layer=2, n_head=4, n_kv_heads=1, d_model=128,
                           max_seq_len=128, vocab_size=512, remat=False)
# falcon-7b point (config.json: 32 layers, 71 heads, hidden 4544, MQA)
FALCON_7B = FalconConfig(n_layer=32, n_head=71, n_kv_heads=1, d_model=4544,
                         d_ff=4 * 4544, max_seq_len=2048,
                         tie_embeddings=True)

FALCON_PRESETS = {"tiny": FALCON_TINY, "falcon-7b": FALCON_7B}


class Falcon(Llama):
    """Falcon: LN model on the shared Llama machinery (see module
    docstring). The family spans three generations — 7b (parallel block
    + MQA), new-decoder-arch 40b/180b (parallel block + GQA, two input
    norms), and falcon-rw (sequential block, per-head attention, ALiBi,
    biases) — all expressed as config knobs; no per-variant subclass."""

    def __init__(self, config: FalconConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
