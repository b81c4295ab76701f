"""Phi model family — parallel attention/MLP block, partial rotary, LN.

Counterpart of ``deepspeed_tpu/models/phi.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class PhiConfig(LlamaConfig):
    parallel_block: bool = True
    rotary_pct: float = 0.4              # phi-2 partial rotary factor
    mlp_gated: bool = False              # plain gelu MLP
    norm_type: str = "ln"                # LayerNorm with bias
    qkv_bias: bool = True                # phi projects with bias
    proj_bias: bool = True               # ...including wo/MLP/lm_head


PHI_TINY = PhiConfig(n_layer=2, n_head=4, n_kv_heads=4, d_model=128,
                     max_seq_len=128, vocab_size=512, remat=False)
# phi-2 point (config.json: 32 layers, 32 heads, hidden 2560,
# intermediate 10240, rotary over 32 of 80 dims)
PHI_2 = PhiConfig(n_layer=32, n_head=32, n_kv_heads=32, d_model=2560,
                  d_ff=10240, max_seq_len=2048, vocab_size=51200)

PHI_PRESETS = {"tiny": PHI_TINY, "phi-2": PHI_2}


class Phi(Llama):
    """Phi: parallel-block partial-rotary LN model on the shared Llama
    machinery (see module docstring)."""

    def __init__(self, config: PhiConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        if not config.parallel_block:
            raise ValueError("Phi requires parallel_block=True")
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
