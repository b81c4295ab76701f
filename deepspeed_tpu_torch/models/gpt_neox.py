"""GPT-NeoX / Pythia family — biased everything, two-LN parallel residual.

Counterpart of ``deepspeed_tpu/models/gpt_neox.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class GPTNeoXConfig(LlamaConfig):
    norm_type: str = "ln"
    mlp_gated: bool = False
    mlp_act: str = "gelu"                # nn.GELU default: exact erf
    qkv_bias: bool = True
    o_bias: bool = True
    mlp_bias: bool = True
    head_bias: object = False            # embed_out has no bias
    parallel_block: bool = True          # use_parallel_residual
    rotary_pct: float = 0.25
    vocab_size: int = 50432


GPTNEOX_TINY = GPTNeoXConfig(n_layer=2, n_head=4, n_kv_heads=4,
                             d_model=128, max_seq_len=128, vocab_size=512,
                             remat=False)
# gpt-neox-20b point (config.json: 44 layers, 64 heads, hidden 6144)
GPTNEOX_20B = GPTNeoXConfig(n_layer=44, n_head=64, n_kv_heads=64,
                            d_model=6144, d_ff=24576, max_seq_len=2048,
                            vocab_size=50432)

GPTNEOX_PRESETS = {"tiny": GPTNEOX_TINY, "gpt-neox-20b": GPTNEOX_20B}


class GPTNeoX(Llama):
    """GPT-NeoX on the shared Llama machinery (see module docstring)."""

    def __init__(self, config: GPTNeoXConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
