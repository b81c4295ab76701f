"""GPT-J family — parallel block, shared input LN, interleaved rotary.

Counterpart of ``deepspeed_tpu/models/gptj.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class GPTJConfig(LlamaConfig):
    parallel_block: bool = True
    mlp_gated: bool = False              # fc_in/gelu/fc_out
    norm_type: str = "ln"
    mlp_bias: bool = True                # fc_in/fc_out biased
    head_bias: object = True             # lm_head.bias (o_proj stays plain)
    rotary_interleaved: bool = True      # rotate_every_two pairing
    rotary_pct: float = 0.25             # rotary_dim 64 of hd 256 (6B)
    vocab_size: int = 50400


GPTJ_TINY = GPTJConfig(n_layer=2, n_head=4, n_kv_heads=4, d_model=128,
                       max_seq_len=128, vocab_size=512, remat=False)
# gpt-j-6b point (config.json: 28 layers, 16 heads, hidden 4096,
# rotary_dim 64)
GPTJ_6B = GPTJConfig(n_layer=28, n_head=16, n_kv_heads=16, d_model=4096,
                     d_ff=16384, max_seq_len=2048, vocab_size=50400)

GPTJ_PRESETS = {"tiny": GPTJ_TINY, "gpt-j-6b": GPTJ_6B}


class GPTJ(Llama):
    """GPT-J on the shared Llama machinery (see module docstring)."""

    def __init__(self, config: GPTJConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
