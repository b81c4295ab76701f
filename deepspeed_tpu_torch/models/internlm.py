"""InternLM (v1) family — llama architecture with biased attention.

Counterpart of ``deepspeed_tpu/models/internlm.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class InternLMConfig(LlamaConfig):
    qkv_bias: bool = True
    o_bias: bool = True
    vocab_size: int = 103168


INTERNLM_TINY = InternLMConfig(n_layer=2, n_head=4, n_kv_heads=4,
                               d_model=128, max_seq_len=128,
                               vocab_size=512, remat=False)
# internlm-7b point (config.json: 32 layers, 32 heads, hidden 4096)
INTERNLM_7B = InternLMConfig(n_layer=32, n_head=32, n_kv_heads=32,
                             d_model=4096, d_ff=11008, max_seq_len=2048,
                             vocab_size=103168)

INTERNLM_PRESETS = {"tiny": INTERNLM_TINY, "internlm-7b": INTERNLM_7B}


class InternLM(Llama):
    """InternLM on the shared Llama machinery (see module docstring)."""

    def __init__(self, config: InternLMConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
