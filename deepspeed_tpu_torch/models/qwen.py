"""Qwen model family — Llama-architecture with attention-projection bias.

Counterpart of ``deepspeed_tpu/models/qwen.py``: the same config (its
knobs, presets and ``*_TINY``) and the same constructor checks, on the
port's :class:`~.llama.Llama`, which carries every knob through training
and the paged serving programs (see its module docstring). The family is
the config point; weights load from the JAX tree with
``convert.llama_params_from_numpy`` and no renaming.
"""

from dataclasses import dataclass

from .llama import Llama, LlamaConfig


@dataclass(frozen=True)
class QwenConfig(LlamaConfig):
    qkv_bias: bool = True                # the family's distinguishing knob
    rope_theta: float = 1000000.0        # qwen2 long-context base
    vocab_size: int = 151936


QWEN_TINY = QwenConfig(n_layer=2, n_head=4, n_kv_heads=2, d_model=128,
                       max_seq_len=128, vocab_size=512, remat=False)
# Qwen2-1.5B point (config.json: 28 layers, 12 heads, 2 KV heads,
# hidden 1536, intermediate 8960)
QWEN2_1_5B = QwenConfig(n_layer=28, n_head=12, n_kv_heads=2, d_model=1536,
                        d_ff=8960, max_seq_len=32768, tie_embeddings=True)
QWEN2_7B = QwenConfig(n_layer=28, n_head=28, n_kv_heads=4, d_model=3584,
                      d_ff=18944, max_seq_len=32768)

QWEN_PRESETS = {"tiny": QWEN_TINY, "qwen2-1.5b": QWEN2_1_5B,
                "qwen2-7b": QWEN2_7B}


class Qwen(Llama):
    """Qwen: Llama forward/caching/serving with qkv bias enabled via
    config; subclass exists so engines and tooling can name the family
    (mirrors the reference's per-family model_implementations)."""

    def __init__(self, config: QwenConfig, device=None, dtype=None, seed=0,
                 quantize=None):
        if not config.qkv_bias:
            raise ValueError("Qwen requires qkv_bias=True")
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
