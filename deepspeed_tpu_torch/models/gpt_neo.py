"""GPT-Neo family — GPT-2 blocks, unscaled attention, local layers.

Counterpart of ``deepspeed_tpu/models/gpt_neo.py``: the same config (its
knobs, presets and ``GPTNEO_TINY``) on the port's :class:`~.gpt2.GPT2`,
with the family's two quirks as GPT2Config knobs:

  * ``scale_attn=False``: HF GPT-Neo never divides the scores by
    sqrt(head_dim); the kernels take ``scale = 1.0``;
  * ``attn_layer_windows``: the config's ``attention_types`` pattern
    alternates global and LOCAL (sliding-window, ``window_size``)
    attention per layer (0 = global). Training attends densely with the
    window in the mask, serving passes each layer's window to K4 / K5.

q/k/v carry no bias (zero rows of the fused ``bqkv``); out_proj and the
MLP are biased. Weights load from the JAX tree with
``convert.gpt2_params_from_numpy`` and no renaming. The engine serves it
without the prefix cache (a cached block's KV is position-valid only
inside each layer's window: ``prefix_cache=True`` raises).
"""

from dataclasses import dataclass

from .gpt2 import GPT2, GPT2Config


@dataclass(frozen=True)
class GPTNeoConfig(GPT2Config):
    scale_attn: bool = False


GPTNEO_TINY = GPTNeoConfig(n_layer=2, n_head=4, d_model=128,
                           max_seq_len=128, vocab_size=512, remat=False,
                           attn_layer_windows=(0, 64))
# gpt-neo-1.3B point (24 layers alternating global/local window 256)
GPTNEO_1_3B = GPTNeoConfig(n_layer=24, n_head=16, d_model=2048,
                           max_seq_len=2048, vocab_size=50257,
                           attn_layer_windows=tuple(
                               0 if i % 2 == 0 else 256
                               for i in range(24)))

GPTNEO_PRESETS = {"tiny": GPTNEO_TINY, "gpt-neo-1.3b": GPTNEO_1_3B}


class GPTNeo(GPT2):
    """GPT-Neo on the GPT-2 machinery (see module docstring)."""
