"""OPT model family — the GPT-2 architecture with a ReLU feed-forward.

Counterpart of ``deepspeed_tpu/models/opt.py``: the same config (its knobs,
presets and ``OPT_TINY``) and the same constructor check, on the port's
:class:`~.gpt2.GPT2` (learned positions, pre-LayerNorm blocks, tied
unembedding), which carries training and the v2 paged serving programs.
The family is the config point; weights load from the JAX tree with
``convert.gpt2_params_from_numpy`` and no renaming. (HF OPT offsets its
position ids by 2 padding slots: a checkpoint-conversion detail, sliced
off ``wpe`` by a loader, not an architecture one.)
"""

from dataclasses import dataclass

from .gpt2 import GPT2, GPT2Config


@dataclass(frozen=True)
class OPTConfig(GPT2Config):
    activation: str = "relu"             # the family's distinguishing knob
    vocab_size: int = 50272


OPT_TINY = OPTConfig(n_layer=2, n_head=4, d_model=128, max_seq_len=128,
                     vocab_size=512, remat=False)
# opt-1.3b point (config.json: 24 layers, 32 heads, hidden 2048)
OPT_1_3B = OPTConfig(n_layer=24, n_head=32, d_model=2048,
                     max_seq_len=2048)

OPT_PRESETS = {"tiny": OPT_TINY, "opt-1.3b": OPT_1_3B}


class OPT(GPT2):
    """OPT: GPT-2 training and serving with a ReLU MLP via config."""

    def __init__(self, config: OPTConfig, device=None, dtype=None, seed=0):
        if config.activation != "relu":
            raise ValueError("OPT uses a ReLU feed-forward")
        super().__init__(config, device=device, dtype=dtype, seed=seed)
