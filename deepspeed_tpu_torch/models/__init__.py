from .convert import (gpt2_moe_params_from_numpy, gpt2_params_from_numpy,
                      llama_params_from_numpy, mixtral_params_from_numpy)
from .gpt2 import GPT2, GPT2_350M, GPT2_TINY, GPT2Config
from .gpt2 import PRESETS as GPT2_PRESETS
from .gpt2_moe import GPT2MoE, GPT2MoEConfig
from .llama import (LLAMA2_7B, LLAMA_PRESETS, LLAMA_TINY, MISTRAL_7B, Llama,
                    LlamaConfig)
from .mixtral import MIXTRAL_8X7B, MIXTRAL_TINY, Mixtral, MixtralConfig

__all__ = ["gpt2_moe_params_from_numpy", "gpt2_params_from_numpy",
           "llama_params_from_numpy", "mixtral_params_from_numpy", "GPT2",
           "GPT2_350M", "GPT2_TINY", "GPT2Config", "GPT2_PRESETS", "GPT2MoE",
           "GPT2MoEConfig", "LLAMA2_7B", "LLAMA_PRESETS",
           "LLAMA_TINY", "MISTRAL_7B", "Llama", "LlamaConfig", "MIXTRAL_8X7B",
           "MIXTRAL_TINY", "Mixtral", "MixtralConfig"]
