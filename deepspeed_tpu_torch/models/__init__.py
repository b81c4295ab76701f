from .convert import (gpt2_moe_params_from_numpy, gpt2_params_from_numpy,
                      llama_params_from_numpy, mixtral_params_from_numpy)
from .gpt2 import (GPT2, GPT2_1_3B, GPT2_125M, GPT2_350M, GPT2_TINY,
                   GPT2Config)
from .gpt2 import PRESETS as GPT2_PRESETS
from .gpt2_moe import GPT2MoE, GPT2MoEConfig
from .llama import (LLAMA2_7B, LLAMA_PRESETS, LLAMA_TINY, MISTRAL_7B, Llama,
                    LlamaConfig)
from .mixtral import MIXTRAL_8X7B, MIXTRAL_TINY, Mixtral, MixtralConfig
from .bloom import Bloom, BloomConfig, BLOOM_PRESETS
from .qwen import Qwen, QwenConfig, QWEN_PRESETS
from .phi import Phi, PhiConfig, PHI_PRESETS
from .falcon import Falcon, FalconConfig, FALCON_PRESETS
from .gptj import GPTJ, GPTJConfig, GPTJ_PRESETS
from .gpt_neox import GPTNeoX, GPTNeoXConfig, GPTNEOX_PRESETS
from .internlm import InternLM, InternLMConfig, INTERNLM_PRESETS
from .opt import OPT, OPTConfig, OPT_PRESETS
from .gpt_neo import GPTNeo, GPTNeoConfig, GPTNEO_PRESETS

__all__ = ["gpt2_moe_params_from_numpy", "gpt2_params_from_numpy",
           "llama_params_from_numpy", "mixtral_params_from_numpy", "GPT2",
           "GPT2_125M", "GPT2_350M", "GPT2_1_3B", "GPT2_TINY", "GPT2Config", "GPT2_PRESETS", "GPT2MoE",
           "GPT2MoEConfig", "LLAMA2_7B", "LLAMA_PRESETS",
           "LLAMA_TINY", "MISTRAL_7B", "Llama", "LlamaConfig", "MIXTRAL_8X7B",
           "MIXTRAL_TINY", "Mixtral", "MixtralConfig", "Bloom",
           "BloomConfig", "BLOOM_PRESETS", "Qwen", "QwenConfig",
           "QWEN_PRESETS", "Phi", "PhiConfig", "PHI_PRESETS", "Falcon",
           "FalconConfig", "FALCON_PRESETS", "GPTJ", "GPTJConfig",
           "GPTJ_PRESETS", "GPTNeoX", "GPTNeoXConfig", "GPTNEOX_PRESETS",
           "InternLM", "InternLMConfig", "INTERNLM_PRESETS", "OPT",
           "OPTConfig", "OPT_PRESETS", "GPTNeo", "GPTNeoConfig",
           "GPTNEO_PRESETS"]
