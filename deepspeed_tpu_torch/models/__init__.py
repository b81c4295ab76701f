from .convert import llama_params_from_numpy
from .llama import (LLAMA2_7B, LLAMA_PRESETS, LLAMA_TINY, MISTRAL_7B, Llama,
                    LlamaConfig)

__all__ = ["llama_params_from_numpy", "LLAMA2_7B", "LLAMA_PRESETS",
           "LLAMA_TINY", "MISTRAL_7B", "Llama", "LlamaConfig"]
