"""PyTorch + CUDA port of deepspeed_tpu for NVIDIA Hopper (H100).

Imports torch and never jax; nothing of the JAX package is imported."""

from .inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .models import LLAMA_PRESETS, Llama, LlamaConfig, llama_params_from_numpy

__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig",
           "LLAMA_PRESETS", "Llama", "LlamaConfig", "llama_params_from_numpy"]
