"""PyTorch + CUDA port of deepspeed_tpu for NVIDIA Hopper (H100).

Imports torch and never jax; nothing of the JAX package is imported."""

from .inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
from .models import (GPT2, GPT2_PRESETS, LLAMA_PRESETS, MIXTRAL_8X7B,
                     MIXTRAL_TINY, GPT2Config, GPT2MoE, GPT2MoEConfig, Llama,
                     LlamaConfig, Mixtral, MixtralConfig,
                     gpt2_moe_params_from_numpy, gpt2_params_from_numpy,
                     llama_params_from_numpy, mixtral_params_from_numpy)
from .runtime.config import DeepSpeedConfig
from .runtime.engine import DeepSpeedEngine

_TODO_DATA = "(ROADMAP Queue 1, M14: data loader)"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config=None,
               config_params=None, seed=0, device=None):
    """Initialize the training engine (the JAX package's ``initialize``,
    reference deepspeed/__init__.py:69).

    Returns the reference's 4-tuple ``(engine, optimizer, dataloader,
    lr_scheduler)``; the dataloader is None. ``model`` is a module with
    ``loss(batch)`` (``deepspeed_tpu_torch.GPT2``, ``GPT2MoE``) whose
    parameters are the initial weights; ``device`` defaults to the card and
    raises without one."""
    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize needs a config "
                         "(dict or json path)")
    if training_data is not None:
        raise NotImplementedError(
            f"training_data (the data loader) is not ported yet "
            f"{_TODO_DATA}")
    engine = DeepSpeedEngine(model=model, config=config, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, device=device)
    return engine, engine.optimizer, None, engine.lr_scheduler


__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig", "GPT2",
           "GPT2_PRESETS", "GPT2Config", "GPT2MoE", "GPT2MoEConfig",
           "LLAMA_PRESETS", "Llama", "LlamaConfig", "MIXTRAL_8X7B",
           "MIXTRAL_TINY", "Mixtral", "MixtralConfig",
           "gpt2_moe_params_from_numpy", "gpt2_params_from_numpy",
           "llama_params_from_numpy", "mixtral_params_from_numpy",
           "DeepSpeedConfig", "DeepSpeedEngine", "initialize"]
