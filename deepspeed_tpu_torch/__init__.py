"""PyTorch + CUDA port of deepspeed_tpu for NVIDIA Hopper (H100).

Imports torch and never jax; nothing of the JAX package is imported."""

from . import comm
from .comm import init_distributed
from .inference.v2 import (DeadlineExceeded, InferenceEngineV2, Overloaded,
                           RaggedInferenceEngineConfig, Replica, ReplicaDead,
                           Router, RouterConfig, kv_transfer)
from .models import (GPT2, GPT2_PRESETS, LLAMA_PRESETS, MIXTRAL_8X7B,
                     MIXTRAL_TINY, GPT2Config, GPT2MoE, GPT2MoEConfig, Llama,
                     LlamaConfig, Mixtral, MixtralConfig,
                     gpt2_moe_params_from_numpy, gpt2_params_from_numpy,
                     llama_params_from_numpy, mixtral_params_from_numpy)
from .runtime.config import DeepSpeedConfig
from .runtime.engine import DeepSpeedEngine

_TODO_DATA = "(ROADMAP Queue 1, M14: data loader)"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, topology=None,
               config=None, config_params=None, seed=0,
               dist_init_required=None, device=None):
    """Initialize the training engine (the JAX package's ``initialize``,
    __init__.py:29-52, reference deepspeed/__init__.py:69).

    Returns the reference's 4-tuple ``(engine, optimizer, dataloader,
    lr_scheduler)``; the dataloader is None. ``model`` is a module with
    ``loss(batch)`` (``deepspeed_tpu_torch.GPT2``, ``GPT2MoE``) whose
    parameters are the initial weights (rank 0's, in a multi-process
    world); ``device`` defaults to this process's card
    (``cuda:$LOCAL_RANK``) and raises without one. Unless
    ``dist_init_required`` is False it joins the world first
    (``comm.init_distributed``: ``env://``, a no-op without
    ``WORLD_SIZE`` or when already joined). ``topology`` is a
    ``utils.groups.ParallelTopology``; by default it is built from the
    config as the JAX ``initialize`` builds its mesh: ``seq`` from
    ``sequence_parallel_size``, data parallelism over the rest of
    ``WORLD_SIZE`` (dp = WORLD_SIZE / sequence_parallel_size), split by
    ``mics_shard_size`` / ``hpz_partition_size``; the batch triad
    resolves against that dp. ZeRO stages 0-3 partition over the
    data-parallel ranks (``runtime/engine.py``). ``seed`` makes the
    engine's RNG words, ``jax.random.key(seed + 1)``'s as the JAX engine
    keeps them (checkpointed as ``rng_data``)."""
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
    if dist_init_required is None or dist_init_required:
        init_distributed(device=device)
    engine = DeepSpeedEngine(model=model, config=config, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, device=device,
                             topology=topology, seed=seed)
    return engine, engine.optimizer, None, engine.lr_scheduler


__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig", "Replica",
           "ReplicaDead", "Router", "RouterConfig", "Overloaded",
           "DeadlineExceeded", "kv_transfer", "GPT2",
           "GPT2_PRESETS", "GPT2Config", "GPT2MoE", "GPT2MoEConfig",
           "LLAMA_PRESETS", "Llama", "LlamaConfig", "MIXTRAL_8X7B",
           "MIXTRAL_TINY", "Mixtral", "MixtralConfig",
           "gpt2_moe_params_from_numpy", "gpt2_params_from_numpy",
           "llama_params_from_numpy", "mixtral_params_from_numpy",
           "DeepSpeedConfig", "DeepSpeedEngine", "comm", "init_distributed",
           "initialize"]
