"""PyTorch + CUDA port of deepspeed_tpu for NVIDIA Hopper (H100).

Imports torch and never jax; nothing of the JAX package is imported."""

__version__ = "0.1.0"

from . import comm
from .comm import init_distributed
from .inference.v2 import (DeadlineExceeded, InferenceEngineV2, Overloaded,
                           RaggedInferenceEngineConfig, Replica, ReplicaDead,
                           Router, RouterConfig, kv_transfer)
from .models import (GPT2, GPT2_1_3B, GPT2_125M, GPT2_PRESETS, LLAMA_PRESETS, MIXTRAL_8X7B,
                     MIXTRAL_TINY, GPT2Config, GPT2MoE, GPT2MoEConfig, Llama,
                     LlamaConfig, Mixtral, MixtralConfig,
                     gpt2_moe_params_from_numpy, gpt2_params_from_numpy,
                     llama_params_from_numpy, mixtral_params_from_numpy)
from .models import (BLOOM_PRESETS, FALCON_PRESETS, GPTJ_PRESETS,
                     GPTNEOX_PRESETS, INTERNLM_PRESETS, PHI_PRESETS,
                     QWEN_PRESETS, GPTJ, Bloom, BloomConfig, Falcon,
                     FalconConfig, GPTJConfig, GPTNeoX, GPTNeoXConfig,
                     InternLM, InternLMConfig, Phi, PhiConfig, Qwen,
                     QwenConfig)
from .models import (GPTNEO_PRESETS, OPT_PRESETS, OPT, GPTNeo, GPTNeoConfig,
                     OPTConfig)
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
    ``loss(batch)`` (``deepspeed_tpu_torch.GPT2``, ``GPT2MoE``, ``Llama``,
    ``Mixtral`` and the families on them) whose
    parameters are the initial weights (rank 0's, in a multi-process
    world); ``device`` defaults to this process's card
    (``cuda:$LOCAL_RANK``) and raises without one. Unless
    ``dist_init_required`` is False it joins the world first
    (``comm.init_distributed``: ``env://``, a no-op without
    ``WORLD_SIZE`` or when already joined). ``topology`` is a
    ``utils.groups.ParallelTopology``; by default it is built from the
    config as the JAX ``initialize`` builds its mesh: ``seq`` from
    ``sequence_parallel_size``, ``expert`` from ``expert_parallel_size``,
    data parallelism over the rest of ``WORLD_SIZE``, split by
    ``mics_shard_size`` / ``hpz_partition_size``; the batch triad
    resolves against the data-parallel count (WORLD_SIZE /
    sequence_parallel_size: the expert ranks split the batch too).
    ``lr_scheduler`` (or the config's ``scheduler`` block) sets each
    step's lr. ZeRO stages 0-3 partition over the
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


def init_inference(model=None, config=None, **kwargs):
    """The v1 inference engine (the JAX package's ``init_inference``,
    __init__.py:62): not ported; serve through ``InferenceEngineV2``."""
    raise NotImplementedError(
        "init_inference (the v1 InferenceEngine) is not ported yet "
        "(ROADMAP Queue 1, M9: other inference and HF); serve through "
        "InferenceEngineV2")


def add_config_arguments(parser):
    """argparse passthrough (the JAX package's ``add_config_arguments``,
    __init__.py:72; reference deepspeed/__init__.py:245)."""
    group = parser.add_argument_group("DeepSpeed-TPU",
                                      "DeepSpeed-TPU configurations")
    group.add_argument("--deepspeed", default=False, action="store_true",
                       help="Enable DeepSpeed-TPU (helper flag)")
    group.add_argument("--deepspeed_config", default=None, type=str,
                       help="DeepSpeed-TPU json configuration file")
    group.add_argument("--local_rank", type=int, default=-1,
                       help="accepted for launcher compatibility")
    return parser


__all__ = ["InferenceEngineV2", "RaggedInferenceEngineConfig", "Replica",
           "ReplicaDead", "Router", "RouterConfig", "Overloaded",
           "DeadlineExceeded", "kv_transfer", "GPT2",
           "GPT2_PRESETS", "GPT2Config", "GPT2MoE", "GPT2MoEConfig",
           "LLAMA_PRESETS", "Llama", "LlamaConfig", "MIXTRAL_8X7B",
           "MIXTRAL_TINY", "Mixtral", "MixtralConfig",
           "gpt2_moe_params_from_numpy", "gpt2_params_from_numpy",
           "llama_params_from_numpy", "mixtral_params_from_numpy",
           "DeepSpeedConfig", "DeepSpeedEngine", "comm", "init_distributed",
           "initialize", "init_inference", "add_config_arguments",
           "__version__", "GPT2_125M", "GPT2_1_3B", "Bloom", "BloomConfig", "BLOOM_PRESETS", "Falcon",
           "FalconConfig", "FALCON_PRESETS", "GPTNeoX", "GPTNeoXConfig",
           "GPTNEOX_PRESETS", "GPTJ", "GPTJConfig", "GPTJ_PRESETS",
           "InternLM", "InternLMConfig", "INTERNLM_PRESETS", "Phi",
           "PhiConfig", "PHI_PRESETS", "Qwen", "QwenConfig", "QWEN_PRESETS",
           "OPT", "OPTConfig", "OPT_PRESETS", "GPTNeo", "GPTNeoConfig",
           "GPTNEO_PRESETS"]
