"""JSON config -> typed config objects, for the blocks the port carries.

Own copy of ``deepspeed_tpu/runtime/config.py`` for the training slice:
the batch-size triad with the same resolution rules and error text, the
precision blocks, the ZeRO block, optimizer, gradient clipping,
``data_types.grad_accum_dtype``, ``steps_per_print``, the ``moe`` block,
``sequence_parallel_size`` with the ``sequence`` block, the
``comms_logger`` block and the ``checkpoint_engine`` block, with the same
unknown-key warnings inside a block. A block the port does
not carry yet raises NotImplementedError naming its ROADMAP item when it
is enabled.
"""

import json
from dataclasses import dataclass, field, fields

import torch

from . import constants as C
from ..utils.logging import logger


class DeepSpeedConfigError(Exception):
    pass


@dataclass
class FP16Config:
    enabled: bool = False
    loss_scale: float = 0.0          # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class OffloadConfig:
    """Reference zero/offload_config.py: where the offloaded state lives."""
    device: str = "none"              # none | cpu | nvme
    nvme_path: str = "/tmp/dstpu_swap"
    pin_memory: bool = True
    buffer_count: int = 4

    @classmethod
    def normalize(cls, val):
        """Accept bool (true -> cpu), reference-style dict, or None."""
        if isinstance(val, cls):
            return val
        if val is None or val is False:
            return cls()
        if val is True:
            return cls(device="cpu")
        if isinstance(val, dict):
            known = {f.name for f in fields(cls)}
            out = cls(**{k: v for k, v in val.items() if k in known})
            out.device = str(out.device).lower()
            if out.device not in ("none", "cpu", "nvme"):
                raise DeepSpeedConfigError(
                    f"offload device must be none|cpu|nvme, got "
                    f"{out.device!r}")
            return out
        raise DeepSpeedConfigError(f"bad offload config: {val!r}")

    @property
    def enabled(self):
        return self.device != "none"


@dataclass
class ZeroConfig:
    """The JAX ZeroConfig's knobs. At world size 1 every stage partitions
    nothing, so stages 0-3 give the same result; bucket and overlap knobs
    are accepted for config compatibility."""
    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = int(5e8)
    allgather_bucket_size: int = int(5e8)
    overlap_comm: bool = True
    round_robin_gradients: bool = False
    sub_group_size: int = int(1e9)
    prefetch_bucket_size: int = int(5e7)
    param_persistence_threshold: int = int(1e5)
    model_persistence_threshold: int = int(1e10)
    max_live_parameters: int = int(1e9)
    offload_optimizer: object = False   # bool | dict -> OffloadConfig
    offload_param: object = False       # bool | dict -> OffloadConfig
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    hpz_partition_size: int = 1
    mics_shard_size: int = -1

    def __post_init__(self):
        self.offload_optimizer = OffloadConfig.normalize(
            self.offload_optimizer)
        self.offload_param = OffloadConfig.normalize(self.offload_param)
        if self.stage not in (0, 1, 2, 3):
            raise DeepSpeedConfigError(f"invalid ZeRO stage {self.stage}")
        mics = self.mics_shard_size not in (-1, 0)
        hpz = self.hpz_partition_size > 1
        if mics and hpz and self.mics_shard_size != self.hpz_partition_size:
            raise DeepSpeedConfigError(
                f"mics_shard_size={self.mics_shard_size} and "
                f"hpz_partition_size={self.hpz_partition_size} disagree; "
                "both subdivide the same inner data axis — set one (or "
                "equal values)")


@dataclass
class MoEConfig:
    """Dropless-MoE block (the JAX ``MoEConfig``). The engine installs it
    on the model as ``model._moe_cfg``; for GPT2MoE an explicit non-"auto"
    ``grouped_kernel`` overrides the model-config knob:

      grouped_kernel   "auto" (the Hopper grouped kernels: the port has no
                       winner cache) | true (the kernels) | false (the
                       ragged math).
      hierarchical_a2a "auto" | true | false: the staging of the expert-
                       parallel all_to_all; validated, inert at one expert
                       shard (as in JAX without an outer mesh axis).
      dcn_quantize     true | false | "auto": the int8 round trip on that
                       exchange's cross-slice legs; validated, inert here.
    """
    grouped_kernel: object = "auto"    # "auto" | bool
    hierarchical_a2a: object = "auto"  # "auto" | bool
    dcn_quantize: object = False       # bool | "auto"

    def __post_init__(self):
        if self.grouped_kernel not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"moe.grouped_kernel must be true|false|'auto', got "
                f"{self.grouped_kernel!r}")
        if self.hierarchical_a2a not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"moe.hierarchical_a2a must be true|false|'auto', got "
                f"{self.hierarchical_a2a!r}")
        if self.dcn_quantize not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"moe.dcn_quantize must be true|false|'auto', got "
                f"{self.dcn_quantize!r}")


@dataclass
class SequenceConfig:
    """Sequence/context-parallelism block (the JAX ``SequenceConfig``,
    runtime/config.py:443-488), read by models with
    ``attention_backend='ring'`` when seq > 1 (sequence/ring.py):

      layout        'zigzag' (default) | 'contiguous' (every pair computed
                    and positionally masked).
      block_kernel  'auto' (default: the K10 / K2 steps; the JAX winner
                    cache's choice on a miss) | true (the same) | false
                    (dense einsum block steps, the reference path).
      double_buffer post each step's KV exchange before the step's
                    kernels; false serializes rotate-then-compute.
      rotate_chunks split each KV rotation into this many head-dim
                    exchanges: int >= 1 | "auto" (1).
    """
    layout: str = "zigzag"
    block_kernel: object = "auto"
    double_buffer: bool = True
    rotate_chunks: object = "auto"

    def __post_init__(self):
        if self.layout not in ("zigzag", "contiguous"):
            raise DeepSpeedConfigError(
                f"sequence.layout must be 'zigzag'|'contiguous', got "
                f"{self.layout!r}")
        if self.block_kernel not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"sequence.block_kernel must be true|false|'auto', got "
                f"{self.block_kernel!r}")
        if self.rotate_chunks != "auto" and (
                not isinstance(self.rotate_chunks, int)
                or isinstance(self.rotate_chunks, bool)
                or self.rotate_chunks < 1):
            raise DeepSpeedConfigError(
                f"sequence.rotate_chunks must be an int >= 1 or 'auto', "
                f"got {self.rotate_chunks!r}")


@dataclass
class CommsLoggerConfig:
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False


@dataclass
class CheckpointEngineConfig:
    """The JAX ``CheckpointEngineConfig`` (its runtime/config.py:236-348):
    one block with a type switch (``runtime/checkpoint_engine/engines.py``
    ``ENGINES``: sync, async, native, none and the reference-fork aliases),
    the crash-consistency knobs (retry/degrade policy, retention) and the
    hot-tier fields with the same defaults and validation. The hot tier
    and the preemption drain are not ported: a block that turns either on
    (``true``, or ``"auto"`` resolving to on) raises, naming ROADMAP
    Queue 1, M14."""
    type: str = "sync"                # sync | async | native | none
    host_cache_bytes: int = 1 << 30   # pinned-host staging budget (async/native)
    writer_threads: int = 2
    max_inflight: int = 2
    # retry/degrade policy: each shard write gets save_retries retries
    # with capped exponential backoff, then the engine's degraded writer
    # (native -> python; async pool dead -> in-caller sync write)
    save_retries: int = 2
    retry_backoff_s: float = 0.05
    retry_backoff_cap_s: float = 2.0
    # retention: keep the newest keep_last durable tags, GC older ones
    # only after the newest verifies (CRC + chunk coverage). 0 = keep all.
    keep_last: int = 0
    # hot tier (JAX checkpoint_engine/hot_tier.py; M14): peer-replicated
    # in-memory generations so the common single-host loss restores with
    # zero persistent-storage reads.
    #   hot_tier      "auto" (on iff an elastic launcher exported the
    #                 ring env — DSTPU_HOT_PEERS/DSTPU_HOT_TIER_ROOT/
    #                 DSTPU_HOT_TRANSPORT) | true | false. 'auto' is
    #                 deliberately NOT on for a bare multi-process
    #                 world: the default fs transport writes into
    #                 node-local tmpfs, which only survives a host loss
    #                 when the launcher wired the ring (or the dcn
    #                 transport moves bytes between hosts) — pushing
    #                 replicas nobody could ever restore from would be
    #                 pure per-save overhead
    #   hot_replicas  K: ring neighbors receiving each shard replica
    #   hot_root      store root ("" = DSTPU_HOT_TIER_ROOT env, else
    #                 tmpfs /dev/shm — host RAM, the point of the tier)
    #   hot_keep_last hot-tier retention (a bounded RAM cache, not an
    #                 archive)
    hot_tier: object = "auto"
    hot_replicas: object = 1          # int >= 0 | "auto" (winner cache)
    hot_root: str = ""
    hot_keep_last: int = 2
    # async-push backlog bound (hot_tier.push_async): at most this many
    # pending pushes; the oldest queued one is dropped (counted as an
    # advisory hot_push_errors) and a newer push of the same tag
    # supersedes a still-queued one
    hot_max_inflight_pushes: int = 4
    # preemption-graceful drain: on SIGTERM (maintenance notice /
    # elastic-agent forward) finish the in-flight step, force one
    # hot+replica push and a flight-recorder dump, then exit with
    # PREEMPTED_EXIT_CODE so the agent classifies 'preempted' (no
    # backoff). "auto" = on iff supervised (ELASTIC_GENERATION in env
    # or DSTPU_PREEMPT_DRAIN exported) | true | false.
    preempt_drain: object = "auto"

    def __post_init__(self):
        if self.save_retries < 0:
            raise DeepSpeedConfigError(
                f"checkpoint_engine.save_retries must be >= 0, got "
                f"{self.save_retries}")
        if self.keep_last < 0:
            raise DeepSpeedConfigError(
                f"checkpoint_engine.keep_last must be >= 0 (0 disables "
                f"retention GC), got {self.keep_last}")
        if self.hot_tier not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"checkpoint_engine.hot_tier must be true|false|'auto', "
                f"got {self.hot_tier!r}")
        if self.hot_replicas != "auto" and (
                not isinstance(self.hot_replicas, int)
                or isinstance(self.hot_replicas, bool)
                or self.hot_replicas < 0):
            raise DeepSpeedConfigError(
                f"checkpoint_engine.hot_replicas must be an int >= 0 or "
                f"'auto', got {self.hot_replicas!r}")
        if self.hot_keep_last < 1:
            raise DeepSpeedConfigError(
                f"checkpoint_engine.hot_keep_last must be >= 1 (the "
                f"tier must hold at least the newest generation), got "
                f"{self.hot_keep_last}")
        if not isinstance(self.hot_max_inflight_pushes, int) \
                or isinstance(self.hot_max_inflight_pushes, bool) \
                or self.hot_max_inflight_pushes < 1:
            raise DeepSpeedConfigError(
                f"checkpoint_engine.hot_max_inflight_pushes must be an "
                f"int >= 1 (the bound must admit at least one pending "
                f"push), got {self.hot_max_inflight_pushes!r}")
        if self.preempt_drain not in (True, False, "auto"):
            raise DeepSpeedConfigError(
                f"checkpoint_engine.preempt_drain must be "
                f"true|false|'auto', got {self.preempt_drain!r}")

    def resolve_preempt_drain(self):
        """'auto' arms the SIGTERM drain iff something supervises us —
        an elastic agent (ELASTIC_GENERATION) or an operator export
        (DSTPU_PREEMPT_DRAIN). Unsupervised runs keep the default
        SIGTERM disposition: nothing would classify the distinct exit
        code, and hijacking the signal would only delay teardown."""
        import os
        if self.preempt_drain != "auto":
            return bool(self.preempt_drain)
        return bool(os.environ.get("ELASTIC_GENERATION") is not None
                    or os.environ.get("DSTPU_PREEMPT_DRAIN"))

    def resolve_hot_tier(self, nprocs=1):
        """'auto' turns the tier on iff an elastic launcher (or the
        operator) exported the ring env. ``nprocs`` is accepted for
        call-site symmetry but deliberately unused — see the hot_tier
        field comment."""
        import os
        if self.hot_tier != "auto":
            return bool(self.hot_tier)
        return bool(os.environ.get("DSTPU_HOT_PEERS")
                    or os.environ.get("DSTPU_HOT_TIER_ROOT")
                    or os.environ.get("DSTPU_HOT_TRANSPORT"))


@dataclass
class OptimizerConfig:
    type: str = "AdamW"
    params: dict = field(default_factory=dict)


def _take(d, cls, key):
    sub = d.get(key, {})
    if isinstance(sub, cls):
        return sub
    if not isinstance(sub, dict):
        raise DeepSpeedConfigError(f"'{key}' must be a dict, got {type(sub)}")
    known = {f for f in cls.__dataclass_fields__}
    unknown = set(sub) - known
    if unknown:
        logger.warning(f"config block '{key}': ignoring unknown keys "
                       f"{sorted(unknown)}")
    return cls(**{k: v for k, v in sub.items() if k in known})


def _enabled(block):
    return isinstance(block, dict) and block.get("enabled", False) is True


def _unported(raw, zero, fp16, ckpt):
    """(what, ROADMAP item) for every enabled block the port does not
    carry yet."""
    out = []
    if ckpt.resolve_hot_tier():
        out.append(("checkpoint_engine hot_tier", "M14, hot tier"))
    if ckpt.resolve_preempt_drain():
        out.append(("checkpoint_engine preempt_drain", "M14, hot tier"))
    if zero.offload_optimizer.enabled or zero.offload_param.enabled:
        out.append(("zero_optimization offload_optimizer/offload_param",
                    "M14, offload"))
    if int(raw.get(C.PIPELINE, {}).get("stages", 1)) > 1:
        out.append(("pipeline", "M13"))
    if raw.get(C.EXPERT_PARALLEL_SIZE, 1) > 1:
        out.append(("expert_parallel_size > 1", "M10, MoE expert parallel"))
    if int(raw.get(C.TENSOR_PARALLEL, {}).get("size", 1)) > 1:
        out.append(("tensor_parallel", "M5"))
    if _enabled(raw.get("comm_overlap")):
        out.append(("comm_overlap", "M5"))
    if raw.get("quantize"):
        out.append(("quantize", "M11"))
    if _enabled(raw.get("telemetry")):
        out.append(("telemetry", "M14"))
    if any(_enabled(raw.get(k)) for k in ("tensorboard", "wandb",
                                          C.MONITOR_CSV)):
        out.append(("monitor (tensorboard / wandb / csv_monitor)", "M14"))
    if raw.get(C.SCHEDULER) is not None:
        out.append(("scheduler (LR schedules)", "M4"))
    if fp16.enabled:
        out.append(("fp16 training", "M4"))
    de = raw.get("data_efficiency", {}) or {}
    if _enabled(raw.get("curriculum_learning")) or (
            de.get("enabled") and _enabled(
                (de.get("data_sampling") or {}).get("curriculum_learning"))):
        out.append(("curriculum learning", "M14"))
    if de.get("enabled") and _enabled(
            (de.get("data_routing") or {}).get("random_ltd")):
        out.append(("random_ltd", "M14"))
    if raw.get("parallelism", "") == "auto":
        out.append(("parallelism='auto'", "M14, autotuning"))
    if raw.get("autotune", {}).get("mode", "") not in ("", "off"):
        out.append(("autotune", "M14, autotuning"))
    return out


class DeepSpeedConfig:
    """Resolved, validated run config.

    Batch triad resolution follows reference runtime/config.py: given any two
    of (train_batch_size, train_micro_batch_size_per_gpu,
    gradient_accumulation_steps) the third is derived; given one, the others
    default to fill; all three must satisfy
    train_batch == micro_batch * grad_accum * dp_world.
    """

    def __init__(self, config, dp_world_size=1):
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        if not isinstance(config, dict):
            raise DeepSpeedConfigError(
                f"expected dict or json path, got {type(config)}")
        self._raw = config
        self.dp_world_size = dp_world_size

        self.train_batch_size = config.get(C.TRAIN_BATCH_SIZE)
        self.train_micro_batch_size_per_gpu = config.get(
            C.TRAIN_MICRO_BATCH_SIZE_PER_GPU)
        self.gradient_accumulation_steps = config.get(
            C.GRADIENT_ACCUMULATION_STEPS)
        self._resolve_batch_size()

        self.steps_per_print = config.get(C.STEPS_PER_PRINT,
                                          C.STEPS_PER_PRINT_DEFAULT)
        self.gradient_clipping = config.get(C.GRADIENT_CLIPPING,
                                            C.GRADIENT_CLIPPING_DEFAULT)

        self.fp16 = _take(config, FP16Config, C.FP16)
        self.bf16 = _take(config, BF16Config, C.BF16)
        if self.fp16.enabled and self.bf16.enabled:
            raise DeepSpeedConfigError("fp16 and bf16 cannot both be enabled")
        self.zero = _take(config, ZeroConfig, C.ZERO_OPTIMIZATION)
        self.moe = _take(config, MoEConfig, "moe")
        self.sequence = _take(config, SequenceConfig, "sequence")
        self.sequence_parallel_size = int(
            config.get(C.SEQUENCE_PARALLEL_SIZE, 1))
        self.comms_logger = _take(config, CommsLoggerConfig,
                                  C.COMMS_LOGGER)
        self.checkpoint_engine = _take(config, CheckpointEngineConfig,
                                       "checkpoint_engine")

        opt = config.get(C.OPTIMIZER)
        self.optimizer = None if opt is None else _take(
            {"o": opt}, OptimizerConfig, "o")

        dtypes = config.get(C.DATA_TYPES, {})
        self.grad_accum_dtype = dtypes.get(C.GRAD_ACCUM_DTYPE)

        bad = _unported(config, self.zero, self.fp16, self.checkpoint_engine)
        if bad:
            raise NotImplementedError(
                "config blocks the PyTorch port does not carry yet: "
                + "; ".join(f"{what} (ROADMAP Queue 1, {item})"
                            for what, item in bad))

    # reference runtime/config.py batch resolution logic, same error text style
    def _resolve_batch_size(self):
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        dp = self.dp_world_size
        for name, v in ((C.TRAIN_BATCH_SIZE, train),
                        (C.TRAIN_MICRO_BATCH_SIZE_PER_GPU, micro),
                        (C.GRADIENT_ACCUMULATION_STEPS, gas)):
            if v is not None and (not isinstance(v, int) or v <= 0):
                raise DeepSpeedConfigError(
                    f"{name} must be a positive integer, got {v!r}")

        if all(v is not None for v in (train, micro, gas)):
            if train != micro * gas * dp:
                raise DeepSpeedConfigError(
                    f"Check batch related parameters. train_batch_size is not equal "
                    f"to micro_batch_per_gpu * gradient_acc_step * world_size "
                    f"{train} != {micro} * {gas} * {dp}")
        elif train is not None and micro is not None:
            gas = train // (micro * dp)
            if gas * micro * dp != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by "
                    f"micro_batch {micro} * dp world size {dp}")
        elif train is not None and gas is not None:
            micro = train // (gas * dp)
            if micro * gas * dp != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by "
                    f"gradient_accumulation_steps {gas} * dp world size {dp}")
        elif micro is not None:
            gas = 1 if gas is None else gas
            train = micro * gas * dp
        elif train is not None:
            micro = train // dp
            gas = 1
            if micro * dp != train:
                raise DeepSpeedConfigError(
                    f"train_batch_size {train} not divisible by dp world size {dp}")
        else:
            raise DeepSpeedConfigError(
                "Either train_batch_size or train_micro_batch_size_per_gpu "
                "must be provided")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas

    @property
    def precision_dtype(self):
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32

    @property
    def grad_accum_torch_dtype(self):
        """data_types.grad_accum_dtype as a torch dtype (fp32 default)."""
        name = {"fp32": "float32", "bf16": "bfloat16", "fp16": "float16",
                None: "float32"}.get(self.grad_accum_dtype,
                                     self.grad_accum_dtype)
        return getattr(torch, name)
