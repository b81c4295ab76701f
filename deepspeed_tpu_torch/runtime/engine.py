"""DeepSpeedEngine — the training engine, eager PyTorch, one card a
process.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` ``train_batch``
(engine.py:599-695, :1315-1400): working parameters in the precision
dtype cast from an fp32 master; the global batch split into
``(gas, micro)``; per micro step the loss times the loss scale is
backpropagated and the gradients, cast to ``grad_accum_dtype``, are
accumulated as ``g / gas``; then unscale, an overflow check, global-norm
clipping with the JAX formula, the optimizer update on the master (skipped
on overflow) and the cast back to the parameters' dtype. The step's lr
is the schedule's value at ``global_step`` (the config's ``scheduler``
block through ``lr_schedules.build_scheduler``, or an ``lr_scheduler``
object; the optimizer's ``lr`` without one), and the schedule steps after
the update (JAX engine.py:1277, :1397). fp16 training runs the dynamic
loss scaler (``runtime/fp16/loss_scaler.py``): the loss times the scale
is backpropagated through the fp16 parameters, the gradients (fp32 by
default) are unscaled, and a non-finite gradient skips the step and
halves the scale once the hysteresis is spent, as JAX engine.py:580-654;
``last_metrics`` holds the step's ``loss_scale``, ``overflow``, ``lr``
and ``grad_norm``.

The engine trains GPT2, GPT2MoE, Llama and Mixtral (``models/``). It takes
its initial parameters from the model module (so a JAX engine's initial
master can be loaded through ``gpt2_params_from_numpy``,
``gpt2_moe_params_from_numpy``, ``llama_params_from_numpy`` or
``mixtral_params_from_numpy``), casts every one to the precision dtype and
takes the fp32 master from those, as JAX's engine.py:468-474 does (so a
router the model keeps in fp32 enters a bf16 engine's master rounded).
It installs the config's ``moe`` block on the model as ``model._moe_cfg``
and, at dp > 1, the live data-parallel axes as ``model._moe_dp_axes``
(an MoE layer's aux loss then sums its routing statistics over them, and
a capacity gate routes the global batch: the JAX loss runs over the
global batch), and drives ``model.loss(batch)``. The JAX state key
(``rng_data``, the words of ``jax.random.key(seed + 1)``) is folded with 0
after every optimizer step, a skipped one included (JAX engine.py:652),
and micro step i's key is ``fold_in(rng_data, i)``; a model whose
training forward draws noise (``model._requires_train_rng()``, GPT2MoE's
noisy gating) gets it as ``loss(rng=)``, as JAX's ``_model_loss`` passes
it (engine.py:564-574, :669, :680).

A multi-process world (``utils/groups.py``) is built from the config as
the JAX engine.py:130-141 builds its mesh: ``sequence_parallel_size``
ranks a ``seq`` group, data parallelism over the rest, split into
``data_outer`` x ``data`` by ``mics_shard_size`` / ``hpz_partition_size``,
with ``expert_parallel_size`` ranks an ``expert`` group.
Rank 0's initial parameters are broadcast at construction. Every rank
passes the same global batch (JAX engine.py:1298-1312): it is reshaped to
``(gas, B / gas, ...)`` and each rank takes its contiguous block of dim 1
by ``axis_index(BATCH_AXES)``; with seq > 1 the model's loss runs
seq-sharded (``_model_loss``, JAX engine.py:565-567), each rank computing
its sequence block. The gradients are summed over ``seq`` and averaged
over the data-parallel axes, in fp32, so every rank applies the same step,
and the returned loss is the mean over the data-parallel ranks.

ZeRO (``runtime/zero/partitioning.py``, the JAX ``ZeroShardingPlan``):
stage 0 all-reduces the gradients and every rank updates the whole master;
stage 1 partitions the fp32 master and the Adam moments, each rank updates
its shard and an all-gather of the cast shards re-makes the parameters
whole; stage 2 reduce-scatters the partitioned gradients each micro step,
so the buffer a rank keeps is its shard; stage 3 also holds the working
parameters as shards between steps, all-gathers them whole for each micro
step's forward and backward and frees them after it (per-layer fetch and
release is ROADMAP M6). The global-norm clip counts each partitioned
leaf's shards once and each replicated leaf once; that sum and the
overflow flag are all-reduced over the partition group, so every rank
clips, steps or skips alike. Collectives over one rank are skipped. At one
data-parallel rank no stage partitions anything and all give the same
result. Each collective moves one flat buffer a dtype.

Expert parallelism (``expert_parallel_size`` > 1, M10): the leaves whose
base spec names ``expert`` (GPT2MoE's ``blocks.moe.*`` but the router,
Mixtral's ``moe_w*``; over ``("data_outer", "expert")`` when Mixtral's
exchange stages) are cut to this rank's ``E / ep`` experts after the
broadcast, and the model learns the expert count it runs with
(``model._moe_ep``). Their ZeRO partition drops ``expert`` from its group,
as ``add_partition_axis`` does. Their gradients sum over the reduce axes
but those the leaf is split over (the exchange's backward already brought
every expert rank's tokens to them) and are still divided by the full
data-parallel count; the global norm sums an expert leaf's squares over
its split axes once and a replicated leaf's not at all; LAMB's norms sum
likewise (``optimizer.norm_axes``). A checkpoint holds the whole leaves,
each rank writing its experts' chunks.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``, the JAX
engine.py:1718-2201) write and read the JAX package's files: one
``{save_dir}/{tag}/shard-{rank}.npz`` a rank (this rank's chunks of the
fp32 master, the optimizer state, the loss-scale state, ``step``,
``skipped`` and ``rng_data``, keyed by the JAX tree paths) and the
``latest`` pointer, published only once every rank's shard is durable.
The engine copies its shards to host memory first (``d2h``), then hands
them to the ``checkpoint_engine`` config block's engine (sync, async,
native, none). A load reassembles the global arrays, takes this rank's
shards through the current plan, recasts the working parameters from the
master and adapts to a changed topology or ZeRO stage (the global batch
kept by rescaling gas, micro_steps realigned, the RNG words folded).
"""

import json
import os
import time

import numpy as np
import torch

from .. import comm
from ..ops.optimizers import FusedLamb, build_optimizer
from ..utils import fault_injection, groups, prng
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from . import constants as C
from .checkpoint_engine import manager as ckpt_manager
from .checkpoint_engine import serialization as ser
from .checkpoint_engine.engines import create_checkpoint_engine
from .config import DeepSpeedConfig
from .fp16.loss_scaler import create_loss_scaler, grads_finite
from .lr_schedules import build_scheduler
from .zero.partitioning import (ZeroShardingPlan, flat_all_gather,
                                flat_reduce_scatter, reshape_diff, shard)


BROADCAST_BUCKET = 1 << 28


def _axes_of(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _jax_order(names):
    """Parameter names in the JAX tree's leaf order (sorted keys, the
    ``blocks`` subtree at its sorted place), so the global norm sums in the
    same order."""
    def key(n):
        return n.split(".") if n.startswith("blocks.") else [n]
    return sorted(names, key=key)


def _topology_config(config):
    """The TopologyConfig of a config (dict, json path or
    DeepSpeedConfig), as JAX engine.py:130-141: ``zero_shard_size`` from
    ``mics_shard_size``, else from ``hpz_partition_size`` > 1."""
    if isinstance(config, DeepSpeedConfig):
        mics = config.zero.mics_shard_size
        hpz = config.zero.hpz_partition_size
        sp = config.sequence_parallel_size
        ep = config.expert_parallel_size
    else:
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        zero = config.get("zero_optimization", {}) or {}
        mics = int(zero.get("mics_shard_size", -1))
        hpz = int(zero.get("hpz_partition_size", 1))
        sp = int(config.get("sequence_parallel_size", 1))
        ep = int(config.get("expert_parallel_size", 1))
    shard_size = mics if mics not in (-1, 0) else (hpz if hpz > 1 else -1)
    return groups.TopologyConfig(seq_parallel_size=sp,
                                 expert_parallel_size=ep,
                                 zero_shard_size=shard_size)


def _nest(named):
    """{"blocks.wq": x} -> {"blocks": {"wq": x}} (the JAX tree)."""
    out = {}
    for n, v in named.items():
        node = out
        *head, last = n.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def _by_axes(names, part):
    """{axes: [names]} of the partitioned names of a plan part."""
    out = {}
    for n in names:
        dim, axes = part[n]
        if dim is not None:
            out.setdefault(axes, []).append(n)
    return out


class DeepSpeedEngine:
    def __init__(self, model, config, optimizer=None, lr_scheduler=None,
                 device=None, topology=None, seed=0):
        if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
                not comm.is_initialized():
            raise RuntimeError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} but this process "
                f"has joined no world: call deepspeed_tpu_torch.initialize "
                f"(or comm.init_distributed) first")
        if topology is None:
            topology = groups.initialize(_topology_config(config))
        if topology.axis_size("tensor") > 1:
            raise NotImplementedError(
                f"a tensor axis of {topology.axis_size('tensor')} ranks: the "
                f"training engine does not carry tensor parallelism yet "
                f"(ROADMAP Queue 1, M5: tensor parallel); the v2 serving "
                f"engine does")
        dp = topology.get_data_parallel_world_size()
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config, dp_world_size=dp))
        if self.config.dp_world_size != dp:
            raise ValueError(
                f"the config was resolved for {self.config.dp_world_size} "
                f"data-parallel ranks, the topology has {dp}")
        self.topology = topology
        self.dp = dp
        self.seq_parallel = topology.get_sequence_parallel_world_size()
        comm.configure(self.config)
        # the measured kernel dispatch is process-global: the config's
        # autotune block becomes the complete state before any step runs
        # (empty fields take the DSTPU_AUTOTUNE* env), as JAX engine.py:157
        from ..autotuning import kernel_dispatch
        kernel_dispatch.configure_from_config(self.config.autotune)
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.zero_stage = self.config.zero.stage
        self.param_dtype = self.config.precision_dtype
        model_dtype = getattr(getattr(model, "config", None), "dtype", None)
        if model_dtype is not None and \
                getattr(torch, model_dtype) != self.param_dtype:
            raise ValueError(
                f"model config dtype {model_dtype!r} != engine precision "
                f"{self.param_dtype} (from the bf16/fp16 config blocks); set "
                f"the model's dtype to match, or enable/disable bf16 "
                f"accordingly")
        self.global_step = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._global_grad_norm = None
        # the JAX engine's state key, jax.random.key(seed + 1), as its two
        # threefry words: checkpointed as rng_data, folded after each step
        # and on a reshape
        self.rng_data = prng.key_data(seed + 1)
        self.checkpoint_engine = create_checkpoint_engine(
            self.config.checkpoint_engine)
        # the last save_checkpoint: its tag, the seconds it blocked the
        # caller and the seconds until 'latest' named it (None until then)
        self.last_save = None

        if optimizer is None:
            if self.config.optimizer is None:
                raise ValueError(
                    "no optimizer: pass one or set config['optimizer']")
            optimizer = build_optimizer(self.config.optimizer.type,
                                        self.config.optimizer.params)
        self.optimizer = optimizer
        if lr_scheduler is None and self.config.scheduler is not None:
            lr_scheduler = build_scheduler(self.config.scheduler.type,
                                           self.config.scheduler.params)
        self.lr_scheduler = lr_scheduler
        self.last_metrics = None
        self.loss_scaler = create_loss_scaler(self.config.fp16,
                                              self.param_dtype)
        self.grad_dtype = self.config.grad_accum_torch_dtype
        # the dropless-MoE knobs (config 'moe' block): MoE layers consult
        # model._moe_cfg per dispatch (as the JAX engine.py:181-198)
        try:
            self.model._moe_cfg = self.config.moe
        except (AttributeError, TypeError):   # frozen/slotted models
            log_dist(
                "moe config block could not be installed on the model "
                "(attribute assignment rejected); MoE layers will use "
                "the module defaults", ranks=[0])
        # the axes the batch splits over: an MoE aux loss is the global
        # batch's (topk_routing), as the JAX loss over the sharded batch
        try:
            self.model._moe_dp_axes = self._live(groups.BATCH_AXES) or None
        except (AttributeError, TypeError):
            log_dist(
                "data-parallel axes could not be installed on the model; "
                "an MoE aux loss will be each rank's own", ranks=[0])
        # the 'sequence' block: ring attention reads it when seq-sharded
        try:
            self.model._sequence_cfg = self.config.sequence
        except (AttributeError, TypeError):
            log_dist(
                "sequence config block could not be installed on the model "
                "(attribute assignment rejected); ring attention will use "
                "the module defaults", ranks=[0])

        # state: working params (the module's own tensors; at stage 3 the
        # partitioned ones live in param_shards between steps), fp32
        # master, optimizer state, loss-scale state, step
        params = dict(model.named_parameters())
        self._names = _jax_order(params)
        zc = self.config.zero
        specs = getattr(model, "partition_specs", None)
        specs = specs(topology) if specs else {}
        # expert-parallel leaves: name -> (dim, axes) of their expert split
        self._expert = {}
        for n, spec in specs.items():
            for dim, entry in enumerate(spec):
                axes = _axes_of(entry)
                if "expert" in axes and topology.axis_size(axes) > 1:
                    self._expert[n] = (dim, axes)
        self.model._moe_ep = topology.axis_size("expert")
        with torch.no_grad():
            for p in params.values():
                p.data = p.data.to(self.param_dtype)
            if topology.world_size > 1:     # every rank starts from rank 0's
                self._broadcast(params)
            for n, (dim, axes) in self._expert.items():   # this rank's
                params[n].data = shard(params[n].data, dim, axes,
                                       topology).clone()
        self.plan = ZeroShardingPlan(
            self.zero_stage, topology, specs,
            {n: tuple(p.shape) for n, p in params.items()},
            partition_axes=(groups.INNER_DP_AXES
                            if zc.mics_shard_size not in (-1, 0)
                            else groups.DP_AXES),
            param_partition_axes=(groups.INNER_DP_AXES
                                  if zc.hpz_partition_size > 1 else None))
        if isinstance(self.optimizer, FusedLamb):
            # the axes each master leaf is split over: its norms sum there
            self.optimizer.norm_axes = {
                n: self._split_axes(n, "master") for n in self._names}
        with torch.no_grad():
            master = {n: self._shard(params[n], "master", n).float().clone()
                      for n in self._names}
            param_shards = {n: self._shard(params[n], "param", n).clone()
                            for n in self.plan.partitioned("param")}
        self.state = {
            "params": params,
            "param_shards": param_shards,
            "master": master,
            "opt": self.optimizer.init(master),
            "scale": self.loss_scaler.init_state(self.device),
            "step": 0,
        }
        self._release_params()
        log_dist(
            f"engine ready: zero_stage={self.zero_stage} "
            f"dtype={self.param_dtype} dp={dp} sp={self.seq_parallel} "
            f"device={self.device} "
            f"micro_bs={self.config.train_micro_batch_size_per_gpu} "
            f"gas={self.config.gradient_accumulation_steps}", ranks=[0])

    def _broadcast(self, params):
        """Rank 0's parameters to every rank, one flat buffer a dtype and
        bucket of at most ``BROADCAST_BUCKET`` bytes (or one leaf), so the
        buffers stay small beside the model."""
        buckets = {}
        for n in self._names:
            p = params[n]
            group = buckets.setdefault(p.dtype, [[]])
            size = sum(q.numel() for q in group[-1]) * p.element_size()
            if group[-1] and size + p.numel() * p.element_size() \
                    > BROADCAST_BUCKET:
                group.append([])
            group[-1].append(p)
        for ps in (b for group in buckets.values() for b in group):
            flat = comm.broadcast(torch.cat([p.reshape(-1) for p in ps]),
                                  groups.GRAD_REDUCE_AXES)
            for p, f in zip(ps, flat.split([p.numel() for p in ps])):
                p.copy_(f.view_as(p))

    # ---------------------------------------------------------- partitions
    def _shard(self, x, which, name):
        """This rank's ``which`` ("param", "master", "grad") shard of the
        whole leaf ``x`` (``x`` itself where the plan keeps it whole)."""
        dim, axes = self.plan.parts[which][name]
        return x if dim is None else shard(x, dim, axes, self.topology)

    def _live(self, axes):
        """The axes of ``axes`` with more than one rank."""
        return tuple(a for a in axes if self.topology.axis_size(a) > 1)

    def _all_reduce_flat(self, tensors, axes):
        """Each tensor summed over ``axes`` in fp32 (one flat all-reduce),
        back in its dtype."""
        flat = torch.cat([t.float().reshape(-1) for t in tensors])
        flat = comm.all_reduce(flat, axes)
        return [f.view_as(t).to(t.dtype) for t, f in zip(
            tensors, flat.split([t.numel() for t in tensors]))]

    def _split_axes(self, n, which):
        """The live mesh axes leaf ``n``'s ``which`` ("master", "grad") is
        split over on this rank: its expert axes, then its ZeRO partition
        axes."""
        axes = self._expert.get(n, (None, ()))[1]
        dim, part = self.plan.parts[which][n]
        if dim is not None:
            axes = axes + part
        return tuple(a for a in groups.MESH_AXES
                     if a in axes and self.topology.axis_size(a) > 1)

    def _reduce_axes(self, n):
        """The live axes leaf ``n``'s gradient sums over: the reduce axes
        but those an expert leaf is split over."""
        split = self._expert.get(n, (None, ()))[1]
        return tuple(a for a in self._live(groups.GRAD_REDUCE_AXES)
                     if a not in split)

    def _reduce_grads(self, grads):
        """Gradients summed over ``seq`` and averaged over the
        data-parallel axes in fp32: the plan's partitioned grad leaves
        reduce-scattered to this rank's shard (then summed over the reduce
        axes outside the partition group: ``seq``, ``data_outer`` under
        MiCS), the rest all-reduced. An expert leaf sums over the reduce
        axes but its expert axes and is divided by the full dp all the
        same."""
        if not self._live(groups.GRAD_REDUCE_AXES):
            return grads
        out = {}
        for axes, names in _by_axes(self._names,
                                    self.plan.parts["grad"]).items():
            by_rest = {}
            for n in names:
                rest = tuple(a for a in self._reduce_axes(n)
                             if a not in axes)
                by_rest.setdefault(rest, []).append(n)
            for rest, group in by_rest.items():
                dims = [self.plan.parts["grad"][n][0] for n in group]
                shards = flat_reduce_scatter(
                    [grads[n].float() for n in group], dims, axes)
                if rest:
                    shards = self._all_reduce_flat(shards, rest)
                out.update(zip(group, shards))
        by_axes = {}
        for n in self._names:
            if n not in out:
                by_axes.setdefault(self._reduce_axes(n), []).append(n)
        for axes, whole in by_axes.items():
            tensors = [grads[n].float() for n in whole]
            out.update(zip(whole, self._all_reduce_flat(tensors, axes)
                           if axes else tensors))
        dp = self.dp
        return {n: (out[n] / dp if dp > 1 else out[n]).to(grads[n].dtype)
                for n in self._names}

    def _gather_params(self):
        """Stage 3: the partitioned parameters made whole in the module
        (one all-gather a partition group)."""
        params, shards = self.state["params"], self.state["param_shards"]
        for axes, names in _by_axes(shards, self.plan.parts["param"]).items():
            full = flat_all_gather(
                [shards[n] for n in names],
                [self.plan.parts["param"][n][0] for n in names], axes)
            for n, f in zip(names, full):
                params[n].data = f.contiguous()

    def _release_params(self):
        """Stage 3: free the whole copies of the partitioned parameters
        (the module keeps an empty tensor of each until the next
        gather)."""
        for n, s in self.state["param_shards"].items():
            self.state["params"][n].data = s.new_empty(0)

    def gathered_master(self):
        """The whole fp32 master on every rank (collective over the
        partition group at stage >= 1 and over the expert axes of the
        expert leaves; the master itself otherwise)."""
        master = self.state["master"]
        out = dict(master)
        for axes, names in _by_axes(self._names,
                                    self.plan.parts["master"]).items():
            out.update(zip(names, flat_all_gather(
                [master[n] for n in names],
                [self.plan.parts["master"][n][0] for n in names], axes)))
        for axes, names in _by_axes(list(self._expert), self._expert).items():
            out.update(zip(names, flat_all_gather(
                [out[n] for n in names],
                [self._expert[n][0] for n in names], axes)))
        return {n: out[n] for n in self._names}

    # ------------------------------------------------------------- batches
    def _add_gas_dim(self, x):
        """(train_batch_size, ...) -> this rank's (gas, micro, ...) on the
        engine's device: reshaped to (gas, train_batch_size // gas, ...)
        first, then the rank's contiguous block of dim 1 by
        ``axis_index(BATCH_AXES)`` (where the JAX ``_shard_batch`` puts
        its rows)."""
        gas = self.config.gradient_accumulation_steps
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        if x.shape[0] != self.config.train_batch_size:
            raise ValueError(f"batch dim {x.shape[0]} != train_batch_size "
                             f"{self.config.train_batch_size}")
        x = x.reshape((gas, x.shape[0] // gas) + tuple(x.shape[1:]))
        if self.dp > 1:
            micro = x.shape[1] // self.dp
            x = x.narrow(1, self.topology.axis_index(groups.BATCH_AXES)
                         * micro, micro)
        return x.to(self.device)

    def _micro_loss_and_grads(self, micro, scale, rng):
        params = self.state["params"]
        self._gather_params()
        for p in params.values():
            p.grad = None
        loss = self._model_loss(micro, rng)
        (loss * scale).backward()
        grads = {}
        for n in self._names:     # each autograd grad freed once cast
            grads[n] = params[n].grad.to(self.grad_dtype)
            params[n].grad = None
        self._release_params()
        return loss.detach(), grads

    def _model_loss(self, micro, rng):
        """The model's training loss of one micro batch; ``rng``: the
        micro step's key words, passed where the model draws noise."""
        kwargs = {"seq_sharded": True} if self.seq_parallel > 1 else {}
        needs = getattr(self.model, "_requires_train_rng", None)
        if needs is not None and needs():
            kwargs["rng"] = rng
        return self.model.loss(micro, train=True, **kwargs)

    def _unscale_clip(self, grads, scale):
        """Unscale, overflow check and global-norm clip (engine.py:609-628):
        returns (grads, finite, gnorm). A partitioned or expert gradient
        leaf counts its shards, summed over the axes it is split over with
        the overflow flag; a replicated one counts once. The unscale and the
        clip run in place on the accumulated buffers (the same ops as ``g /
        scale`` and ``g * coef`` in the buffers' dtype), so no second copy
        of the gradients exists."""
        for g in grads.values():
            g.div_(scale)
        finite = grads_finite(grads.values())
        split = {}
        for n in self._names:
            split.setdefault(self._split_axes(n, "grad"), []).append(n)
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for n in split.pop((), []):
            sq = sq + grads[n].float().square().sum()
        for axes, names in split.items():
            part = torch.zeros((), dtype=torch.float32, device=self.device)
            for n in names:
                part = part + grads[n].float().square().sum()
            red = comm.all_reduce(torch.stack(
                [part, (~finite).float()]), axes)
            sq = sq + red[0]
            finite = finite & (red[1] == 0)
        gnorm = torch.sqrt(sq)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            for g in grads.values():
                g.mul_(coef)
        return grads, finite, gnorm

    def train_batch(self, batch):
        """One full optimizer step over a global batch. batch leaves:
        (train_batch_size, ...) arrays or tensors, the same on every rank,
        split into (gas, train_batch_size // gas, ...) and then into this
        rank's block. Returns the mean loss of the micro steps over the
        data-parallel ranks (a 0-d tensor)."""
        gas = self.config.gradient_accumulation_steps
        batch = {k: self._add_gas_dim(v) for k, v in batch.items()}
        scale = self.state["scale"]["scale"]
        # stage >= 2 at dp > 1: each micro step's gradients reduce-scattered
        # at once, so the accumulated buffer is this rank's shard
        per_micro = bool(self.plan.partitioned("grad"))
        losses, acc = [], None
        for i in range(gas):
            loss, grads = self._micro_loss_and_grads(
                {k: v[i] for k, v in batch.items()}, scale,
                prng.fold_in(self.rng_data, i))
            losses.append(loss)
            if per_micro:
                grads = self._reduce_grads(grads)
            if gas == 1:
                acc = grads
            elif acc is None:
                acc = {n: g / gas for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    acc[n] += g / gas
        loss = losses[0] if gas == 1 else torch.stack(losses).mean()
        if not per_micro:
            acc = self._reduce_grads(acc)
        if self.dp > 1:
            loss = comm.all_reduce(loss, self._live(groups.DP_AXES),
                                   op="avg")
        metrics = self._apply_update(acc, self._current_lr())
        metrics["loss"] = loss
        self._global_grad_norm = metrics["grad_norm"]
        self.last_metrics = metrics
        self.global_step += 1
        self.micro_steps += gas
        if self.lr_scheduler is not None:
            self.lr_scheduler.step()
        self._maybe_print(metrics)
        return loss

    def _current_lr(self):
        """This step's lr: the schedule's value at ``global_step`` (fp32,
        as the JAX engine passes it), else the optimizer's own."""
        if self.lr_scheduler is not None:
            return torch.as_tensor(self.lr_scheduler(self.global_step),
                                   dtype=torch.float32, device=self.device)
        return self.optimizer.lr

    def _apply_update(self, grads, lr):
        state = self.state
        scale = state["scale"]["scale"]
        grads, finite, gnorm = self._unscale_clip(grads, scale)
        overflow = not bool(finite)
        if overflow:
            # skip-on-overflow: master and optimizer state stay as they were
            self.skipped_steps += 1
        else:
            with torch.no_grad():
                # stage 1: whole gradients, each rank updates its shard
                grads = {n: (self._shard(g, "master", n)
                             if self.plan.parts["grad"][n][0] is None
                             else g) for n, g in grads.items()}
                self.optimizer.update(grads, state["opt"], state["master"],
                                      lr=lr)
                self._refresh_params()
        state["scale"] = self.loss_scaler.update(state["scale"], overflow)
        state["step"] += 1
        self.rng_data = prng.fold_in(self.rng_data, 0)
        return {"grad_norm": gnorm, "overflow": overflow,
                "loss_scale": scale, "lr": lr}

    def _refresh_params(self):
        """The working parameters from the master: a leaf laid out alike in
        both is cast in place; a partitioned master is all-gathered (cast
        first, one flat buffer a group: the step-end all-gather) and, at
        stage 3, cut to this rank's parameter shard."""
        state, plan = self.state, self.plan
        master, params = state["master"], state["params"]
        shards = state["param_shards"]

        def put(n, whole):
            if n in shards:
                shards[n].copy_(self._shard(whole, "param", n))
            else:
                params[n].copy_(whole)

        gather = []
        for n in self._names:
            if plan.parts["master"][n] == plan.parts["param"][n]:
                (shards[n] if n in shards else params[n]).copy_(master[n])
            elif plan.parts["master"][n][0] is None:
                put(n, master[n])
            else:
                gather.append(n)
        for axes, names in _by_axes(gather, plan.parts["master"]).items():
            full = flat_all_gather(
                [master[n].to(self.param_dtype) for n in names],
                [plan.parts["master"][n][0] for n in names], axes)
            for n, f in zip(names, full):
                put(n, f)

    def _maybe_print(self, metrics):
        if (self.config.steps_per_print
                and self.global_step % self.config.steps_per_print == 0):
            log_dist(
                f"step={self.global_step} loss={float(metrics['loss']):.4f} "
                f"lr={float(metrics['lr']):.3e} "
                f"grad_norm={float(metrics['grad_norm']):.3f} "
                f"scale={float(metrics['loss_scale']):.0f} "
                f"overflow={metrics['overflow']}", ranks=[0])

    def get_lr(self):
        """The lr of the next step."""
        return [float(self._current_lr())]

    def get_global_grad_norm(self):
        """The last step's global gradient norm before clipping (the same
        on every rank), or None before the first step (reference
        engine.get_global_grad_norm)."""
        n = self._global_grad_norm
        return None if n is None else float(n)

    # ------------------------------------------------------------ checkpoint
    def _ckpt_tree(self):
        """(tree, parts): the state to save as the JAX engine's
        ``_ckpt_tree`` (engine.py:1718) — fp32 master, optimizer state,
        loss-scale state, ``step`` and ``skipped`` (0-d int32) and
        ``rng_data`` (uint32 (2,)), nested by the JAX tree paths — with
        this rank's shards where the plan partitions a leaf or a leaf holds
        this rank's experts; ``parts``: key -> the (dim, axes) splits of
        every such leaf."""
        st, plan = self.state, self.plan
        parts = {}

        def nest(prefix, named):
            for n in named:
                splits = [self._expert[n]] if n in self._expert else []
                if plan.parts["master"][n][0] is not None:
                    splits.append(plan.parts["master"][n])
                parts[f"{prefix}/{n.replace('.', '/')}"] = splits
            return _nest(named)

        opt = {k: (nest(f"opt/{k}", v) if isinstance(v, dict) else v)
               for k, v in st["opt"].items()}
        tree = {"master": nest("master", st["master"]), "opt": opt,
                "scale": dict(st["scale"]),
                "step": np.asarray(st["step"], np.int32),
                "skipped": np.asarray(self.skipped_steps, np.int32),
                "rng_data": np.asarray(self.rng_data, np.uint32)}
        return tree, {k: v for k, v in parts.items() if v}

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True):
        """Save this rank's shard of the state as the JAX engine does
        (engine.py:1771-1911): ``{save_dir}/{tag}/shard-{rank}.npz`` and,
        once every rank's shard is durable, ``{save_dir}/latest`` (with
        ``.latest_seq`` = the global step). The tag defaults to
        ``global_step{N}``. Each rank copies its shards to host memory
        before it returns (so training may go on at once), then the
        configured engine writes them (an async or native engine off
        this thread). At world > 1 every rank waits for its own write,
        then all agree through an all-reduce (min) of success flags before
        rank 0 publishes; a failed rank still reaches the collective, and
        a failure anywhere leaves 'latest' on the previous generation.
        Returns the tag."""
        t_start = time.perf_counter()
        tag = tag or f"global_step{self.global_step}"
        self.checkpoint_engine.create(tag)
        # device -> host copy of this rank's shards (the VELOC D2H stage)
        fault_injection.fire("d2h")
        tree, parts = self._ckpt_tree()
        chunks, index, meta = ser.extract_local_chunks(
            tree, lambda k: parts.get(k, []), self.topology)
        cfg = self.config
        extra = {
            "index": index,
            "__tree_meta__": meta,
            "user_extra": {
                "global_step": self.global_step,
                "micro_steps": self.micro_steps,
                "zero_stage": self.zero_stage,
                "nprocs": self.topology.world_size,
                "lr_scheduler": (self.lr_scheduler.state_dict()
                                 if self.lr_scheduler is not None
                                 else None),
                "client_state": client_state or {},
                # reshape-on-resume metadata: the topology / batch this
                # generation was written under and the plan (diagnostic;
                # a load re-derives the partitions from the current plan)
                "topology": self._topology_desc(),
                "batch": {
                    "train_batch_size": cfg.train_batch_size,
                    "micro": cfg.train_micro_batch_size_per_gpu,
                    "gas": cfg.gradient_accumulation_steps,
                },
                "zero_plan": self.plan.describe(),
                "sampler": None,
            },
        }
        rank = self.topology.rank
        path = os.path.join(save_dir, tag, f"shard-{rank}.npz")
        keep_last = cfg.checkpoint_engine.keep_last
        # captured NOW: async saves can reach durability out of order;
        # the seq guard keeps 'latest' from regressing
        seq = self.global_step
        times = self.last_save = {"tag": tag, "blocked_s": None,
                                  "latest_s": None}

        def mark_latest():
            if ckpt_manager.publish_latest(save_dir, tag, seq=seq):
                times["latest_s"] = time.perf_counter() - t_start
            # retention GC rides the durability path (the writer thread
            # for async engines); gc_tags re-verifies the newest tag
            # before deleting anything and never raises
            ckpt_manager.gc_tags(save_dir, keep_last,
                                 counters=self.checkpoint_engine.counters)

        rank0 = rank == 0
        if save_latest and self.topology.world_size > 1:
            err = None
            try:
                self.checkpoint_engine.save((chunks, extra), path)
                self.checkpoint_engine.wait()
            except Exception as e:  # noqa: BLE001 - re-raised after sync
                err = e
            flag = torch.tensor([0.0 if err is not None else 1.0],
                                device=self.device)
            all_ok = float(comm.all_reduce(flag, groups.MESH_AXES,
                                           op="min")[0]) >= 1.0
            # a no-op engine writes nothing: 'latest' would dangle
            if rank0 and all_ok and os.path.exists(path):
                mark_latest()
            elif rank0 and not all_ok:
                log_dist(
                    f"not publishing 'latest' for tag {tag!r}: a rank's "
                    f"shard write failed; the previous durable "
                    f"generation remains the recovery point", ranks=[0])
            if err is not None:
                raise err
        else:
            self.checkpoint_engine.save(
                (chunks, extra), path,
                on_durable=(mark_latest if save_latest and rank0
                            else None))
        self.checkpoint_engine.commit(tag)
        times["blocked_s"] = time.perf_counter() - t_start
        return tag

    def _topology_desc(self):
        t = self.topology
        return {"world": int(t.world_size),
                "dp": t.get_data_parallel_world_size(),
                "tp": t.get_model_parallel_world_size(),
                "ep": t.get_expert_parallel_world_size(),
                "seq": t.get_sequence_parallel_world_size(),
                "pipe": t.get_pipe_parallel_world_size()}

    def load_checkpoint(self, load_dir, tag=None,
                        load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        elastic_reshape=True):
        """Load a generation (the JAX engine.py:1958-2083). Returns
        ``(path, client_state)``, ``(None, {})`` when ``load_dir`` holds
        no checkpoint.

        Pending async saves are drained first (without raising: a failed
        save must not block reading what did land). With no ``tag``, the
        generation 'latest' names is tried first, then every other tag
        newest first: a corrupt or truncated shard (CRC mismatch, torn
        zip, missing chunks) falls back to the previous durable
        generation (``counters["load_fallbacks"]``). An explicit ``tag``
        is never substituted; when generations exist and none loads,
        CheckpointCorruptionError is raised. The global arrays go to this
        rank's shards through the current plan, any ZeRO stage or dp;
        the working parameters are recast from the master. With
        ``elastic_reshape`` a checkpoint of another topology or stage
        keeps its global batch (gas rescaled), realigns micro_steps and
        folds the RNG words for the new world. With
        ``load_lr_scheduler_states`` the schedule's saved state is loaded
        into this engine's schedule (JAX engine.py:2065)."""
        self.checkpoint_engine.drain()

        def loader(tag_dir):
            legacy = os.path.join(tag_dir, "state.npz")
            if os.path.exists(legacy):
                return self.checkpoint_engine.load(legacy)
            return ser.load_sharded(tag_dir)

        _, cand, flat, header = ckpt_manager.load_best_tiered(
            load_dir, tag, loader=loader,
            counters=self.checkpoint_engine.counters)
        if cand is None:
            return None, {}
        tree = ser.unflatten_into(self._ckpt_tree()[0], flat,
                                  header.get("meta"))
        extra = header["extra"]
        self._restore(tree, load_optimizer_states)
        if (load_lr_scheduler_states and self.lr_scheduler is not None
                and extra.get("lr_scheduler") is not None):
            self.lr_scheduler.load_state_dict(extra["lr_scheduler"])
        self.global_step = int(extra.get("global_step", 0))
        self.micro_steps = int(extra.get("micro_steps", 0))
        if elastic_reshape:
            self._reshape_on_resume(extra)
        return os.path.join(load_dir, cand), extra.get("client_state", {})

    def _restore(self, tree, load_optimizer_states):
        """The loaded global arrays into the state: this rank's master
        (and moment) shards, the working parameters cast from the whole
        master (no collective: every rank holds the global arrays)."""
        st, dev = self.state, self.device

        def local(arr, name):
            """This rank's experts of a whole leaf (the leaf otherwise)."""
            x = arr if torch.is_tensor(arr) else \
                torch.from_numpy(np.asarray(arr))
            if name in self._expert:
                dim, axes = self._expert[name]
                x = shard(x, dim, axes, self.topology)
            return x

        def into(dst, arr, name):
            src = self._shard(local(arr, name), "master", name)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"checkpoint leaf {name}: shard {tuple(src.shape)} does "
                    f"not match this engine's {tuple(dst.shape)}")
            dst.copy_(src)

        def scalar(arr, like):
            return torch.as_tensor(np.asarray(arr)).to(dev, like.dtype)

        with torch.no_grad():
            master = {n: _leaf(tree["master"], n) for n in self._names}
            for n in self._names:
                into(st["master"][n], master[n], n)
            if load_optimizer_states:
                for k, v in st["opt"].items():
                    if isinstance(v, dict):
                        for n in v:
                            into(v[n], _leaf(tree["opt"][k], n), n)
                    else:
                        st["opt"][k] = scalar(tree["opt"][k], v)
            st["scale"] = {k: scalar(tree["scale"][k], v)
                           for k, v in st["scale"].items()}
            params, shards = st["params"], st["param_shards"]
            for n in self._names:
                whole = local(master[n], n).to(dev).to(self.param_dtype)
                if n in shards:
                    shards[n].copy_(self._shard(whole, "param", n))
                else:
                    params[n].copy_(whole)
        st["step"] = int(tree["step"])
        self.skipped_steps = int(tree["skipped"])
        self.rng_data = np.asarray(tree["rng_data"], np.uint32).copy()

    def _preserve_saved_global_batch(self, extra):
        """The global-batch rule (JAX engine.py:2085-2131): the
        checkpoint's train_batch_size wins over one derived from a
        micro-batch-only config (an explicit ``train_batch_size`` in the
        config is respected, with a warning); with the micro batch fixed,
        gas becomes ``saved_train_batch / (micro * dp)``, and an
        indivisible combination raises. Returns True when gas changed."""
        target = (extra.get("batch") or {}).get("train_batch_size")
        cfg = self.config
        if not target or target == cfg.train_batch_size:
            return False
        if C.TRAIN_BATCH_SIZE in getattr(cfg, "_raw", {}):
            log_dist(
                f"resume: checkpoint global batch {target} != the "
                f"explicitly configured train_batch_size "
                f"{cfg.train_batch_size}; the explicit config wins (drop "
                f"train_batch_size from the config to preserve the "
                f"checkpoint's batch across topologies)", ranks=[0])
            return False
        micro = cfg.train_micro_batch_size_per_gpu
        new_gas = target // max(1, micro * self.dp)
        if new_gas < 1 or new_gas * micro * self.dp != target:
            raise ValueError(
                f"reshape-on-resume: cannot preserve the global batch size "
                f"{target} at dp={self.dp} with micro_batch={micro} (needs "
                f"gradient_accumulation_steps={target}/{micro * self.dp}); "
                f"pick a micro batch that divides it")
        log_dist(
            f"resume: preserving global batch {target}: "
            f"gradient_accumulation_steps {cfg.gradient_accumulation_steps}"
            f" -> {new_gas} at dp={self.dp}", ranks=[0])
        cfg.gradient_accumulation_steps = new_gas
        cfg.train_batch_size = target
        return True

    def _reshape_on_resume(self, extra):
        """Adapt the resumed run to a changed topology or ZeRO stage (the
        JAX engine.py:2133-2195; the load already re-partitioned the
        global arrays onto the current plan). Returns True when the
        checkpoint was written under another topology or stage. The
        global batch is kept (gas rescaled, micro_steps realigned) also
        without a change; on a topology change micro_steps realign and
        the RNG words fold with ``dp * 1000003 + world``, so every
        resumed world derives the same key, distinct from the old one."""
        saved_topo = extra.get("topology") or {}
        cur_topo = self._topology_desc()
        stage_changed = ("zero_stage" in extra
                         and extra["zero_stage"] != self.zero_stage)
        topo_changed = bool(saved_topo) and saved_topo != cur_topo
        rescaled = self._preserve_saved_global_batch(extra)
        if rescaled:
            self.micro_steps = self.global_step * \
                self.config.gradient_accumulation_steps
        if not topo_changed and not stage_changed:
            return rescaled
        fault_injection.fire("reshape")
        diff = reshape_diff(extra.get("zero_plan"), self.plan)
        log_dist(
            f"reshape-on-resume: checkpoint topology {saved_topo} / stage "
            f"{extra.get('zero_stage')} -> {cur_topo} / stage "
            f"{self.zero_stage}; {len(diff['resharded'])} leaves "
            f"re-partitioned (group {diff['old_partition_group']} -> "
            f"{diff['new_partition_group']}), {len(diff['replicated'])} "
            f"replicated on the new mesh", ranks=[0])
        if topo_changed:
            self.micro_steps = self.global_step * \
                self.config.gradient_accumulation_steps
            fold = int(cur_topo["dp"]) * 1000003 + int(cur_topo["world"])
            self.rng_data = prng.fold_in(self.rng_data, fold)
        return True

    def save_checkpoint_terminate(self):
        """Drain async checkpoint work (the fork's engine.py:3114):
        barrier, wait, shut the engine down, barrier."""
        comm.barrier()
        self.checkpoint_engine.wait()
        self.checkpoint_engine.shutdown()
        comm.barrier()
