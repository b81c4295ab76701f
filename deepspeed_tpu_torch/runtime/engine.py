"""DeepSpeedEngine — the training engine, eager PyTorch, one card a
process.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` ``train_batch``
(engine.py:599-695, :1315-1400): working parameters in the precision
dtype cast from an fp32 master; the global batch split into
``(gas, micro)``; per micro step the loss times the loss scale is
backpropagated and the gradients, cast to ``grad_accum_dtype``, are
accumulated as ``g / gas``; then unscale, an overflow check, global-norm
clipping with the JAX formula, the optimizer update on the master (skipped
on overflow) and the cast back to the parameters' dtype.

The engine takes its initial parameters from the model module (so a JAX
engine's initial master can be loaded through ``gpt2_params_from_numpy``
or ``gpt2_moe_params_from_numpy``), casts every one to the precision dtype
and takes the fp32 master from those, as JAX's engine.py:468-474 does (so
a router the model keeps in fp32 enters a bf16 engine's master rounded).
It installs the config's ``moe`` block on the model as ``model._moe_cfg``
and drives ``model.loss(batch)``.

A multi-process world (``utils/groups.py``) is built from the config as
the JAX engine.py:130-141 builds its mesh: ``sequence_parallel_size``
ranks a ``seq`` group, data parallelism over the rest, split into
``data_outer`` x ``data`` by ``mics_shard_size`` / ``hpz_partition_size``.
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
"""

import json
import os

import numpy as np
import torch

from .. import comm
from ..models.gpt2_moe import GPT2MoE
from ..ops.optimizers import build_optimizer
from ..utils import groups
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedConfig
from .fp16.loss_scaler import create_loss_scaler, grads_finite
from .zero.partitioning import (ZeroShardingPlan, flat_all_gather,
                                flat_reduce_scatter, shard)

_TODO_MOE_DP = "(ROADMAP Queue 1, S9 (rest): GPT2MoE at dp > 1 (aux loss " \
    "over the global batch))"
_TODO_CKPT = "(ROADMAP Queue 1, M7: checkpoints)"


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
    else:
        if isinstance(config, str):
            with open(config) as f:
                config = json.load(f)
        zero = config.get("zero_optimization", {}) or {}
        mics = int(zero.get("mics_shard_size", -1))
        hpz = int(zero.get("hpz_partition_size", 1))
        sp = int(config.get("sequence_parallel_size", 1))
    shard_size = mics if mics not in (-1, 0) else (hpz if hpz > 1 else -1)
    return groups.TopologyConfig(seq_parallel_size=sp,
                                 zero_shard_size=shard_size)


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
                 device=None, topology=None):
        if lr_scheduler is not None:
            raise NotImplementedError(
                "lr_scheduler objects are not ported yet (ROADMAP Queue 1, "
                "M4: LR schedules)")
        if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
                not comm.is_initialized():
            raise RuntimeError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} but this process "
                f"has joined no world: call deepspeed_tpu_torch.initialize "
                f"(or comm.init_distributed) first")
        if topology is None:
            topology = groups.initialize(_topology_config(config))
        dp = topology.get_data_parallel_world_size()
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config, dp_world_size=dp))
        if self.config.dp_world_size != dp:
            raise ValueError(
                f"the config was resolved for {self.config.dp_world_size} "
                f"data-parallel ranks, the topology has {dp}")
        if dp > 1 and isinstance(model, GPT2MoE):
            raise NotImplementedError(
                f"GPT2MoE over {dp} data-parallel ranks is not ported yet "
                f"{_TODO_MOE_DP}")
        self.topology = topology
        self.dp = dp
        self.seq_parallel = topology.get_sequence_parallel_world_size()
        comm.configure(self.config)
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

        if optimizer is None:
            if self.config.optimizer is None:
                raise ValueError(
                    "no optimizer: pass one or set config['optimizer']")
            optimizer = build_optimizer(self.config.optimizer.type,
                                        self.config.optimizer.params)
        self.optimizer = optimizer
        self.lr_scheduler = None
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
        self.plan = ZeroShardingPlan(
            self.zero_stage, topology, specs() if specs else {},
            {n: tuple(p.shape) for n, p in params.items()},
            partition_axes=(groups.INNER_DP_AXES
                            if zc.mics_shard_size not in (-1, 0)
                            else groups.DP_AXES),
            param_partition_axes=(groups.INNER_DP_AXES
                                  if zc.hpz_partition_size > 1 else None))
        with torch.no_grad():
            for p in params.values():
                p.data = p.data.to(self.param_dtype)
            if topology.world_size > 1:     # every rank starts from rank 0's
                self._broadcast(params)
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
        """Rank 0's parameters to every rank, one flat buffer a dtype."""
        by_dtype = {}
        for n in self._names:
            by_dtype.setdefault(params[n].dtype, []).append(params[n])
        for ps in by_dtype.values():
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

    def _reduce_grads(self, grads):
        """Gradients summed over ``seq`` and averaged over the
        data-parallel axes in fp32: the plan's partitioned grad leaves
        reduce-scattered to this rank's shard (then summed over the reduce
        axes outside the partition group: ``seq``, ``data_outer`` under
        MiCS), the rest all-reduced."""
        reduce_axes = self._live(groups.GRAD_REDUCE_AXES)
        if not reduce_axes:
            return grads
        out = {}
        for axes, names in _by_axes(self._names,
                                    self.plan.parts["grad"]).items():
            dims = [self.plan.parts["grad"][n][0] for n in names]
            shards = flat_reduce_scatter([grads[n].float() for n in names],
                                         dims, axes)
            rest = tuple(a for a in reduce_axes if a not in axes)
            if rest:
                shards = self._all_reduce_flat(shards, rest)
            out.update(zip(names, shards))
        whole = [n for n in self._names if n not in out]
        if whole:
            out.update(zip(whole, self._all_reduce_flat(
                [grads[n].float() for n in whole], reduce_axes)))
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
        partition group at stage >= 1; the master itself otherwise)."""
        master = self.state["master"]
        out = dict(master)
        for axes, names in _by_axes(self._names,
                                    self.plan.parts["master"]).items():
            out.update(zip(names, flat_all_gather(
                [master[n] for n in names],
                [self.plan.parts["master"][n][0] for n in names], axes)))
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

    def _micro_loss_and_grads(self, micro, scale):
        params = self.state["params"]
        self._gather_params()
        for p in params.values():
            p.grad = None
        loss = self._model_loss(micro)
        (loss * scale).backward()
        grads = {n: params[n].grad.to(self.grad_dtype) for n in self._names}
        for p in params.values():
            p.grad = None
        self._release_params()
        return loss.detach(), grads

    def _model_loss(self, micro):
        kwargs = {"seq_sharded": True} if self.seq_parallel > 1 else {}
        return self.model.loss(micro, train=True, **kwargs)

    def _unscale_clip(self, grads, scale):
        """Unscale, overflow check and global-norm clip (engine.py:609-628):
        returns (grads, finite, gnorm). A partitioned gradient leaf counts
        its shards, summed over its partition group with the overflow
        flag; a replicated one counts once."""
        grads = {n: (g / scale).to(g.dtype) for n, g in grads.items()}
        finite = grads_finite(grads.values())
        split = _by_axes(self._names, self.plan.parts["grad"])
        parted = {n for names in split.values() for n in names}
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for n in self._names:
            if n not in parted:
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
            grads = {n: (g * coef).to(g.dtype) for n, g in grads.items()}
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
                {k: v[i] for k, v in batch.items()}, scale)
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
        metrics = self._apply_update(acc)
        metrics["loss"] = loss
        self._global_grad_norm = metrics["grad_norm"]
        self.global_step += 1
        self.micro_steps += gas
        self._maybe_print(metrics)
        return loss

    def _apply_update(self, grads):
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
                                      lr=self.optimizer.lr)
                self._refresh_params()
        state["scale"] = self.loss_scaler.update(state["scale"], overflow)
        state["step"] += 1
        return {"grad_norm": gnorm, "overflow": overflow,
                "loss_scale": scale}

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
                f"lr={float(self.optimizer.lr):.3e} "
                f"grad_norm={float(metrics['grad_norm']):.3f} "
                f"scale={float(metrics['loss_scale']):.0f} "
                f"overflow={metrics['overflow']}", ranks=[0])

    def get_lr(self):
        return [float(self.optimizer.lr)]

    def get_global_grad_norm(self):
        """The last step's global gradient norm before clipping (the same
        on every rank), or None before the first step (reference
        engine.get_global_grad_norm)."""
        n = self._global_grad_norm
        return None if n is None else float(n)

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            f"save_checkpoint is not ported yet {_TODO_CKPT}")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            f"load_checkpoint is not ported yet {_TODO_CKPT}")
