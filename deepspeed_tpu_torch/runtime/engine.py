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
and drives ``model.loss(batch)``. ZeRO stages 0-3 are accepted: with one
data-parallel rank they partition nothing and give the same result.

A multi-process world (``utils/groups.py``) is one of
``sequence_parallel_size`` ranks with dp = 1; a data-parallel world of
more than one rank raises (ROADMAP Queue 1, S9). As the JAX engine
(engine.py:1298-1312), every rank passes the same global batch; with
seq > 1 the model's loss runs seq-sharded (``_model_loss``, JAX
engine.py:565-567), each rank computing its sequence block, and the
gradients are summed over the group in fp32 before the overflow check,
clipping and the update, so every rank applies the same step. Rank 0's
initial parameters are broadcast at construction.
"""

import os

import numpy as np
import torch

from .. import comm
from ..ops.optimizers import build_optimizer
from ..utils import groups
from ..utils.device import resolve_device
from ..utils.logging import log_dist
from .config import DeepSpeedConfig
from .fp16.loss_scaler import create_loss_scaler, grads_finite

_TODO_DP = "(ROADMAP Queue 1, S9: ZeRO sharding at dp > 1)"
_TODO_CKPT = "(ROADMAP Queue 1, M7: checkpoints)"


def _jax_order(names):
    """Parameter names in the JAX tree's leaf order (sorted keys, the
    ``blocks`` subtree at its sorted place), so the global norm sums in the
    same order."""
    def key(n):
        return n.split(".") if n.startswith("blocks.") else [n]
    return sorted(names, key=key)


class DeepSpeedEngine:
    def __init__(self, model, config, optimizer=None, lr_scheduler=None,
                 device=None, topology=None):
        if lr_scheduler is not None:
            raise NotImplementedError(
                "lr_scheduler objects are not ported yet (ROADMAP Queue 1, "
                "M4: LR schedules)")
        self.config = (config if isinstance(config, DeepSpeedConfig)
                       else DeepSpeedConfig(config, dp_world_size=1))
        if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
                not comm.is_initialized():
            raise RuntimeError(
                f"WORLD_SIZE={os.environ['WORLD_SIZE']} but this process "
                f"has joined no world: call deepspeed_tpu_torch.initialize "
                f"(or comm.init_distributed) first")
        if topology is None:
            topology = groups.initialize(groups.TopologyConfig(
                seq_parallel_size=self.config.sequence_parallel_size))
        dp = topology.get_data_parallel_world_size()
        if dp > 1:
            raise NotImplementedError(
                f"a data-parallel world of {dp} ranks (world "
                f"{topology.world_size}, seq "
                f"{topology.get_sequence_parallel_world_size()}) is not "
                f"ported yet {_TODO_DP}")
        self.topology = topology
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

        # state: working params (the module's own tensors), fp32 master,
        # optimizer state, loss-scale state, step
        params = dict(model.named_parameters())
        self._names = _jax_order(params)
        with torch.no_grad():
            for p in params.values():
                p.data = p.data.to(self.param_dtype)
            if topology.world_size > 1:     # every rank starts from rank 0's
                self._broadcast(params)
            master = {n: params[n].detach().float().clone()
                      for n in self._names}
        self.state = {
            "params": params,
            "master": master,
            "opt": self.optimizer.init(master),
            "scale": self.loss_scaler.init_state(self.device),
            "step": 0,
        }
        log_dist(
            f"engine ready: zero_stage={self.zero_stage} "
            f"dtype={self.param_dtype} dp=1 sp={self.seq_parallel} "
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

    def _sum_over_seq(self, grads):
        """Each rank's gradient share summed over the seq group in fp32
        (one flat all-reduce), back in the accumulation dtype."""
        flat = torch.cat([grads[n].float().reshape(-1) for n in self._names])
        flat = comm.all_reduce(flat, "seq")
        out = {}
        for n, f in zip(self._names, flat.split(
                [grads[n].numel() for n in self._names])):
            out[n] = f.view_as(grads[n]).to(grads[n].dtype)
        return out

    # ------------------------------------------------------------- batches
    def _add_gas_dim(self, x):
        """(train_batch_size, ...) -> (gas, train_batch_size//gas, ...) on
        the engine's device."""
        gas = self.config.gradient_accumulation_steps
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        if x.shape[0] != self.config.train_batch_size:
            raise ValueError(f"batch dim {x.shape[0]} != train_batch_size "
                             f"{self.config.train_batch_size}")
        return x.to(self.device).reshape((gas, x.shape[0] // gas)
                                         + tuple(x.shape[1:]))

    def _micro_loss_and_grads(self, micro, scale):
        params = self.state["params"]
        for p in params.values():
            p.grad = None
        loss = self._model_loss(micro)
        (loss * scale).backward()
        grads = {n: params[n].grad.to(self.grad_dtype) for n in self._names}
        return loss.detach(), grads

    def _model_loss(self, micro):
        kwargs = {"seq_sharded": True} if self.seq_parallel > 1 else {}
        return self.model.loss(micro, train=True, **kwargs)

    def _unscale_clip(self, grads, scale):
        """Unscale, overflow check and global-norm clip (engine.py:609-628):
        returns (grads, finite, gnorm)."""
        grads = {n: (g / scale).to(g.dtype) for n, g in grads.items()}
        finite = grads_finite(grads.values())
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for n in self._names:
            sq = sq + grads[n].float().square().sum()
        gnorm = torch.sqrt(sq)
        clip = self.config.gradient_clipping
        if clip and clip > 0:
            coef = torch.clamp(clip / (gnorm + 1e-6), max=1.0)
            grads = {n: (g * coef).to(g.dtype) for n, g in grads.items()}
        return grads, finite, gnorm

    def train_batch(self, batch):
        """One full optimizer step over a global batch. batch leaves:
        (train_batch_size, ...) arrays or tensors, split into
        (gas, train_batch_size // gas, ...). Returns the mean loss of the
        micro steps (a 0-d tensor)."""
        gas = self.config.gradient_accumulation_steps
        batch = {k: self._add_gas_dim(v) for k, v in batch.items()}
        scale = self.state["scale"]["scale"]
        losses, acc = [], None
        for i in range(gas):
            loss, grads = self._micro_loss_and_grads(
                {k: v[i] for k, v in batch.items()}, scale)
            losses.append(loss)
            if gas == 1:
                acc = grads
            elif acc is None:
                acc = {n: g / gas for n, g in grads.items()}
            else:
                for n, g in grads.items():
                    acc[n] += g / gas
        loss = losses[0] if gas == 1 else torch.stack(losses).mean()
        if self.seq_parallel > 1:
            acc = self._sum_over_seq(acc)
        metrics = self._apply_update(acc)
        metrics["loss"] = loss
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
                self.optimizer.update(grads, state["opt"], state["master"],
                                      lr=self.optimizer.lr)
                for n in self._names:
                    state["params"][n].copy_(state["master"][n])
        state["scale"] = self.loss_scaler.update(state["scale"], overflow)
        state["step"] += 1
        return {"grad_norm": gnorm, "overflow": overflow,
                "loss_scale": scale}

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

    def save_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            f"save_checkpoint is not ported yet {_TODO_CKPT}")

    def load_checkpoint(self, *args, **kwargs):
        raise NotImplementedError(
            f"load_checkpoint is not ported yet {_TODO_CKPT}")
