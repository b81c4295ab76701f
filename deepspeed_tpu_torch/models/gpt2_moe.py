"""GPT-2 with dropless Mixture-of-Experts MLPs, for training.

Counterpart of ``deepspeed_tpu/models/gpt2_moe.py``: every block's dense
MLP becomes a top-k routed MoE (``moe/layer.py``). The parameter tree is
the JAX one: ``blocks`` loses ``wup/bup/wdown/bdown`` and gains

  moe.gate_w (L, D, E) fp32 at init | moe.wi (L, E, D, F) | moe.bi (L, E, F)
  moe.wo (L, E, F, D) | moe.bo (L, E, D)

(state-dict names ``blocks.moe.<name>``). ``loss`` adds
``moe_loss_coeff`` times the load-balance aux loss summed over layers. The
port carries the dropless ``moe_backend="ragged"``; the GShard capacity
backend ("dense", the config's default) raises. The experts' activation
is always gelu (tanh form): as in the JAX model, ``GPT2Config.activation``
does not reach them.
"""

from dataclasses import dataclass

import torch.nn as nn

from ..moe.layer import MoE
from .gpt2 import BLOCK_KEYS, GPT2, GPT2Config

_MOE_KEYS = ("gate_w", "wi", "bi", "wo", "bo")


@dataclass(frozen=True)
class GPT2MoEConfig(GPT2Config):
    num_experts: int = 8
    moe_top_k: int = 1
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    noisy_gate_policy: str = None        # None | 'RSample' | 'Jitter'
    moe_loss_coeff: float = 0.01
    moe_drop_tokens: bool = True
    # 'dense' = GShard capacity dispatch (not ported); 'ragged' = dropless
    # grouped GEMM
    moe_backend: str = "dense"
    # ragged backend's expert-product engine: "auto" | True (the Hopper
    # grouped kernels) | False (the ragged math)
    moe_grouped_kernel: object = "auto"

    def num_params(self):
        dense = super().num_params()
        # replace per-layer dense MLP params with E experts + gate
        mlp = 2 * self.d_model * self.d_ff + self.d_ff + self.d_model
        moe = (self.num_experts * mlp + self.d_model * self.num_experts)
        return dense + self.n_layer * (moe - mlp)


class GPT2MoE(GPT2):
    """Training-side GPT2MoE; ``device``, ``dtype`` and ``seed`` as for
    ``GPT2``. An engine's ``moe`` config block (``model._moe_cfg``) with a
    non-"auto" ``grouped_kernel`` overrides ``moe_grouped_kernel``."""

    block_keys = BLOCK_KEYS[:8] + tuple(f"moe.{k}" for k in _MOE_KEYS)

    def __init__(self, config: GPT2MoEConfig, device=None, dtype=None,
                 seed=0):
        super().__init__(config, device=device, dtype=dtype, seed=seed)
        self.moe_loss_coeff = config.moe_loss_coeff

    def _init_mlp(self, nrm, const, res_std, gen):
        cfg = self.config
        self.moe = MoE(
            hidden_size=cfg.d_model, ffn_hidden_size=cfg.d_ff,
            num_experts=cfg.num_experts, k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor,
            eval_capacity_factor=cfg.eval_capacity_factor,
            min_capacity=cfg.min_capacity,
            noisy_gate_policy=cfg.noisy_gate_policy,
            drop_tokens=cfg.moe_drop_tokens, dtype=self.wte.dtype,
            backend=cfg.moe_backend, grouped_kernel=cfg.moe_grouped_kernel)
        params = self.moe.init(stack=cfg.n_layer, out_std=res_std,
                               device=self.wte.device, generator=gen)
        self.blocks.add_module("moe", nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in params.items()}))

    def _mlp(self, x, ln2_scale, ln2_bias, *moe):
        """ln2 (through ``_ln``, so ``fused_layernorm`` reaches it as in
        the JAX GPT2MoE) + the MoE layer -> (y, aux). ``mlp_kernel`` does
        not reach the experts, in JAX as here."""
        h = self._ln(x, ln2_scale, ln2_bias)
        # an explicit (non-"auto") engine 'moe' block setting overrides
        # the model-config knob (gpt2_moe.py:95-106)
        moe_cfg = getattr(self, "_moe_cfg", None)
        override = (moe_cfg.grouped_kernel
                    if moe_cfg is not None
                    and moe_cfg.grouped_kernel != "auto" else None)
        y, aux, _ = self.moe.apply(dict(zip(_MOE_KEYS, moe)), h,
                                   grouped_kernel=override)
        return y, aux
