"""Mixtral-class model for training and v2 paged serving: the port's
Llama attention (GQA + RoPE; the flash kernels in training, the paged
kernels in serving) with a dropless top-k SwiGLU MoE FFN per block.

Counterpart of ``deepspeed_tpu/models/mixtral.py``. Parameter names and
shapes are the JAX package's: the blocks swap ``wgate/wup/wdown`` for

  moe_gate (L, D, E) | moe_w1 (L, E, D, F) | moe_w3 (L, E, D, F) |
  moe_w2 (L, E, F, D)          (w1 = gate, w3 = up, w2 = down)

The expert FFN is the dropless grouped-GEMM pattern: routed rows sort by
expert, each expert multiplies exactly its contiguous group through the
Hopper grouped kernels (moe/sharded_moe.py, ops/cuda/grouped_matmul.py),
the outputs unsort and combine by the renormalised top-k weights. The
paged prefill/chunk/decode programs are Llama's and call ``_mlp`` per
layer. Every step stays on the device: no host sync per layer.

Training is Llama's (``apply``, ``loss``) with this ``_mlp`` under
autograd: the router's gradient flows through ``route_top_k``'s
renormalised weights, the experts' through ``grouped_swiglu``'s backward
(K8: the dx-view ``grouped_gmm`` and ``grouped_tgmm``). As in JAX
(mixtral.py:17-19) no aux loss is threaded through ``apply``.

``grouped_kernel`` ("auto" | True | False) picks the expert-FFN backend as
the JAX ``MoEConfig.grouped_kernel`` does; "auto" resolves through the
autotune winner cache per (S k, E, D, F) bucket, the kernels on a miss
(``resolve_grouped_params``). False is the ragged-math parity path. An
engine's ``moe`` block (``model._moe_cfg``) with a non-"auto"
``grouped_kernel`` overrides it, as for GPT2MoE. Under an engine at
``expert_parallel_size`` > 1 (``model._moe_ep``) the experts are this
rank's and ``_mlp`` runs ``moe_swiglu_ragged_ep`` with the block's
``hierarchical_a2a`` and ``dcn_quantize`` knobs.

Under weight quantization the experts stay quantized into K9
(``grouped_swiglu_wq``) on the fused path (``_WQ_KEEP``), the router
``moe_gate`` is never quantized and keeps fp32, and the attention
weights dequantize one layer at a time as in the Llama.
"""

from dataclasses import dataclass

import torch

from ..moe.sharded_moe import (_grouped_swiglu_ffn, moe_swiglu_ragged_ep,
                               resolve_grouped_params,
                               resolve_hierarchical_a2a, route_top_k,
                               sort_by_expert)
from .llama import Llama, LlamaConfig, _rms_norm


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    moe_top_k: int = 2

    def num_params(self):
        base = super().num_params()
        # replace the dense SwiGLU (3 * D * F) with E experts + router
        L, D, Fd, E = self.n_layer, self.d_model, self.ffn_dim, \
            self.num_experts
        return base - L * 3 * D * Fd + L * (D * E + E * 3 * D * Fd)


MIXTRAL_TINY = MixtralConfig(n_layer=2, n_head=4, n_kv_heads=2, d_model=128,
                             max_seq_len=128, vocab_size=512, remat=False,
                             num_experts=4, moe_top_k=2)
MIXTRAL_8X7B = MixtralConfig(n_layer=32, n_head=32, n_kv_heads=8,
                             d_model=4096, d_ff=14336, max_seq_len=8192,
                             vocab_size=32000, num_experts=8, moe_top_k=2)


class Mixtral(Llama):
    """Serving-side Mixtral (see the module docstring). ``device``,
    ``dtype``, ``seed`` and ``quantize`` as for ``Llama``."""

    _WQ_KEEP = ("moe_w1", "moe_w3", "moe_w2")

    def __init__(self, config: MixtralConfig, device=None, dtype=None,
                 seed=0, quantize=None):
        if not config.mlp_gated:
            raise ValueError("Mixtral's experts are SwiGLU: mlp_gated=True")
        if not 1 <= config.moe_top_k <= config.num_experts:
            raise ValueError(f"moe_top_k must be in [1, num_experts], got "
                             f"{config.moe_top_k}")
        knobs = [k for k, on in (
            ("alibi", config.alibi),
            ("norm_type='ln'", config.norm_type != "rms"),
            ("parallel_block", config.parallel_block),
            ("bias knobs", config.qkv_bias or config.o_bias_on
             or config.mlp_bias_on or config.head_bias_on),
            ("embed_norm", config.embed_norm),
            ("rotary_pct<1", config.rotary_pct < 1.0)) if on]
        if knobs:
            # the JAX expert FFN (mixtral.py:132-174) reads rms2 alone and
            # no MLP bias, so no JAX Mixtral configuration sets these
            raise NotImplementedError(
                f"the Mixtral port takes none of the Llama-family knobs "
                f"(got {', '.join(knobs)}): its expert FFN has no LayerNorm "
                f"shift, bias or parallel block")
        super().__init__(config, device=device, dtype=dtype, seed=seed,
                         quantize=quantize)
        self.grouped_kernel = "auto"

    def _init_mlp(self, nrm, res_std):
        cfg = self.config
        L, D, Fd, E = cfg.n_layer, cfg.d_model, cfg.ffn_dim, cfg.num_experts
        return {
            # the router stays fp32, as the JAX init keeps it (an engine
            # that casts the model casts it too, as the JAX engine does)
            "moe_gate": nrm((L, D, E), dtype=torch.float32, key="moe_gate"),
            "moe_w1": nrm((L, E, D, Fd), key="moe_w1"),
            "moe_w3": nrm((L, E, D, Fd), key="moe_w3"),
            "moe_w2": nrm((L, E, Fd, D), res_std, key="moe_w2"),
        }

    def _mlp_specs(self, topology=None):
        """The experts over "expert", their FFN dim over "tensor"; the
        router whole (JAX mixtral.py:97-121). With a ``topology`` whose
        exchange stages (``resolve_hierarchical_a2a`` on the engine's
        ``moe`` knob) the experts span the ``("data_outer", "expert")``
        grid."""
        eaxis = "expert"
        if topology is not None and resolve_hierarchical_a2a(
                self._moe_knob("hierarchical_a2a", "auto"),
                topology.axis_size("data_outer"), self.config.num_experts,
                topology.axis_size("expert")):
            eaxis = ("data_outer", "expert")
        return {"moe_gate": (None, None, None),
                "moe_w1": (None, eaxis, None, "tensor"),
                "moe_w3": (None, eaxis, None, "tensor"),
                "moe_w2": (None, eaxis, "tensor", None)}

    def _serving_topology_(self, topology):
        super()._serving_topology_(topology)
        self._moe_ep = topology.axis_size("expert")

    def _moe_knob(self, name, default):
        moe_cfg = getattr(self, "_moe_cfg", None)
        return default if moe_cfg is None else getattr(moe_cfg, name)

    def _grouped_knob(self):
        knob = self._moe_knob("grouped_kernel", "auto")
        return self.grouped_kernel if knob == "auto" else knob

    def _mlp(self, x, i):
        """Dropless top-k SwiGLU MoE over the flattened tokens
        (``deepspeed_tpu/models/mixtral.py:132-174`` step for step)."""
        cfg = self.config
        D, E, k = x.shape[-1], cfg.num_experts, cfg.moe_top_k
        h = _rms_norm(x, self._w("rms2", i), cfg.rms_eps)
        if getattr(self, "_moe_ep", 1) > 1:     # JAX mixtral.py:137-144
            y = moe_swiglu_ragged_ep(
                h, self._w("moe_gate", i), self._w("moe_w1", i),
                self._w("moe_w3", i), self._w("moe_w2", i), k=k,
                hierarchical=self._moe_knob("hierarchical_a2a", "auto"),
                dcn_quantize=self._moe_knob("dcn_quantize", False),
                grouped_kernel=self._grouped_knob(),
                # serving: every rank holds the same tokens (training
                # splits the batch instead)
                replicated=self._serving_topo is not None)
            return y.to(x.dtype)
        xs = h.reshape(-1, D)
        S = xs.shape[0]
        weights, experts = route_top_k(xs, self._w("moe_gate", i), k)
        order, group_sizes = sort_by_expert(experts, E)
        # token-major repeat: routed row s*k + j is token s
        xr = xs.index_select(0, torch.div(order, k, rounding_mode="floor"))
        # the rank's F (F / tp columns under tensor parallelism)
        params = resolve_grouped_params(
            self._grouped_knob(), S * k, E, D,
            self._w("moe_w1", i).shape[-1], xr.dtype, xr.device)
        # under tensor parallelism the experts' F / tp columns give partial
        # sums of the down products (JAX: GSPMD's psum over "tensor")
        o = self._tp_sum(_grouped_swiglu_ffn(
            xr, self._w("moe_w1", i), self._w("moe_w3", i),
            self._w("moe_w2", i), group_sizes, params))
        unsorted = torch.empty_like(o).index_copy_(0, order, o)
        y = (unsorted * weights.reshape(-1, 1).to(x.dtype)).reshape(
            S, k, D).sum(dim=1)
        return y.to(x.dtype).reshape(x.shape)
