"""Mixtral-class model for v2 paged serving: the port's Llama attention
(GQA + RoPE, the paged kernels) with a dropless top-k SwiGLU MoE FFN per
block.

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

``grouped_kernel`` ("auto" | True | False) picks the expert-FFN backend as
the JAX ``MoEConfig.grouped_kernel`` does; "auto" means the kernels (the
port has no winner cache). False is the ragged-math parity path.

Under weight quantization the experts stay quantized into K9
(``grouped_swiglu_wq``) on the fused path (``_WQ_KEEP``), the router
``moe_gate`` is never quantized and keeps fp32, and the attention
weights dequantize one layer at a time as in the Llama.
"""

from dataclasses import dataclass

import torch

from ..moe.sharded_moe import (_grouped_swiglu_ffn, resolve_grouped_params,
                               route_top_k, sort_by_expert)
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

    def _mlp(self, x, i):
        """Dropless top-k SwiGLU MoE over the flattened tokens
        (``deepspeed_tpu/models/mixtral.py:132-174`` step for step)."""
        cfg = self.config
        D, E, k = x.shape[-1], cfg.num_experts, cfg.moe_top_k
        h = _rms_norm(x, self._w("rms2", i), cfg.rms_eps)
        xs = h.reshape(-1, D)
        S = xs.shape[0]
        weights, experts = route_top_k(xs, self._w("moe_gate", i), k)
        order, group_sizes = sort_by_expert(experts, E)
        # token-major repeat: routed row s*k + j is token s
        xr = xs.index_select(0, torch.div(order, k, rounding_mode="floor"))
        params = resolve_grouped_params(self.grouped_kernel)
        o = _grouped_swiglu_ffn(xr, self._w("moe_w1", i),
                                self._w("moe_w3", i), self._w("moe_w2", i),
                                group_sizes, params)
        unsorted = torch.empty_like(o).index_copy_(0, order, o)
        y = (unsorted * weights.reshape(-1, 1).to(x.dtype)).reshape(
            S, k, D).sum(dim=1)
        return y.to(x.dtype).reshape(x.shape)
