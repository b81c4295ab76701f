"""Dropless MoE: top-k routing and the grouped-GEMM expert FFNs of
``Mixtral._mlp`` and of the GPT2MoE layers.

Counterpart of the dropless part of ``deepspeed_tpu/moe/sharded_moe.py``
(``resolve_grouped_params``, ``_grouped_dot``, ``_grouped_swiglu_ffn``,
``topk_routing``, ``moe_layer_ragged``, ``moe_layer_ragged_ep`` at one
expert shard). Two backends, as there: ``"kernel"`` = the Hopper
grouped-GEMM kernels (ops/cuda/grouped_matmul.py, differentiable through
their own backward kernels) and ``"ragged"`` = the ``lax.ragged_dot`` math
in plain PyTorch (g and u rounded to the activation dtype before silu *
mul), the explicit parity path. The port has no autotune winner cache, so
``"auto"`` resolves to the kernels (as ``paged_kernel="auto"`` does).
Group sizes come from a fixed-size scatter_add, so no forward syncs the
host. The GShard capacity gating (``top1gating``/``top2gating``,
``moe_layer``) and the expert-parallel all_to_all are not ported yet.
"""

import torch
import torch.nn.functional as F

from ..ops.cuda.grouped_matmul import (grouped_matmul,
                                       grouped_matmul_reference,
                                       grouped_swiglu, grouped_swiglu_wq,
                                       grouped_tgmm)
from ..ops.int8_weights import is_quantized

_TODO_INT8 = "int8 expert compute (M11, ROADMAP Queue 1)"
_TODO_EP = "MoE expert parallel (ROADMAP Queue 1, M10)"


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def resolve_grouped_params(knob):
    """Backend resolution for the grouped expert FFN. ``knob``: "auto" or
    True (the kernels) | False or None (ragged math). The JAX version also
    takes the call's shape bucket for its winner cache; the port has no
    cache, so the knob alone decides."""
    if knob is False or knob is None:
        return {"backend": "ragged"}
    if knob is True or knob == "auto":
        return {"backend": "kernel"}
    raise ValueError(f"grouped_kernel must be true|false|'auto', got "
                     f"{knob!r}")


def _grouped_dot(xs, w, group_sizes, params):
    if params.get("backend") == "kernel":
        return grouped_matmul(xs, w, group_sizes)
    return grouped_matmul_reference(xs, w, group_sizes)


class _ExpertBias(torch.autograd.Function):
    """b[experts] for rows sorted by expert. The gradient, an index-add of
    the rows into b, is then a per-group row sum: grouped_tgmm(ones, dy),
    fp32 with one rounding, deterministic, where PyTorch's indexing
    backward serialises on the few distinct experts."""

    @staticmethod
    def forward(ctx, b, experts, group_sizes):
        ctx.save_for_backward(group_sizes)
        return b.index_select(0, experts)

    @staticmethod
    def backward(ctx, dy):
        gs, = ctx.saved_tensors
        ones = dy.new_ones(dy.shape[0], 1)
        return grouped_tgmm(ones, dy, gs)[:, 0], None, None


def _expert_bias(b, experts, group_sizes, params):
    if params.get("backend") == "kernel":
        return _ExpertBias.apply(b, experts, group_sizes)
    return b[experts]


def _grouped_swiglu_ffn(xs, w1, w3, w2, group_sizes, params):
    """``gmm(silu(gmm(xs, w1)) * gmm(xs, w3), w2)`` over rows sorted by
    expert: xs (S, D), w1/w3 (E, D, F), w2 (E, F, D) -> (S, D); rows past
    ``sum(group_sizes)`` are 0. Quantized experts (``Int8Weight`` /
    ``Int4Weight``, the serving engine's ``weight_quant``) go through K9
    (``grouped_swiglu_wq``: codes streamed, scales in the epilogue); with
    the ragged backend they take the JAX fallback math instead: each
    expert dequantized to xs's dtype, then the ragged products."""
    if any(is_quantized(w) for w in (w1, w3, w2)):
        if params.get("backend") == "kernel":
            return grouped_swiglu_wq(xs, w1, w3, w2, group_sizes)
        w1, w3, w2 = (w.dequant(xs.dtype) if is_quantized(w) else w
                      for w in (w1, w3, w2))
    if params.get("int8"):
        raise NotImplementedError(f"{_TODO_INT8} is not ported yet")
    if params.get("backend") == "kernel":
        return grouped_swiglu(xs, w1, w3, w2, group_sizes)
    g = _grouped_dot(xs, w1, group_sizes, params)
    u = _grouped_dot(xs, w3, group_sizes, params)
    return _grouped_dot(F.silu(g) * u, w2, group_sizes, params)


def route_top_k(xs, gate, k):
    """Dropless top-k routing of xs (S, D) by the router ``gate`` (D, E):
    fp32 logits (the router weights as they are, e.g. bf16 after an engine
    cast), softmax, top-k, renormalised weights. Returns (weights (S, k)
    fp32, experts (S, k) int64)."""
    logits = xs.float() @ gate.float()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, k, dim=-1)
    return weights / weights.sum(dim=-1, keepdim=True), experts


def sort_by_expert(experts, E):
    """Token-major (S, k) expert ids -> (order, group_sizes): ``order``
    sorts the S*k routed rows by expert, stably; ``group_sizes`` (E,) int32
    counts them with a fixed-size scatter_add (no bincount, whose output
    size syncs the host on the card)."""
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    sizes = torch.zeros(E, dtype=torch.int32, device=flat.device)
    sizes.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, sizes


def topk_routing(logits, k=1):
    """Capacity-free top-k routing of fp32 logits (S, E): (weights (S, k),
    experts (S, k) int32, the GShard/Switch aux loss
    E * sum(mean router prob per expert * first-choice fraction), counts
    (E,) fp32 of all k dispatches per expert)."""
    S, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, k, dim=-1)
    if k > 1:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    first = F.one_hot(experts[:, 0], E).to(probs.dtype).sum(0)
    l_aux = E * torch.sum(probs.mean(0) * first / S)
    counts = F.one_hot(experts, E).to(probs.dtype).sum((0, 1))
    return weights, experts.to(torch.int32), l_aux, counts


def moe_layer_ragged(tokens, gate_w, wi, bi, wo, bo, k=1, *,
                     activation=gelu, grouped_kernel="auto"):
    """Dropless MoE layer (the megablox pattern): the k routed copies of
    each token sort by expert, each expert multiplies exactly its
    contiguous group (``gmm(xs, wi) + bi``, activation,
    ``gmm(h, wo) + bo``), the outputs unsort and combine by the
    renormalised top-k weights. tokens (..., M); gate_w (M, E); wi (E, M,
    F); bi (E, F); wo (E, F, M); bo (E, M). Returns (y like tokens, l_aux,
    group_sizes (E,) int32)."""
    orig_shape = tokens.shape
    M = orig_shape[-1]
    x = tokens.reshape(-1, M)
    S = x.shape[0]
    E = gate_w.shape[-1]
    logits = x.float() @ gate_w.float()
    weights, experts, l_aux, _ = topk_routing(logits, k)
    flat_exp = experts.reshape(-1).long()
    order, group_sizes = sort_by_expert(flat_exp, E)
    flat_w = weights.reshape(-1).to(tokens.dtype)
    # routed row s*k + j is token s (the JAX jnp.repeat(x, k))
    xs = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    exp_sorted = flat_exp[order]
    gp = resolve_grouped_params(grouped_kernel)
    h = activation(_grouped_dot(xs, wi, group_sizes, gp)
                   + _expert_bias(bi, exp_sorted, group_sizes, gp))
    out = (_grouped_dot(h, wo, group_sizes, gp)
           + _expert_bias(bo, exp_sorted, group_sizes, gp))
    unsorted = torch.zeros_like(out).index_copy(0, order, out)
    y = (unsorted * flat_w[:, None]).reshape(S, k, M).sum(dim=1)
    return y.to(tokens.dtype).reshape(orig_shape), l_aux, group_sizes


def moe_layer_ragged_ep(tokens, gate_w, wi, bi, wo, bo, k=1, *,
                        activation=gelu, expert_parallel_size=1,
                        grouped_kernel="auto"):
    """The expert-parallel dropless layer. At one expert shard (the only
    size the port runs) it is ``moe_layer_ragged``, as in the JAX package;
    more shards need the all_to_all exchange, not ported yet."""
    if expert_parallel_size > 1:
        raise NotImplementedError(
            f"expert_parallel_size={expert_parallel_size}: {_TODO_EP} is "
            f"not ported yet")
    return moe_layer_ragged(tokens, gate_w, wi, bi, wo, bo, k=k,
                            activation=activation,
                            grouped_kernel=grouped_kernel)
