"""Dropless expert FFN for the MoE models (the grouped-GEMM pieces that
``Mixtral._mlp`` calls).

Counterpart of the grouped expert-FFN part of
``deepspeed_tpu/moe/sharded_moe.py`` (``resolve_grouped_params``,
``_grouped_dot``, ``_grouped_swiglu_ffn``). Two backends, as there:
``"kernel"`` = the Hopper grouped-GEMM kernels (ops/cuda/grouped_matmul.py:
the fused gate/up launch, then the grouped down projection) and
``"ragged"`` = the ``lax.ragged_dot`` math in plain PyTorch (three grouped
products, g and u rounded to the activation dtype before silu * mul), the
explicit parity path. The port has no autotune winner cache, so ``"auto"``
resolves to the kernels (as ``paged_kernel="auto"`` does). Gating with
capacity, the expert-parallel all_to_all (``moe_swiglu_ragged_ep``) and
MoE training are not ported yet.
"""

import torch
import torch.nn.functional as F

from ..ops.cuda.grouped_matmul import (grouped_matmul,
                                       grouped_matmul_reference,
                                       grouped_swiglu)

_TODO_WQ = "quantized expert weights (K9 `grouped_swiglu_wq`, ROADMAP Queue 2)"
_TODO_INT8 = "int8 expert compute (M11, ROADMAP Queue 1)"


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


def _is_quantized(w):
    return hasattr(w, "scale") or not w.dtype.is_floating_point


def _grouped_swiglu_ffn(xs, w1, w3, w2, group_sizes, params):
    """``gmm(silu(gmm(xs, w1)) * gmm(xs, w3), w2)`` over rows sorted by
    expert: xs (S, D), w1/w3 (E, D, F), w2 (E, F, D) -> (S, D); rows past
    ``sum(group_sizes)`` are 0."""
    if any(_is_quantized(w) for w in (w1, w3, w2)):
        raise NotImplementedError(f"{_TODO_WQ} is not ported yet")
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
