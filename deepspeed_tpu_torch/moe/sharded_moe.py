"""Dropless MoE: top-k routing and the grouped-GEMM expert FFNs of
``Mixtral._mlp`` and of the GPT2MoE layers.

Counterpart of the dropless part of ``deepspeed_tpu/moe/sharded_moe.py``
(``resolve_grouped_params``, ``_grouped_dot``, ``_grouped_swiglu_ffn``,
``topk_routing``, ``moe_layer_ragged``, ``resolve_hierarchical_a2a``,
``moe_layer_ragged_ep``, ``moe_swiglu_ragged_ep``). Two backends, as
there: ``"kernel"`` = the Hopper grouped-GEMM kernels
(ops/cuda/grouped_matmul.py, differentiable through their own backward
kernels) and ``"ragged"`` = the ``lax.ragged_dot`` math
in plain PyTorch (g and u rounded to the activation dtype before silu *
mul), the explicit parity path. ``"auto"`` resolves through the autotune
winner cache (op ``moe_grouped_mm``, JAX's bucket of (rows, E_loc, M, F))
to the kernels: K8 takes no lever, so the op's one candidate on a card is
the kernel backend, the port's cold "auto" (JAX's cold "auto" is
ragged_dot), and a card entry naming the ragged math is refused.
Group sizes come from a fixed-size scatter_add, so no forward syncs the
host. Under data parallelism the aux loss is taken over the global batch,
as the JAX loss over a batch sharded on the data axes takes it
(``topk_routing``'s ``dp_axes``).

The GShard capacity backend (``_capacity``, ``_gumbel``, ``top1gating``,
``top2gating``, ``TopKGate``, ``moe_layer``; JAX sharded_moe.py:124-362):
top-1 (Switch, with RSample or Jitter noise) and top-2 (the second queue
after every first choice, optional gumbel second-expert sampling) gating
over a static per-expert capacity C, the tokens past C dropped (their MoE
output 0). JAX materialises (S, E, C) ``combine`` / ``dispatch`` tensors
and contracts them in einsums; a capacity slot holds at most one token,
so the port scatters each dispatched token into its (expert, slot) row of
an (E, C', M) buffer, runs the expert FFN there as batched products, and
gathers each token's rows weighted by its kept gates: the same values
without the (S, E, C) tensors (84 M elements a layer at 8 x 1024 tokens,
E 8, cf 1.25). The gates return that compact routing (``Gating``). Under
data parallelism the gate is the global batch's, as the JAX gate over
GSPMD's global (S, E) logits: C from the global token count, each token's
queue position counted over the whole batch rank-major (the lower ranks'
per-expert counts from one all_gather over ``dp_axes``), the second queue
after every rank's first choices, the aux loss's means global, the noise
this rank's rows of the global draw; the buffer holds only this rank's
tokens (C' = min(C, S), each rank's slots of an expert renumbered from 0),
so only they take expert compute.

Expert parallelism (``*_ragged_ep``): each rank holds ``E / ep`` experts
and routes its own tokens over all ``E``. Where the JAX ``shard_map``
splits one global token dim over the shards, each rank here sees only
its local tokens; routing is per token, so a token's result does not
depend on the rank that carries it. The routed rows pack by destination
shard into a ``(ep[, wo], cap, M)`` transport (``cap`` = k times the most
tokens any rank of the exchange holds, agreed by one collective); empty
slots carry expert id ``E_loc``, sort last, stay outside every group and
are masked. The exchange is ``comm.exchange`` (the untiled all_to_all,
differentiable), the grouped FFN runs on the received rows sorted by
local expert (K8 on the card), the outputs go back the same way, unsort
and combine. The staged exchange (``hierarchical``) goes over ``expert``
then ``data_outer``, experts over the ``(data_outer, expert)`` grid, with
``dcn_quantize`` the K12 int8 round trip on the token payload of the
``data_outer`` legs only, straight-through in the backward (the JAX
clamp defines no gradient of its own).
"""

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..comm import comm
from ..comm.quantized import dcn_precision_clamp
from ..ops.cuda.grouped_matmul import (grouped_matmul,
                                       grouped_matmul_reference,
                                       grouped_swiglu, grouped_swiglu_wq,
                                       grouped_tgmm)
from ..ops.int8_weights import is_quantized
from ..utils import groups, prng

_TODO_INT8 = "int8 expert compute (M11, ROADMAP Queue 1)"


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# the 'moe_grouped_mm' autotune op's cold-cache lever: the kernels
TUNE_DEFAULTS = {"backend": "kernel"}


def resolve_grouped_params(knob, rows, E_loc, M, F, dtype, device=None):
    """Backend resolution for the grouped expert FFN of ``rows`` routed
    rows over ``E_loc`` local experts of widths (M, F). ``knob``: "auto"
    (the winner cache for this bucket; the kernels on a miss) | True (the
    kernels) | False or None (ragged math)."""
    if knob is False or knob is None:
        return {"backend": "ragged"}
    if knob is True:
        return dict(TUNE_DEFAULTS)
    if knob != "auto":
        raise ValueError(f"grouped_kernel must be true|false|'auto', got "
                         f"{knob!r}")
    from ..ops.cuda._common import dispatch, dtype_name, moe_grouped_bucket
    return dispatch("moe_grouped_mm", moe_grouped_bucket(rows, E_loc, M, F),
                    dtype_name(dtype), TUNE_DEFAULTS, device=device)


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


class _SumOverRanks(torch.autograd.Function):
    """A sum over the ranks of ``axes`` whose backward sums the cotangent
    over them too: every rank's loss reads the global sum, and the engine
    averages the ranks' gradients, so each rank's share of the global
    term's gradient must come back whole (an identity backward leaves it
    ``dp`` times too small)."""

    @staticmethod
    def forward(ctx, x, axes):
        ctx.axes = axes
        return comm.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce(g.contiguous(), ctx.axes), None


def topk_routing(logits, k=1, dp_axes=None):
    """Capacity-free top-k routing of fp32 logits (S, E): (weights (S, k),
    experts (S, k) int32, the GShard/Switch aux loss
    E * sum(mean router prob per expert * first-choice fraction), counts
    (E,) fp32 of all k dispatches per expert). With ``dp_axes`` (the
    data-parallel axes each rank's S tokens split the global batch over)
    the aux loss is the global batch's: the per-expert prob sums, the
    first-choice counts and S are summed over those ranks in one
    collective, differentiable in the prob sums (``_SumOverRanks``)."""
    S, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    weights, experts = torch.topk(probs, k, dim=-1)
    if k > 1:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    first = F.one_hot(experts[:, 0], E).to(probs.dtype).sum(0)
    if dp_axes:
        tot = _SumOverRanks.apply(torch.cat(
            [probs.sum(0), first, probs.new_full((1,), S)]), dp_axes)
        n = tot[2 * E].detach()
        l_aux = E * torch.sum(tot[:E] / n * tot[E:2 * E].detach() / n)
    else:
        l_aux = E * torch.sum(probs.mean(0) * first / S)
    counts = F.one_hot(experts, E).to(probs.dtype).sum((0, 1))
    return weights, experts.to(torch.int32), l_aux, counts


def moe_layer_ragged(tokens, gate_w, wi, bi, wo, bo, k=1, *,
                     activation=gelu, grouped_kernel="auto", dp_axes=None):
    """Dropless MoE layer (the megablox pattern): the k routed copies of
    each token sort by expert, each expert multiplies exactly its
    contiguous group (``gmm(xs, wi) + bi``, activation,
    ``gmm(h, wo) + bo``), the outputs unsort and combine by the
    renormalised top-k weights. tokens (..., M); gate_w (M, E); wi (E, M,
    F); bi (E, F); wo (E, F, M); bo (E, M); ``dp_axes`` as for
    ``topk_routing``. Returns (y like tokens, l_aux, group_sizes (E,)
    int32)."""
    orig_shape = tokens.shape
    M = orig_shape[-1]
    x = tokens.reshape(-1, M)
    S = x.shape[0]
    E = gate_w.shape[-1]
    logits = x.float() @ gate_w.float()
    weights, experts, l_aux, _ = topk_routing(logits, k, dp_axes)
    flat_exp = experts.reshape(-1).long()
    order, group_sizes = sort_by_expert(flat_exp, E)
    flat_w = weights.reshape(-1).to(tokens.dtype)
    # routed row s*k + j is token s (the JAX jnp.repeat(x, k))
    xs = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    exp_sorted = flat_exp[order]
    gp = resolve_grouped_params(grouped_kernel, S * k, E, M, wi.shape[-1],
                                xs.dtype, xs.device)
    h = activation(_grouped_dot(xs, wi, group_sizes, gp)
                   + _expert_bias(bi, exp_sorted, group_sizes, gp))
    out = (_grouped_dot(h, wo, group_sizes, gp)
           + _expert_bias(bo, exp_sorted, group_sizes, gp))
    unsorted = torch.zeros_like(out).index_copy(0, order, out)
    y = (unsorted * flat_w[:, None]).reshape(S, k, M).sum(dim=1)
    return y.to(tokens.dtype).reshape(orig_shape), l_aux, group_sizes


# --------------------------------------------- GShard capacity backend

def _capacity(num_tokens, num_experts, capacity_factor, min_capacity):
    """Static per-expert capacity (JAX sharded_moe.py:124)."""
    cap = int(math.ceil(num_tokens / num_experts * capacity_factor))
    return max(cap, int(min_capacity))


def _gumbel(rng, shape, offset=0, device=None):
    """Gumbel noise from the threefry key words ``rng``, bitwise the
    uniform draw of JAX's ``_gumbel`` (sharded_moe.py:130); ``offset``: the
    flat index of this draw's first element in the global one."""
    u = prng.uniform(rng, shape, 1e-20, 1.0 - 1e-20, offset, device)
    return -torch.log(-torch.log(u))


class Gating(NamedTuple):
    """The compact routing of S tokens over k choices: ``experts`` (S, k)
    int64; ``locations`` (S, k) int64, each choice's position in its
    expert's global queue, 0 where dropped (JAX's ``loc_s``); ``slots``
    (S, k) int64, its row in this rank's buffer (``locations`` at one
    rank); ``weights`` (S, k) fp32, the combine weights, 0 where dropped
    (a choice is dispatched where its weight is > 0, JAX's ``combine >
    0``); ``capacity`` C; ``l_aux``; ``exp_counts`` (E,) fp32, every
    choice before the drop, over the global batch."""
    experts: torch.Tensor
    locations: torch.Tensor
    slots: torch.Tensor
    weights: torch.Tensor
    capacity: int
    l_aux: torch.Tensor
    exp_counts: torch.Tensor


def _ranks(dp_axes):
    """(ranks, this rank's index) over the data-parallel axes."""
    if not dp_axes:
        return 1, 0
    topo = groups.get_topology()
    return topo.axis_size(dp_axes), topo.axis_index(dp_axes)


def _lower_and_total(counts, dp_axes):
    """Per-expert counts (n, E) of this rank -> (the lower ranks' sum, every
    rank's sum), one all_gather over ``dp_axes``."""
    if not dp_axes:
        return torch.zeros_like(counts), counts
    allc = comm.all_gather(counts[None], dp_axes, gather_dimension=0)
    r = groups.get_topology().axis_index(dp_axes)
    return allc[:r].sum(0), allc.sum(0)


def _queue(mask, idx):
    """Each token's exclusive position among the tokens before it that
    chose the same expert: (cumsum(mask) - mask) at the chosen column."""
    return (torch.cumsum(mask, 0) - mask).gather(1, idx[:, None])[:, 0]


def _aux(gates, first, S_global, dp_axes):
    """E * sum(mean gates * first-choice fraction) over the global batch
    (JAX ``l_aux``) from the global first-choice counts ``first`` (E,);
    the gate sum differentiable across ranks."""
    me = gates.sum(0)
    if dp_axes:
        me = _SumOverRanks.apply(me, dp_axes)
    return torch.sum(me / S_global * (first.float() / S_global)) * \
        gates.shape[1]


def top1gating(logits, capacity_factor=1.0, min_capacity=4,
               noisy_gate_policy=None, rng=None, drop_tokens=True,
               dp_axes=None):
    """Switch-style top-1 gating of fp32 logits (S, E) (JAX
    sharded_moe.py:135): RSample adds gumbel noise and Jitter scales by
    U(0.99, 1.01) before the argmax (the gates stay the clean softmax);
    ``drop_tokens=False`` sets C to the global token count. Returns a
    ``Gating``."""
    S, E = logits.shape
    R, r = _ranks(dp_axes)
    C = _capacity(S * R, E, capacity_factor, min_capacity)
    if not drop_tokens:
        C = S * R
    gates = torch.softmax(logits, dim=-1)
    select = logits
    if noisy_gate_policy in ("RSample", "Jitter"):
        if rng is None:
            raise ValueError(f"{noisy_gate_policy} noisy gating needs an "
                             f"rng")
        if noisy_gate_policy == "RSample":
            select = logits + _gumbel(rng, (S, E), r * S * E, logits.device)
        else:
            select = logits * prng.uniform(rng, (S, E), 0.99, 1.01,
                                           r * S * E, logits.device)
    idx1 = torch.argmax(select, dim=-1)
    mask1 = F.one_hot(idx1, E)
    lower, total = _lower_and_total(mask1.sum(0), dp_axes)
    l_aux = _aux(gates, total, S * R, dp_axes)
    local = _queue(mask1, idx1)
    pos = local + lower[idx1]
    kept = pos < C
    w = gates.gather(1, idx1[:, None])[:, 0] * kept
    zero = torch.zeros_like(pos)
    return Gating(idx1[:, None], torch.where(kept, pos, zero)[:, None],
                  torch.where(kept, local, zero)[:, None], w[:, None], C,
                  l_aux, total.float())


def top2gating(logits, capacity_factor=1.0, min_capacity=4, rng=None,
               drop_tokens=True, top2_2nd_expert_sampling=True,
               dp_axes=None):
    """GShard top-2 gating of fp32 logits (S, E) (JAX sharded_moe.py:181):
    capacity for 2 * capacity_factor; the second expert the argmax of the
    logits (plus gumbel noise when sampling) with the first masked; its
    queue starts after every first choice; the kept pair's gates
    renormalised. Returns a ``Gating``."""
    S, E = logits.shape
    R, r = _ranks(dp_axes)
    C = _capacity(S * R, E, 2 * capacity_factor, min_capacity)
    if not drop_tokens:
        C = S * R
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = F.one_hot(idx1, E)
    logits2 = logits
    if top2_2nd_expert_sampling:
        if rng is None:
            raise ValueError("top2 2nd-expert sampling needs an rng")
        logits2 = logits + _gumbel(rng, (S, E), r * S * E, logits.device)
    logits2 = logits2.masked_fill(mask1 > 0, float("-inf"))
    idx2 = torch.argmax(logits2, dim=-1)
    mask2 = F.one_hot(idx2, E)
    n_local = torch.stack([mask1.sum(0), mask2.sum(0)])
    lower, total = _lower_and_total(n_local, dp_axes)
    l_aux = _aux(gates, total[0], S * R, dp_axes)
    q1, q2 = _queue(mask1, idx1), _queue(mask2, idx2)
    pos1 = q1 + lower[0][idx1]
    pos2 = q2 + lower[1][idx2] + total[0][idx2]
    kept1, kept2 = pos1 < C, pos2 < C
    g1 = gates.gather(1, idx1[:, None])[:, 0] * kept1
    g2 = gates.gather(1, idx2[:, None])[:, 0] * kept2
    denom = torch.clamp(g1 + g2, min=1e-9)
    zero = torch.zeros_like(pos1)
    # this rank's buffer rows of an expert: its first choices, then its
    # second choices
    slot2 = n_local[0][idx2] + q2
    return Gating(
        torch.stack([idx1, idx2], 1),
        torch.stack([torch.where(kept1, pos1, zero),
                     torch.where(kept2, pos2, zero)], 1),
        torch.stack([torch.where(kept1, q1, zero),
                     torch.where(kept2, slot2, zero)], 1),
        torch.stack([g1 / denom, g2 / denom], 1), C, l_aux,
        (total[0] + total[1]).float())


class TopKGate:
    """Gate config + apply (JAX sharded_moe.py:230 ``TopKGate``): the
    training capacity factor when ``train``, else the eval one; no noise
    and no second-expert sampling in eval."""

    def __init__(self, k=1, capacity_factor=1.0, eval_capacity_factor=1.0,
                 min_capacity=4, noisy_gate_policy=None, drop_tokens=True,
                 top2_2nd_expert_sampling=True):
        if k not in (1, 2):
            raise ValueError("only top-1 and top-2 gating supported")
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.top2_2nd_expert_sampling = top2_2nd_expert_sampling

    def __call__(self, logits, rng=None, train=True, dp_axes=None):
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1gating(
                logits, cf, self.min_capacity,
                self.noisy_gate_policy if train else None, rng,
                self.drop_tokens, dp_axes)
        return top2gating(
            logits, cf, self.min_capacity, rng, self.drop_tokens,
            self.top2_2nd_expert_sampling and train and rng is not None,
            dp_axes)


def moe_layer(tokens, gate_w, wi, bi, wo, bo, gate, *, rng=None,
              train=True, activation=gelu, dp_axes=None):
    """The GShard capacity MoE layer (JAX sharded_moe.py:325): fp32 router
    logits, ``gate``'s routing, each dispatched token copied into its
    (expert, slot) row of an (E, C', M) buffer (C' = min(C, S) rows an
    expert hold this rank's tokens), the expert FFN ``act(buf @ wi + bi)
    @ wo + bo`` as batched products, and each token's output the sum of
    its rows times its kept gates (fp32 products and sum), 0 for a token
    every choice of which was dropped. tokens (..., M); gate_w (M, E);
    wi (E, M, F); bi (E, F); wo (E, F, M); bo (E, M). Returns (y like
    tokens, l_aux, exp_counts (E,) fp32)."""
    orig_shape = tokens.shape
    M = orig_shape[-1]
    x = tokens.reshape(-1, M)
    S = x.shape[0]
    E = gate_w.shape[-1]
    g = gate(x.float() @ gate_w.float(), rng=rng, train=train,
             dp_axes=dp_axes)
    k = g.experts.shape[1]
    rows = min(g.capacity, S)
    flat = g.experts * rows + g.slots                          # (S, k)
    sent = g.weights > 0
    # undispatched choices go to a spare last row, dropped after the copy
    dest = torch.where(sent, flat, E * rows).reshape(-1)
    src = x.repeat_interleave(k, dim=0) if k > 1 else x
    buf = x.new_zeros(E * rows + 1, M).index_copy(0, dest, src)
    buf = buf[:-1].view(E, rows, M)
    h = activation(torch.bmm(buf, wi) + bi[:, None])
    out = (torch.bmm(h, wo) + bo[:, None]).reshape(E * rows, M)
    picked = out.index_select(0, torch.where(sent, flat, 0).reshape(-1))
    w = g.weights.to(tokens.dtype).float()
    y = (w[..., None] * picked.view(S, k, M).float()).sum(1)
    return y.to(tokens.dtype).reshape(orig_shape), g.l_aux, g.exp_counts


def resolve_hierarchical_a2a(knob, outer_size, E, ep):
    """Whether the expert-parallel exchange stages ``expert`` ->
    ``data_outer``: "auto" iff ``data_outer`` > 1 and the experts divide
    the ``(data_outer, expert)`` grid (the JAX cold-cache default: its
    ``a2a_staging`` collective op is not ported, ROADMAP Queue 1, M5 /
    M14); True requires the division (a loud error
    instead of a silent flat exchange); False never stages."""
    if knob is False or knob is None or outer_size <= 1:
        return False
    if E % (ep * outer_size) != 0:
        if knob is True:
            raise ValueError(
                f"hierarchical EP needs experts ({E}) divisible by "
                f"expert*outer shards ({ep}*{outer_size})")
        return False
    if knob not in (True, "auto"):
        raise ValueError(f"hierarchical must be true|false|'auto', got "
                         f"{knob!r}")
    return True


def resolve_dcn_quantize(knob):
    """``dcn_quantize``: True | False | "auto" (= False, the JAX choice on
    a cold winner cache: quantization changes numerics; its collective
    autotune op is not ported, ROADMAP Queue 1, M5 / M14)."""
    if knob not in (True, False, "auto"):
        raise ValueError(f"dcn_quantize must be true|false|'auto', got "
                         f"{knob!r}")
    return knob is True


class _DcnClamp(torch.autograd.Function):
    """The int8 block round trip of a DCN leg's token payload (K12 on the
    card), straight-through in the backward. The JAX clamp defines no
    gradient, so ``jax.grad`` differentiates the round trip's arithmetic
    and passes a gradient only through each block's absmax: this backward
    departs from it on purpose, passing the gradient an exact exchange
    would (ROADMAP.md, open divergences)."""

    @staticmethod
    def forward(ctx, x):
        return dcn_precision_clamp(x)

    @staticmethod
    def backward(ctx, g):
        return g


def _expert_axes(hier):
    return ("data_outer", "expert") if hier else ("expert",)


def _ep_exchange(x, flat_exp, k, E_loc, hier, dcn_quantize, ffn,
                 valid=None):
    """Route the ``S * k`` rows of ``x`` (S, M) (routed row ``s * k + j``
    is token s, its expert ``flat_exp[s * k + j]`` of all ``E``) to the
    ranks that hold their experts, run ``ffn(xs, es, group_sizes)`` there
    on the received rows sorted by local expert (ids ``es``; rows past
    ``sum(group_sizes)`` carry ``E_loc``) and bring its rows back: returns
    the (S * k, M) outputs in routed-row order and this rank's local
    group sizes (E_loc,) int32. ``valid`` (S,) bool: a padding token's
    rows travel with the invalid id ``E_loc``, outside every group."""
    topo = groups.get_topology()
    ep = topo.axis_size("expert")
    wo = topo.axis_size("data_outer") if hier else 1
    S, M = x.shape
    # the transport's rows: every rank of the exchange agrees on them
    s_cap = comm.all_reduce(torch.tensor([S], dtype=torch.float32,
                                         device=x.device),
                            _expert_axes(hier), op="max")
    cap = int(s_cap.item()) * k
    dest = torch.div(flat_exp, E_loc, rounding_mode="floor")
    local_e = flat_exp - dest * E_loc
    if valid is not None:
        local_e = torch.where(valid.repeat_interleave(k), local_e, E_loc)
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    pos = torch.arange(S * k, device=x.device) - torch.searchsorted(
        dest_s, dest_s, side="left")
    if hier:      # buckets keyed (inner rank, outer slice)
        slot = ((dest_s % ep) * wo + torch.div(
            dest_s, ep, rounding_mode="floor")) * cap + pos
        shape = (ep, wo, cap)
    else:
        slot = dest_s * cap + pos
        shape = (ep, cap)
    rows = x.index_select(0, torch.div(order, k, rounding_mode="floor"))
    send_x = x.new_zeros(ep * wo * cap, M).index_copy(0, slot, rows)
    send_e = torch.full((ep * wo * cap,), E_loc, dtype=torch.int32,
                        device=x.device).index_copy(
        0, slot, local_e[order].to(torch.int32))
    recv_x = comm.exchange(send_x.view(*shape, M), "expert", 0)
    recv_e = comm.exchange(send_e.view(shape), "expert", 0)
    if hier:
        if dcn_quantize:
            recv_x = _DcnClamp.apply(recv_x)
        recv_x = comm.exchange(recv_x, "data_outer", 1)
        recv_e = comm.exchange(recv_e, "data_outer", 1)
    rx = recv_x.reshape(-1, M)
    re = recv_e.reshape(-1).long()
    g_order = torch.sort(re, stable=True).indices
    xs = rx.index_select(0, g_order)
    es = re[g_order]
    sizes = torch.zeros(E_loc + 1, dtype=torch.int32, device=x.device)
    sizes.scatter_add_(0, re, torch.ones_like(re, dtype=torch.int32))
    group_sizes = sizes[:E_loc]
    out = ffn(xs, es, group_sizes)
    out = torch.where((es < E_loc)[:, None], out, torch.zeros_like(out))
    back = torch.zeros_like(out).index_copy(0, g_order, out).view(
        *shape, M)
    if hier:
        if dcn_quantize:
            back = _DcnClamp.apply(back)
        back = comm.exchange(back, "data_outer", 1)
    ret = comm.exchange(back, "expert", 0).reshape(-1, M)
    ret = ret.index_select(0, slot)
    unsorted = torch.zeros_like(ret).index_copy(0, order, ret)
    return unsorted, group_sizes


def moe_swiglu_ragged_ep(tokens, gate_w, w1, w3, w2, k=2, *,
                         hierarchical="auto", dcn_quantize=False,
                         grouped_kernel="auto", return_counts=False,
                         replicated=False):
    """Expert-parallel dropless SwiGLU MoE (Mixtral's experts; the JAX
    ``moe_swiglu_ragged_ep``): softmax, top-k, renormalised weights; the
    routed rows exchanged (``_ep_exchange``) to the rank of their expert,
    ``gmm(silu(gmm(xs, w1)) * gmm(xs, w3), w2)`` over the local experts
    (K8's ``grouped_swiglu`` / ``grouped_gmm`` on the card), exchanged
    back and combined. tokens (..., M) this rank's; w1 / w3 (E_loc, M, F),
    w2 (E_loc, F, M) this rank's experts, ``E_loc = E / (ep * wo)`` with
    ``wo`` the ``data_outer`` size when the exchange stages
    (``resolve_hierarchical_a2a``), else 1. Returns y like tokens (and the
    global per-expert counts (E,) int32 with ``return_counts``).

    ``replicated``: every rank holds the same tokens (serving), and the
    JAX function's split applies (sharded_moe.py:436-444, :589-591): the
    flattened tokens padded to a multiple of the expert shards, this
    rank's ``S / shards`` rows exchanged (a padding row's gate weight is
    zero and its rows carry the invalid expert id) and the rows brought
    back whole with ``all_gather``. Under a ``tensor`` axis > 1 the
    experts hold F / tp columns and the down products' partial sums are
    summed over ``tensor`` (the row-parallel reduction)."""
    topo = groups.get_topology()
    ep = topo.axis_size("expert")
    if ep == 1:
        raise ValueError("moe_swiglu_ragged_ep needs an expert axis > 1; "
                         "use the dense ragged path otherwise")
    E = gate_w.shape[-1]
    wo = topo.axis_size("data_outer")
    hier = resolve_hierarchical_a2a(hierarchical, wo, E, ep)
    ep_total = ep * wo if hier else ep
    if E % ep_total:
        raise ValueError(f"experts {E} not divisible by expert shards "
                         f"{ep_total}")
    E_loc = E // ep_total
    if w1.shape[0] != E_loc:
        raise ValueError(f"this rank holds {w1.shape[0]} experts, the "
                         f"exchange expects {E_loc}")
    orig_shape = tokens.shape
    M = orig_shape[-1]
    x = tokens.reshape(-1, M)
    S = x.shape[0]
    valid = None
    if replicated:
        shard = topo.axis_index(_expert_axes(hier))
        x = F.pad(x, (0, 0, 0, (-S) % ep_total))
        S_loc = x.shape[0] // ep_total
        x = x[shard * S_loc:(shard + 1) * S_loc]
        valid = shard * S_loc + torch.arange(S_loc, device=x.device) < S
    weights, experts = route_top_k(x, gate_w, k)
    if valid is not None:
        weights = torch.where(valid[:, None], weights, 0.0)
    tp = topo.axis_size("tensor")

    def ffn(xs, es, group_sizes):
        gp = resolve_grouped_params(grouped_kernel, xs.shape[0], E_loc, M,
                                    w1.shape[-1], x.dtype, x.device)
        out = _grouped_swiglu_ffn(xs, w1, w3, w2, group_sizes, gp)
        return out if tp == 1 else comm.all_reduce(out, "tensor")

    out, group_sizes = _ep_exchange(
        x, experts.reshape(-1), k, E_loc, hier,
        hier and resolve_dcn_quantize(dcn_quantize), ffn, valid)
    y = (out * weights.reshape(-1, 1).to(x.dtype)).reshape(
        -1, k, M).sum(dim=1)
    if replicated:
        y = comm.all_gather(y, _expert_axes(hier), 0)[:S]
    y = y.to(tokens.dtype).reshape(orig_shape)
    if not return_counts:
        return y
    shard = topo.axis_index(_expert_axes(hier))
    counts = torch.zeros(E, dtype=torch.int32, device=x.device)
    counts[shard * E_loc:(shard + 1) * E_loc] = group_sizes
    return y, comm.all_reduce(counts, _expert_axes(hier))


def moe_layer_ragged_ep(tokens, gate_w, wi, bi, wo, bo, k=1, *,
                        activation=gelu, expert_parallel_size=1,
                        grouped_kernel="auto", dp_axes=None):
    """The expert-parallel dropless layer (the JAX ``moe_layer_ragged_ep``,
    flat exchange over ``expert``). At one expert shard it is
    ``moe_layer_ragged``, as in the JAX package. Otherwise wi / bi / wo /
    bo hold this rank's ``E / ep`` experts, the router all ``E``; the aux
    loss sums its raw statistics over ``dp_axes`` (the token axes, which
    include ``expert``) before forming the loss, as the JAX function sums
    them over its token axes; the returned counts (E,) are the global
    dispatches (fp32 summed over ``dp_axes``, as int32). Returns (y like
    tokens, l_aux, counts)."""
    if expert_parallel_size == 1:
        return moe_layer_ragged(tokens, gate_w, wi, bi, wo, bo, k=k,
                                activation=activation,
                                grouped_kernel=grouped_kernel,
                                dp_axes=dp_axes)
    ep = groups.get_topology().axis_size("expert")
    if ep != expert_parallel_size:
        raise ValueError(f"expert_parallel_size={expert_parallel_size} but "
                         f"the topology's expert axis has {ep} ranks")
    E = gate_w.shape[-1]
    if E % ep:
        raise ValueError(f"experts {E} not divisible by expert axis {ep}")
    E_loc = E // ep
    if wi.shape[0] != E_loc:
        raise ValueError(f"this rank holds {wi.shape[0]} experts, the "
                         f"exchange expects {E_loc}")
    orig_shape = tokens.shape
    M = orig_shape[-1]
    x = tokens.reshape(-1, M)
    weights, experts, l_aux, counts = topk_routing(x.float() @ gate_w.float(),
                                                   k, dp_axes)
    if dp_axes:
        counts = comm.all_reduce(counts, dp_axes)

    def ffn(xs, es, group_sizes):
        gp = resolve_grouped_params(grouped_kernel, xs.shape[0], E_loc, M,
                                    wi.shape[-1], xs.dtype, xs.device)
        safe_e = torch.clamp(es, max=E_loc - 1)
        h = activation(_grouped_dot(xs, wi, group_sizes, gp)
                       + _expert_bias(bi, safe_e, group_sizes, gp))
        return (_grouped_dot(h, wo, group_sizes, gp)
                + _expert_bias(bo, safe_e, group_sizes, gp))

    out, _ = _ep_exchange(x, experts.reshape(-1).long(), k, E_loc, False,
                          False, ffn)
    flat_w = weights.reshape(-1).to(tokens.dtype)
    y = (out * flat_w[:, None]).reshape(-1, k, M).sum(dim=1)
    return (y.to(tokens.dtype).reshape(orig_shape), l_aux,
            counts.to(torch.int32))
