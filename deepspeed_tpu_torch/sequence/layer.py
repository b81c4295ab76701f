"""Ulysses sequence parallelism: head-scatter / seq-gather all-to-all.

Counterpart of ``deepspeed_tpu/sequence/layer.py`` (``single_all_to_all``
:30, ``DistributedAttention`` :38, ``ulysses_attention`` :76) and of the
reference's ``deepspeed/sequence/layer.py``: q/k/v arrive
sequence-sharded, an all-to-all over the ``seq`` process group trades the
head dim for the full sequence, any local attention runs, and the reverse
all-to-all restores sequence sharding. The all-to-all is a
``torch.autograd.Function`` whose backward is the reverse all-to-all (the
reference's ``_SeqAllToAll``).
"""

import math

import torch

from .. import comm
from ..utils import groups


class _SeqAllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scatter_idx, gather_idx, axis_name):
        ctx.args = (scatter_idx, gather_idx, axis_name)
        return comm.all_to_all(x, axis_name, scatter_idx, gather_idx)

    @staticmethod
    def backward(ctx, g):
        scatter_idx, gather_idx, axis_name = ctx.args
        return (comm.all_to_all(g, axis_name, gather_idx, scatter_idx),
                None, None, None)


def single_all_to_all(x, scatter_idx, gather_idx, axis_name):
    """All-to-all over the group of ``axis_name``: split ``scatter_idx``
    across the ranks, concatenate along ``gather_idx`` (tiled, as the
    reference's reshape + all_to_all_single layout)."""
    return _SeqAllToAll.apply(x, scatter_idx, gather_idx, axis_name)


class DistributedAttention:
    """Wrap a local attention fn for Ulysses SP (reference layer.py:60).

    ``local_attn(q, k, v, *args, **kwargs)`` operates on (B, T, H/P, D)
    full-sequence, head-sharded blocks; __call__ receives (B, T/P, H, D)
    sequence-sharded blocks on every rank of ``axis_name``."""

    def __init__(self, local_attn, axis_name="seq", scatter_idx=2,
                 gather_idx=1):
        self.local_attn = local_attn
        self.axis_name = axis_name
        self.scatter_idx = scatter_idx
        self.gather_idx = gather_idx

    def __call__(self, query, key, value, *args, **kwargs):
        s, g = self.scatter_idx, self.gather_idx
        q = single_all_to_all(query, s, g, self.axis_name)
        k = single_all_to_all(key, s, g, self.axis_name)
        v = single_all_to_all(value, s, g, self.axis_name)
        out = self.local_attn(q, k, v, *args, **kwargs)
        # reverse: scatter seq back, gather heads
        return single_all_to_all(out, g, s, self.axis_name)


def _dense_causal_attention(q, k, v):
    """Reference local attention: causal softmax(QK^T/sqrt(d))V, fp32
    scores. q/k/v: (B, T, H, D)."""
    T = q.shape[1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(causal[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def shard_sequence(x, axis_name="seq", dim=1):
    """This rank's contiguous block of the global ``dim`` (the JAX
    sharding of the sequence dim over ``axis_name``)."""
    topo = groups.get_topology()
    R, r = topo.axis_size(axis_name), topo.axis_index(axis_name)
    n = x.shape[dim] // R
    return x.narrow(dim, r * n, n)


class _GatherSequence(torch.autograd.Function):
    """The ranks' blocks concatenated along ``dim`` on every rank; the
    gradient of a rank's block is its slice of the (replicated)
    cotangent."""

    @staticmethod
    def forward(ctx, x, axis_name, dim):
        ctx.args = (axis_name, dim)
        return comm.all_gather(x, axis_name, dim)

    @staticmethod
    def backward(ctx, g):
        axis_name, dim = ctx.args
        return shard_sequence(g, axis_name, dim).contiguous(), None, None


def gather_sequence(x, axis_name="seq", dim=1):
    return _GatherSequence.apply(x, axis_name, dim)


def ulysses_attention(q, k, v, *, axis_name="seq", local_attn=None):
    """Global-tensor entry: every rank passes the same (B, T, H, D) q/k/v;
    each runs Ulysses on its sequence block and the output is gathered
    back to (B, T, H, D) on every rank (gradients reach each rank's own
    block, as ``ring_attention_sharded``)."""
    dist_attn = DistributedAttention(local_attn or _dense_causal_attention,
                                     axis_name)
    out = dist_attn(*(shard_sequence(x, axis_name) for x in (q, k, v)))
    return gather_sequence(out, axis_name)
