"""Block-sparse attention op.

Counterpart of ``deepspeed_tpu/ops/sparse_attention/sparse_self_attention.py``
(the reference's ``ops/sparse_attention/``): ``sparse_attention`` is the
masked-dense op (every block computed, the block layout expanded into an
element mask; the parity reference), and ``SparseSelfAttention`` bundles a
sparsity config with it and with the block-sparse kernels
(ops/cuda/block_sparse_attention.py), whose work scales with the layout's
density.
"""

import math

import numpy as np
import torch

from ..cuda.block_sparse_attention import (block_sparse_attention,
                                           layout_lists, lists_on)


def _expand_layout(layout, block, T, device):
    """(H, n, n) block layout -> (H, T, T) element mask."""
    n = T // block
    lay = torch.as_tensor(np.asarray(layout)[:, :n, :n], device=device)
    return lay.repeat_interleave(block, 1).repeat_interleave(block, 2)


def sparse_attention(q, k, v, layout, block, causal=False, scale=None):
    """q/k/v: (B, T, H, hd); layout: (H, T//block, T//block) bool.
    Returns (B, T, H, hd): fp32 scores times ``scale``, masked to -1e30,
    softmax, fully masked rows zero, probabilities in v's dtype."""
    B, T, H, hd = q.shape
    scale = scale or 1.0 / math.sqrt(hd)
    mask = _expand_layout(layout, block, T, q.device)            # (H, T, T)
    if causal:
        mask = mask & torch.ones(T, T, dtype=torch.bool,
                                 device=q.device).tril()[None]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    scores = torch.where(mask[None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked rows (possible in exotic layouts) -> zero output
    any_allowed = mask.any(-1)                                   # (H, T)
    probs = torch.where(any_allowed[None, :, :, None], probs, 0.0)
    probs = probs.to(v.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


class SparseSelfAttention:
    """The reference's ``SparseSelfAttention``: a SparsityConfig with the
    op; the layout is built per sequence length and cached, and the
    kernels' block lists are uploaded once per (T, device) as int32 device
    tensors and cached, so a call makes no host sync.

    ``use_kernel=True`` (default) runs the block-sparse kernels (their plain
    versions on CPU tensors). False takes the masked-dense op (the parity
    reference)."""

    def __init__(self, sparsity_config, causal=True, use_kernel=True):
        self.config = sparsity_config
        self.causal = causal
        self.use_kernel = use_kernel
        self._layouts = {}
        self._lists = {}

    def layout(self, seq_len):
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.config.make_layout(seq_len)
        return self._layouts[seq_len]

    def lists(self, seq_len, device):
        """The layout's block lists for ``seq_len`` on ``device`` ("cuda"
        and "cuda:<current>" share one entry)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (seq_len, str(dev))
        if key not in self._lists:
            n = seq_len // self.config.block
            self._lists[key] = lists_on(
                layout_lists(self.layout(seq_len), self.causal, n, n), device)
        return self._lists[key]

    def __call__(self, q, k, v):
        T = q.shape[1]
        lay = self.layout(T)
        if not self.use_kernel:
            return sparse_attention(q, k, v, lay, self.config.block,
                                    causal=self.causal)
        return block_sparse_attention(q, k, v, lay, self.config.block,
                                      causal=self.causal,
                                      lists=self.lists(T, q.device))

    def density(self, seq_len):
        lay = self.layout(seq_len)
        return float(lay.mean())
