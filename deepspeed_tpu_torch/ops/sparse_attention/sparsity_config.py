"""Block-sparsity layout configs.

Own copy of ``deepspeed_tpu/ops/sparse_attention/sparsity_config.py`` (the
port imports nothing of the JAX package): each config builds a (num_heads,
n_blocks, n_blocks) boolean LAYOUT — which key blocks each query block
attends — consumed by the block-sparse attention op. Pure numpy; layouts
come out bitwise equal to the JAX package's, BigBird's
``np.random.RandomState(seed)`` draws included.
"""

import numpy as np


class SparsityConfig:
    def __init__(self, num_heads, block=16, different_layout_per_head=False):
        self.num_heads = num_heads
        self.block = block
        self.different_layout_per_head = different_layout_per_head

    def setup_layout(self, seq_len):
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), dtype=bool), n

    def check_and_propagate_first_head_layout(self, layout):
        if not self.different_layout_per_head:
            layout[1:] = layout[0:1]
        return layout

    def make_layout(self, seq_len):
        raise NotImplementedError


class DenseSparsityConfig(SparsityConfig):
    """Full attention expressed as a layout (reference
    DenseSparsityConfig)."""

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        layout[:] = True
        return layout


class FixedSparsityConfig(SparsityConfig):
    """reference FixedSparsityConfig: local blocks within windows of
    ``num_local_blocks``, plus attention to the last
    ``num_global_blocks`` block(s) of each preceding window
    ('unidirectional') or chosen global blocks both ways
    ('bidirectional')."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_local_blocks=4, num_global_blocks=1,
                 attention="bidirectional", horizontal_global_attention=False):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_local_blocks = num_local_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.horizontal_global_attention = horizontal_global_attention

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        L, G = self.num_local_blocks, self.num_global_blocks
        heads = (self.num_heads if self.different_layout_per_head else 1)
        # global block indices: the last G blocks of every window
        gidx = [b for w0 in range(0, n, L)
                for b in range(max(w0 + L - G, w0), min(w0 + L, n))]
        for h in range(heads):
            for q in range(n):
                w = q // L
                # local window
                start = w * L
                end = min(start + L, n)
                layout[h, q, start:end] = True
                if self.attention == "unidirectional":
                    # global: last G blocks of every previous window
                    for pw in range(w):
                        ps = pw * L
                        pe = min(ps + L, n)
                        layout[h, q, max(pe - G, ps):pe] = True
            if self.attention == "bidirectional":
                # every query sees every global block (reference sets the
                # global columns for ALL rows)
                layout[h][:, gidx] = True
                if self.horizontal_global_attention:
                    layout[h][gidx, :] = True
        if self.attention == "unidirectional":
            tril = np.tril(np.ones((n, n), dtype=bool))
            layout &= tril[None]
        return self.check_and_propagate_first_head_layout(layout)


class BigBirdSparsityConfig(SparsityConfig):
    """reference BigBirdSparsityConfig: random + sliding window + global
    blocks."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_random_blocks=1, num_sliding_window_blocks=3,
                 num_global_blocks=1, attention="bidirectional", seed=0):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_random_blocks = num_random_blocks
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.num_global_blocks = num_global_blocks
        self.attention = attention
        self.seed = seed

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        rs = np.random.RandomState(self.seed)
        W = self.num_sliding_window_blocks
        heads = (self.num_heads if self.different_layout_per_head else 1)
        for h in range(heads):
            for q in range(n):
                lo = max(0, q - W // 2)
                layout[h, q, lo:min(n, q + W // 2 + 1)] = True
                # random blocks
                if self.attention == "unidirectional":
                    pool = np.arange(0, max(q, 1))
                else:
                    pool = np.arange(n)
                if len(pool) and self.num_random_blocks:
                    pick = rs.choice(pool, size=min(self.num_random_blocks,
                                                    len(pool)),
                                     replace=False)
                    layout[h, q, pick] = True
            # global blocks: first G rows/cols fully connected
            G = self.num_global_blocks
            layout[h, :G, :] = True
            layout[h, :, :G] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self.check_and_propagate_first_head_layout(layout)


class BSLongformerSparsityConfig(SparsityConfig):
    """reference BSLongformerSparsityConfig: sliding window + selected
    global block indices."""

    def __init__(self, num_heads, block=16, different_layout_per_head=False,
                 num_sliding_window_blocks=3, global_block_indices=(0,),
                 attention="bidirectional"):
        super().__init__(num_heads, block, different_layout_per_head)
        self.num_sliding_window_blocks = num_sliding_window_blocks
        self.global_block_indices = list(global_block_indices)
        self.attention = attention

    def make_layout(self, seq_len):
        layout, n = self.setup_layout(seq_len)
        W = self.num_sliding_window_blocks
        heads = (self.num_heads if self.different_layout_per_head else 1)
        for h in range(heads):
            for q in range(n):
                lo = max(0, q - W // 2)
                layout[h, q, lo:min(n, q + W // 2 + 1)] = True
            for g in self.global_block_indices:
                if g < n:
                    layout[h, g, :] = True
                    layout[h, :, g] = True
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=bool))[None]
        return self.check_and_propagate_first_head_layout(layout)
