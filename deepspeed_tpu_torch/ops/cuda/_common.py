"""The measured-dispatch layer of the port's kernel wrappers.

Counterpart of ``deepspeed_tpu/ops/pallas/_common.py:17-103`` (without the
TPU helpers): knobs set to ``"auto"`` resolve here against the persistent
autotune winner cache (``autotuning/kernel_dispatch.py``), keyed by the
device kind, the op, a shape bucket and the dtype. Each bucket string is
the JAX package's for the same shape: exact in the dims that pick a design
(feature, head, vocab, block sizes), rounded up to a power of two in the
data-volume dims (tokens, rows, batch slots, blocks) so that nearby shapes
share a winner.
"""

import torch


def dispatch(op, bucket, dtype, defaults, device=None):
    """The knobs of ``op`` for this (device kind, bucket, dtype) under the
    active autotune mode: the cached winner's params merged over
    ``defaults``, a measured search first in the search modes, the
    ``defaults`` on a miss. ``device``: the device the call computes on
    (default: this process's card, or the CPU without one)."""
    from ...autotuning import kernel_dispatch
    return kernel_dispatch.resolve(op, bucket, dtype, defaults,
                                   device=device)


def dtype_name(dtype):
    """Canonical dtype string of a cache key ('bfloat16', 'float32')."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    name = str(dtype)
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"not a dtype name: {dtype!r}")
    return name


def pow2_bucket(n):
    """``n`` rounded up to the next power of two (>= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


def flash_bucket(T, d, causal, qkv_t):
    return f"T{pow2_bucket(T)},d{int(d)},c{int(bool(causal))}," \
           f"q{int(bool(qkv_t))}"


def mlp_bucket(T, D, F):
    return f"T{pow2_bucket(T)},D{int(D)},F{int(F)}"


def ln_bucket(rows, D):
    return f"R{pow2_bucket(rows)},D{int(D)}"


def moe_grouped_bucket(S, E, M, F):
    """Grouped expert-FFN bucket: the rows entering the grouped product on
    one shard (tokens times k) rounded; the local expert count and the
    model / FFN dims exact."""
    return f"S{pow2_bucket(S)},E{int(E)},M{int(M)},F{int(F)}"


def paged_decode_bucket(B, MB, BS, KVH, G, d):
    """Decode-step bucket: batch slots and blocks a sequence rounded; block
    size, kv heads, GQA group and head dim exact."""
    return f"B{pow2_bucket(B)},MB{pow2_bucket(MB)},BS{int(BS)}," \
           f"kh{int(KVH)},g{int(G)},d{int(d)}"


def paged_chunk_bucket(C, MB, BS, KVH, G, d):
    """Chunk-program bucket: the chunk length C exact, blocks a sequence
    rounded."""
    return f"C{int(C)},MB{pow2_bucket(MB)},BS{int(BS)}," \
           f"kh{int(KVH)},g{int(G)},d{int(d)}"


def prefix_cache_bucket(B, NB, BS):
    """Prefix-cache policy bucket (JAX ``prefix_cache.py:51``): batch slots
    and pool blocks rounded, the block size exact."""
    return f"B{pow2_bucket(B)},NB{pow2_bucket(NB)},BS{int(BS)}"


def spec_bucket(B, NB, BS):
    """Speculation policy bucket (JAX ``speculative.py:46``): batch slots
    and pool blocks rounded, the block size exact."""
    return f"B{pow2_bucket(B)},NB{pow2_bucket(NB)},BS{int(BS)}"
