"""The JAX package's PRNG, bitwise: key words, ``fold_in``, ``split``
and ``uniform`` for threefry-2x32 keys.

The JAX engine keeps a threefry-2x32 key in its train state
(``jax.random.key(seed + 1)``), checkpoints its two uint32 words as
``rng_data``, folds it after every optimizer step and hands each micro
step ``fold_in(key, micro_index)``; the models split that key into one
key a layer and draw their noise from it (GPT2MoE's noisy gating). The
port has no JAX key, so it carries the same two words and computes what
JAX computes from them here, under JAX's default
``jax_threefry_partitionable=True``: ``split(key, n)[i]`` is
``fold_in(key, i)``, and random bits at flat index n of a shape are
``b0 ^ b1`` of threefry over the count words (n >> 32, n & 0xFFFFFFFF),
so any row block of a draw is computed by offsetting n (the port's share
of a draw JAX makes over the global batch). Key words are numpy uint32
(2,); bits and draws are torch tensors on the caller's device, in int64
integer ops (tests/test_torch_prng.py holds every function against
``jax.random``).
"""

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def key_data(seed):
    """The words of ``jax.random.key_data(jax.random.key(seed))`` (the
    default threefry implementation, 32-bit seeds as JAX takes them
    without x64: the high word of an int32 seed is 0, the low word its
    two's complement bits)."""
    seed = int(seed)
    if -2 ** 31 <= seed < 2 ** 31:
        return np.array([0, seed & _MASK], np.uint32)
    return np.array([(seed >> 32) & _MASK, seed & _MASK], np.uint32)


def _threefry(key, x0, x1):
    """The 20 rounds of threefry-2x32 on the count words (x0, x1) under
    the key words ``key``, modulo 2**32: Python ints or int64 tensors
    (the same operators serve both)."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def threefry_2x32(key, x0, x1):
    """One threefry-2x32 block of the count words (x0, x1) under the key
    words ``key``: JAX's ``threefry2x32`` lowering."""
    return np.array(_threefry(key, int(x0), int(x1)), np.uint32)


def fold_in(key, data):
    """The words of ``jax.random.fold_in(key, data)`` for threefry key
    words ``key`` and a 32-bit ``data``."""
    return threefry_2x32(key, 0, int(data) & _MASK)


def split(key, n):
    """The words of ``jax.random.split(key, n)``, (n, 2) uint32: row i is
    ``fold_in(key, i)`` (the partitionable split)."""
    return np.stack([fold_in(key, i) for i in range(int(n))]) if n else \
        np.zeros((0, 2), np.uint32)


def random_bits(key, shape, offset=0, device=None):
    """``jax.random.bits(key, shape, uint32)`` as int64 values, the flat
    indices starting at ``offset`` (the rows of a larger draw)."""
    n = math.prod(shape)
    idx = torch.arange(offset, offset + n, dtype=torch.int64, device=device)
    b0, b1 = _threefry(key, idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(shape)


def uniform(key, shape, minval=0.0, maxval=1.0, offset=0, device=None):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the
    high 23 bits of each word as the mantissa of a float in [1, 2), minus
    1, then ``max(minval, u * (maxval - minval) + minval)`` with the fp32
    operands. XLA contracts that product and sum into one fused
    multiply-add; the product of two fp32 numbers is exact in fp64, so
    the sum is formed there and rounded to fp32 once."""
    bits = random_bits(key, shape, offset, device)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    out = (u.double() * span.double() + lo.double()).float()
    return torch.maximum(lo, out)
