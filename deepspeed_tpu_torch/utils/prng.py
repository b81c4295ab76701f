"""The JAX package's PRNG key words, in numpy.

The JAX engine keeps a threefry-2x32 key in its train state
(``jax.random.key(seed + 1)``) and checkpoints its two uint32 words as
``rng_data``; on a topology change at resume it folds the key with
``jax.random.fold_in``. The port has no JAX key, so it carries the same
two words and computes them here, bitwise as JAX does (held against
``jax.random.key_data`` / ``fold_in`` in tests/test_torch_checkpoint.py).
"""

import numpy as np

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


def threefry_2x32(key, x0, x1):
    """One threefry-2x32 block (20 rounds) of the count words (x0, x1)
    under the key words ``key``: JAX's ``threefry2x32`` lowering, in
    Python integers modulo 2**32."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(int(x0) + ks[0]) & _MASK, (int(x1) + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = ((x[1] << r) | (x[1] >> (32 - r))) & _MASK
            x[1] ^= x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return np.array(x, np.uint32)


def fold_in(key, data):
    """The words of ``jax.random.fold_in(key, data)`` for threefry key
    words ``key`` and a 32-bit ``data``."""
    return threefry_2x32(key, 0, int(data) & _MASK)
