"""The paged serving programs of the seven Llama-family models
(``apply_paged_prefill`` / ``chunk`` / ``decode`` / ``verify``) held
against the JAX programs on CPU at the families' ``*_TINY`` presets, fp32,
with the randomized biases and norms of test_torch_families.py and random
pools: logits and every pool within 1e-5. The JAX side runs its dense
programs (``paged_kernel`` off; under ALiBi its decode still takes the
Pallas kernel, in interpret mode, as the JAX program dispatches); the
port's kernels' plain versions are held against the JAX Pallas kernels
in test_torch_paged_attention.py and test_torch_family_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_families import FAMILIES, pair

PROG_TOL = dict(rtol=1e-5, atol=1e-5)
NB, BS = 12, 8


def _pools(jm, pm, rs):
    """The same random pools on both sides (a pool of zeros would hide a
    read of the wrong block)."""
    jc = jm.init_paged_cache(NB, BS, dtype=jnp.float32)
    pc = pm.init_paged_cache(NB, BS)
    for key in ("k", "v"):
        for i in range(len(pc[key])):
            arr = rs.standard_normal(pc[key][i].shape).astype(np.float32)
            pc[key][i].copy_(torch.from_numpy(arr))
            jc[key][i] = jnp.asarray(arr)
    return jc, pc


def _close(got, want, tag):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=tag, **PROG_TOL)


def _check_pools(jc, pc, tag):
    for key in ("k", "v"):
        for a, b in zip(jc[key], pc[key]):
            _close(b.numpy(), a, f"{tag} pool {key}")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_paged_programs_match_jax(name):
    """prefill (13 tokens) -> chunk (5 more, mid-block) -> decode (two live
    slots) -> verify (3 tokens a slot): logits and pools agree with the
    JAX programs."""
    jm, params, pm, _ = pair(name)
    jm._paged_kernel = False          # the JAX dense programs
    rs = np.random.RandomState(1)
    jc, pc = _pools(jm, pm, rs)
    V = jm.config.vocab_size
    prompt = rs.randint(0, V, (18,)).astype(np.int32)
    blocks = np.array([3, 7, 5], np.int32)

    T0, Tp = 13, 16
    ids = np.zeros((1, Tp), np.int32)
    ids[0, :T0] = prompt[:T0]
    tb = np.zeros((Tp,), np.int32)
    to = np.zeros((Tp,), np.int32)
    tb[:T0] = blocks[np.arange(T0) // BS]
    to[:T0] = np.arange(T0) % BS
    jl, jc = jm.apply_paged_prefill(params, jnp.asarray(ids), jc,
                                    jnp.asarray(tb), jnp.asarray(to),
                                    jnp.int32(T0))
    pl_, pc = pm.apply_paged_prefill(torch.from_numpy(ids), pc,
                                     torch.from_numpy(tb),
                                     torch.from_numpy(to), T0)
    _close(pl_.numpy(), jl, f"{name} prefill")
    _check_pools(jc, pc, f"{name} prefill")

    C, start, tl = 8, 13, 5
    ids = np.zeros((1, C), np.int32)
    ids[0, :tl] = prompt[start:start + tl]
    tb = np.zeros((C,), np.int32)
    to = np.zeros((C,), np.int32)
    pos = start + np.arange(tl)
    tb[:tl] = blocks[pos // BS]
    to[:tl] = pos % BS
    table = np.zeros((4,), np.int32)
    table[:3] = blocks
    jl, jc = jm.apply_paged_chunk(
        params, jnp.asarray(ids), jc, jnp.asarray(tb), jnp.asarray(to),
        jnp.int32(start), jnp.int32(tl), jnp.asarray(table))
    pl_, pc = pm.apply_paged_chunk(
        torch.from_numpy(ids), pc, torch.from_numpy(tb),
        torch.from_numpy(to), start, tl, torch.from_numpy(table))
    _close(pl_.numpy(), jl, f"{name} chunk")
    _check_pools(jc, pc, f"{name} chunk")

    tables = np.zeros((2, 4), np.int32)
    tables[0] = table
    tables[1] = [9, 10, 11, 0]
    tokens = np.array([int(np.argmax(np.asarray(jl)[0])), 4], np.int32)
    lengths = np.array([18, 21], np.int32)
    jl, jc = jm.apply_paged_decode(params, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jc,
                                   jnp.asarray(tables))
    pl_, pc = pm.apply_paged_decode(torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), pc,
                                    torch.from_numpy(tables))
    _close(pl_.numpy(), jl, f"{name} decode")
    _check_pools(jc, pc, f"{name} decode")

    vt = rs.randint(0, V, (2, 3)).astype(np.int32)
    lengths = np.array([19, 22], np.int32)
    jl, jc = jm.apply_paged_verify(params, jnp.asarray(vt),
                                   jnp.asarray(lengths), jc,
                                   jnp.asarray(tables))
    pl_, pc = pm.apply_paged_verify(torch.from_numpy(vt), lengths, pc,
                                    torch.from_numpy(tables))
    _close(pl_.numpy(), jl, f"{name} verify")
    _check_pools(jc, pc, f"{name} verify")
