"""K6 (deepspeed_tpu_torch/ops/cuda/mlp_matmul.py ``mlp_matmul``) held
against the JAX package's layout-owning projection
(ops/pallas/mlp_matmul.py, Pallas in interpret mode) and its jnp
``_ref_proj`` on CPU, fp32: the value and the gradients of (x, w) for all
four (x_t, out_t) orientations, with the fused dW kernel and without it.
Inputs from numpy seeds.

Tolerances: value 1e-5 and gradients 1e-4 (test_mlp_matmul.py:47 and
:114, its fp32 cases). The JAX module's bf16 reference does not run on
XLA:CPU with an fp32 accumulator (DotThunk BF16 x BF16 = F32), so the
port is held against it in fp32."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import mlp_matmul as jmm
from deepspeed_tpu_torch.ops.cuda import mlp_matmul as tmm

# the JAX tile sizes, small enough that the Pallas grid has several blocks
KW = dict(block_t=128, block_o=128, block_k=128)


def _inputs(x_t, out_t, B=2, T=256, K=256, M=128, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, K, T) if x_t else (B, T, K)).astype(
        np.float32)
    w = (rs.standard_normal((K, M)) / np.sqrt(K)).astype(np.float32)
    dy = rs.standard_normal((B, M, T) if out_t else (B, T, M)).astype(
        np.float32)
    return x, w, dy


@pytest.mark.parametrize("fuse_dw", [True, False], ids=["fuse_dw", "xla_dw"])
@pytest.mark.parametrize("x_t,out_t", list(itertools.product(
    [False, True], [False, True])))
def test_value_and_grads_match_jax(x_t, out_t, fuse_dw):
    x, w, dy = _inputs(x_t, out_t)
    jy = jmm.mlp_matmul(jnp.asarray(x), jnp.asarray(w), x_t=x_t, out_t=out_t,
                        fuse_dw=fuse_dw, interpret=True, **KW)
    jref = jmm._ref_proj(jnp.asarray(x), jnp.asarray(w), x_t, out_t)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ty = tmm.mlp_matmul(tx, tw, x_t=x_t, out_t=out_t, fuse_dw=fuse_dw, **KW)
    assert tuple(ty.shape) == jy.shape
    for want in (jy, jref):
        np.testing.assert_allclose(ty.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)

    def f(x_, w_):
        return jnp.sum(jmm.mlp_matmul(x_, w_, x_t=x_t, out_t=out_t,
                                      fuse_dw=fuse_dw, interpret=True, **KW)
                       * jnp.asarray(dy))

    jgx, jgw = jax.grad(f, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tgx, tgw = torch.autograd.grad(ty, (tx, tw), torch.from_numpy(dy))
    assert tgx.shape == tx.shape and tgw.shape == tw.shape
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-4)


def test_plain_products_match_the_jax_kernels():
    """The plain ``_mm`` (all a_t / b_t / out_t) and ``_dw`` (all a_t /
    g_t) against the JAX Pallas ``_mm`` / ``_dw`` in interpret mode."""
    rs = np.random.RandomState(1)
    P, N, K, M = 2, 128, 256, 128
    for a_t, b_t, out_t in itertools.product([False, True], repeat=3):
        a = rs.standard_normal((P, K, N) if a_t else (P, N, K)).astype(
            np.float32)
        b = rs.standard_normal((M, K) if b_t else (K, M)).astype(np.float32)
        want = jmm._mm(jnp.asarray(a), jnp.asarray(b), a_t=a_t, b_t=b_t,
                       out_t=out_t, bn=128, bm=128, bk=128,
                       out_dtype=jnp.float32, interpret=True)
        got = tmm.mm_reference(torch.from_numpy(a), torch.from_numpy(b), a_t,
                               b_t, out_t, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-4)
    for a_t, g_t in itertools.product([False, True], repeat=2):
        a = rs.standard_normal((P, K, N) if a_t else (P, N, K)).astype(
            np.float32)
        g = rs.standard_normal((P, M, N) if g_t else (P, N, M)).astype(
            np.float32)
        want = jmm._dw(jnp.asarray(a), jnp.asarray(g), a_t=a_t, g_t=g_t,
                       bkK=128, bm=128, bn=128, out_dtype=jnp.float32,
                       interpret=True)
        got = tmm.dw_reference(torch.from_numpy(a), torch.from_numpy(g), a_t,
                               g_t, torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-3)


def test_shape_validation_matches_jax():
    for fn, mk in ((jmm.mlp_matmul, jnp.zeros),
                   (tmm.mlp_matmul, torch.zeros)):
        with pytest.raises(ValueError, match="mlp_matmul expects"):
            fn(mk((4, 4)), mk((4, 4)))
        with pytest.raises(ValueError, match="contract dim"):
            fn(mk((1, 8, 16)), mk((8, 16)))
        with pytest.raises(ValueError, match="contract dim"):
            fn(mk((1, 8, 16)), mk((16, 4)), x_t=True)


@pytest.mark.parametrize("x_t,out_t", list(itertools.product(
    [False, True], repeat=2)))
def test_k6_design_rule(x_t, out_t):
    """``_k6_design`` on the operands each K6 launch of ``mlp_matmul`` reads
    (``_mm_operands`` / ``_dw_operands``, built on CPU tensors): every
    product of the GPT-2 350M MLP (P = 24, T = 1024, D = 1024, F = 4096) in
    bf16 takes the sm90 design (TMA + wgmma); a bf16 operand TMA cannot
    address (a row of 100 values = 200 bytes, also as the only row; a base
    one element off) takes mma_sync; fp32 takes fp32."""
    bf = torch.bfloat16

    def designs(x, w, dy, dtype):
        return {tmm._k6_design(*launch[:3]) for launch in (
            tmm._mm_operands(x, w, x_t, False, out_t, dtype),
            tmm._mm_operands(dy, w, out_t, True, x_t, dtype),
            tmm._dw_operands(x, dy, x_t, out_t, dtype))}

    def case(P, T, K, M, dtype=bf):
        return (torch.empty((P, K, T) if x_t else (P, T, K), dtype=dtype),
                torch.empty(K, M, dtype=dtype),
                torch.empty((P, M, T) if out_t else (P, T, M), dtype=dtype))

    for K, M in ((1024, 4096), (4096, 1024)):
        assert designs(*case(24, 1024, K, M), bf) == {"sm90"}
    assert designs(*case(2, 64, 64, 100), bf) == {"mma_sync"}   # M = 100
    # one row of K = 100: a tensor map holds the row stride even at one row
    assert designs(*case(1, 1, 100, 64), bf) == {"mma_sync"}
    x, w, dy = case(2, 64, 128, 64)
    x = torch.empty(x.numel() + 1, dtype=bf)[1:].view(x.shape)  # base + 2 B
    assert tmm._k6_design(*tmm._mm_operands(x, w, x_t, False, out_t,
                                            bf)[:3]) == "mma_sync"
    assert designs(*case(2, 64, 128, 64, torch.float32),
                   torch.float32) == {"fp32"}
    for P, T in ((0, 64), (2, 0)):                  # dW over no (p, n) rows
        x, w, dy = case(P, T, 128, 64)
        assert tmm._k6_design(*tmm._dw_operands(x, dy, x_t, out_t,
                                                bf)[:3]) == "mma_sync"
