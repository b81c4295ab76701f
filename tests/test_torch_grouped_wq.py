"""K9 held against the JAX package on CPU: the port's quantized grouped
products (their plain versions on CPU tensors) against the JAX Pallas
kernels ``_swiglu_up_wq`` and ``_gmm_wq`` in interpret mode on the same
int8 / int4 expert codes, fp32: each product within 1e-5, the
``grouped_swiglu_wq`` chain within 1e-4 (two products, the silu between).
Uneven groups, an empty group, every row on one expert and a row tail
past the groups (exactly 0); w2 in int8 beside int4 w1/w3 (an odd F) runs
each product on its own weights' type."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import int8_weights as jiw
from deepspeed_tpu.ops.pallas import grouped_matmul as jgm
from deepspeed_tpu_torch.models.convert import _quantized
from deepspeed_tpu_torch.ops import int8_weights as iw
from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm

TOL = dict(rtol=1e-5, atol=1e-5)
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)
K, F = 256, 384


def _experts(rs, E, In, Out, bits):
    jw = jiw.quantize_leaf((rs.standard_normal((E, In, Out)) * 0.05)
                           .astype(np.float32), bits=bits)
    return jax.tree.map(jnp.asarray, jw), _quantized(jw, "cpu")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,sizes", [
    (96, [30, 0, 41, 25]),          # uneven, an empty group
    (96, [0, 96, 0, 0]),            # every row on one expert
    (128, [20, 33, 0, 11]),         # a 64-row tail past the groups
])
def test_products_match_the_jax_kernels(bits, M, sizes):
    rs = np.random.RandomState(M + sum(sizes[:2]))
    E = len(sizes)
    x = rs.standard_normal((M, K)).astype(np.float32)
    (j1, p1), (j3, p3) = (_experts(rs, E, K, F, bits) for _ in range(2))
    j2, p2 = _experts(rs, E, F, K, bits)
    gs = np.asarray(sizes, np.int32)
    jx, jgs = jnp.asarray(x), jnp.asarray(gs)
    tm = 32
    int4 = bits == 4
    jh = jgm._swiglu_up_wq(jx, j1.q, j1.scale, j3.q, j3.scale, jgs, tm=tm,
                           tn=128, tk=128, int4=int4, interpret=True)
    jo = jgm._gmm_wq(jh, j2.q, j2.scale, jgs, tm=tm, tn=128, tk=128,
                     int4=int4, interpret=True)
    tx, tgs = torch.from_numpy(x), torch.from_numpy(gs)
    h = gm.grouped_swiglu_up_wq(tx, p1, p3, tgs)
    o = gm.grouped_matmul_wq(torch.from_numpy(np.array(jh)), p2, tgs)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    live = sum(sizes)
    assert torch.all(h[live:] == 0) and torch.all(o[live:] == 0)
    chain = gm.grouped_swiglu_wq(tx, p1, p3, p2, tgs)
    want = jgm.grouped_swiglu_wq(jx, j1, j3, j2, jgs, interpret=True)
    np.testing.assert_allclose(chain.numpy(), np.asarray(want),
                               **CHAIN_TOL)
    assert gm.LAUNCHES["grouped_swiglu_up_wq"] == 0   # CPU: plain versions
    assert gm.LAUNCHES["grouped_gmm_wq"] == 0


def test_mixed_types_run_each_product_on_its_own():
    """int4 w1/w3 with an odd F put w2 in int8 (quantize_leaf's
    fallback): the JAX wrapper then dequantizes everything into
    ragged_dot; the port runs both products on their codes. Same result
    within 1e-4."""
    rs = np.random.RandomState(11)
    E, Fo, M = 3, 129, 40
    x = rs.standard_normal((M, K)).astype(np.float32)
    (j1, p1), (j3, p3) = (_experts(rs, E, K, Fo, 4) for _ in range(2))
    j2, p2 = _experts(rs, E, Fo, K, 4)
    assert isinstance(p1, iw.Int4Weight) and type(p2) is iw.Int8Weight
    gs = np.asarray([10, 0, 25], np.int32)
    want = jgm.grouped_swiglu_wq(jnp.asarray(x), j1, j3, j2,
                                 jnp.asarray(gs), interpret=True)
    got = gm.grouped_swiglu_wq(torch.from_numpy(x), p1, p3, p2,
                               torch.from_numpy(gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CHAIN_TOL)


def test_plain_version_applies_scales_before_silu():
    """h = silu(s1 (x c1)) * (s3 (x c3)), fp32, rounded once."""
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.standard_normal((6, 32))).to(torch.bfloat16)
    w1, w3 = (iw.quantize_leaf(torch.from_numpy(
        rs.standard_normal((2, 32, 16)).astype(np.float32)), 8)
        for _ in range(2))
    gs = torch.tensor([4, 2], dtype=torch.int32)
    got = gm.grouped_swiglu_up_wq(x, w1, w3, gs)
    for e, (lo, hi) in enumerate(((0, 4), (4, 6))):
        xf = x[lo:hi].float()
        g = (xf @ w1.q[e].float()) * w1.scale[e]
        u = (xf @ w3.q[e].float()) * w3.scale[e]
        assert torch.equal(got[lo:hi],
                           (torch.nn.functional.silu(g) * u).to(x.dtype))


def test_rejects_what_the_kernels_do_not_take():
    w = iw.quantize_leaf(torch.ones(2, 16, 8), 8)
    w4 = iw.quantize_leaf(torch.ones(2, 16, 8), 4)
    x = torch.ones(5, 16)
    gs = torch.tensor([2, 3], dtype=torch.int32)
    with pytest.raises(TypeError, match="Int8Weight"):
        gm.grouped_matmul_wq(x, torch.ones(2, 16, 8), gs)
    with pytest.raises(TypeError, match="share a quantization type"):
        gm.grouped_swiglu_up_wq(x, w, w4, gs)
    with pytest.raises(ValueError, match="group_sizes"):
        gm.grouped_matmul_wq(x, w, torch.tensor([5], dtype=torch.int32))
    with pytest.raises(ValueError, match="w2"):
        gm.grouped_swiglu_wq(x, w, w, w, gs)
