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


def _codes(E, K, N, bits, offset=0):
    """Quantized experts (E, K, N); ``offset`` bytes off an aligned base
    puts the codes off 16 bytes."""
    w = iw.quantize_leaf(torch.ones(E, K, N), bits)
    if offset:
        q = torch.empty(w.q.numel() + offset, dtype=torch.int8)[offset:]
        w = type(w)(q.view(w.q.shape), w.scale)
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype,M,K,N,offset,want", [
    (torch.bfloat16, 16, 4096, 14336, 0, "sm90"),    # Mixtral decode, up
    (torch.bfloat16, 512, 14336, 4096, 0, "sm90"),   # the 512-row chunk, down
    (torch.bfloat16, 162, 256, 384, 0, "sm90"),
    (torch.float32, 512, 256, 384, 0, "fp32"),
    (torch.bfloat16, 16, 100, 96, 0, "mma_sync"),    # K % 8
    (torch.bfloat16, 16, 128, 90, 0, "mma_sync"),    # N % 16
    (torch.bfloat16, 16, 128, 96, 1, "mma_sync"),    # codes off 16 bytes
])
def test_wq_grouped_design_rule(bits, dtype, M, K, N, offset, want):
    """``_wq_grouped_design``: dtype, shape and TMA addressability only."""
    x = torch.zeros(M, K, dtype=dtype)
    assert gm._wq_grouped_design(x, _codes(2, K, N, bits, offset)) == want


def test_wq_grouped_design_rule_row_threshold(monkeypatch):
    w = _codes(2, 256, 128, 8)
    monkeypatch.setattr(gm, "WQ_GROUPED_SM90_MIN_ROWS", 32)
    assert gm._wq_grouped_design(torch.zeros(16, 256, dtype=torch.bfloat16),
                                 w) == "mma_sync"
    assert gm._wq_grouped_design(torch.zeros(512, 256, dtype=torch.bfloat16),
                                 w) == "sm90"
    x = torch.zeros(1 + 512 * 256, dtype=torch.bfloat16)[1:].view(512, 256)
    assert gm._wq_grouped_design(x, w) == "mma_sync"   # x off 16 bytes


@pytest.mark.parametrize("M,E,want", [
    (16, 8, 16),       # Mixtral decode: one run a touched expert
    (512, 8, 80),      # the 256-token chunk's 512 routed rows: 64 + 16
    (1, 8, 16),
    (96, 8, 16),       # 12 + 3
    (104, 8, 80),      # 13 + 4
    (162, 4, 80),      # 41 + 11
    (513, 8, 128),     # 65 + 17
    (4096, 8, 128),    # more than 128 a group: the largest tile
    (64, 1, 80),
    (65, 1, 128),
])
def test_wq_grouped_plan(M, E, want):
    assert gm.wq_grouped_plan(M, E) == want


def test_wq_grouped_launch_refuses_an_unknown_design():
    """A design name K9's launchers do not know raises before anything
    launches (the C launchers refuse an unknown code likewise: the card
    test)."""
    w = _codes(2, 64, 32, 8)
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    gs = torch.tensor([2, 2], dtype=torch.int32)
    for fn, name, ws in (("grouped_gmm_wq_launch", "grouped_gmm_wq", (w,)),
                         ("grouped_swiglu_up_wq_launch",
                          "grouped_swiglu_up_wq", (w, w))):
        with pytest.raises(ValueError, match="unknown design"):
            gm._launch_wq_grouped(fn, name, x, ws, gs, design="wgmma")
        assert gm.LAUNCHES[name] == 0
