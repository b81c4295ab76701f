"""The port's grouped matmul (K8 forward) and the dropless expert FFN held
against the JAX package on CPU: the plain ``grouped_matmul`` /
``grouped_swiglu`` (what a CPU tensor takes) against the JAX Pallas kernels
in interpret mode and against ``lax.ragged_dot`` on the same numpy-seeded
inputs (fp32: 1e-5 for one grouped product, 1e-4 for the SwiGLU chain, the
JAX tests' own tolerances), the exact zero tail, and the MoE helpers
(knob resolution, routing, the stable expert sort)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas.grouped_matmul import grouped_matmul as j_gmm
from deepspeed_tpu.ops.pallas.grouped_matmul import grouped_swiglu as j_swiglu
from deepspeed_tpu_torch.moe import sharded_moe as moe
from deepspeed_tpu_torch.ops import int8_weights as iw
from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm

GMM_TOL = dict(rtol=1e-5, atol=1e-5)
SWIGLU_TOL = dict(rtol=1e-4, atol=1e-4)


def _data(S, K, N, E, seed, n_w=1):
    rs = np.random.RandomState(seed)
    x = (rs.standard_normal((S, K)) * 0.3).astype(np.float32)
    ws = [(rs.standard_normal((E, K, N)) * 0.1).astype(np.float32)
          for _ in range(n_w)]
    return x, ws


def _swiglu_ragged(x, w1, w3, w2, gs):
    g = jax.lax.ragged_dot(x, w1, gs)
    u = jax.lax.ragged_dot(x, w3, gs)
    return jax.lax.ragged_dot(jax.nn.silu(g) * u, w2, gs)


@pytest.mark.parametrize("sizes", [
    [50, 0, 120, 22],        # uneven + an empty group
    [192, 0, 0, 0],          # everything on one expert
    [0, 0, 0, 0],            # all groups empty (zero output)
    [1, 63, 100, 28],
])
def test_gmm_matches_jax(sizes):
    x, (w,) = _data(192, 128, 256, 4, seed=0)
    gs = np.asarray(sizes, np.int32)
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(gs)).numpy()
    kern = np.asarray(j_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                            block_m=64))
    ragged = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(gs)))
    np.testing.assert_allclose(got, kern, **GMM_TOL)
    np.testing.assert_allclose(got, ragged, **GMM_TOL)
    assert np.all(got[sum(sizes):] == 0.0)


def test_rows_beyond_groups_are_zero():
    """The ragged_dot tail contract: rows past sum(group_sizes) come out
    exactly zero, in both the gmm and the fused up chain."""
    x, (w, w3) = _data(192, 128, 256, 4, seed=1, n_w=2)
    gs = torch.tensor([40, 30, 0, 10], dtype=torch.int32)
    xt, wt, w3t = (torch.from_numpy(a) for a in (x, w, w3))
    for out in (gm.grouped_matmul(xt, wt, gs),
                gm.grouped_swiglu_up(xt, wt, w3t, gs)):
        assert torch.all(out[80:] == 0.0)
        assert out[:80].abs().max() > 0


@pytest.mark.parametrize("sizes", [[60, 0, 89, 11], [160, 0, 0, 0],
                                   [0, 0, 0, 0], [3, 77, 1, 79]])
def test_swiglu_chain_matches_jax(sizes):
    """The fused w1/w3 -> silu*mul -> w2 chain against the JAX Pallas
    chain (interpret mode) and the three-ragged_dot reference."""
    S, K, Fd, E = 160, 128, 256, 4
    rs = np.random.RandomState(2)
    x = (rs.standard_normal((S, K)) * 0.3).astype(np.float32)
    w1, w3 = ((rs.standard_normal((E, K, Fd)) * 0.1).astype(np.float32)
              for _ in range(2))
    w2 = (rs.standard_normal((E, Fd, K)) * 0.1).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    got = gm.grouped_swiglu(*(torch.from_numpy(a)
                              for a in (x, w1, w3, w2, gs))).numpy()
    jargs = [jnp.asarray(a) for a in (x, w1, w3, w2, gs)]
    kern = np.asarray(j_swiglu(*jargs, block_m=64))
    ragged = np.asarray(_swiglu_ragged(*jargs))
    np.testing.assert_allclose(got, kern, **SWIGLU_TOL)
    np.testing.assert_allclose(got, ragged, **SWIGLU_TOL)
    assert np.all(got[sum(sizes):] == 0.0)


def test_transposed_weight_view():
    """w given as a transposed (E, N, K) view (the dx product's operand)
    gives the same product as the contiguous (E, K, N) tensor."""
    x, (w,) = _data(64, 96, 80, 3, seed=3)
    gs = torch.tensor([20, 0, 40], dtype=torch.int32)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1)))
    view = wt.transpose(1, 2)
    assert not view.is_contiguous()
    torch.testing.assert_close(
        gm.grouped_matmul(torch.from_numpy(x), view, gs),
        gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), gs),
        rtol=0, atol=0)


def test_group_sizes_past_the_rows_are_clipped():
    """sum(group_sizes) > S: the groups are cut at S, as the kernel does."""
    x, (w,) = _data(32, 16, 24, 2, seed=4)
    got = gm.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                            torch.tensor([20, 30]))
    want = np.concatenate([x[:20] @ w[0], x[20:] @ w[1]])
    np.testing.assert_allclose(got.numpy(), want, **GMM_TOL)


def test_bad_inputs_raise():
    x = torch.zeros(8, 16)
    w = torch.zeros(2, 16, 24)
    gs = torch.tensor([4, 4])
    with pytest.raises(ValueError, match="want x"):
        gm.grouped_matmul(torch.zeros(8, 15), w, gs)
    with pytest.raises(ValueError, match="group_sizes"):
        gm.grouped_matmul(x, w, torch.tensor([4, 4, 0]))
    with pytest.raises(TypeError, match="dtype"):
        gm.grouped_matmul(x, w.to(torch.bfloat16), gs)
    with pytest.raises(ValueError, match="w2"):
        gm.grouped_swiglu(x, w, w, torch.zeros(2, 16, 16), gs)
    with pytest.raises(TypeError, match="w2"):
        gm.grouped_swiglu(x, w, w, torch.zeros(2, 24, 16,
                                               dtype=torch.bfloat16), gs)


def test_block_m_covers_decode_in_one_tile():
    assert gm.block_m_for(16) == 16      # 8 slots x top-2
    assert gm.block_m_for(17) == 64
    assert gm.block_m_for(512) == 64     # a 256-token chunk x top-2


# ----------------------------------------------------------- MoE helpers


@pytest.mark.parametrize("knob,backend", [
    ("auto", "kernel"), (True, "kernel"), (False, "ragged"),
    (None, "ragged")])
def test_resolve_grouped_params(knob, backend, tmp_path):
    """The backend for a (rows, E, M, F) bucket; "auto" on a cold winner
    cache is the kernels."""
    from deepspeed_tpu_torch.autotuning import kernel_dispatch
    kernel_dispatch.configure(mode="cache_only",
                              cache_path=str(tmp_path / "winners.json"))
    try:
        assert moe.resolve_grouped_params(
            knob, 16, 4, 32, 64, torch.float32, "cpu")["backend"] == backend
    finally:
        kernel_dispatch.reset()


@pytest.mark.parametrize("knob", ["yes", {"backend": "ragged"}])
def test_resolve_rejects_unknown_knob(knob):
    with pytest.raises(ValueError, match="grouped_kernel"):
        moe.resolve_grouped_params(knob, 16, 4, 32, 64, torch.float32,
                                   "cpu")


def test_expert_ffn_backends_agree_and_unported_branches_raise():
    """The kernel backend (plain version on CPU) and the ragged math agree
    in fp32, on float and on quantized experts (K9: the quantized chain
    against the ragged math on the dequantized experts); integer experts
    without their scales and int8 compute (M11) raise."""
    rs = np.random.RandomState(5)
    S, K, Fd, E = 40, 32, 48, 4
    xs = torch.from_numpy(rs.standard_normal((S, K)).astype(np.float32))
    w1, w3 = (torch.from_numpy((rs.standard_normal((E, K, Fd)) * 0.2)
                               .astype(np.float32)) for _ in range(2))
    w2 = torch.from_numpy((rs.standard_normal((E, Fd, K)) * 0.2)
                          .astype(np.float32))
    gs = torch.tensor([10, 0, 25, 5], dtype=torch.int32)
    a = moe._grouped_swiglu_ffn(xs, w1, w3, w2, gs, {"backend": "kernel"})
    b = moe._grouped_swiglu_ffn(xs, w1, w3, w2, gs, {"backend": "ragged"})
    torch.testing.assert_close(a, b, **SWIGLU_TOL)
    qs = [iw.quantize_leaf(w, 8) for w in (w1, w3, w2)]
    a = moe._grouped_swiglu_ffn(xs, *qs, gs, {"backend": "kernel"})
    b = moe._grouped_swiglu_ffn(xs, *qs, gs, {"backend": "ragged"})
    torch.testing.assert_close(a, b, **SWIGLU_TOL)
    with pytest.raises(TypeError, match="share a dtype"):
        moe._grouped_swiglu_ffn(xs, w1.to(torch.int8), w3, w2, gs,
                                {"backend": "kernel"})
    with pytest.raises(NotImplementedError, match="M11"):
        moe._grouped_swiglu_ffn(xs, w1, w3, w2, gs,
                                {"backend": "kernel", "int8": 1})


def test_routing_matches_jax():
    """fp32 router logits, softmax, top-k and renormalisation as the JAX
    ``Mixtral._mlp``; the stable sort and the group sizes as
    ``jnp.argsort(stable=True)`` and ``jnp.bincount``."""
    rs = np.random.RandomState(6)
    S, D, E, k = 37, 24, 8, 2
    xs = rs.standard_normal((S, D)).astype(np.float32)
    gate = (rs.standard_normal((D, E)) * 0.5).astype(np.float32)
    w, ex = moe.route_top_k(torch.from_numpy(xs), torch.from_numpy(gate), k)
    probs = jax.nn.softmax(jnp.asarray(xs) @ jnp.asarray(gate), axis=-1)
    jw, jex = jax.lax.top_k(probs, k)
    jw = jw / jnp.sum(jw, axis=-1, keepdims=True)
    np.testing.assert_array_equal(ex.numpy(), np.asarray(jex))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    order, sizes = moe.sort_by_expert(ex, E)
    flat = np.asarray(jex).reshape(-1)
    np.testing.assert_array_equal(
        order.numpy(), np.asarray(jnp.argsort(jnp.asarray(flat),
                                              stable=True)))
    np.testing.assert_array_equal(sizes.numpy(),
                                  np.bincount(flat, minlength=E))
    assert sizes.dtype == torch.int32


# ------------------------------------------------- the swiglu_up design rule


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("dtype,M,K,N,view,offset,want", [
    (torch.bfloat16, 16, 4096, 14336, False, 0, "sm90"),   # Mixtral decode
    (torch.bfloat16, 512, 4096, 14336, False, 0, "sm90"),  # the 512-row chunk
    (torch.bfloat16, 162, 256, 384, False, 0, "sm90"),
    (torch.float32, 512, 256, 384, False, 0, "fp32"),
    (torch.bfloat16, 16, 100, 96, False, 0, "mma_sync"),   # K % 8
    (torch.bfloat16, 16, 128, 92, False, 0, "mma_sync"),   # N % 8
    (torch.bfloat16, 16, 128, 96, True, 0, "mma_sync"),    # a unit k stride
    (torch.bfloat16, 16, 128, 96, False, 1, "mma_sync"),   # x off 16 bytes
    (torch.bfloat16, 16, 128, 96, False, 2, "mma_sync"),   # w3 off 16 bytes
])
def test_swiglu_up_design_rule(dtype, M, K, N, view, offset, want):
    """``_swiglu_up_design``: dtype, row count, shape and TMA
    addressability only (w1 and w3 share their strides)."""
    E = 2
    x = torch.zeros(1 + M * K, dtype=dtype)[1:].view(M, K) if offset == 1 \
        else torch.zeros(M, K, dtype=dtype)
    if view:
        w1 = torch.zeros(E, N, K, dtype=dtype).transpose(1, 2)
    else:
        w1 = torch.zeros(E, K, N, dtype=dtype)
    w3 = (torch.zeros(1 + E * K * N, dtype=dtype)[1:].view(E, K, N)
          if offset == 2 else torch.zeros_like(w1))
    assert gm._swiglu_up_design(x, w1, w3) == want


def test_swiglu_up_design_rule_row_threshold(monkeypatch):
    w = _bf16(8, 256, 384)
    monkeypatch.setattr(gm, "SWIGLU_UP_SM90_MIN_ROWS", 32)
    assert gm._swiglu_up_design(_bf16(16, 256), w, w) == "mma_sync"
    assert gm._swiglu_up_design(_bf16(32, 256), w, w) == "sm90"
    assert gm._swiglu_up_design(_bf16(512, 256), w, w) == "sm90"
    assert gm._swiglu_up_design(torch.zeros(0, 256, dtype=torch.bfloat16),
                                w, w) == "mma_sync"


def test_swiglu_up_launch_refuses_an_unknown_design():
    """A design name grouped_swiglu_up's launcher does not know raises
    before anything launches (the C launcher refuses an unknown code
    likewise: the card test)."""
    w = _bf16(2, 64, 32)
    gs = torch.tensor([2, 2], dtype=torch.int32)
    gm.reset_launch_counts()
    with pytest.raises(ValueError, match="unknown design"):
        gm._launch("grouped_swiglu_up_launch", "grouped_swiglu_up",
                   _bf16(4, 64), (w, w), gs, design="wgmma")
    assert gm.LAUNCHES["grouped_swiglu_up"] == 0
