"""The port's flash attention (deepspeed_tpu_torch/ops/cuda/flash_attention)
held against the JAX package's: on CPU tensors the port's wrappers take
their plain PyTorch versions, compared here with the JAX Pallas kernels in
interpret mode and with the JAX dense ``attention_reference``, in fp32.

Tolerances: forward o and lse at rtol=atol=1e-5 (the JAX flash tests' own
fp32 tolerance, test_pallas_ops.py); gradients at rtol=atol=1e-4 (fp32
sums over T keys taken in another order and through the softmax twice,
tighter than the 1e-3 the JAX bf16 tests use)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, T, H, d, seed=0, n=4):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal((B, T, H, d)) * 0.5).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("T,causal,window", [(64, True, 0), (40, True, 0),
                                             (64, False, 0), (64, True, 24)])
def test_forward_matches_jax_kernel_and_reference(T, causal, window):
    q, k, v, _ = _inputs(2, T, 2, 32)
    o, lse = tfa.flash_attention_with_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window)
    jo, jlse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)
    if not window:
        ref = jfa.attention_reference(*map(jnp.asarray, (q, k, v)),
                                      causal=causal)
        np.testing.assert_allclose(o.numpy(), np.asarray(ref), **FWD_TOL)
        tref = tfa.attention_reference(*map(torch.from_numpy, (q, k, v)),
                                       causal=causal)
        np.testing.assert_allclose(tref.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("causal,window,heads_major",
                         [(True, 0, False), (False, 0, False),
                          (True, 24, False), (True, 0, True)])
def test_grads_match_jax(causal, window, heads_major):
    q, k, v, cot = _inputs(2, 64, 2, 32, seed=1)
    if heads_major:
        q, k, v, cot = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                        for x in (q, k, v, cot))
    kw = dict(causal=causal, window=window, heads_major=heads_major)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=32, block_k=32,
                                interpret=True, **kw)
        return jnp.sum(o * jnp.asarray(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, **kw) * torch.from_numpy(cot)).sum() \
        .backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_lse_cotangent_matches_jax():
    """A loss that reads lse too: its cotangent shifts delta."""
    q, k, v, cot = _inputs(1, 64, 2, 32, seed=2)
    lcot = np.random.RandomState(3).standard_normal((1, 2, 64)).astype(
        np.float32)

    def jloss(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, block_q=32,
                                              block_k=32, interpret=True)
        return jnp.sum(o * jnp.asarray(cot)) + jnp.sum(lse * jnp.asarray(lcot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv)
    ((o * torch.from_numpy(cot)).sum()
     + (lse * torch.from_numpy(lcot)).sum()).backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


@pytest.mark.parametrize("overflow", [False, True])
def test_fp16_matches_jax_kernel(overflow):
    """fp16 operands: o, lse and the gradients of the port (its plain
    versions on CPU tensors, the kernels' arithmetic) against the JAX
    Pallas kernels in interpret mode, within one fp16 rounding (rtol
    2^-9); with ``overflow`` the cotangent of the first query rows sits
    near fp16's top, so ds passes 65504 and rounds to inf in both: the
    same gradient rows are non-finite, and the rows the large cotangent
    does not reach (queries and, causal, keys past the first 6) agree: in
    the others ds is a difference of two terms near 1e5, whose fp32
    rounding differs between two summation orders."""
    q, k, v, cot = (x.astype(np.float16) for x in _inputs(1, 64, 2, 32,
                                                           seed=6))
    if overflow:
        v = v * np.float16(4)
        cot[:, :6] = 6e4
    tol = dict(rtol=2 ** -9, atol=2e-3)
    jo, jlse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), block_q=32, block_k=32,
        interpret=True)
    o, lse = tfa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)))
    assert o.dtype == torch.float16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(jo, np.float32), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **FWD_TOL)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=32, block_k=32,
                                interpret=True)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(cot, jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv).float()
     * torch.from_numpy(cot).float()).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jg):
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        rows = np.isfinite(want).all(-1)
        np.testing.assert_array_equal(np.isfinite(got).all(-1), rows,
                                      err_msg=name)
        assert rows.any()
        if name == "q":
            assert overflow != rows.all()
        far = slice(6, None) if overflow else slice(None)
        np.testing.assert_allclose(got[:, far], want[:, far], err_msg=name,
                                   **tol)


def test_plain_versions_agree_with_each_other():
    """flash_forward/backward_reference (the kernels' plain versions) on
    (B, H, T, d) equal autograd through the dense reference."""
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2)
                   for x in _inputs(1, 48, 3, 32, seed=4))
    qs = q * 0.25
    o, lse = tfa.flash_forward_reference(qs, k, v)
    dq, dk, dv = tfa.flash_backward_reference(qs, k, v, o, lse, do)
    qr, kr, vr = (x.detach().clone().requires_grad_() for x in (qs, k, v))
    ref = tfa.attention_reference(*(x.transpose(1, 2) for x in (qr, kr, vr)),
                                  scale=1.0).transpose(1, 2)
    (ref * do).sum().backward()
    torch.testing.assert_close(o, ref.detach(), **FWD_TOL)
    for got, want in zip((dq, dk, dv), (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_unported_operands_raise_and_cpu_launches_nothing():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(q, q, q, bias=torch.zeros(1, 1, 8, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfa.flash_attention(q, q, q, alibi=[0.5, 0.25])
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(q, q, q, causal=False, window=4)
    tfa.reset_launch_counts()
    o = tfa.flash_attention(q, q, q, block_q=999, block_h=7)   # knobs: no-op
    assert o.shape == q.shape
    assert tfa.LAUNCHES == {"flash_fwd": 0, "flash_bwd": 0,
                            "flash_bwd_qmajor": 0, "flash_block_fwd": 0}


def test_fwd_design_rule():
    """``_fwd_design`` on (B, H, T, d) operands as the kernel reads them
    (CPU tensors): bf16 at d = 64 and 128 in the model's (B, T, H, d)
    layout (GPT-2 350M's B=24, T=1024, H=16, d=64) and heads-major, at a
    ragged T, takes the sm90 design; d = 32, an unaligned base and a (b, h,
    t) stride TMA cannot address take mma_sync; fp32 takes fp32."""
    bf = torch.bfloat16

    def design(B, T, H, d, dtype=bf, heads_major=False, views=None):
        if views is None:
            shape = (B, H, T, d) if heads_major else (B, T, H, d)
            views = [torch.empty(shape, dtype=dtype) for _ in range(3)]
            if not heads_major:
                views = [x.transpose(1, 2) for x in views]
        return tfa._fwd_design(*views)

    assert design(24, 1024, 16, 64) == "sm90"
    assert design(2, 333, 4, 128) == "sm90"
    assert design(2, 333, 4, 128, heads_major=True) == "sm90"
    assert design(1, 40, 1, 64, heads_major=True) == "sm90"
    assert design(2, 200, 4, 32) == "mma_sync"
    assert design(24, 1024, 16, 64, dtype=torch.float32) == "fp32"
    assert design(2, 64, 4, 32, dtype=torch.float32) == "fp32"
    q = torch.empty(2 * 4 * 64 * 64 + 1, dtype=bf)[1:].view(2, 4, 64, 64)
    k = torch.empty(2, 4, 64, 64, dtype=bf)
    assert design(0, 0, 0, 0, views=(q, k, k)) == "mma_sync"  # base + 2 B
    # heads 68 values apart: a (b, h, t) stride of 136 bytes
    wide = torch.empty(2, 64, 4, 68, dtype=bf)[..., :64].transpose(1, 2)
    assert design(0, 0, 0, 0, views=(wide, k, k)) == "mma_sync"


def test_bwd_design_rule():
    """``_bwd_design`` on (B, H, T, d) operands and gradients as the kernels
    read them (CPU tensors): GPT-2 350M's model-layout (B, T, H, d) and
    heads-major views, a ragged T at d = 128, and the ring's folded (1,
    B*H, C, d) chunk pairs (halves of one (B*H, 2C, d) buffer) take the
    sm90 design; d = 32, a (b, h, t) stride that is not a whole 16 bytes
    (in an operand or in a gradient) or a d that is not contiguous take
    mma_sync; fp32 takes fp32. Every design is one the launchers have a
    code for."""
    bf = torch.bfloat16

    def views(B, T, H, d, dtype=bf, heads_major=False):
        shape = (B, H, T, d) if heads_major else (B, T, H, d)
        xs = [torch.empty(shape, dtype=dtype) for _ in range(5)]
        return xs if heads_major else [x.transpose(1, 2) for x in xs]

    def design(xs, grads=None):
        if grads is None:
            grads = [torch.empty_like(x) for x in xs[:3]]
        got = tfa._bwd_design(*xs, grads)
        assert got in tfa._DESIGN_CODE
        return got

    assert design(views(24, 1024, 16, 64)) == "sm90"
    assert design(views(24, 1024, 16, 64, heads_major=True)) == "sm90"
    assert design(views(2, 333, 4, 128)) == "sm90"
    # the ring's pairs at its step-0 shape: (B*H, C, d) = (64, 2048, 64)
    # halves of the zigzag's (B*H, 2C, d) chunks, folded as flash_block_bwd
    # folds them
    chunks = [torch.empty(64, 2 * 2048, 64, dtype=bf) for _ in range(5)]
    for half in (slice(0, 2048), slice(2048, None)):
        assert design([x[:, half][None] for x in chunks]) == "sm90"
    assert design(views(2, 200, 4, 32)) == "mma_sync"
    assert design(views(24, 1024, 16, 64, dtype=torch.float32)) == "fp32"
    assert design(views(2, 64, 4, 32, dtype=torch.float32)) == "fp32"
    # heads 68 values apart: a (b, h, t) stride of 136 bytes
    wide = torch.empty(2, 64, 4, 68, dtype=bf)[..., :64].transpose(1, 2)
    good = views(2, 64, 4, 64)
    assert design([wide] + good[1:]) == "mma_sync"
    assert design(good, [wide, good[1], good[2]]) == "mma_sync"
    # d not contiguous: the (B, H, d, T) layout seen as (B, H, T, d)
    qkv_t = [x.transpose(-1, -2) for x in
             (torch.empty(2, 4, 64, 128, dtype=bf) for _ in range(5))]
    assert design(qkv_t) == "mma_sync"


def test_fp16_design_rule_and_library():
    """fp16 operands take bf16's rule (the .f16 forms of the same designs:
    sm90 at d = 64 / 128 that TMA can address, mma_sync at d = 32 or what
    TMA cannot address) from the fp16 build of flash_attention.cu, dtype
    code 1 of its library; K2-qmajor and K10 refuse fp16 before any
    build."""
    from deepspeed_tpu_torch.op_builder import (FlashAttentionBuilder,
                                                FlashAttentionF16Builder)
    h = torch.float16
    views = [torch.empty(24, 1024, 16, 64, dtype=h).transpose(1, 2)
             for _ in range(5)]
    assert tfa._fwd_design(*views[:3]) == "sm90"
    assert tfa._bwd_design(*views, views[:3]) == "sm90"
    d32 = [torch.empty(2, 4, 100, 32, dtype=h) for _ in range(5)]
    assert tfa._fwd_design(*d32[:3]) == "mma_sync"
    assert tfa._bwd_design(*d32, d32[:3]) == "mma_sync"
    wide = torch.empty(2, 64, 4, 68, dtype=h)[..., :64].transpose(1, 2)
    good = [torch.empty(2, 4, 64, 64, dtype=h) for _ in range(3)]
    assert tfa._fwd_design(wide, *good[1:]) == "mma_sync"
    assert tfa._DTYPE_CODE[h] == tfa._DTYPE_CODE[torch.bfloat16] == 1
    f16, b16 = FlashAttentionF16Builder(), FlashAttentionBuilder()
    assert f16.flags() == b16.flags() + ["-DDS_ELEM_F16"]
    assert f16.SOURCES == b16.SOURCES and "elem16.cuh" in f16.DEPENDS
    assert f16.so_path() != b16.so_path()
    x = torch.empty(1, 2, 64, 64, dtype=h, device="meta")
    lse = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(TypeError, match="fp16 operands.*ROADMAP"):
        tfa.flash_backward_qmajor(x, x, x, x, lse, x)
    f = torch.empty(2, 64, 64, dtype=h, device="meta")
    with pytest.raises(TypeError, match="fp16 operands.*ROADMAP"):
        tfa.flash_block_fwd(f, f, f, tfa.flash_block_state(2, 64, 64,
                                                           "meta"))


def test_fp16_plain_versions_round_like_the_kernels():
    """On CPU tensors fp16 takes the plain versions, which round p and ds
    to fp16 as the kernels do: past fp16's 65504 a ds rounds to inf (no
    clamp), and the rows it reaches are non-finite."""
    rs = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 2, 16, 32).astype(
        np.float32)).half() for _ in range(4))
    o, lse = tfa.flash_forward(q, k, v)
    assert o.dtype == torch.float16
    ro, _ = tfa.flash_forward_reference(q.float(), k.float(), v.float())
    torch.testing.assert_close(o.float(), ro, rtol=2 ** -9, atol=1e-3)
    do[:, :, :4] = 3e4
    dq, dk, dv = tfa.flash_backward(q, k, v, o, lse, do)
    assert not torch.isfinite(dq[:, :, 1:4]).all()
    assert torch.isfinite(dq[:, :, 4:]).all()
    assert float(dq[torch.isfinite(dq)].abs().max()) < 65504


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [0.125, 1 / 3, 1 / math.sqrt(80)])
def test_scale_q_rounds_the_scale_like_jax(dtype, scale):
    """scale_q is bitwise the JAX wrapper's q * jnp.asarray(scale,
    q.dtype), and bitwise a product with the scale as a 0-dim tensor of
    q's dtype."""
    x = np.random.RandomState(5).randn(4, 33).astype(np.float32)
    q = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tfa.scale_q(q, scale)
    assert got.dtype == q.dtype
    assert torch.equal(got, q * torch.tensor(scale, dtype=q.dtype))
    jq = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray((jq * jnp.asarray(scale, jq.dtype)).astype(
        jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)
