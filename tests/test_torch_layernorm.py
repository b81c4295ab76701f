"""K13 (deepspeed_tpu_torch/ops/cuda/layernorm.py) held against the JAX
package's fused LayerNorm (ops/pallas/layernorm.py, Pallas in interpret
mode) on CPU: values and the gradients of (x, scale, bias), through
``fused_layernorm`` (kernel forward + kernel backward) and
``layernorm_fused_bwd`` (plain forward + kernel backward), the port's
kernels in their plain versions. Inputs from numpy seeds.

K13's RMSNorm (``fused_rmsnorm``, forward only) against the JAX
``fused_rmsnorm`` in interpret mode and the Llama ``_rms_norm``: (3, 37,
256) fp32 at 1e-5 (TestFusedRMSNorm's shape and tolerance), bf16 at 2e-2
as the LayerNorm. The kernel itself is held against its plain version on
a card in test_torch_cuda_kernels.py (which the card's machine runs: it
has no JAX).

Shapes and tolerances are test_pallas_ops.py's (TestFusedLayerNorm,
:682-757): (4, 37, 256) and (300, 384) fp32 at 1e-5 (values) / 1e-4
(gradients); (2, 128, 128) bf16 at 2e-2 / 5e-2 (the outputs' own bf16
rounding). The plain backward is also held against torch autograd of the
plain forward at 1e-5 (both compute in fp32; the sums run in another
order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models.llama import _rms_norm as jrms_norm
from deepspeed_tpu.ops.pallas import layernorm as jln
from deepspeed_tpu_torch.ops.cuda import layernorm as tln

CASES = [((4, 37, 256), "float32"), ((2, 128, 128), "bfloat16"),
         ((300, 384), "float32")]


def _inputs(shape, dt, seed=0):
    rs = np.random.RandomState(seed)
    D = shape[-1]
    x = rs.randn(*shape).astype(np.float32)
    s = (1 + 0.1 * rs.randn(D)).astype(np.float32)
    b = (0.1 * rs.randn(D)).astype(np.float32)
    jx, js, jb = (jnp.asarray(a, dt) for a in (x, s, b))
    tdt = getattr(torch, dt)
    tx, ts, tb = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(tdt) for a in (jx, js, jb))
    return (jx, js, jb), (tx, ts, tb)


def _f32(a):
    """A JAX array or a torch tensor as fp32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a.astype(jnp.float32))


@pytest.mark.parametrize("variant", ["fused", "hybrid"])
@pytest.mark.parametrize("shape,dt", CASES, ids=["4x37x256_f32",
                                                 "2x128x128_bf16",
                                                 "300x384_f32"])
def test_values_and_grads_match_jax(shape, dt, variant):
    (jx, js, jb), (tx, ts, tb) = _inputs(shape, dt)
    jfn = {"fused": jln.fused_layernorm,
           "hybrid": jln.layernorm_fused_bwd}[variant]
    tfn = {"fused": tln.fused_layernorm,
           "hybrid": tln.layernorm_fused_bwd}[variant]
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    tol2 = 5e-2 if dt == "bfloat16" else 1e-4
    jy = jfn(jx, js, jb, interpret=True)
    ps = [t.clone().requires_grad_() for t in (tx, ts, tb)]
    ty = tfn(*ps)
    assert ty.dtype == ps[0].dtype and ty.shape == ps[0].shape
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=tol, atol=tol)

    def f(x, s, b):
        return jnp.sum(jnp.sin(jfn(x, s, b, interpret=True)
                               .astype(jnp.float32)))

    jg = jax.grad(f, argnums=(0, 1, 2))(jx, js, jb)
    tg = torch.autograd.grad(ty.float().sin().sum(), ps)
    for name, a, b in zip(("x", "scale", "bias"), tg, jg):
        assert a.dtype == ps[0].dtype
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=tol2, atol=tol2,
                                   err_msg=name)


def test_rejects_untileable_feature_dim():
    x, s, b = torch.zeros(8, 100), torch.ones(100), torch.zeros(100)
    for fn in (tln.fused_layernorm, tln.layernorm_fused_bwd):
        with pytest.raises(ValueError, match="128"):
            fn(x, s, b)
    with pytest.raises(ValueError, match="128"):
        jln.fused_layernorm(jnp.zeros((8, 100)), jnp.ones(100),
                            jnp.zeros(100), interpret=True)


def test_plain_backward_is_the_autograd_of_the_plain_forward():
    """layernorm_bwd_reference (the TPU backward kernel's formula) against
    torch autograd of layernorm_reference, rows summed for dscale /
    dbias."""
    rs = np.random.RandomState(1)

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    x = t(rs.randn(70, 256)).requires_grad_()
    s = t(1 + 0.1 * rs.randn(256)).requires_grad_()
    b = t(0.1 * rs.randn(256)).requires_grad_()
    dy = t(rs.randn(70, 256))
    want = torch.autograd.grad(tln.layernorm_reference(x, s, b), (x, s, b),
                               dy)
    got = tln.layernorm_bwd_reference(x.detach(), s.detach(), dy)
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5, msg=name)


def test_scale_grads_take_the_scale_dtype_and_no_padding_is_needed():
    """dscale / dbias come back in the scale's dtype (``_ln_bwd``'s cast),
    and a row count that is no multiple of any tile (37 * 3) needs no
    padding: JAX's zero pad rows add nothing."""
    (jx, js, jb), (tx, ts, tb) = _inputs((3, 37, 128), "float32", seed=2)
    ps = [tx.clone().requires_grad_(), ts.double().requires_grad_(),
          tb.double().requires_grad_()]
    y = tln.fused_layernorm(*ps)
    assert y.dtype == torch.float32
    gx, gs, gb = torch.autograd.grad(y.sum(), ps)
    assert gs.dtype == gb.dtype == torch.float64
    jg = jax.grad(lambda x, s, b: jnp.sum(jln.fused_layernorm(
        x, s, b, interpret=True)), argnums=(0, 1, 2))(jx, js, jb)
    for a, b in zip((gx, gs, gb), jg):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ RMSNorm

RMS_CASES = [((3, 37, 256), "float32"), ((2, 128, 128), "bfloat16"),
             ((300, 384), "float32"), ((4, 5, 1024), "bfloat16")]


@pytest.mark.parametrize("shape,dt", RMS_CASES, ids=[
    "3x37x256_f32", "2x128x128_bf16", "300x384_f32", "4x5x1024_bf16"])
def test_rmsnorm_matches_jax(shape, dt):
    (jx, js, _), (tx, ts, _) = _inputs(shape, dt, seed=3)
    tol = 2e-2 if dt == "bfloat16" else 1e-5
    ty = tln.fused_rmsnorm(tx, ts)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    for want in (jln.fused_rmsnorm(jx, js, interpret=True),
                 jrms_norm(jx, js, 1e-5)):
        np.testing.assert_allclose(_f32(ty), _f32(want), rtol=tol,
                                   atol=tol)


def test_rmsnorm_eps_and_block_rows():
    """eps reaches the statistic; ``block_rows`` changes nothing."""
    (jx, js, _), (tx, ts, _) = _inputs((2, 9, 128), "float32", seed=4)
    tx = tx * 1e-2
    jx = jnp.asarray(tx.numpy())
    for block_rows in (8, 256):
        np.testing.assert_allclose(
            _f32(tln.fused_rmsnorm(tx, ts, eps=1e-3, block_rows=block_rows)),
            _f32(jln.fused_rmsnorm(jx, js, eps=1e-3, interpret=True)),
            rtol=1e-5, atol=1e-5)


def test_rmsnorm_rejects_untileable_feature_dim():
    with pytest.raises(ValueError, match="128"):
        tln.fused_rmsnorm(torch.zeros(8, 100), torch.ones(100))
    with pytest.raises(ValueError, match="128"):
        jln.fused_rmsnorm(jnp.zeros((8, 100)), jnp.ones(100),
                          interpret=True)

