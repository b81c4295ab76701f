"""K7 held against the JAX package on CPU: the port's ``wq_matmul`` (its
plain version on CPU tensors) against the JAX ``wq_matmul`` on the same
int8 / int4 codes, fp32, within 1e-5 (summation order only). The shapes
cover the Pallas ``_mm_wq`` kernel in interpret mode (every x_t / out_t
orientation) and a decode shape (T = 1) where the JAX wrapper takes its
jnp ``_ref_proj_wq`` fallback; the port's kernel runs at every shape."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import int8_weights as jiw
from deepspeed_tpu.ops.pallas import mlp_matmul as jmm
from deepspeed_tpu_torch.models.convert import _quantized
from deepspeed_tpu_torch.ops import int8_weights as iw
from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(rs, B, T, K, M, bits, x_t):
    x = rs.standard_normal((B, K, T) if x_t else (B, T, K)).astype(
        np.float32)
    jw = jiw.quantize_leaf((rs.standard_normal((K, M)) * 0.05).astype(
        np.float32), bits=bits)
    return x, jw, _quantized(jw, "cpu")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("x_t,out_t", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("B,T,K,M", [(2, 256, 512, 256),
                                     (1, 128, 256, 384),
                                     (1, 16, 1024, 256)])
def test_matches_the_jax_kernel(bits, x_t, out_t, B, T, K, M):
    """Shapes the Pallas ``_mm_wq`` kernel takes (interpret mode)."""
    rs = np.random.RandomState(B * 7 + T)
    x, jw, pw = _case(rs, B, T, K, M, bits, x_t)
    want = jmm.wq_matmul(jnp.asarray(x), jax.tree.map(jnp.asarray, jw),
                         x_t=x_t, out_t=out_t, interpret=True)
    got = mm.wq_matmul(torch.from_numpy(x), pw, x_t=x_t, out_t=out_t)
    assert mm.LAUNCHES["wq_matmul"] == 0          # CPU: the plain version
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("x_t,out_t", [(False, False), (True, True)])
def test_decode_shape_matches_the_jax_fallback(bits, x_t, out_t):
    """8 slots x 1 token at the Llama FFN's aspect: JAX falls back to
    ``_ref_proj_wq`` (dequantized weight, the same math)."""
    rs = np.random.RandomState(3)
    x, jw, pw = _case(rs, 8, 1, 256, 688, bits, x_t)
    want = jmm.wq_matmul(jnp.asarray(x), jax.tree.map(jnp.asarray, jw),
                         x_t=x_t, out_t=out_t, interpret=True)
    got = mm.wq_matmul(torch.from_numpy(x), pw, x_t=x_t, out_t=out_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a 2-D x is lifted to B = 1 and squeezed back, as in JAX
    x2 = x[0]
    want2 = jmm.wq_matmul(jnp.asarray(x2), jax.tree.map(jnp.asarray, jw),
                          x_t=x_t, out_t=out_t, interpret=True)
    got2 = mm.wq_matmul(torch.from_numpy(x2), pw, x_t=x_t, out_t=out_t)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)


def test_plain_version_is_the_kernel_math():
    """fp32 products of x and the codes, then the scale, then one rounding
    (bf16 here): not x @ (q * s)."""
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.standard_normal((3, 5, 64))).to(torch.bfloat16)
    w = iw.quantize_leaf(torch.from_numpy(
        rs.standard_normal((64, 48)).astype(np.float32)), 4)
    want = ((x.float() @ iw.unpack_int4(w.q).float()) * w.scale).to(
        torch.bfloat16)
    assert torch.equal(mm.wq_matmul(x, w), want)
    assert torch.equal(mm.wq_matmul_reference(x, w), want)


def test_rejects_what_the_kernel_does_not_take():
    w = iw.quantize_leaf(torch.ones(16, 8), 8)
    with pytest.raises(TypeError, match="Int8Weight"):
        mm.wq_matmul(torch.ones(2, 3, 16), torch.ones(16, 8))
    with pytest.raises(ValueError, match="quantized"):
        mm.wq_matmul(torch.ones(2, 3, 12), w)
    with pytest.raises(ValueError, match="B, T, K"):
        mm.wq_matmul(torch.ones(2, 2, 3, 16), w)
