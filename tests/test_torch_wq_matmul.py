"""K7 held against the JAX package on CPU: the port's ``wq_matmul`` (its
plain version on CPU tensors) against the JAX ``wq_matmul`` on the same
int8 / int4 codes, fp32, within 1e-5 (summation order only). The shapes
cover the Pallas ``_mm_wq`` kernel in interpret mode (every x_t / out_t
orientation) and a decode shape (T = 1) where the JAX wrapper takes its
jnp ``_ref_proj_wq`` fallback; the port's kernel runs at every shape.
The sm90 design's split-K arithmetic (``wq_matmul_split_reference``) is
held to the same JAX kernel, and its design rule and plan to their
tables (shape and dtype only: no card)."""

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


@pytest.mark.parametrize("bits,K,S", [(8, 512, 2), (8, 640, 3), (4, 512, 4),
                                      (4, 640, 3), (4, 1024, 5),
                                      (8, 600, 3)])   # a 24-deep last slice
def test_split_reference_matches_the_jax_kernel(bits, K, S):
    """The sm90 design's split-K arithmetic: S fp32 partials over the
    64-deep slice ranges of ``wq_split_bounds``, summed in split order,
    then the scale and one rounding."""
    rs = np.random.RandomState(K + S)
    x, jw, pw = _case(rs, 1, 128, K, 256, bits, False)
    want = jmm.wq_matmul(jnp.asarray(x), jax.tree.map(jnp.asarray, jw),
                         interpret=True)
    x2 = torch.from_numpy(x[0])
    got = mm.wq_matmul_split_reference(x2, pw, S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want[0]), **TOL)
    torch.testing.assert_close(got, mm.wq_matmul_reference(x2, pw), **TOL)
    bounds = mm.wq_split_bounds(K, S)
    assert bounds[0][0] == 0 and bounds[-1][1] == K and all(
        lo < hi and hi == nxt for (lo, hi), (nxt, _) in
        zip(bounds, bounds[1:] + [(K, K)]))


@pytest.mark.parametrize("M,K,N,want", [
    (8, 4096, 11008, (8, 1)),        # Llama-2-7B decode, gate / up
    (8, 11008, 4096, (8, 4)),        # decode, down
    (256, 4096, 11008, (256, 1)),    # the 256-token chunk
    (256, 11008, 4096, (256, 4)),
    (200, 4096, 4096, (256, 4)),     # a ragged chunk
    (2048, 4096, 11008, (256, 1)),   # 688 tiles: more than a wave
    (1, 64, 128, (8, 1)),            # one k slice: no split
    (100, 512, 96, (128, 2)),        # 8 slices: at most 2 splits
    (300, 4096, 4096, (256, 2)),     # two row tiles
    (8, 4096, 1024, (8, 8)),         # 8 tiles: WQ_MAX_SPLITS
])
def test_wq_plan(M, K, N, want):
    assert mm.wq_plan(M, K, N) == want


def _weight(K, N, bits, offset=0):
    w = iw.quantize_leaf(torch.ones(K, N), bits)
    if offset:                       # codes whose base is off 16 bytes
        q = torch.empty(w.q.numel() + offset, dtype=torch.int8)[offset:]
        w = type(w)(q.view(w.q.shape), w.scale)
    return w


@pytest.mark.parametrize("dtype,M,K,N,bits,offset,want", [
    (torch.bfloat16, 8, 4096, 11008, 4, 0, "sm90"),
    (torch.bfloat16, 256, 11008, 4096, 8, 0, "sm90"),
    (torch.bfloat16, 300, 512, 384, 4, 0, "sm90"),
    (torch.float32, 256, 4096, 11008, 4, 0, "fp32"),
    (torch.bfloat16, 5, 100, 96, 8, 0, "mma_sync"),    # K % 8
    (torch.bfloat16, 5, 128, 90, 8, 0, "mma_sync"),    # N % 16
    (torch.bfloat16, 8, 128, 96, 8, 1, "mma_sync"),    # codes off 16 bytes
    (torch.float16, 8, 128, 96, 8, 0, "mma_sync"),     # raises at launch
])
def test_wq_design_rule(dtype, M, K, N, bits, offset, want):
    """``_wq_design``: dtype, shape and TMA addressability only."""
    x = torch.zeros(M, K, dtype=dtype)
    assert mm._wq_design(x, _weight(K, N, bits, offset)) == want


def test_wq_design_rule_row_threshold(monkeypatch):
    w = _weight(256, 128, 8)
    monkeypatch.setattr(mm, "WQ_SM90_MIN_ROWS", 16)
    assert mm._wq_design(torch.zeros(8, 256, dtype=torch.bfloat16),
                         w) == "mma_sync"
    assert mm._wq_design(torch.zeros(16, 256, dtype=torch.bfloat16),
                         w) == "sm90"
    x = torch.zeros(1 + 16 * 256, dtype=torch.bfloat16)[1:].view(16, 256)
    assert mm._wq_design(x, w) == "mma_sync"          # x off 16 bytes
