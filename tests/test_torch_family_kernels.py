"""The attention kernels' new operands and head dims, held against the JAX
package on CPU (fp32, the port's wrappers taking their plain versions on
CPU tensors, the JAX Pallas kernels in interpret mode):

- K1 / K2 with ALiBi: ``flash_attention(..., alibi=slopes)`` and its
  gradients against the JAX ``flash_attention(..., alibi=)`` and
  ``jax.grad``, at d = 32 and 80, plain bloom ALiBi and the falcon-rw
  variant (the term rounded through bf16, then scaled by 1 / sqrt(d));
  custom slopes and the query-major backward under ALiBi raise;
- K4 / K5 at d = 80, 96 and 256 (phi-2, gpt-neox-20b, gpt-j-6b) and at the
  GQA groups of Falcon-7b (MQA) and Qwen2-7B (G = 7) against the JAX paged
  kernels, ALiBi in the decode;
- the design rules: d = 80 / 96 / 256 go to the designs that exist
  (mma_sync for K1 / K2, simt for K5), d = 64 / 128 keep sm90, and G that
  does not divide 64 takes K5's simt design.

Tolerances: the JAX tests' own (forward 1e-5, gradients 1e-4,
test_torch_flash_attention.py; paged 1e-5, test_torch_paged_attention.py).
Head counts are 4 and 6, whose bloom slopes are powers of two, so both
sides evaluate them exactly."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import flash_attention as jfa
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.ops.cuda import flash_attention as tfa
from deepspeed_tpu_torch.ops.cuda import paged_attention as tpa
from test_torch_paged_attention import _chunk_case, _decode_case

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(B, T, H, d, seed=0, n=4):
    rs = np.random.RandomState(seed)
    return [(rs.standard_normal((B, T, H, d)) * 0.5).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("d,H,falcon_rw", [(32, 4, False), (32, 6, True),
                                           (80, 4, False), (80, 4, True)])
def test_alibi_forward_and_grads_match_jax(d, H, falcon_rw):
    """o, lse and (dq, dk, dv) of the port's flash_attention with the
    bloom slopes against the JAX kernel with the same operand (its slope
    evaluated in-kernel from the head index), causal, T off the block."""
    T = 48
    q, k, v, cot = _inputs(1, T, H, d, seed=d + H)
    kw = dict(alibi=jpa.alibi_slopes(H),
              alibi_scale=1.0 / math.sqrt(d) if falcon_rw else 1.0,
              alibi_bf16=falcon_rw)
    jo, jlse = jfa.flash_attention_with_lse(
        *map(jnp.asarray, (q, k, v)), block_q=32, block_k=32,
        interpret=True, **kw)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = tfa.flash_attention_with_lse(tq, tk, tv, **kw)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               **FWD_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               **FWD_TOL)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, block_q=32, block_k=32,
                                interpret=True, **kw)
        return jnp.sum(o * jnp.asarray(cot))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    (o * torch.from_numpy(cot)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)
    # the term is really there: without it the outputs differ
    plain = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert not np.allclose(plain.numpy(), np.asarray(jo), **FWD_TOL)


def test_alibi_plain_versions_take_the_wrappers_arguments():
    """flash_forward_reference / flash_backward_reference with the ALiBi
    arguments agree with the dense reference given the term as a bias."""
    B, T, H, d = 1, 40, 4, 32
    q, k, v, do = (torch.from_numpy(x).transpose(1, 2)
                   for x in _inputs(B, T, H, d, seed=5))
    kw = dict(alibi=tfa.alibi_slopes(H), alibi_scale=0.25, alibi_bf16=True)
    o, lse = tfa.flash_forward_reference(q, k, v, **kw)
    bias = tfa.alibi_term(H, T, "cpu", 0.25, True)[None]
    ref = tfa.attention_reference(*(x.transpose(1, 2) for x in (q, k, v)),
                                  scale=1.0, bias=bias).transpose(1, 2)
    torch.testing.assert_close(o, ref, **FWD_TOL)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out = tfa.attention_reference(*(x.transpose(1, 2) for x in (qr, kr, vr)),
                                  scale=1.0, bias=bias).transpose(1, 2)
    (out * do).sum().backward()
    grads = tfa.flash_backward_reference(q, k, v, o, lse, do, **kw)
    for got, want in zip(grads, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(got, want, **GRAD_TOL)


def test_custom_slopes_and_qmajor_with_alibi_raise():
    H = 4
    q = torch.zeros(1, H, 32, 128)              # qkv_t: (B, H, d, T)
    with pytest.raises(NotImplementedError, match="custom"):
        tfa.flash_attention(q, q, q, qkv_t=True, alibi=[0.5] * H)
    with pytest.raises(NotImplementedError, match="query-major"):
        tfa.flash_attention(q, q, q, qkv_t=True, bwd_qmajor=True,
                            alibi=tfa.alibi_slopes(H))
    with pytest.raises(NotImplementedError, match="additive bias"):
        tfa.flash_attention(q, q, q, qkv_t=True,
                            bias=torch.zeros(1, 1, 128, 128))
    # the slopes the JAX package gives are the port's
    for n in (4, 6, 32, 71):
        assert tfa.alibi_slopes(n) == jpa.alibi_slopes(n)


@pytest.mark.parametrize("d", [80, 96, 256])
def test_decode_and_chunk_at_new_head_dims_match_jax(d):
    """GQA decode (with falcon-rw's ALiBi at d = 80) and a chunk."""
    _decode_case(3, 4, 2, d, 12, 8, 4, lengths=[5, 17, 31],
                 alibi=d == 80, alibi_scale=1.0 / math.sqrt(d),
                 alibi_bf16=d == 80)
    _chunk_case(12, 4, 2, d, 12, 8, 5, start=17, true_len=10)


@pytest.mark.parametrize("H,KVH", [(71, 1), (28, 4)])
def test_decode_and_chunk_at_family_gqa_groups_match_jax(H, KVH):
    """Falcon-7b's 71 query heads on one KV head (K4 takes them in chunks
    of 16) and Qwen2-7B's 28 on 4, at a narrow head dim."""
    _decode_case(2, H, KVH, 32, 12, 8, 4, lengths=[7, 29])
    _chunk_case(9, H, KVH, 32, 12, 8, 4, start=11, true_len=9)


def test_design_rules_at_family_head_dims():
    """K1 / K2: bf16 at d = 80 / 96 / 256 take mma_sync (the sm90 designs
    are d = 64 / 128 only), d = 64 / 128 keep sm90, fp32 takes fp32; K5:
    bf16 at d = 80 / 96 / 256 and at G = 71 or 7 take simt, d = 64 / 128
    at G dividing 64 keep sm90. Every choice is one the launchers have a
    code for."""
    bf = torch.bfloat16

    def views(T, H, d, dtype=bf):
        return [torch.empty(1, T, H, d, dtype=dtype).transpose(1, 2)
                for _ in range(5)]

    for d, want in ((80, "mma_sync"), (96, "mma_sync"), (256, "mma_sync"),
                    (64, "sm90"), (128, "sm90")):
        xs = views(256, 8, d)
        assert tfa._fwd_design(*xs[:3]) == want, d
        got = tfa._bwd_design(*xs, [torch.empty_like(x) for x in xs[:3]])
        assert got == want and got in tfa._DESIGN_CODE, d
        assert tfa._fwd_design(*views(256, 8, d, torch.float32)[:3]) \
            == "fp32"

    def chunk(H, KVH, d, BS=64):
        q = torch.empty(64, H, d, dtype=bf)
        pool = torch.empty(4, KVH, BS, d, dtype=bf)
        got = tpa._chunk_design(q, pool, pool)
        assert got in tpa.CHUNK_DESIGN_CODE
        return got

    for d in (80, 96, 256):
        assert chunk(8, 8, d) == "simt"
    assert chunk(8, 8, 64) == chunk(8, 8, 128) == "sm90"
    assert chunk(71, 1, 64) == "simt"           # falcon-7b
    assert chunk(28, 4, 128) == "simt"          # qwen2-7b
    assert chunk(32, 8, 128) == "sm90"          # G = 4
    # the SIMT / fp32 chunk tiles' shared memory: fp32 at d = 256 fits a
    # CTA over 64-position blocks only
    assert tpa.chunk_smem("simt", 256, 128, 64) <= tpa._SMEM_LIMIT
    assert tpa.chunk_smem("fp32", 256, 64, 64) <= tpa._SMEM_LIMIT
    assert tpa.chunk_smem("fp32", 256, 128, 64) > tpa._SMEM_LIMIT
