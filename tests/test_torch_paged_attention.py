"""The port's paged attention (deepspeed_tpu_torch/ops/cuda/paged_attention)
held against the JAX package's: on CPU tensors the port's wrappers take
their plain PyTorch versions, compared here with the JAX Pallas kernels in
interpret mode and with the JAX dense references, in fp32 at the JAX
tests' own tolerance (rtol=atol=1e-5, test_paged_kernel.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu_torch.ops.cuda import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _pools(rs, NB, KVH, BS, d):
    k = rs.standard_normal((NB, KVH, BS, d)).astype(np.float32)
    v = rs.standard_normal((NB, KVH, BS, d)).astype(np.float32)
    return k, v


def _decode_case(B, H, KVH, d, NB, BS, MB, lengths, window=0, alibi=False,
                 alibi_scale=1.0, alibi_bf16=False, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, H, d)).astype(np.float32)
    k, v = _pools(rs, NB, KVH, BS, d)
    tables = rs.randint(1, NB, (B, MB)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    tables[lengths == 0] = 0            # inactive slots: scratch block 0
    slopes = jpa.alibi_slopes(H) if alibi else None
    kw = dict(window=window, alibi_slopes=slopes, alibi_scale=alibi_scale,
              alibi_bf16=alibi_bf16)
    port = tpa.paged_decode_attention(
        *map(torch.from_numpy, (q, k, v, tables, lengths)), **kw).numpy()
    jk = np.asarray(jpa.paged_decode_attention(
        *map(jnp.asarray, (q, k, v, tables, lengths)), interpret=True, **kw))
    np.testing.assert_allclose(port, jk, **TOL)
    if alibi_scale == 1.0 and not alibi_bf16:
        jr = np.asarray(jpa.paged_decode_attention_reference(
            *map(jnp.asarray, (q, k, v, tables, lengths)), window=window,
            alibi_slopes=slopes))
        np.testing.assert_allclose(port, jr, **TOL)
    return port


def _chunk_case(C, H, KVH, d, NB, BS, MB, start, true_len, window=0,
                block_c=8, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((C, H, d)).astype(np.float32)
    k, v = _pools(rs, NB, KVH, BS, d)
    table = rs.permutation(np.arange(1, NB))[:MB].astype(np.int32)
    port = tpa.paged_chunk_attention(
        *map(torch.from_numpy, (q, k, v, table)), start, true_len,
        window=window, block_c=block_c).numpy()
    jk = np.asarray(jpa.paged_chunk_attention(
        *map(jnp.asarray, (q, k, v, table)), jnp.int32(start),
        jnp.int32(true_len), window=window, block_c=block_c,
        interpret=True))
    jr = np.asarray(jpa.paged_chunk_attention_reference(
        *map(jnp.asarray, (q, k, v, table)), jnp.int32(start),
        jnp.int32(true_len), window=window))
    np.testing.assert_allclose(port[:true_len], jk[:true_len], **TOL)
    np.testing.assert_allclose(port[:true_len], jr[:true_len], **TOL)
    assert np.isfinite(port).all()
    return port


class TestDecodeParity:
    def test_gqa(self):
        _decode_case(3, 4, 2, 32, 12, 8, 4, lengths=[5, 17, 31])

    def test_sliding_window(self):
        _decode_case(3, 4, 2, 32, 12, 8, 4, lengths=[5, 17, 31], window=6)

    def test_inactive_slots(self):
        out = _decode_case(4, 4, 4, 32, 12, 8, 4, lengths=[0, 9, 0, 20])
        assert np.isfinite(out).all()

    def test_alibi_against_pallas_decode(self):
        # bloom slopes with a non-power-of-two head count, then the
        # falcon variant (bias rounded through bf16 and scaled)
        _decode_case(2, 6, 6, 32, 12, 8, 4, lengths=[11, 25], alibi=True)
        _decode_case(2, 6, 3, 32, 12, 8, 4, lengths=[11, 25], alibi=True,
                     alibi_scale=1.0 / np.sqrt(32), alibi_bf16=True)

    def test_custom_alibi_slopes_raise(self):
        q = torch.zeros(1, 2, 32)
        k = torch.zeros(3, 2, 8, 32)
        with pytest.raises(NotImplementedError):
            tpa.paged_decode_attention(
                q, k, k, torch.zeros(1, 2, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int32), alibi_slopes=[0.5, 0.1])


class TestChunkParity:
    def test_gqa(self):
        _chunk_case(16, 8, 2, 32, 12, 16, 4, start=17, true_len=16)

    def test_sliding_window(self):
        _chunk_case(16, 4, 2, 32, 12, 16, 4, start=33, true_len=16,
                    window=20)

    def test_mid_sequence_crossing_block_boundary(self):
        _chunk_case(16, 4, 4, 32, 12, 16, 4, start=26, true_len=9,
                    block_c=16)

    def test_block_c_padding(self):
        # block_c not dividing C, prefill-shaped start=0 call
        _chunk_case(20, 8, 2, 32, 12, 16, 4, start=0, true_len=20,
                    block_c=8)
        _chunk_case(24, 4, 2, 32, 12, 16, 4, start=0, true_len=17,
                    block_c=128)


class TestWrapperChecks:
    def test_rejects_bad_operands(self):
        q = torch.zeros(2, 4, 32)
        k = torch.zeros(5, 2, 8, 32)
        tables = torch.zeros(2, 3, dtype=torch.int32)
        lengths = torch.zeros(2, dtype=torch.int32)
        with pytest.raises(TypeError):
            tpa.paged_decode_attention(q, k, k, tables.long(), lengths)
        with pytest.raises(TypeError):
            tpa.paged_decode_attention(q, k.double(), k.double(), tables,
                                       lengths)
        with pytest.raises(ValueError):
            tpa.paged_decode_attention(q, k, k, tables, lengths.long())
        with pytest.raises(ValueError):
            tpa.paged_decode_attention(torch.zeros(2, 3, 32), k, k, tables,
                                       lengths)
        with pytest.raises(ValueError):
            tpa.paged_chunk_attention(q, k, k, tables, 0, 2)

    def test_plain_path_launches_nothing(self):
        tpa.reset_launch_counts()
        _decode_case(2, 4, 2, 32, 6, 8, 2, lengths=[3, 9])
        _chunk_case(8, 4, 2, 32, 6, 16, 2, start=0, true_len=8)
        assert tpa.LAUNCHES == {"paged_decode": 0, "paged_chunk": 0}
