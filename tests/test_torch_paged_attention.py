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


def _split_case(B, H, KVH, d, NB, BS, MB, lengths, splits, window=0,
                alibi=False, alibi_scale=1.0, alibi_bf16=False, seed=0):
    """The decode kernel's split-and-merge arithmetic in torch
    (``paged_decode_split_reference``, splits = (S, table blocks a split))
    against the JAX Pallas decode kernel in interpret mode and against the
    port's dense plain version, fp32 at 1e-5. Returns the partials."""
    rs = np.random.RandomState(seed)
    q = rs.standard_normal((B, H, d)).astype(np.float32)
    k, v = _pools(rs, NB, KVH, BS, d)
    tables = rs.randint(1, NB, (B, MB)).astype(np.int32)
    lengths = np.asarray(lengths, np.int32)
    tables[lengths == 0] = 0            # inactive slots: scratch block 0
    kw = dict(window=window, alibi_slopes=jpa.alibi_slopes(H) if alibi
              else None, alibi_scale=alibi_scale, alibi_bf16=alibi_bf16)
    tq, tk, tv, tt, tl = map(torch.from_numpy, (q, k, v, tables, lengths))
    got = tpa.paged_decode_split_reference(tq, tk, tv, tt, tl, splits=splits,
                                           **kw).numpy()
    jk = np.asarray(jpa.paged_decode_attention(
        *map(jnp.asarray, (q, k, v, tables, lengths)), interpret=True, **kw))
    np.testing.assert_allclose(got, jk, **TOL)
    plain = tpa.paged_decode_attention_reference(tq, tk, tv, tt, tl,
                                                 **kw).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    return tpa.paged_decode_split_partials(tq, tk, tv, tt, tl, splits=splits,
                                           **kw)


class TestDecodeSplitParity:
    """The split decode's plain version (partials + fixed-order merge)."""

    def test_splits_with_no_live_block(self):
        # one block a split: slot 0 lives in split 0 alone, slot 1 ends
        # in split 2 of 6
        m, l, acc = _split_case(3, 4, 2, 32, 24, 8, 6, lengths=[5, 17, 47],
                                splits=(6, 1))
        assert (m[0, :, 1:] == tpa.NEG_INF).all() and (l[0, :, 1:] == 0).all()
        assert (acc[1, :, 3:] == 0).all() and (l[1, :, :3] > 0).all()

    def test_inactive_slot(self):
        m, l, _ = _split_case(4, 4, 4, 32, 24, 8, 4, lengths=[0, 9, 0, 30],
                              splits=(2, 2))
        # length 0 attends position 0 only: split 0 holds it
        assert (l[0, :, 0] > 0).all() and (m[0, :, 1] == tpa.NEG_INF).all()

    def test_window_drops_whole_splits(self):
        m, _, _ = _split_case(2, 4, 2, 32, 40, 8, 16, lengths=[100, 127],
                              splits=(8, 2), window=20)
        # positions > L - 20 lie in splits 5-7 of 8
        assert (m[:, :, :5] == tpa.NEG_INF).all()
        _split_case(2, 4, 2, 32, 40, 8, 16, lengths=[100, 127],
                    splits=(3, 6), window=20)

    @pytest.mark.parametrize("bf16_scaled", [False, True])
    def test_alibi(self, bf16_scaled):
        kw = (dict(alibi_scale=1.0 / np.sqrt(32), alibi_bf16=True)
              if bf16_scaled else {})
        _split_case(2, 6, 6 if not bf16_scaled else 3, 32, 24, 8, 8,
                    lengths=[11, 60], splits=(4, 2), alibi=True, **kw)

    def test_gqa(self):
        _split_case(3, 8, 2, 32, 30, 8, 8, lengths=[5, 33, 63],
                    splits=(3, 3))

    def test_steps_span_blocks_and_splits_cut_blocks(self):
        # 4-position blocks: a 64-position step covers 16 of them
        _split_case(2, 4, 2, 32, 80, 4, 36, lengths=[70, 143],
                    splits=(2, 18), window=100)

    def test_kernel_rule_is_the_default(self):
        """``decode_splits`` from the table's shape alone; the default
        partials follow it (the Llama-2-7B serving table: 8 splits of 8
        blocks of 64)."""
        assert tpa.decode_splits(64, 64) == (8, 8)
        assert tpa.decode_splits(4, 8) == (1, 64)
        assert tpa.decode_splits(3, 1024) == (3, 1)
        m, _, _ = _split_case(2, 4, 2, 32, 12, 8, 4, lengths=[3, 20],
                              splits=None)
        assert m.shape == (2, 4, 1)

    def test_merge_of_one_split_is_the_direct_output(self):
        rs = np.random.RandomState(3)
        m = torch.from_numpy(rs.standard_normal((2, 3, 1)).astype(np.float32))
        l = torch.from_numpy(rs.uniform(1, 2, (2, 3, 1)).astype(np.float32))
        acc = torch.from_numpy(rs.standard_normal((2, 3, 1, 8))
                               .astype(np.float32))
        assert torch.equal(tpa.merge_decode_partials(m, l, acc, torch.float32),
                           acc[:, :, 0] / l)


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


def _chunk_operands(H, KVH, d, BS, dtype, offset=0):
    """(q, k, v) for the design rule: q (8, H, d); ``offset`` elements off
    an aligned base puts q's data off 16 bytes."""
    q = torch.zeros(8 * H * d + offset, dtype=dtype)[offset:].view(8, H, d)
    k = torch.zeros(3, KVH, BS, d, dtype=dtype)
    return q, k, torch.zeros_like(k)


@pytest.mark.parametrize("H,KVH,d,BS,dtype,offset,want", [
    (32, 32, 128, 64, torch.bfloat16, 0, "sm90"),   # Llama-2-7B pools
    (32, 8, 128, 64, torch.bfloat16, 0, "sm90"),    # Mixtral-8x7B: G = 4
    (32, 32, 64, 128, torch.bfloat16, 0, "sm90"),   # d = 64, BS = 128
    (8, 8, 32, 64, torch.bfloat16, 0, "simt"),      # d = 32
    (32, 32, 128, 16, torch.bfloat16, 0, "simt"),   # BS = 16
    (32, 32, 128, 64, torch.bfloat16, 1, "simt"),   # q off 16 bytes
    (128, 1, 64, 64, torch.bfloat16, 0, "simt"),    # G = 128: no q box
    (32, 32, 128, 64, torch.float32, 0, "fp32"),
    (8, 2, 32, 16, torch.float32, 0, "fp32"),
])
def test_chunk_design_rule(H, KVH, d, BS, dtype, offset, want):
    """``_chunk_design``: dtype, shapes and addresses only."""
    q, k, v = _chunk_operands(H, KVH, d, BS, dtype, offset)
    assert tpa._chunk_design(q, k, v) == want


def test_chunk_design_rule_scale_and_unknown_design():
    """A non-positive scale (it goes into the sm90 design's exp) takes the
    SIMT design; a design name the launcher does not know raises before
    anything launches."""
    q, k, v = _chunk_operands(32, 8, 128, 64, torch.bfloat16)
    assert tpa._chunk_design(q, k, v, 0.125) == "sm90"
    assert tpa._chunk_design(q, k, v, -0.125) == "simt"
    table = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown design"):
        tpa.paged_chunk_launch(q, k, v, table, 0, 8, 0.125, 0, "auto",
                               "wgmma")
    assert tpa.LAUNCHES["paged_chunk"] == 0


@pytest.mark.parametrize("C,H,KVH,MB,start,true_len,window,want", [
    (256, 32, 32, 64, 1000, 256, 0, 1),    # Llama-2-7B chunk: 64 items,
    (256, 32, 8, 128, 1000, 256, 0, 1),    # Mixtral-8x7B (G = 4): 10 tiles
    (256, 32, 32, 64, 0, 256, 0, 1),       # a prompt's first chunk: 2 tiles
    (256, 32, 32, 64, 2000, 256, 0, 2),    # 18 tiles
    (256, 32, 32, 64, 3800, 256, 0, 2),    # 32 tiles: 2 fill the SMs
    (64, 8, 8, 64, 3000, 64, 0, 3),        # 8 items of a 24-tile walk
    (64, 8, 8, 64, 3000, 64, 100, 1),      # a window: 2 tiles a walk
    (2048, 32, 32, 64, 0, 2048, 0, 1),     # a long prefill: 512 items
])
def test_chunk_splits(C, H, KVH, MB, start, true_len, window, want):
    """The sm90 chunk design's key-walk splits: shape and host ints only."""
    assert tpa.chunk_splits(C, H, KVH, 64, MB, start, true_len,
                            window) == want
