"""The Hopper kernels on the card (paged attention, flash attention forward
and backward (K1 and K2 also on their sm90 designs, K2-qmajor's bitwise
equal to K2's), fused CE, the MoE grouped matmuls and their backward, the
weight-only int8/int4 products K7 and K9, the LayerNorm forward and
backward and the RMSNorm forward K13, the layout-owning projection and its
dW K6 (K3, K6 and K8's grouped_tgmm in bf16 through their wgmma
designs, at ragged shapes and repeated bitwise; K4's split decode at
several split sizes, repeated bitwise), the
query-major flash backward and the block-sparse forward, dq and dk/dv
K11, the ring block step K10 and the blockwise int8 quantize /
dequantize K12, bitwise for K12), held
against their plain PyTorch versions at
small shapes (bf16 against the plain version in fp32
on the same inputs, chip_smoke.bf16_mismatch; fp32 at 1e-4).
Marked ``cuda``: skipped without an NVIDIA GPU; on the card run
``python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest``
(the repo's conftest sets up the JAX test mesh).
``chip_smoke.py`` repeats these checks at the serving shapes."""

import ctypes

import numpy as np
import pytest
import torch

import chip_smoke
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
from deepspeed_tpu_torch.ops.cuda import fused_ce as fce
from deepspeed_tpu_torch.ops import int8_weights as iw
from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
from deepspeed_tpu_torch.ops.cuda import layernorm as ln
from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
from deepspeed_tpu_torch.ops.cuda import quantization as qz
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, FixedSparsityConfig, SparseSelfAttention)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA C++ only)")


def _assert_matches(out, plain, q, k, v):
    """``plain(q, k, v)`` is the kernel's plain version on the same
    inputs; a bf16 output is held against it run in fp32."""
    if out.dtype == torch.bfloat16:
        ref = plain(q.float(), k.float(), v.float())
        assert chip_smoke.bf16_mismatch(out, ref) is None
    else:
        torch.testing.assert_close(out, plain(q, k, v), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,d,window,alibi",
                         [(4, 2, 32, 0, False), (8, 8, 64, 10, False),
                          (8, 2, 128, 0, False), (6, 6, 128, 0, True)])
def test_decode_kernel(dtype, H, KVH, d, window, alibi):
    rs = np.random.RandomState(0)
    B, BS, MB = 4, 16, 4
    NB = 1 + B * MB
    q = torch.from_numpy(rs.standard_normal((B, H, d))).to("cuda", dtype)
    k = torch.from_numpy(rs.standard_normal((NB, KVH, BS, d))).to(
        "cuda", dtype)
    v = torch.from_numpy(rs.standard_normal((NB, KVH, BS, d))).to(
        "cuda", dtype)
    tables = rs.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    lengths = np.array([0, 7, 33, 63], np.int32)
    tables[0] = 0
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lengths).cuda()
    kw = dict(window=window, alibi_slopes=pa.alibi_slopes(H) if alibi
              else None)
    n0 = pa.LAUNCHES["paged_decode"]
    out = pa.paged_decode_attention(q, k, v, tb, ln, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == n0 + 1
    _assert_matches(out, lambda q, k, v: pa.paged_decode_attention_reference(
        q, k, v, tb, ln, **kw), q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,d,window,alibi",
                         [(4, 2, 32, 0, False), (8, 8, 64, 10, False),
                          (8, 2, 128, 0, False), (6, 6, 128, 0, True),
                          (32, 1, 64, 40, False)])
def test_decode_kernel_splits(monkeypatch, dtype, H, KVH, d, window, alibi):
    """K4's split design (partials + merge) at 16, 32 and 64 positions a
    split over a 16-block table of 16 positions (a 64-position step then
    spans table blocks; G = 32 takes two CTAs of 16 heads): against the
    dense plain version and the split plain version on the same splits,
    every call on the split design, and repeated bitwise."""
    rs = np.random.RandomState(5)
    B, BS, MB = 5, 16, 16
    NB = 1 + B * MB
    q = _rand(rs, (B, H, d), dtype)
    k, v = (_rand(rs, (NB, KVH, BS, d), dtype) for _ in range(2))
    tables = rs.permutation(np.arange(1, NB)).reshape(B, MB).astype(np.int32)
    lengths = np.array([0, 7, 100, 255, 262], np.int32)  # 262: past the table
    tables[0] = 0
    tb = torch.from_numpy(tables).cuda()
    ln = torch.from_numpy(lengths).cuda()
    kw = dict(window=window, alibi_slopes=pa.alibi_slopes(H) if alibi
              else None)
    for positions in (16, 32, 64):
        monkeypatch.setattr(pa, "DECODE_SPLIT_POSITIONS", positions)
        pa.reset_launch_counts()
        outs = [pa.paged_decode_attention(q, k, v, tb, ln, **kw)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert pa.DESIGN_LAUNCHES["paged_decode"] == {"split": 2,
                                                      "single": 0}
        assert torch.equal(outs[0], outs[1])
        _assert_matches(outs[0], lambda q, k, v:
                        pa.paged_decode_attention_reference(
                            q, k, v, tb, ln, **kw), q, k, v)
        _assert_matches(outs[0], lambda q, k, v:
                        pa.paged_decode_split_reference(
                            q, k, v, tb, ln, **kw), q, k, v)


def test_decode_kernel_single_split_and_empty_window():
    """A table of one split writes the output in one launch ("single"); a
    window past every table position leaves a slot's output 0."""
    rs = np.random.RandomState(6)
    q = _rand(rs, (2, 4, 64), torch.bfloat16)
    k, v = (_rand(rs, (9, 2, 16, 64), torch.bfloat16) for _ in range(2))
    tb = torch.arange(1, 9, dtype=torch.int32, device="cuda").view(2, 4)
    ln = torch.tensor([40, 500], dtype=torch.int32, device="cuda")
    pa.reset_launch_counts()
    out = pa.paged_decode_attention(q, k, v, tb, ln, window=16)
    torch.cuda.synchronize()
    assert pa.DESIGN_LAUNCHES["paged_decode"] == {"split": 0, "single": 1}
    assert torch.all(out[1] == 0)
    # the JAX kernel's 0 (no live block); the dense plain version spreads
    # a softmax over all-masked scores there, so it holds slot 0 only
    _assert_matches(out, lambda q, k, v: pa.paged_decode_split_reference(
        q, k, v, tb, ln, window=16), q, k, v)
    _assert_matches(out[:1], lambda q, k, v:
                    pa.paged_decode_attention_reference(
                        q, k, v, tb, ln, window=16)[:1], q, k, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,d,start,true_len,window,block_c",
                         [(4, 2, 32, 0, 20, 0, 8), (4, 4, 64, 37, 9, 0, 16),
                          (8, 2, 128, 50, 24, 20, 64),
                          (4, 4, 128, 19, 24, 0, 4)])
def test_chunk_kernel(dtype, H, KVH, d, start, true_len, window, block_c):
    rs = np.random.RandomState(1)
    C, BS, MB = 24, 16, 6
    NB = 1 + MB
    q = torch.from_numpy(rs.standard_normal((C, H, d))).to("cuda", dtype)
    k = torch.from_numpy(rs.standard_normal((NB, KVH, BS, d))).to(
        "cuda", dtype)
    v = torch.from_numpy(rs.standard_normal((NB, KVH, BS, d))).to(
        "cuda", dtype)
    table = torch.from_numpy(
        rs.permutation(np.arange(1, NB)).astype(np.int32)).cuda()
    out = pa.paged_chunk_attention(q, k, v, table, start, true_len,
                                   window=window, block_c=block_c)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    _assert_matches(out[:true_len], lambda q, k, v:
                    pa.paged_chunk_attention_reference(
                        q, k, v, table, start, true_len,
                        window=window)[:true_len], q, k, v)


@pytest.mark.parametrize("H,KVH,d,BS,C,start,true_len,window", [
    (4, 4, 128, 64, 200, 100, 200, 0),      # MHA, a chunk after a prefix
    (8, 2, 128, 64, 256, 300, 100, 130),    # G = 4, pad rows, a window
    (4, 4, 64, 128, 130, 0, 130, 0),        # d = 64, BS = 128, first chunk
    (16, 1, 64, 64, 50, 37, 50, 0),         # G = 16: 8 tokens an item
    (4, 4, 128, 64, 256, 0, 20, 16),        # an item the window leaves empty
])
def test_chunk_sm90(H, KVH, d, BS, C, start, true_len, window):
    """K5's bf16 sm90 design: every call counted there, the real rows
    within the bf16 limits of the plain version in fp32, pad rows finite,
    repeated bitwise."""
    rs = np.random.RandomState(C + start)
    MB = (start + C + BS - 1) // BS + 1
    NB = 1 + MB
    bf = torch.bfloat16
    q = _rand(rs, (C, H, d), bf)
    k, v = _rand(rs, (NB, KVH, BS, d), bf), _rand(rs, (NB, KVH, BS, d), bf)
    table = torch.from_numpy(
        rs.permutation(np.arange(1, NB)).astype(np.int32)).cuda()
    pa.reset_launch_counts()
    runs = [pa.paged_chunk_attention(q, k, v, table, start, true_len,
                                     window=window) for _ in range(2)]
    torch.cuda.synchronize()
    assert pa.DESIGN_LAUNCHES["paged_chunk"] == {"sm90": 2, "simt": 0,
                                                 "fp32": 0}
    assert torch.equal(runs[0], runs[1])
    assert torch.isfinite(runs[0]).all()
    _assert_matches(runs[0][:true_len], lambda q, k, v:
                    pa.paged_chunk_attention_reference(
                        q, k, v, table, start, true_len,
                        window=window)[:true_len], q, k, v)


@pytest.mark.parametrize("H,KVH,d,start,true_len,window", [
    (4, 4, 128, 900, 200, 0), (8, 2, 64, 700, 150, 300)])
def test_chunk_sm90_splits(H, KVH, d, start, true_len, window):
    """K5's sm90 design at forced key-walk splits (fp32 partials merged in
    split order, more splits than some walks have tiles): each within the
    bf16 limits of the plain version in fp32, repeated bitwise."""
    rs = np.random.RandomState(start)
    C, BS = 200, 64
    MB = (start + C + BS - 1) // BS
    bf = torch.bfloat16
    q = _rand(rs, (C, H, d), bf)
    k, v = _rand(rs, (MB + 1, KVH, BS, d), bf), _rand(rs, (MB + 1, KVH, BS,
                                                           d), bf)
    table = torch.from_numpy(
        rs.permutation(np.arange(1, MB + 1)).astype(np.int32)).cuda()
    sc = 1 / np.sqrt(d)
    for S in (1, 2, 3, 16):
        runs = [pa.paged_chunk_launch(q, k, v, table, start, true_len, sc,
                                      window, "auto", "sm90", splits=S)
                for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1]), S
        assert torch.isfinite(runs[0]).all(), S
        _assert_matches(runs[0][:true_len], lambda q, k, v:
                        pa.paged_chunk_attention_reference(
                            q, k, v, table, start, true_len,
                            window=window)[:true_len], q, k, v)


def test_chunk_and_grouped_wq_launchers_refuse_a_wrong_design():
    """A design code K5's and K9's launchers do not know returns an error
    and launches nothing."""
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    q = torch.zeros(8, 4, 64, dtype=bf, device="cuda")
    k = torch.zeros(3, 4, 64, 64, dtype=bf, device="cuda")
    out = torch.full_like(q, 7.0)
    table = torch.tensor([1, 2], dtype=torch.int32, device="cuda")
    lib = pa.kernel_builder().load()
    for design in (3, -1):
        assert lib.paged_chunk_launch(
            q.data_ptr(), k.data_ptr(), k.data_ptr(), table.data_ptr(),
            out.data_ptr(), 8, 4, 4, 64, 64, 3, 2, 0, 8, 0.125, 0, 8, 16,
            design, 1, None, stream) != 0
    rs = np.random.RandomState(3)
    w = _quantized(rs, (2, 64, 32), 8)
    x = torch.ones(4, 64, dtype=bf, device="cuda")
    gs = torch.tensor([2, 2], dtype=torch.int32, device="cuda")
    h = torch.full((4, 32), 7.0, dtype=bf, device="cuda")
    a = gm.WqArgs(x.data_ptr(), w.q.data_ptr(), w.q.data_ptr(),
                  w.scale.data_ptr(), w.scale.data_ptr(), gs.data_ptr(),
                  h.data_ptr(), 4, 64, 32, 2, 1, 1)
    glib = gm.kernel_builder().load()
    for fn in (glib.grouped_gmm_wq_launch, glib.grouped_swiglu_up_wq_launch):
        for design in (3, -1):
            assert fn(ctypes.byref(a), design, 8, 16, stream) != 0
    torch.cuda.synchronize()
    assert bool((out == 7).all()) and bool((h == 7).all())


def test_swiglu_up_and_bsa_launchers_refuse_a_wrong_design():
    """A design code grouped_swiglu_up's and K11's launchers do not know
    (and sm90 for a K11 backward pass without its orders) returns an error
    and launches nothing."""
    stream = torch.cuda.current_stream().cuda_stream
    bf = torch.bfloat16
    x = torch.ones(4, 64, dtype=bf, device="cuda")
    w = torch.ones(2, 64, 32, dtype=bf, device="cuda")
    gs = torch.tensor([2, 2], dtype=torch.int32, device="cuda")
    h = torch.full((4, 32), 7.0, dtype=bf, device="cuda")
    a = gm._GroupedArgs(x.data_ptr(), w.data_ptr(), w.data_ptr(),
                        gs.data_ptr(), h.data_ptr(), *w.stride(), 4, 64, 32,
                        2, 1, 1, 0)
    glib = gm.kernel_builder().load()
    for design in (3, -1):
        assert glib.grouped_swiglu_up_launch(ctypes.byref(a), design, 16,
                                             stream) != 0
    q = torch.ones(2, 128, 64, dtype=bf, device="cuda")
    o = torch.full_like(q, 7.0)
    lse = torch.full((2, 128), 7.0, device="cuda")
    lists = bsa.lists_on(bsa.layout_lists(np.ones((2, 2, 2), bool), True,
                                          2, 2), "cuda")
    ba = bsa._BsaArgs()
    ba.BH, ba.H, ba.T, ba.D, ba.block, ba.causal = 2, 2, 128, 64, 64, 1
    ba.max_row, ba.max_col = (lists["rows"].shape[-1],
                              lists["cols"].shape[-1])
    ba.max_u = lists["urows"].shape[-1]
    counter = torch.zeros(1, dtype=torch.int32, device="cuda")
    for key, t in dict(q=q, k=q, v=q, o=o, lse=lse, dout=q, delta=lse,
                       dq=o, dk=o, dv=o, next_item=counter, **lists).items():
        setattr(ba, key, t.data_ptr())
    blib = bsa.kernel_builder().load()
    for design, which in ((3, 0), (-1, 0), (3, 1), (3, 2)):
        assert blib.bsa_launch(ctypes.byref(ba), design, which, stream) != 0
    ba.rorder = ba.corder = None
    for which in (1, 2):
        assert blib.bsa_launch(ctypes.byref(ba), 2, which, stream) != 0
    torch.cuda.synchronize()
    assert bool((h == 7).all()) and bool((o == 7).all())
    assert bool((lse == 7).all())


def test_cuda_tensor_never_takes_the_plain_path():
    q = torch.zeros(1, 4, 48, device="cuda")          # head dim 48: no kernel
    k = torch.zeros(3, 2, 16, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(
            q, k, k, torch.zeros(1, 2, dtype=torch.int32, device="cuda"),
            torch.zeros(1, dtype=torch.int32, device="cuda"))


def _rand(rs, shape, dtype):
    return torch.from_numpy(rs.standard_normal(shape)).to("cuda", dtype)


def _assert_close(out, ref, dtype):
    """``ref`` is the plain version run in fp32 on the same inputs."""
    if dtype == torch.bfloat16:
        assert chip_smoke.bf16_mismatch(out, ref) is None
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,d,causal,window",
                         [(2, 3, 64, 64, True, 0), (1, 2, 200, 32, True, 0),
                          (2, 2, 130, 128, False, 0),
                          (1, 4, 256, 64, True, 70)])
def test_flash_kernels(dtype, B, H, T, d, causal, window):
    rs = np.random.RandomState(2)
    q, k, v, do = (_rand(rs, (B, T, H, d), dtype) for _ in range(4))
    qs, ks, vs, dos = (x.transpose(1, 2) for x in (q, k, v, do))
    qs = qs * 0.3
    n0 = dict(fa.LAUNCHES)
    o, lse = fa.flash_forward(qs, ks, vs, causal=causal, window=window)
    dq, dk, dv = fa.flash_backward(qs, ks, vs, o, lse, dos, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_fwd"] == n0["flash_fwd"] + 1
    assert fa.LAUNCHES["flash_bwd"] == n0["flash_bwd"] + 1
    f32 = [x.float() for x in (qs, ks, vs)]
    ro, rlse = fa.flash_forward_reference(*f32, causal=causal, window=window)
    _assert_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-3)
    # the backward from the kernel's own o and lse, held against the plain
    # backward on the same (fp32-cast) inputs
    refs = fa.flash_backward_reference(*f32, o.float(), lse, dos.float(),
                                       causal=causal, window=window)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        if dtype == torch.bfloat16:
            assert chip_smoke.bf16_grad_mismatch(got, ref) is None, name
        else:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,H,T,d,causal,window,heads_major", [
    (2, 3, 256, 64, True, 0, False),        # the model's (B, T, H, d) strides
    (1, 2, 333, 128, True, 100, False),     # ragged T, a window
    (2, 2, 200, 64, False, 0, True),        # non-causal, heads-major
    (1, 4, 130, 128, True, 0, True),        # a 2-row last tile
    (2, 2, 640, 64, True, 200, False),      # window past one key tile
])
def test_flash_fwd_sm90(B, H, T, d, causal, window, heads_major):
    """K1's bf16 sm90 design (TMA + wgmma, online softmax on the
    accumulator fragments): o within the bf16 limits and lse within 1e-3
    of the plain version in fp32, every launch on sm90, repeated
    bitwise."""
    rs = np.random.RandomState(T + d)
    bf = torch.bfloat16
    shape = (B, H, T, d) if heads_major else (B, T, H, d)
    q, k, v = (_rand(rs, shape, bf) for _ in range(3))
    if not heads_major:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    q = fa.scale_q(q, d ** -0.5)
    fa.reset_launch_counts()
    runs = [fa.flash_forward(q, k, v, causal=causal, window=window)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.DESIGN_LAUNCHES["flash_fwd"] == {"sm90": 2, "mma_sync": 0,
                                               "fp32": 0}
    (o, lse), (o2, lse2) = runs
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert o.stride() == q.stride()
    ro, rlse = fa.flash_forward_reference(q.float(), k.float(), v.float(),
                                          causal=causal, window=window)
    _assert_close(o, ro, bf)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-3)


@pytest.mark.parametrize("B,H,T,d,causal,window,heads_major,dl", [
    (2, 3, 256, 64, True, 0, False, False),  # the model's strides
    (1, 2, 333, 128, True, 100, False, True),  # ragged T, window, dlse
    (2, 2, 200, 64, False, 0, True, True),   # non-causal, heads-major
    (1, 4, 130, 128, True, 0, True, False),  # a 2-row last tile
    (2, 2, 640, 64, True, 200, False, False),  # window past a key tile
])
def test_flash_bwd_sm90(B, H, T, d, causal, window, heads_major, dl):
    """K2's and K2-qmajor's bf16 sm90 designs (TMA + wgmma) against the
    plain backward in fp32 on the same inputs (each (b, h) slab's relative
    error norm, chip_smoke.bf16_grad_mismatch), every launch on sm90, each
    repeated bitwise, and K2-qmajor's output bitwise equal to K2's."""
    rs = np.random.RandomState(T + d)
    bf = torch.bfloat16
    shape = (B, H, T, d) if heads_major else (B, T, H, d)
    q, k, v, do = (_rand(rs, shape, bf) for _ in range(4))
    if not heads_major:
        q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
    q = fa.scale_q(q, d ** -0.5)
    o, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
    dlse = (torch.from_numpy(rs.randn(B, H, T).astype(np.float32) * 0.1)
            .cuda() if dl else None)
    kw = dict(causal=causal, window=window, dlse=dlse)
    fa.reset_launch_counts()
    kmajor = [fa.flash_backward(q, k, v, o, lse, do, **kw)
              for _ in range(2)]
    qmajor = [fa.flash_backward_qmajor(q, k, v, o, lse, do, **kw)
              for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("flash_bwd", "flash_bwd_qmajor"):
        assert fa.DESIGN_LAUNCHES[name] == {"sm90": 2, "mma_sync": 0,
                                            "fp32": 0}
    for runs in (kmajor, qmajor):
        assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert all(torch.equal(a, b) for a, b in zip(kmajor[0], qmajor[0]))
    refs = fa.flash_backward_reference(*(x.float() for x in (q, k, v, o)),
                                       lse, do.float(), **kw)
    for name, got, ref in zip(("dq", "dk", "dv"), kmajor[0], refs):
        assert got.stride() == {"dq": q, "dk": k, "dv": v}[name].stride()
        assert chip_smoke.bf16_grad_mismatch(got, ref) is None, name


def test_flash_bwd_launchers_refuse_a_wrong_design():
    """A design code the backward launchers do not know, and the sm90
    design on operands it does not take (d = 32), return an error and
    launch nothing; the wrappers raise on a launcher's error."""
    lib = fa.kernel_builder().load()
    stream = torch.cuda.current_stream().cuda_stream
    q = torch.zeros(1, 2, 64, 32, dtype=torch.bfloat16, device="cuda")
    lse = torch.zeros(1, 2, 64, device="cuda")
    delta, acc = torch.zeros_like(lse), torch.zeros(2, 2, 128, 32,
                                                    device="cuda")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    a = fa._args(1, 2, 64, 32, True, 0, q=q, k=q, v=q, o=q, lse=lse,
                 dout=q, delta=delta, dq=dq, dk=dk, dv=dv, acc=acc)
    counter = torch.zeros(2, dtype=torch.int32, device="cuda")
    for design in (3, -1, 2):
        assert lib.flash_bwd_launch(ctypes.byref(a), design,
                                    counter.data_ptr(), stream) != 0
        assert lib.flash_bwd_qmajor_launch(ctypes.byref(a), design,
                                           stream) != 0
    torch.cuda.synchronize()
    assert torch.equal(counter, torch.zeros_like(counter))
    fa._bwd_design, real = (lambda *_a, **_k: "sm90"), fa._bwd_design
    try:
        with pytest.raises(RuntimeError, match="sm90"):
            fa.flash_backward(q, q, q, q, lse, q)
    finally:
        fa._bwd_design = real


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,D,V", [(100, 64, 200), (256, 128, 1000)])
def test_fused_ce_kernel(dtype, N, D, V):
    rs = np.random.RandomState(3)
    h = _rand(rs, (N, D), dtype)
    w = (_rand(rs, (V, D), torch.float32) * 0.1).to(dtype)
    t = torch.from_numpy(rs.randint(-3, V + 3, N)).cuda()
    fce.reset_launch_counts()
    logits, logz, gold = fce.unembed_logits_stats(h, w, t)
    torch.cuda.synchronize()
    assert fce.LAUNCHES["fused_ce"] == 1
    design = "sm90" if dtype == torch.bfloat16 else "fp32"
    assert fce.DESIGN_LAUNCHES["fused_ce"][design] == 1
    rl, rz, rg = fce.unembed_logits_stats_reference(h.float(), w.float(), t)
    _assert_close(logits, rl, dtype)
    torch.testing.assert_close(logz, rz, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gold, rg, rtol=1e-4, atol=1e-4)
    again = fce.unembed_logits_stats(h, w, t)
    assert all(torch.equal(a, b) for a, b in zip((logits, logz, gold), again))


@pytest.mark.parametrize("N,D,V", [(1000, 256, 5000), (300, 64, 50000),
                                   (129, 1024, 513)])
def test_fused_ce_sm90_ragged(N, D, V):
    """The bf16 design (wgmma tiles of 128 rows x 256 vocab columns, then
    the merge) at N and V that cut tiles, targets outside [0, V) and in the
    ragged last vocab tile: logits against the plain version in fp32, logz
    and gold at chip_smoke.CE_STAT_ATOL and against the tiled plain
    version (the same two passes), a bitwise repeat."""
    rs = np.random.RandomState(N)
    h = _rand(rs, (N, D), torch.bfloat16)
    w = (_rand(rs, (V, D), torch.float32) * 0.05).to(torch.bfloat16)
    t = rs.randint(0, V, N)
    t[:3] = [-1, V, V + 11]
    t[3:20] = V - 1 - rs.randint(0, V % fce.SM90_BLOCK_V or 256, 17)
    t = torch.from_numpy(t).cuda()
    fce.reset_launch_counts()
    got = fce.unembed_logits_stats(h, w, t)
    again = fce.unembed_logits_stats(h, w, t)
    torch.cuda.synchronize()
    assert fce.DESIGN_LAUNCHES["fused_ce"] == {"sm90": 2, "fp32": 0}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = fce.unembed_logits_stats_reference(h.float(), w.float(), t)
    tiled = fce.unembed_logits_stats_tiled_reference(
        h.float(), w.float(), t, fce.SM90_BLOCK_V)
    assert chip_smoke.bf16_mismatch(got[0], ref[0]) is None
    for a, b, c in zip(got[1:], ref[1:], tiled[1:]):
        assert (a - b).abs().max().item() <= chip_smoke.CE_STAT_ATOL
        assert (a - c).abs().max().item() <= chip_smoke.CE_STAT_ATOL
    assert (got[2][:3] == 0).all()


def test_training_kernels_never_take_the_plain_path():
    q = torch.zeros(1, 2, 16, 48, device="cuda")   # head dim 48: no kernel
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_forward(q, q, q)
    h = torch.zeros(4, 12, device="cuda")           # D not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        fce.unembed_logits_stats(h, h, torch.zeros(4, dtype=torch.long,
                                                   device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,sizes", [
    (192, 128, 256, [50, 0, 120, 22]),      # uneven + an empty group
    (192, 128, 256, [192, 0, 0, 0]),        # every row on one expert
    (192, 128, 256, [0, 0, 0, 0]),          # all groups empty
    (192, 128, 256, [40, 30, 0, 10]),       # a tail of 112 rows
    (16, 256, 320, [2, 3, 1, 2, 4, 1, 2, 1]),   # decode: BM = 16
    (100, 100, 90, [30, 20, 10, 35]),       # ragged K and N
])
def test_grouped_kernels(dtype, M, K, N, sizes):
    rs = np.random.RandomState(4)
    E = len(sizes)
    x = _rand(rs, (M, K), dtype)
    w1, w3 = ((_rand(rs, (E, K, N), torch.float32) * 0.1).to(dtype)
              for _ in range(2))
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    n0 = dict(gm.LAUNCHES)
    out = gm.grouped_matmul(x, w1, gs)
    h = gm.grouped_swiglu_up(x, w1, w3, gs)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["grouped_gmm"] == n0["grouped_gmm"] + 1
    assert gm.LAUNCHES["grouped_swiglu_up"] == n0["grouped_swiglu_up"] + 1
    live = sum(sizes)
    assert torch.all(out[live:] == 0) and torch.all(h[live:] == 0)
    f32 = [t.float() for t in (x, w1, w3)]
    refs = (gm.grouped_matmul_reference(f32[0], f32[1], gs),
            gm.grouped_swiglu_up_reference(*f32, gs))
    for got, ref in zip((out, h), refs):
        if live:
            _assert_close(got[:live], ref[:live], dtype)


@pytest.mark.parametrize("M,K,N,sizes", [
    (1000, 136, 72, [10, 500, 1, 400]),      # groups under a tile, a 1-row group, ragged K, N
    (777, 256, 520, [130, 0, 300, 200]),     # boundaries off 128, empty expert, 147-row tail
    (640, 128, 256, [0, 640, 0, 0]),         # one group holds every row
    (300, 1032, 8, [100, 100, 100]),         # K past 1024, N = 8
    (512, 64, 264, [0, 0, 0, 0]),            # every group empty: all rows 0
])
@pytest.mark.parametrize("view", [False, True])
def test_grouped_gmm_sm90(M, K, N, sizes, view):
    """grouped_gmm's bf16 sm90 design (TMA + wgmma, each row visit resolved
    to its expert's segment on the device) for the forward (w with a unit n
    stride) and the dx product on a transposed view (a unit k stride): the
    rows inside the groups within the bf16 limits of the plain version in
    fp32, the rows past them exactly 0, every launch on sm90 and repeated
    bitwise."""
    rs = np.random.RandomState(M + K + view)
    bf = torch.bfloat16
    E = len(sizes)
    x = _rand(rs, (M, K), bf)
    if view:
        w = (_rand(rs, (E, N, K), torch.float32) * 0.1).to(bf).transpose(1, 2)
    else:
        w = (_rand(rs, (E, K, N), torch.float32) * 0.1).to(bf)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    gm.reset_launch_counts()
    outs = [gm.grouped_matmul(x, w, gs) for _ in range(2)]
    torch.cuda.synchronize()
    assert gm.DESIGN_LAUNCHES["grouped_gmm"] == {"sm90": 2, "mma_sync": 0,
                                                 "fp32": 0}
    assert torch.equal(outs[0], outs[1])
    live = sum(sizes)
    assert torch.all(outs[0][live:] == 0)
    if live:
        ref = gm.grouped_matmul_reference(x.float(), w.float(), gs)
        _assert_close(outs[0][:live], ref[:live], bf)


@pytest.mark.parametrize("M,K,N,sizes", [
    (16, 512, 384, [2, 3, 1, 2, 4, 1, 2, 1]),      # decode: row tile 16
    (512, 512, 256, [70, 60, 64, 58, 66, 62, 64, 68]),  # chunk: row tile 80
    (512, 256, 384, [100, 0, 50, 30, 120, 80, 0, 132]),  # empty groups, 2 runs
    (512, 256, 384, [0, 0, 0, 512, 0, 0, 0, 0]),   # one expert holds every row
    (512, 256, 384, [0] * 8),                      # every group empty
    (512, 256, 384, [40, 60, 0, 20, 100, 0, 80, 50]),  # a 162-row tail
    (700, 320, 128, [300, 200, 100, 100]),         # row tile 128
    (100, 136, 72, [10, 50, 1, 30]),               # N under one 128 tile, ragged
])
def test_grouped_swiglu_up_sm90(M, K, N, sizes):
    """grouped_swiglu_up's bf16 sm90 design (the transposed product on
    wgmma, K9's runs): every call counted there, within the bf16 limits of
    the plain version in fp32, rows past the groups exactly 0, repeated
    bitwise; the mma_sync design on the same inputs holds too."""
    rs = np.random.RandomState(M + K + N)
    bf = torch.bfloat16
    E = len(sizes)
    x = _rand(rs, (M, K), bf)
    w1, w3 = ((_rand(rs, (E, K, N), torch.float32) * 0.1).to(bf)
              for _ in range(2))
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    gm.reset_launch_counts()
    outs = [gm.grouped_swiglu_up(x, w1, w3, gs) for _ in range(2)]
    old = gm._swiglu_up(x, w1, w3, gs, design="mma_sync")
    torch.cuda.synchronize()
    assert gm.DESIGN_LAUNCHES["grouped_swiglu_up"] == {
        "sm90": 2, "mma_sync": 1, "fp32": 0}
    assert torch.equal(outs[0], outs[1])
    live = sum(sizes)
    assert torch.all(outs[0][live:] == 0) and torch.all(old[live:] == 0)
    if live:
        ref = gm.grouped_swiglu_up_reference(x.float(), w1.float(),
                                             w3.float(), gs)
        _assert_close(outs[0][:live], ref[:live], bf)
        _assert_close(old[:live], ref[:live], bf)


def test_grouped_swiglu_up_sm90_control():
    """A swapped 64-feature half of w1 (as a box descriptor that read the
    other consumer's half would give) fails the check the kernel passes."""
    rs = np.random.RandomState(12)
    bf = torch.bfloat16
    x = _rand(rs, (64, 256), bf)
    w1, w3 = ((_rand(rs, (2, 256, 256), torch.float32) * 0.1).to(bf)
              for _ in range(2))
    gs = torch.tensor([30, 34], dtype=torch.int32, device="cuda")
    h = gm.grouped_swiglu_up(x, w1, w3, gs)
    ref = gm.grouped_swiglu_up_reference(x.float(), w1.float(), w3.float(),
                                         gs)
    assert chip_smoke.bf16_mismatch(h, ref) is None
    swapped = torch.cat([w1[..., 64:128], w1[..., :64], w1[..., 128:]], -1)
    bad = gm.grouped_swiglu_up_reference(x.float(), swapped.float(),
                                         w3.float(), gs)
    assert chip_smoke.bf16_mismatch(bad.to(bf), ref) is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_matmul_transposed_view(dtype):
    """w as a transposed (E, N, K) view goes through the strided loads."""
    rs = np.random.RandomState(5)
    x = _rand(rs, (96, 80), dtype)
    w = (_rand(rs, (3, 72, 80), torch.float32) * 0.1).to(dtype)
    gs = torch.tensor([30, 0, 50], dtype=torch.int32, device="cuda")
    out = gm.grouped_matmul(x, w.transpose(1, 2), gs)
    torch.cuda.synchronize()
    ref = gm.grouped_matmul_reference(x.float(), w.float().transpose(1, 2),
                                      gs)
    _assert_close(out[:80], ref[:80], dtype)
    assert torch.all(out[80:] == 0)


def test_grouped_kernels_never_take_the_plain_path():
    x = torch.zeros(4, 16, device="cuda", dtype=torch.float16)
    gs = torch.tensor([4], dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gm.grouped_matmul(x, torch.zeros(1, 16, 8, device="cuda",
                                         dtype=torch.float16), gs)


def _slab_close(out, ref, dtype):
    """Per leading-dim slab: bf16 within chip_smoke.BF16_REL_NORM of the
    fp32 plain version, fp32 at 1e-4; an all-zero slab exactly 0."""
    if dtype == torch.bfloat16:
        assert chip_smoke.slab_rel_norm(out, ref) <= chip_smoke.BF16_REL_NORM
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,sizes", [
    (256, 128, 192, [50, 0, 120, 22]),      # empty group, 64-row tail
    (300, 100, 90, [0, 0, 300, 0]),         # one expert holds all rows
    (64, 64, 64, [0, 0, 0]),                # every group empty
    (1000, 136, 72, [10, 500, 1, 400]),     # ragged K and N
    (0, 64, 64, [0, 0]),                    # no rows at all
])
def test_grouped_tgmm_kernel(dtype, M, K, N, sizes):
    rs = np.random.RandomState(6)
    x, dy = _rand(rs, (M, K), dtype), _rand(rs, (M, N), dtype)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    n0 = gm.LAUNCHES["grouped_tgmm"]
    out = gm.grouped_tgmm(x, dy, gs)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["grouped_tgmm"] == n0 + 1
    assert out.shape == (len(sizes), K, N) and out.dtype == dtype
    for e, n in enumerate(sizes):
        if n == 0:
            assert torch.all(out[e] == 0)
    _slab_close(out, gm.grouped_tgmm_reference(x.float(), dy.float(), gs),
                dtype)


@pytest.mark.parametrize("M,K,N,sizes", [
    (1000, 136, 72, [10, 500, 1, 400]),      # a group under 64 rows, 1-row group
    (777, 256, 520, [130, 0, 300, 200]),     # boundaries off 64, empty, 147-row tail
    (640, 128, 256, [0, 640, 0, 0]),         # one group holds every row
    (300, 1032, 8, [100, 100, 100]),         # K past one 1024 row band, N = 8
    (96, 8, 264, [33, 31, 32]),              # K = 8, N past one 256 tile
])
def test_grouped_tgmm_sm90(M, K, N, sizes):
    """grouped_tgmm's bf16 sm90 design (TMA + wgmma, each expert's row range
    resolved on the device, x's rows past it zeroed in shared memory) at
    ragged group boundaries and tiles: every slab within the bf16 relative
    error norm of the plain version in fp32, an empty expert exactly 0,
    every launch on sm90, and repeated bitwise."""
    rs = np.random.RandomState(M + K)
    bf = torch.bfloat16
    x, dy = _rand(rs, (M, K), bf), _rand(rs, (M, N), bf)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    gm.reset_launch_counts()
    outs = [gm.grouped_tgmm(x, dy, gs) for _ in range(2)]
    torch.cuda.synchronize()
    assert gm.DESIGN_LAUNCHES["grouped_tgmm"] == {"sm90": 2, "mma_sync": 0,
                                                  "fp32": 0}
    assert torch.equal(outs[0], outs[1])
    for e, n in enumerate(sizes):
        if n == 0:
            assert torch.all(outs[0][e] == 0)
    _slab_close(outs[0], gm.grouped_tgmm_reference(x.float(), dy.float(), gs),
                bf)


def test_grouped_tgmm_design_split():
    """The expert-bias row sums (x = ones (M, 1)) and a 200-byte row take
    mma_sync; fp32 takes the fp32 instance."""
    rs = np.random.RandomState(8)
    gs = torch.tensor([40, 0, 60], dtype=torch.int32, device="cuda")
    dy = _rand(rs, (100, 64), torch.bfloat16)
    gm.reset_launch_counts()
    sums = gm.grouped_tgmm(torch.ones(100, 1, dtype=torch.bfloat16,
                                      device="cuda"), dy, gs)
    x100 = _rand(rs, (100, 100), torch.bfloat16)
    odd = gm.grouped_tgmm(x100, dy, gs)
    f32 = gm.grouped_tgmm(x100.float(), dy.float(), gs)
    torch.cuda.synchronize()
    assert gm.DESIGN_LAUNCHES["grouped_tgmm"] == {"sm90": 0, "mma_sync": 2,
                                                  "fp32": 1}
    _slab_close(sums, gm.grouped_tgmm_reference(
        torch.ones(100, 1, device="cuda"), dy.float(), gs), torch.bfloat16)
    _slab_close(odd, gm.grouped_tgmm_reference(x100.float(), dy.float(), gs),
                torch.bfloat16)
    _slab_close(f32, gm.grouped_tgmm_reference(x100.float(), dy.float(), gs),
                torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_autograd_on_the_card(dtype):
    """grouped_matmul and grouped_swiglu gradients on CUDA tensors (dx
    through the k-major transposed view, dw through tgmm) against the plain
    pieces in fp32 on the same inputs."""
    rs = np.random.RandomState(7)
    M, K, N, E = 200, 128, 256, 4
    gs = torch.tensor([60, 0, 90, 30], dtype=torch.int32, device="cuda")
    x = _rand(rs, (M, K), dtype).requires_grad_()
    w = (_rand(rs, (E, K, N), torch.float32) * 0.1).to(dtype).requires_grad_()
    cot = _rand(rs, (M, N), dtype)
    n0 = dict(gm.LAUNCHES)
    dx, dw = torch.autograd.grad(gm.grouped_matmul(x, w, gs), (x, w), cot)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["grouped_gmm"] == n0["grouped_gmm"] + 2
    assert gm.LAUNCHES["grouped_tgmm"] == n0["grouped_tgmm"] + 1
    xf, wf, cf = x.detach().float(), w.detach().float(), cot.float()
    _assert_close(dx[:180], gm.grouped_matmul_reference(
        cf, wf.transpose(1, 2), gs)[:180], dtype)
    _slab_close(dw, gm.grouped_tgmm_reference(xf, cf, gs), dtype)
    w1, w3 = ((_rand(rs, (E, K, N), torch.float32) * 0.1).to(dtype)
              .requires_grad_() for _ in range(2))
    w2 = (_rand(rs, (E, N, K), torch.float32) * 0.1).to(dtype)
    w2.requires_grad_()
    cot = _rand(rs, (M, K), dtype)
    ps = (x, w1, w3, w2)
    got = torch.autograd.grad(gm.grouped_swiglu(*ps, gs), ps, cot)
    ref = gm.grouped_swiglu_backward_reference(
        *(t.detach().float() for t in ps), gs, cot.float())
    for a, b in zip(got, ref):
        if dtype == torch.bfloat16:
            assert chip_smoke.slab_rel_norm(a[None], b[None]) <= \
                chip_smoke.BF16_GRAD_REL_NORM
        else:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_tgmm_never_takes_the_plain_path(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain tgmm")

    monkeypatch.setattr(gm, "grouped_tgmm_reference", plain)
    x = torch.ones(8, 16, device="cuda")
    gs = torch.tensor([8], dtype=torch.int32, device="cuda")
    assert float(gm.grouped_tgmm(x, x, gs)[0, 0, 0]) == 8.0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gm.grouped_tgmm(x.half(), x.half(), gs)


def _quantized(rs, shape, bits):
    return iw.quantize_leaf(_rand(rs, shape, torch.float32) * 0.1, bits)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,sizes", [
    (192, 128, 256, [50, 0, 120, 22]),      # uneven + an empty group
    (192, 128, 256, [192, 0, 0, 0]),        # every row on one expert
    (192, 128, 256, [40, 30, 0, 10]),       # a tail of 112 rows
    (16, 256, 320, [2, 3, 1, 2, 4, 1, 2, 1]),   # decode: BM = 16
    (100, 100, 90, [30, 20, 10, 35]),       # ragged K and N
])
def test_grouped_wq_kernels(bits, dtype, M, K, N, sizes):
    rs = np.random.RandomState(8)
    E = len(sizes)
    x = _rand(rs, (M, K), dtype)
    w1, w3 = (_quantized(rs, (E, K, N), bits) for _ in range(2))
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    n0 = dict(gm.LAUNCHES)
    h = gm.grouped_swiglu_up_wq(x, w1, w3, gs)
    out = gm.grouped_matmul_wq(x, w1, gs)
    torch.cuda.synchronize()
    assert gm.LAUNCHES["grouped_swiglu_up_wq"] == \
        n0["grouped_swiglu_up_wq"] + 1
    assert gm.LAUNCHES["grouped_gmm_wq"] == n0["grouped_gmm_wq"] + 1
    live = sum(sizes)
    assert torch.all(out[live:] == 0) and torch.all(h[live:] == 0)
    refs = (gm.grouped_swiglu_up_wq_reference(x.float(), w1, w3, gs),
            gm.grouped_matmul_wq_reference(x.float(), w1, gs))
    for got, ref in zip((h, out), refs):
        _assert_close(got[:live], ref[:live], dtype)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,K,N", [
    (8, 1, 256, 320),       # decode rows: BM = 16
    (1, 40, 128, 192),
    (2, 150, 200, 96),
    (1, 5, 100, 90),        # ragged K and N
])
def test_wq_matmul_kernel(bits, dtype, B, T, K, N):
    rs = np.random.RandomState(9)
    x = _rand(rs, (B, T, K), dtype)
    w = _quantized(rs, (K, N), bits)
    n0 = mm.LAUNCHES["wq_matmul"]
    out = mm.wq_matmul(x, w)
    out_t = mm.wq_matmul(x.transpose(1, 2), w, x_t=True, out_t=True)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["wq_matmul"] == n0 + 2
    ref = mm.wq_matmul_reference(x.float(), w)
    _assert_close(out, ref, dtype)
    _assert_close(out_t.transpose(1, 2), ref, dtype)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N,splits", [
    (8, 4096, 1024, None),     # decode rows: row tile 8, K split by the plan
    (256, 1024, 768, None),    # a chunk: row tile 256
    (1, 512, 256, None),
    (200, 640, 384, None),     # ragged rows, 10 k slices
    (300, 600, 256, None),     # two row tiles, a 24-deep last k slice
    (256, 1024, 768, 1),       # one split: the scale in the main kernel
    (64, 1024, 512, 5),        # uneven split ranges, then the merge
])
def test_wq_matmul_sm90(bits, M, K, N, splits):
    """K7's bf16 sm90 design: every call on sm90, within the bf16 limits
    of the plain version in fp32 and of the split-order plain version,
    repeated bitwise."""
    rs = np.random.RandomState(M + K + bits)
    x = _rand(rs, (M, K), torch.bfloat16)
    w = _quantized(rs, (K, N), bits)
    mm.reset_launch_counts()
    if splits is None:
        runs = [mm.wq_matmul(x, w) for _ in range(2)]
        assert mm.DESIGN_LAUNCHES["wq_matmul"] == {"sm90": 2, "mma_sync": 0,
                                                   "fp32": 0}
        splits = mm.wq_plan(M, K, N, torch.cuda.get_device_properties(
            0).multi_processor_count)[1]
    else:
        runs = [mm._launch_wq_sm90(x, w, splits) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    _assert_close(runs[0], mm.wq_matmul_reference(x.float(), w),
                  torch.bfloat16)
    _assert_close(runs[0], mm.wq_matmul_split_reference(x.float(), w,
                                                        splits),
                  torch.bfloat16)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N,sizes", [
    (16, 256, 384, [2, 3, 1, 2, 4, 1, 2, 1]),   # decode: row tile 16
    (192, 512, 256, [50, 0, 120, 22]),          # row tile 80, an empty group
    (192, 512, 256, [192, 0, 0, 0]),            # every row on one expert
    (162, 256, 384, [40, 30, 0, 10]),           # a 82-row tail
    (700, 320, 128, [300, 200, 100, 100]),      # row tile 128
])
def test_grouped_wq_sm90(bits, M, K, N, sizes):
    """K9's bf16 sm90 design: every call counted there, within the bf16
    limits of the plain version in fp32, rows past the groups exactly 0,
    repeated bitwise."""
    rs = np.random.RandomState(M + K + bits)
    E = len(sizes)
    x = _rand(rs, (M, K), torch.bfloat16)
    w1, w3 = (_quantized(rs, (E, K, N), bits) for _ in range(2))
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    gm.reset_launch_counts()
    runs = [(gm.grouped_swiglu_up_wq(x, w1, w3, gs),
             gm.grouped_matmul_wq(x, w1, gs)) for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("grouped_swiglu_up_wq", "grouped_gmm_wq"):
        assert gm.DESIGN_LAUNCHES[name] == {"sm90": 2, "mma_sync": 0,
                                            "fp32": 0}, name
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    h, out = runs[0]
    live = sum(sizes)
    assert torch.all(out[live:] == 0) and torch.all(h[live:] == 0)
    refs = (gm.grouped_swiglu_up_wq_reference(x.float(), w1, w3, gs),
            gm.grouped_matmul_wq_reference(x.float(), w1, gs))
    for got, ref in zip((h, out), refs):
        _assert_close(got[:live], ref[:live], torch.bfloat16)


def test_wq_kernels_never_take_the_plain_path(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took a plain wq product")

    for name in ("grouped_matmul_wq_reference",
                 "grouped_swiglu_up_wq_reference"):
        monkeypatch.setattr(gm, name, plain)
    monkeypatch.setattr(mm, "_plain_rows", plain)
    rs = np.random.RandomState(10)
    w = _quantized(rs, (2, 32, 64), 4)
    x = torch.ones(8, 32, device="cuda")
    gs = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    assert gm.grouped_swiglu_wq(x, w, w, _quantized(rs, (2, 64, 32), 8),
                                gs).shape == (8, 32)
    assert mm.wq_matmul(x, iw.Int4Weight(w.q[0], w.scale[0])).shape == \
        (8, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gm.grouped_matmul_wq(x.half(), w, gs)


def _sums_close(out, ref, dtype):
    """Sums over rows (dscale, dbias, dW): bf16 by relative error norm
    (chip_smoke.BF16_REL_NORM), fp32 at 1e-4."""
    if dtype == torch.bfloat16:
        assert chip_smoke.rel_norm(out, ref) <= chip_smoke.BF16_REL_NORM
    else:
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("N,D", [(37, 128), (200, 384), (130, 1024),
                                 (65, 2048)])   # D > 1024: rows re-read
def test_layernorm_kernels(dtype, s_dtype, N, D):
    rs = np.random.RandomState(11)
    x = _rand(rs, (N, D), dtype) * 2 + 0.5
    s = (1 + 0.1 * _rand(rs, (D,), torch.float32)).to(s_dtype)
    b = (0.1 * _rand(rs, (D,), torch.float32)).to(s_dtype)
    dy = _rand(rs, (N, D), dtype)
    n0 = dict(ln.LAUNCHES)
    y = ln._fwd(x, s, b, 1e-5)
    dx, ds, db = ln._bwd(x, s, dy, 1e-5)
    dx2, ds2, db2 = ln._bwd(x, s, dy, 1e-5)
    torch.cuda.synchronize()
    assert ln.LAUNCHES["layernorm_fwd"] == n0["layernorm_fwd"] + 1
    assert ln.LAUNCHES["layernorm_bwd"] == n0["layernorm_bwd"] + 2
    assert y.dtype == dx.dtype == dtype and ds.dtype == db.dtype == s_dtype
    xf, sf, bf, dyf = (t.float() for t in (x, s, b, dy))
    _assert_close(y, ln.layernorm_reference(xf, sf, bf), dtype)
    rdx, rds, rdb = ln.layernorm_bwd_reference(xf, sf, dyf)
    _assert_close(dx, rdx, dtype)
    _sums_close(ds, rds, s_dtype)
    _sums_close(db, rdb, s_dtype)
    # no atomics: a second run is bitwise the first
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2) and \
        torch.equal(db, db2)


@pytest.mark.parametrize("dtype,s_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("N,D", [(37, 128), (1000, 1024), (77, 4096)])
def test_rmsnorm_kernel(dtype, s_dtype, N, D):
    """K13's RMSNorm against its plain version on the same inputs; one
    launch a call; a second run is bitwise the first; D > 1024 re-reads
    the row."""
    rs = np.random.RandomState(13)
    x = _rand(rs, (N, D), dtype) * 2 + 0.5
    s = (1 + 0.1 * _rand(rs, (D,), torch.float32)).to(s_dtype)
    n0 = ln.LAUNCHES["rmsnorm_fwd"]
    y = ln.fused_rmsnorm(x, s)
    y2 = ln.fused_rmsnorm(x.view(N, 1, D), s).view(N, D)
    torch.cuda.synchronize()
    assert ln.LAUNCHES["rmsnorm_fwd"] == n0 + 2
    assert y.dtype == dtype and torch.equal(y, y2)
    _assert_close(y, ln.rmsnorm_reference(x.float(), s.float()), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layernorm_autograd_on_the_card(dtype):
    rs = np.random.RandomState(12)
    x = _rand(rs, (3, 50, 256), dtype).requires_grad_()
    s = (1 + 0.1 * _rand(rs, (256,), torch.float32)).to(dtype)
    b = (0.1 * _rand(rs, (256,), torch.float32)).to(dtype)
    ps = [x, s.requires_grad_(), b.requires_grad_()]
    cot = _rand(rs, (3, 50, 256), dtype)
    for fn, fwd in ((ln.fused_layernorm, 1), (ln.layernorm_fused_bwd, 0)):
        n0 = dict(ln.LAUNCHES)
        got = torch.autograd.grad(fn(*ps), ps, cot)
        torch.cuda.synchronize()
        assert ln.LAUNCHES["layernorm_fwd"] == n0["layernorm_fwd"] + fwd
        assert ln.LAUNCHES["layernorm_bwd"] == n0["layernorm_bwd"] + 1
        ref = ln.layernorm_bwd_reference(
            x.detach().float().reshape(-1, 256), s.detach().float(),
            cot.float().reshape(-1, 256))
        _assert_close(got[0].reshape(-1, 256), ref[0], dtype)
        _sums_close(got[1], ref[1], dtype)
        _sums_close(got[2], ref[2], dtype)


def test_layernorm_never_takes_the_plain_path(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took a plain LayerNorm")

    for name in ("layernorm_reference", "layernorm_bwd_reference"):
        monkeypatch.setattr(ln, name, plain)
    x = torch.ones(4, 128, device="cuda").requires_grad_()
    s = torch.ones(128, device="cuda")
    y = ln.fused_layernorm(x, s, s)
    y.sum().backward()
    assert float(y[0, 0]) == 1.0 and float(x.grad.abs().max()) < 1e-3
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ln.fused_layernorm(x.detach().half(), s.half(), s.half())


def _k6_reference_grads(x, w, dy, x_t, out_t):
    """(dx, dW) of ``mlp_matmul`` in fp32 on the same inputs."""
    xf, wf, dyf = x.float(), w.float(), dy.float()
    return (mm.mm_reference(dyf, wf, out_t, True, x_t, torch.float32),
            mm.dw_reference(xf, dyf, x_t, out_t, torch.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_t,out_t", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("B,T,K,M", [(2, 64, 128, 256), (3, 200, 136, 96),
                                     (1, 130, 512, 384)])
def test_mlp_matmul_kernels(dtype, x_t, out_t, B, T, K, M):
    rs = np.random.RandomState(13)
    x = _rand(rs, (B, K, T) if x_t else (B, T, K), dtype).requires_grad_()
    w = (_rand(rs, (K, M), torch.float32) / np.sqrt(K)).to(dtype)
    w.requires_grad_()
    dy = _rand(rs, (B, M, T) if out_t else (B, T, M), dtype)
    mm.reset_launch_counts()
    y = mm.mlp_matmul(x, w, x_t=x_t, out_t=out_t)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["mlp_mm"] == 2
    assert mm.LAUNCHES["mlp_dw"] == 1
    if dtype == torch.float32:
        assert mm.DESIGN_LAUNCHES["mlp_mm"]["fp32"] == 2
    elif T % 8 == 0:    # every stride a whole number of 16 bytes
        assert mm.DESIGN_LAUNCHES["mlp_mm"]["sm90"] == 2
        assert mm.DESIGN_LAUNCHES["mlp_dw"]["sm90"] == 1
    assert y.shape == ((B, M, T) if out_t else (B, T, M))
    assert gx.shape == x.shape and gw.shape == w.shape
    _assert_close(y, mm.mlp_matmul_reference(x.detach().float(), w.float(),
                                             x_t, out_t), dtype)
    rdx, rdw = _k6_reference_grads(x.detach(), w.detach(), dy, x_t, out_t)
    _assert_close(gx, rdx, dtype)
    _sums_close(gw, rdw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_matmul_strided_views_and_unfused_dw(dtype):
    """Operands whose rows are not whole 16-byte vectors (element staging),
    a transposed view of w, and fuse_dw=False (no dW kernel)."""
    rs = np.random.RandomState(14)
    x = _rand(rs, (2, 70, 129), dtype)[:, :, 1:].requires_grad_()
    w = (_rand(rs, (96, 128), torch.float32) / 12).to(dtype).t()
    w.requires_grad_()
    dy = _rand(rs, (2, 70, 96), dtype)
    n0 = dict(mm.LAUNCHES)
    y = mm.mlp_matmul(x, w, fuse_dw=False)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["mlp_mm"] == n0["mlp_mm"] + 2
    assert mm.LAUNCHES["mlp_dw"] == n0["mlp_dw"]
    _assert_close(y, mm.mlp_matmul_reference(x.detach().float(), w.float()),
                  dtype)
    rdx, rdw = _k6_reference_grads(x.detach(), w.detach(), dy, False, False)
    _assert_close(gx, rdx, dtype)
    _sums_close(gw, rdw, dtype)


@pytest.mark.parametrize("x_t,out_t", [(False, False), (True, False),
                                       (False, True), (True, True)])
@pytest.mark.parametrize("P,T,K,M", [(3, 200, 136, 264), (1, 8, 1032, 8),
                                     (2, 136, 64, 520)])
def test_k6_sm90_ragged(x_t, out_t, P, T, K, M):
    """K6's bf16 sm90 design at I, J and C that are multiples of 8 but not of
    the 128 x 256 tile or the 64-deep slice (forward (I, J, C) = (T, M, K),
    dx (T, K, M), dW (K, M, T)): forward and dx against the plain version
    in fp32, dW by relative error norm, each launch on sm90 and repeated
    bitwise."""
    rs = np.random.RandomState(T + K)
    bf = torch.bfloat16
    x = _rand(rs, (P, K, T) if x_t else (P, T, K), bf)
    w = (_rand(rs, (K, M), torch.float32) / np.sqrt(K)).to(bf)
    dy = _rand(rs, (P, M, T) if out_t else (P, T, M), bf)
    mm.reset_launch_counts()
    outs = [(mm._mm(x, w, x_t, False, out_t, bf),
             mm._mm(dy, w, out_t, True, x_t, bf),
             mm._dw(x, dy, x_t, out_t, bf)) for _ in range(2)]
    torch.cuda.synchronize()
    assert mm.DESIGN_LAUNCHES == {"mlp_mm": {"sm90": 4, "mma_sync": 0,
                                             "fp32": 0},
                                  "mlp_dw": {"sm90": 2, "mma_sync": 0,
                                             "fp32": 0},
                                  "wq_matmul": {"sm90": 0, "mma_sync": 0,
                                                "fp32": 0}}
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    y, dx, dw = outs[0]
    xf, wf, dyf = x.float(), w.float(), dy.float()
    _assert_close(y, mm.mm_reference(xf, wf, x_t, False, out_t,
                                     torch.float32), bf)
    _assert_close(dx, mm.mm_reference(dyf, wf, out_t, True, x_t,
                                      torch.float32), bf)
    _sums_close(dw, mm.dw_reference(xf, dyf, x_t, out_t, torch.float32), bf)


@pytest.mark.parametrize("P,T", [(0, 64), (2, 0)])
def test_k6_dw_over_no_rows(P, T):
    """dW over no (p, n) rows is zeros (a bf16 operand TMA cannot address:
    the mma_sync design)."""
    bf = torch.bfloat16
    x = torch.ones(P, T, 128, dtype=bf, device="cuda")
    dy = torch.ones(P, T, 64, dtype=bf, device="cuda")
    mm.reset_launch_counts()
    dw = mm._dw(x, dy, False, False, bf)
    torch.cuda.synchronize()
    assert mm.DESIGN_LAUNCHES["mlp_dw"]["mma_sync"] == 1
    assert dw.shape == (128, 64) and not dw.any()


def test_k6_one_unaligned_row():
    """One bf16 row of K = 100 (200 bytes: a tensor map cannot hold that
    row stride, even for one row): forward, dx and dW take the mma_sync
    design and match the plain version in fp32."""
    rs = np.random.RandomState(100)
    bf = torch.bfloat16
    x = _rand(rs, (1, 1, 100), bf)
    w = (_rand(rs, (100, 64), torch.float32) / 10).to(bf)
    dy = _rand(rs, (1, 1, 64), bf)
    mm.reset_launch_counts()
    y = mm._mm(x, w, False, False, False, bf)
    dx = mm._mm(dy, w, False, True, False, bf)
    dw = mm._dw(x, dy, False, False, bf)
    torch.cuda.synchronize()
    assert mm.DESIGN_LAUNCHES == {"mlp_mm": {"sm90": 0, "mma_sync": 2,
                                             "fp32": 0},
                                  "mlp_dw": {"sm90": 0, "mma_sync": 1,
                                             "fp32": 0},
                                  "wq_matmul": {"sm90": 0, "mma_sync": 0,
                                                "fp32": 0}}
    xf, wf, dyf = x.float(), w.float(), dy.float()
    _assert_close(y, mm.mm_reference(xf, wf, False, False, False,
                                     torch.float32), bf)
    _assert_close(dx, mm.mm_reference(dyf, wf, False, True, False,
                                      torch.float32), bf)
    _sums_close(dw, mm.dw_reference(xf, dyf, False, False, torch.float32),
                bf)


def test_mlp_matmul_never_takes_the_plain_path(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took a plain K6 product")

    for name in ("mm_reference", "dw_reference", "mlp_matmul_reference"):
        monkeypatch.setattr(mm, name, plain)
    x = torch.ones(1, 8, 32, device="cuda").requires_grad_()
    w = torch.ones(32, 16, device="cuda").requires_grad_()
    y = mm.mlp_matmul(x, w)
    y.sum().backward()
    assert float(y[0, 0, 0]) == 32.0 and float(w.grad[0, 0]) == 8.0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mm.mlp_matmul(x.detach().half(), w.detach().half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,T,d,causal,window,dlse",
                         [(2, 3, 64, 64, True, 0, False),
                          (1, 2, 200, 32, True, 0, True),
                          (2, 2, 130, 128, False, 0, False),
                          (1, 4, 256, 64, True, 70, True)])
def test_flash_bwd_qmajor_kernel(dtype, B, H, T, d, causal, window, dlse):
    rs = np.random.RandomState(5)
    q, k, v, do = (_rand(rs, (B, T, H, d), dtype).transpose(1, 2)
                   for _ in range(4))
    q = q * 0.3
    o, lse = fa.flash_forward(q, k, v, causal=causal, window=window)
    dl = (torch.from_numpy(rs.standard_normal((B, H, T))).float().cuda()
          if dlse else None)
    n0 = dict(fa.LAUNCHES)
    got = fa.flash_backward_qmajor(q, k, v, o, lse, do, causal=causal,
                                   window=window, dlse=dl)
    again = fa.flash_backward_qmajor(q, k, v, o, lse, do, causal=causal,
                                     window=window, dlse=dl)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_bwd_qmajor"] == n0["flash_bwd_qmajor"] + 2
    assert fa.LAUNCHES["flash_bwd"] == n0["flash_bwd"]
    kmajor = fa.flash_backward(q, k, v, o, lse, do, causal=causal,
                               window=window, dlse=dl)
    refs = fa.flash_bwd_qmajor_reference(
        *(x.float() for x in (q, k, v, o)), lse, do.float(), causal=causal,
        window=window, dlse=dl)
    for name, g, a, km, ref in zip(("dq", "dk", "dv"), got, again, kmajor,
                                   refs):
        assert torch.equal(g, a), f"{name} not bitwise repeatable"
        # the same tile products, accumulated in the same order
        assert torch.equal(g, km), f"{name} differs from the k-major K2"
        if dtype == torch.bfloat16:
            assert chip_smoke.bf16_grad_mismatch(g, ref) is None, name
        else:
            torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-4)


def _bsa_case(rs, cfg, causal, B, T, dtype):
    H, d = cfg.num_heads, 32
    q, k, v, do = (_rand(rs, (B * H, T, d), dtype) for _ in range(4))
    q = q * 0.3
    n = T // cfg.block
    lists = bsa.lists_on(bsa.layout_lists(cfg.make_layout(T), causal, n, n),
                         "cuda")
    return q, k, v, do, lists


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("kind,causal", [("fixed", True), ("fixed", False),
                                         ("bigbird", False)])
def test_block_sparse_kernels(dtype, block, kind, causal):
    rs = np.random.RandomState(6)
    T = 8 * block
    cfg = (FixedSparsityConfig(num_heads=2, block=block,
                               different_layout_per_head=True,
                               attention="unidirectional" if causal
                               else "bidirectional")
           if kind == "fixed" else
           BigBirdSparsityConfig(num_heads=2, block=block))
    q, k, v, do, lists = _bsa_case(rs, cfg, causal, 2, T, dtype)
    n0 = dict(bsa.LAUNCHES)
    o, lse = bsa.bsa_forward(q, k, v, lists, block, causal)
    grads = bsa.bsa_backward(q, k, v, o, lse, do, lists, block, causal)
    o2, _ = bsa.bsa_forward(q, k, v, lists, block, causal)
    grads2 = bsa.bsa_backward(q, k, v, o, lse, do, lists, block, causal)
    torch.cuda.synchronize()
    assert {n: bsa.LAUNCHES[n] - n0[n] for n in n0} == {
        "bsa_fwd": 2, "bsa_dq": 2, "bsa_dkv": 2}
    assert torch.equal(o, o2)
    f32 = [x.float() for x in (q, k, v)]
    ro, rlse = bsa.bsa_forward_reference(*f32, lists, block, causal)
    _assert_close(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-3)
    refs = bsa.bsa_backward_reference(*f32, o.float(), lse, do.float(),
                                      lists, block, causal)
    for name, g, a, ref in zip(("dq", "dk", "dv"), grads, grads2, refs):
        assert torch.equal(g, a), f"{name} not bitwise repeatable"
        if dtype == torch.bfloat16:
            assert chip_smoke.bf16_grad_mismatch(g[:, None], ref[:, None]) \
                is None, name
        else:
            torch.testing.assert_close(g, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_fully_masked_rows_zero(dtype):
    rs = np.random.RandomState(7)
    B, T, H, d = 2, 64, 4, 32
    q, k, v = (_rand(rs, (B, T, H, d), dtype) for _ in range(3))
    layout = np.zeros((H, 2, 2), bool)
    layout[:, 1, :] = True              # rows in block 0 fully masked
    qs, ks, vs = (x.requires_grad_() for x in (q, k, v))
    out = bsa.block_sparse_attention(qs, ks, vs, layout, 32)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[:, :32]) == 0
    assert float(out[:, 32:].detach().abs().max()) > 0
    assert torch.count_nonzero(qs.grad[:, :32]) == 0


def _bsa_sm90_layout(kind, H, T):
    """(layout, causal) of the sm90 forward's card cases at block 64."""
    if kind == "fixed":
        return FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=4,
                                   num_global_blocks=1,
                                   attention="unidirectional").make_layout(T), True
    if kind == "bigbird":
        return BigBirdSparsityConfig(num_heads=H, block=64).make_layout(T), False
    # (a)'s layout with rows 1 and 4 empty (the odd one of pair 0, the even
    # one of pair 2) and an odd number of blocks
    lay = FixedSparsityConfig(num_heads=H, block=64, num_local_blocks=2,
                              num_global_blocks=1,
                              attention="unidirectional").make_layout(T)
    lay[:, 1] = False
    lay[:, 4] = False
    return lay, True


@pytest.mark.parametrize("kind,T,d", [
    ("fixed", 2048, 64),      # (a)'s layout, 32 blocks
    ("bigbird", 2048, 64),    # (b)'s layout, non-causal
    ("fixed", 1024, 128),     # d = 128
    ("bigbird", 1024, 128),
    ("empty_rows", 320, 64),  # rows with no present block, n = 5 (odd)
    ("empty_rows", 320, 128),
])
def test_bsa_fwd_sm90(kind, T, d):
    """K11's bf16 sm90 forward (the union walk on TMA + wgmma): every call
    counted there, within the bf16 limits of the plain version in fp32,
    lse within 1e-3, rows with no present block o = 0 and lse = -1e30,
    repeated bitwise; the backward on its o and lse holds against the plain
    backward."""
    rs = np.random.RandomState(T + d)
    H, B, n = 2, 3, T // 64
    lay, causal = _bsa_sm90_layout(kind, H, T)
    lists = bsa.lists_on(bsa.layout_lists(lay, causal, n, n), "cuda")
    q, k, v, do = (_rand(rs, (B * H, T, d), torch.bfloat16)
                   for _ in range(4))
    q = q * (d ** -0.5)
    bsa.reset_launch_counts()
    o, lse = bsa.bsa_forward(q, k, v, lists, 64, causal)
    o2, lse2 = bsa.bsa_forward(q, k, v, lists, 64, causal)
    torch.cuda.synchronize()
    assert bsa.DESIGN_LAUNCHES["bsa_fwd"] == {"sm90": 2, "mma_sync": 0,
                                              "fp32": 0}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    f32 = [x.float() for x in (q, k, v)]
    ro, rlse = bsa.bsa_forward_reference(*f32, lists, 64, causal)
    _assert_close(o, ro, torch.bfloat16)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-3)
    empty = lists["row_cnt"].cpu()[torch.arange(B * H) % H] == 0
    rows = empty.repeat_interleave(64, dim=1).cuda()
    if kind == "empty_rows":
        assert bool(rows.any())
    assert torch.count_nonzero(o[rows]) == 0
    assert bool((lse[rows] == bsa.NEG_INF).all())
    grads = bsa.bsa_backward(q, k, v, o, lse, do, lists, 64, causal)
    refs = bsa.bsa_backward_reference(*f32, o.float(), lse, do.float(),
                                      lists, 64, causal)
    for name, g, ref in zip(("dq", "dk", "dv"), grads, refs):
        assert chip_smoke.bf16_grad_mismatch(g[:, None], ref[:, None]) \
            is None, name


def test_bsa_fwd_sm90_control():
    """The union walk built from a row list short by its last id (as a walk
    that dropped a listed block would give) fails the check the kernel
    passes on the whole lists."""
    rs = np.random.RandomState(13)
    T, n = 1024, 16
    lay, causal = _bsa_sm90_layout("fixed", 2, T)
    host = bsa.layout_lists(lay, causal, n, n)
    lists = bsa.lists_on(host, "cuda")
    q, k, v = (_rand(rs, (4, T, 64), torch.bfloat16) for _ in range(3))
    q = q * 0.125
    ro, _ = bsa.bsa_forward_reference(*(x.float() for x in (q, k, v)),
                                      lists, 64, causal)
    o, _ = bsa.bsa_forward(q, k, v, lists, 64, causal)
    assert chip_smoke.bf16_mismatch(o, ro) is None
    short = {key: a.copy() for key, a in host.items()}
    short["row_cnt"][0, n - 1] -= 1
    cut, _ = bsa.bsa_forward(q, k, v, bsa.lists_on(short, "cuda"), 64,
                             causal)
    assert chip_smoke.bf16_mismatch(cut, ro) is not None


def _bsa_bwd_layout(kind, H, T):
    """(layout, causal) of the sm90 backward's card cases at block 64: the
    forward's, key blocks no query block attends, and lists of one, two
    and three entries."""
    n = T // 64
    if kind == "empty_cols":
        lay, causal = _bsa_sm90_layout("fixed", H, T)
        lay[:, :, 2] = False
        lay[:, :, 5] = False
        return lay, causal
    if kind == "short_lists":           # non-causal, n = 8
        lay = np.broadcast_to(np.eye(n, dtype=bool), (H, n, n)).copy()
        lay[:, 3, [0, 5, 7]] = True     # row 3: 4 entries
        lay[:, 6, [1, 2]] = True        # row 6: 3
        lay[:, [1, 2], 4] = True        # column 4: 3
        return lay, False
    return _bsa_sm90_layout(kind, H, T)


def _bsa_bwd_case(kind, T, d, seed):
    rs = np.random.RandomState(seed)
    H, B, n = 2, 3, T // 64
    lay, causal = _bsa_bwd_layout(kind, H, T)
    lists = bsa.lists_on(bsa.layout_lists(lay, causal, n, n), "cuda")
    q, k, v, do = (_rand(rs, (B * H, T, d), torch.bfloat16)
                   for _ in range(4))
    q = q * (d ** -0.5)
    o, lse = bsa.bsa_forward(q, k, v, lists, 64, causal)
    return q, k, v, o, lse, do, lists, causal


@pytest.mark.parametrize("kind,T,d", [
    ("fixed", 2048, 64),        # (a)'s layout: the causal diagonal
    ("bigbird", 2048, 64),      # (b)'s: non-causal, odd lists
    ("fixed", 1024, 128),       # d = 128
    ("bigbird", 1024, 128),
    ("empty_rows", 320, 64),    # rows with no present block, n = 5
    ("empty_rows", 320, 128),
    ("empty_cols", 512, 64),    # key blocks no query block attends
    ("empty_cols", 512, 128),
    ("short_lists", 512, 64),   # lists of one, two and three entries
    ("short_lists", 512, 128),
])
def test_bsa_bwd_sm90(kind, T, d):
    """K11's bf16 sm90 dq and dk/dv (the split walk on TMA + wgmma): every
    call counted there, repeated bitwise, delta within 1e-4 and dq, dk, dv
    within the bf16 gradient limits of the plain versions in fp32; rows
    with no present block dq = 0, key blocks with none dk = dv = 0."""
    q, k, v, o, lse, do, lists, causal = _bsa_bwd_case(kind, T, d, T + d)
    H = lists["rows"].shape[0]
    assert bsa._bsa_bwd_design(q, k, v, do, 64, H, o) == "sm90"
    bsa.reset_launch_counts()
    dq, delta = bsa.bsa_dq(q, k, v, o, lse, do, lists, 64, causal)
    dk, dv = bsa.bsa_dkv(q, k, v, lse, delta, do, lists, 64, causal)
    dq2, delta2 = bsa.bsa_dq(q, k, v, o, lse, do, lists, 64, causal)
    dk2, dv2 = bsa.bsa_dkv(q, k, v, lse, delta2, do, lists, 64, causal)
    torch.cuda.synchronize()
    for name in ("bsa_dq", "bsa_dkv"):
        assert bsa.DESIGN_LAUNCHES[name] == {"sm90": 2, "mma_sync": 0,
                                             "fp32": 0}, name
    for a, b in ((dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)):
        assert torch.equal(a, b), "not bitwise repeatable"
    f32 = [x.float() for x in (q, k, v)]
    rdq, rdelta = bsa.bsa_dq_reference(*f32, o.float(), lse, do.float(),
                                       lists, 64, causal)
    rdk, rdv = bsa.bsa_dkv_reference(*f32, lse, rdelta, do.float(), lists,
                                     64, causal)
    torch.testing.assert_close(delta, rdelta, rtol=1e-4, atol=1e-4)
    for name, g, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        assert chip_smoke.bf16_grad_mismatch(g[:, None], ref[:, None]) \
            is None, name
    inst = torch.arange(q.shape[0]) % H
    for x, key in ((dq, "row_cnt"), (dk, "col_cnt"), (dv, "col_cnt")):
        empty = lists[key].cpu()[inst] == 0
        rows = empty.repeat_interleave(64, dim=1).cuda()
        if kind in ("empty_rows", "empty_cols") and key == (
                "row_cnt" if kind == "empty_rows" else "col_cnt"):
            assert bool(rows.any())
        assert torch.count_nonzero(x[rows]) == 0, key


@pytest.mark.parametrize("kind", ["fixed", "bigbird"])
def test_bsa_bwd_sm90_control(kind):
    """The sm90 dk/dv with one column list short by its last entry, and the
    sm90 dq with one row list short, fail the bf16 gradient check on that
    block's rows, which the whole lists pass (chip_smoke.bsa_bwd_controls)."""
    q, k, v, o, lse, do, lists, causal = _bsa_bwd_case(kind, 1024, 64, 14)
    f32 = [x.float() for x in (q, k, v)]
    rdq, rdelta = bsa.bsa_dq_reference(*f32, o.float(), lse, do.float(),
                                       lists, 64, causal)
    rdk, rdv = bsa.bsa_dkv_reference(*f32, lse, rdelta, do.float(), lists,
                                     64, causal)
    _, delta = bsa.bsa_dq(q, k, v, o, lse, do, lists, 64, causal)
    whys = chip_smoke.bsa_bwd_controls(bsa, q, k, v, o, lse, delta, do,
                                       lists, causal, (rdq, rdk, rdv))
    assert sorted(whys) == ["dk", "dq", "dv"]


def test_sparse_self_attention_kernel_matches_masked_dense():
    """fp32 on the card: the kernels give the masked-dense op's output and
    gradients."""
    rs = np.random.RandomState(8)
    q, k, v = (_rand(rs, (2, 256, 4, 32), torch.float32).requires_grad_()
               for _ in range(3))
    cfg = BigBirdSparsityConfig(num_heads=4, block=32)
    outs = []
    for use_kernel in (True, False):
        op = SparseSelfAttention(cfg, causal=True, use_kernel=use_kernel)
        o = op(q, k, v)
        outs.append((o,) + torch.autograd.grad(o.square().sum(), (q, k, v)))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_sparse_self_attention_call_makes_no_host_sync():
    """With its lists cached (under "cuda", which the call finds as
    q.device), a forward + backward call of the op runs under
    torch.cuda.set_sync_debug_mode("error")."""
    rs = np.random.RandomState(9)
    q, k, v, do = (_rand(rs, (2, 512, 4, 64), torch.bfloat16)
                   for _ in range(4))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    op = SparseSelfAttention(FixedSparsityConfig(num_heads=4, block=64),
                             causal=True)
    op.lists(512, "cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        o = op(q, k, v)
        torch.autograd.grad(o, (q, k, v), do)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_new_attention_kernels_never_take_the_plain_path(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took a plain version")

    for mod, names in ((fa, ("flash_bwd_qmajor_reference",
                             "flash_backward_reference")),
                       (bsa, ("bsa_forward_reference", "bsa_dq_reference",
                              "bsa_dkv_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    q = torch.ones(1, 64, 2, 32, device="cuda").requires_grad_()
    o = fa.flash_attention(q.permute(0, 2, 3, 1), q.permute(0, 2, 3, 1),
                           q.permute(0, 2, 3, 1), qkv_t=True,
                           bwd_qmajor=True)
    o.sum().backward()
    lay = np.ones((2, 2, 2), bool)
    o = bsa.block_sparse_attention(q, q, q, lay, 32, causal=True)
    o.sum().backward()
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="block"):
        bsa.block_sparse_attention(q, q, q, np.ones((2, 8, 8), bool), 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,C,d", [(4, 200, 64), (3, 130, 32),
                                    (2, 64, 128), (8, 1024, 64)])
def test_flash_block_fwd_kernel(dtype, BH, C, d):
    """K10 chained over a diagonal-causal pair and a full pair, in place on
    views of one state (the zigzag halves), against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(C)
    q, k1, v1, k2, v2 = (torch.randn(BH, C, d, generator=g,
                                     device="cuda").to(dtype)
                         for _ in range(5))
    q = fa.scale_q(q, d ** -0.5)
    big = fa.flash_block_state(BH, 2 * C, d, device="cuda")
    st = tuple(x[:, C:] for x in big)
    ref = fa.flash_block_state(BH, C, d, device="cuda")
    for k, v, causal in ((k1, v1, True), (k2, v2, False)):
        assert fa.flash_block_fwd(q, k, v, st, causal=causal) is st
        ref = fa.flash_block_fwd_reference(q.float(), k.float(), v.float(),
                                           ref, causal=causal)
    o, lse = fa.flash_block_finalize(st)
    ro, rlse = fa.flash_block_finalize(ref)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    if dtype == torch.bfloat16:
        assert chip_smoke.bf16_mismatch(o.to(dtype), ro) is None
    else:
        torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-4)
    assert torch.equal(big[1][:, :C], torch.zeros_like(big[1][:, :C]))


@pytest.mark.parametrize("BH,C,d", [(4, 200, 64), (2, 130, 128),
                                    (8, 1024, 64), (3, 64, 128)])
def test_flash_block_fwd_sm90(BH, C, d):
    """K10's bf16 sm90 design: a diagonal-causal pair then a full pair,
    chained on views of one state (the zigzag's late half), every launch
    on sm90, against the plain version in fp32 (the finalized o by the
    bf16 check, lse at 1e-4) and repeated bitwise."""
    g = torch.Generator(device="cuda").manual_seed(C + d)
    q, k1, v1, k2, v2 = (torch.randn(BH, C, d, generator=g,
                                     device="cuda").to(torch.bfloat16)
                         for _ in range(5))
    q = fa.scale_q(q, d ** -0.5)
    fa.reset_launch_counts()
    finals = []
    for _ in range(2):
        big = fa.flash_block_state(BH, 2 * C, d, device="cuda")
        st = tuple(x[:, C:] for x in big)
        for k, v, causal in ((k1, v1, True), (k2, v2, False)):
            fa.flash_block_fwd(q, k, v, st, causal=causal)
        finals.append((big, st))
    torch.cuda.synchronize()
    assert fa.DESIGN_LAUNCHES["flash_block_fwd"] == {
        "sm90": 4, "mma_sync": 0, "fp32": 0}
    (big, st), (big2, _) = finals
    assert all(torch.equal(a, b) for a, b in zip(big, big2))
    assert torch.equal(big[1][:, :C], torch.zeros_like(big[1][:, :C]))
    assert torch.equal(big[0][:, :C],
                       torch.full_like(big[0][:, :C], fa.NEG_INF))
    ref = fa.flash_block_state(BH, C, d, device="cuda")
    for k, v, causal in ((k1, v1, True), (k2, v2, False)):
        ref = fa.flash_block_fwd_reference(q.float(), k.float(), v.float(),
                                           ref, causal=causal)
    o, lse = fa.flash_block_finalize(st)
    ro, rlse = fa.flash_block_finalize(ref)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=1e-4)
    assert chip_smoke.bf16_mismatch(o.to(torch.bfloat16), ro) is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("R,P,block", [(1, 10_000_123, 2048), (3, 5000, 2048),
                                       (4, 333, 64), (1, 5, 2048)])
def test_quantize_kernels_bitwise(dtype, R, P, block):
    g = torch.Generator(device="cuda").manual_seed(P)
    x = (torch.randn(R, P + 7, generator=g, device="cuda") * 5).to(dtype)
    x = x[:, :P]                        # a row stride past the row
    x[0, :min(P, block)] = 0            # an all-zero block: scale 1
    q, s = qz.quantize_rows(x, block)
    rq, rs = qz.quantize_rows_reference(x, block)
    assert torch.equal(q, rq) and torch.equal(s, rs)
    for out in (torch.float32, dtype):
        assert torch.equal(qz.dequantize_rows(q, s, R, P, out),
                           qz.dequantize_rows_reference(q, s, R, P, out))
    assert torch.equal(
        qz.dequantize_rows(q, s, R, P, torch.float32, sum_rows=True),
        qz.dequantize_rows_reference(q, s, R, P, torch.float32,
                                     sum_rows=True))


def test_ring_and_quantize_kernels_never_take_the_plain_path(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took a plain version")

    monkeypatch.setattr(fa, "flash_block_fwd_reference", plain)
    monkeypatch.setattr(qz, "quantize_rows_reference", plain)
    monkeypatch.setattr(qz, "dequantize_rows_reference", plain)
    x = torch.randn(2, 64, 64, device="cuda")
    fa.flash_block_fwd(x, x, x, fa.flash_block_state(2, 64, 64, "cuda"))
    q, s, meta = qz.quantize_blockwise(x)
    qz.dequantize_blockwise(q, s, meta)
    torch.cuda.synchronize()


def test_mm_f32_gradient_on_the_card():
    """The bf16 full-logits head (``models/common.mm_f32``) backpropagates
    on the card: the gradient equals the CPU path's a.float() @ b.float()
    computed on the card."""
    from deepspeed_tpu_torch.models.common import mm_f32
    g = torch.Generator(device="cuda").manual_seed(0)
    a, b = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
            for s in ((64, 96), (96, 200)))
    gout = torch.randn(64, 200, generator=g, device="cuda")
    a1, b1 = a.clone().requires_grad_(), b.clone().requires_grad_()
    out = mm_f32(a1, b1.t().contiguous().t())
    assert out.dtype == torch.float32
    da, db = torch.autograd.grad(out, (a1, b1), gout)
    a2, b2 = a.clone().requires_grad_(), b.clone().requires_grad_()
    ra, rb = torch.autograd.grad(a2.float() @ b2.float(), (a2, b2), gout)
    torch.testing.assert_close(out, a.float() @ b.float(), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(da.float(), ra.float(), rtol=2 ** -7,
                               atol=1e-3)
    torch.testing.assert_close(db.float(), rb.float(), rtol=2 ** -7,
                               atol=1e-3)
