"""Paged (blocked-KV) attention: Hopper CUDA kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/paged_attention.py``; the kernels
are ``csrc/paged_attention.cu`` (design and bounds are noted there). Same
signatures and layouts as the JAX functions:

  q (B, H, d) / (C, H, d); pools k/v (NB, KVH, BS, d) heads-major;
  block tables int32, padded with scratch block 0.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
PyTorch version (``*_reference``); a CUDA tensor launches the kernel or
raises — there is no fallback. Each wrapper counts its kernel launches in
``LAUNCHES`` (plain-version calls are not counted).
"""

import ctypes
import math

import torch

NEG_INF = -1e30
# chunk-kernel q tile (chunk tokens per CTA) when the caller says "auto":
# a 256-token chunk then spreads over 4 tiles x KVH heads
PAGED_CHUNK_BLOCK_C = 64

LAUNCHES = {"paged_decode": 0, "paged_chunk": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def alibi_slopes(n_head):
    """Per-head ALiBi slopes (the bloom formula): for the leading
    power-of-two count cp, slope_h = 2^(-8(h+1)/cp); extra heads
    interleave the 2cp sequence: 2^(-4(2(h-cp)+1)/cp)."""
    cp = 2 ** math.floor(math.log2(n_head))
    return [2.0 ** (-8.0 * (h + 1) / cp) if h < cp
            else 2.0 ** (-4.0 * (2 * (h - cp) + 1) / cp)
            for h in range(n_head)]


def _check_bloom_slopes(slopes, n_head, name):
    """The kernel computes bloom-formula slopes from the head index, so
    it takes no others."""
    expect = alibi_slopes(n_head)
    if len(slopes) != n_head or any(
            abs(a - b) > 1e-6 * max(abs(b), 1e-9)
            for a, b in zip(slopes, expect)):
        raise NotImplementedError(
            f"{name} computes bloom-formula ALiBi slopes in-kernel; custom "
            "per-head slopes are not supported")

_builder = None


def kernel_builder():
    """The paged-attention library's builder; the first call builds the
    library (nvcc, see op_builder) and binds its ctypes signatures."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import PagedAttentionBuilder
        b = PagedAttentionBuilder()
        lib = b.load()
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paged_decode_launch.argtypes = [
            P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, F, I, F, I, P]
        lib.paged_decode_launch.restype = I
        lib.paged_chunk_launch.argtypes = [
            P, P, P, P, P, I, I, I, I, I, I, I, I, F, I, I, I, I, P]
        lib.paged_chunk_launch.restype = I
        _builder = b
    return _builder


def _kernels():
    return kernel_builder().load()


def _check_common(q, k_cache, v_cache, tables, name):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(
            f"{name}: want q 3-d and k/v pools of one 4-d shape, got "
            f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
            f"{tuple(v_cache.shape)}")
    H, d = q.shape[1], q.shape[2]
    KVH = k_cache.shape[1]
    if k_cache.shape[3] != d or H % KVH:
        raise ValueError(f"{name}: head dim / GQA group mismatch: q "
                         f"{tuple(q.shape)}, pools {tuple(k_cache.shape)}")
    if tables.dtype != torch.int32:
        raise TypeError(f"{name}: block tables must be int32, got "
                        f"{tables.dtype}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"{name}: q and pools must share a dtype, got "
                        f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")


def _check_cuda(tensors, q, name):
    dev = q.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}, got "
                             f"one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {q.shape[-1]}")


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


# ------------------------------------------------------------------ decode


def paged_decode_attention(q, k_cache, v_cache, block_tables, lengths, *,
                           scale=None, window=0, alibi_slopes=None,
                           alibi_scale=1.0, alibi_bf16=False):
    """One decode step of attention over a paged KV cache.

    q: (B, H, d); k_cache/v_cache: (NB, KVH, BS, d) with H % KVH == 0;
    block_tables: (B, MB) int32; lengths: (B,) int32 = the new token's
    position (attends cache slots 0..lengths inclusive). The new token's
    K/V must already be in the cache. ``window`` > 0 keeps the trailing
    ``window`` positions; ``alibi_slopes`` (len H, bloom formula only —
    the kernel computes them from the head index) adds slope_h * k_pos,
    optionally rounded through bf16 (``alibi_bf16``) and scaled
    (``alibi_scale``). Returns (B, H, d) in q's dtype."""
    name = "paged_decode_attention"
    _check_common(q, k_cache, v_cache, block_tables, name)
    B, H, d = q.shape
    NB, KVH, BS, _ = k_cache.shape
    MB = block_tables.shape[1]
    if block_tables.shape[0] != B or tuple(lengths.shape) != (B,) \
            or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: want tables (B, MB) and int32 lengths "
                         f"(B,), got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if alibi_slopes is not None:
        _check_bloom_slopes(alibi_slopes, H, name)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_cache, v_cache, block_tables, lengths, scale=scale,
            window=window, alibi_slopes=alibi_slopes,
            alibi_scale=alibi_scale, alibi_bf16=alibi_bf16)
    _check_cuda((q, k_cache, v_cache, block_tables, lengths), q, name)
    out = torch.empty_like(q)
    cp = float(2 ** math.floor(math.log2(H)))
    rc = _kernels().paged_decode_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, H, KVH, d, BS, MB, float(scale), int(window),
        int(alibi_slopes is not None), float(alibi_scale), int(alibi_bf16),
        cp, _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device)
        .cuda_stream)
    _raise_on(rc, name)
    LAUNCHES["paged_decode"] += 1
    return out


def paged_decode_attention_reference(q, k_cache, v_cache, block_tables,
                                     lengths, *, scale=None, window=0,
                                     alibi_slopes=None, alibi_scale=1.0,
                                     alibi_bf16=False):
    """Dense-gather plain version (the JAX reference's math, plus the
    kernel's alibi_scale/alibi_bf16 options)."""
    B, H, d = q.shape
    NB, KVH, BS, _ = k_cache.shape
    MB = block_tables.shape[1]
    S = MB * BS
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tb = block_tables.long()
    gk = k_cache.transpose(1, 2)[tb].reshape(B, S, KVH, d)
    gv = v_cache.transpose(1, 2)[tb].reshape(B, S, KVH, d)
    gk = gk.repeat_interleave(G, dim=2)
    gv = gv.repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), gk.float()) * scale
    kpos = torch.arange(S, device=q.device)
    if alibi_slopes is not None:
        sl = torch.tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        ab = sl[:, None] * kpos.float()[None, :]
        if alibi_bf16:
            ab = ab.to(torch.bfloat16).float()
        s = s + ab[None] * alibi_scale
    L = lengths.long()[:, None]
    mask = kpos[None, :] <= L
    if window:
        mask = mask & (kpos[None, :] > L - window)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", p, gv)


# ------------------------------------------------------------------- chunk


def paged_chunk_attention(q, k_cache, v_cache, table, start, true_len, *,
                          scale=None, window=0, block_c="auto"):
    """A C-token query chunk of ONE sequence attends causally over that
    sequence's paged KV blocks (the split-fuse chunk program and the
    bucketed prefill).

    q: (C, H, d) chunk queries at positions start..start+C-1 (rows past
    ``true_len`` are don't-care but finite); k_cache/v_cache: (NB, KVH,
    BS, d) pools that ALREADY hold the chunk's own K/V; table: (MB,)
    int32, scratch-padded; start/true_len: ints. ``window`` > 0 keeps
    the trailing window; ``block_c``: chunk tokens per CTA ("auto" =
    PAGED_CHUNK_BLOCK_C). Returns (C, H, d) in q's dtype."""
    name = "paged_chunk_attention"
    _check_common(q, k_cache, v_cache, table, name)
    C, H, d = q.shape
    NB, KVH, BS, _ = k_cache.shape
    if table.dim() != 1:
        raise ValueError(f"{name}: table must be (MB,), got "
                         f"{tuple(table.shape)}")
    MB = table.shape[0]
    start, true_len = int(start), int(true_len)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(
            q, k_cache, v_cache, table, start, true_len, scale=scale,
            window=window)
    _check_cuda((q, k_cache, v_cache, table), q, name)
    if BS % 16 or BS > 128:
        raise ValueError(f"{name}: kernel takes a KV block size that is a "
                         f"multiple of 16 up to 128, got {BS}")
    bc = PAGED_CHUNK_BLOCK_C if block_c == "auto" else int(block_c)
    bc = max(1, min(bc, C))
    rt = 16 if bc * (H // KVH) <= 16 else 64
    out = torch.empty_like(q)
    rc = _kernels().paged_chunk_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        table.data_ptr(), out.data_ptr(), C, H, KVH, d, BS, MB, start,
        true_len, float(scale), int(window), bc, rt, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, name)
    LAUNCHES["paged_chunk"] += 1
    return out


def paged_chunk_attention_reference(q, k_cache, v_cache, table, start,
                                    true_len, *, scale=None, window=0):
    """Dense-gather plain version: gather the sequence's whole key range
    through its table and run masked dense attention."""
    C, H, d = q.shape
    NB, KVH, BS, _ = k_cache.shape
    MB = table.shape[0]
    S = MB * BS
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    tb = table.long()
    gk = k_cache[tb].transpose(1, 2).reshape(S, KVH, d)
    gv = v_cache[tb].transpose(1, 2).reshape(S, KVH, d)
    gk = gk.repeat_interleave(G, dim=1)
    gv = gv.repeat_interleave(G, dim=1)
    s = torch.einsum("thd,shd->hts", q.float(), gk.float()) * scale
    q_pos = (int(start) + torch.arange(C, device=q.device))[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    ok = (k_pos <= q_pos) & (k_pos < int(start) + int(true_len))
    if window:
        ok = ok & (q_pos - k_pos < window)
    s = torch.where(ok[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("hts,shd->thd", p, gv)
