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

Head dims are 32, 64, 80, 96, 128 and 256 (fp32 at 256 raises where it
does not fit a CTA's shared memory: the decode ring always, the chunk
tiles above 64-position blocks). The chunk kernel has three designs
(``_chunk_design``): bf16 at d = 64 / 128 over 64- or 128-position
blocks goes to the Hopper kernel
(``paged_chunk_sm90_kernel``: wgmma + TMA, the pools read through the
table by TMA), other bf16 to the SIMT ``paged_chunk_kernel``, fp32 to its
fp32 instance; ``DESIGN_LAUNCHES["paged_chunk"]`` counts calls by design.

The decode kernel splits the cache (``decode_splits``: S runs of table
blocks from the table's shape alone) into fp32 partials that a second
kernel merges in split order; a table of one split is written directly.
``DESIGN_LAUNCHES["paged_decode"]`` counts calls by that rule ("split" /
"single"). ``paged_decode_split_partials`` and ``merge_decode_partials``
are the plain version of that arithmetic.

The serving programs resolve their levers per shape bucket through the
autotune winner cache (``resolve_paged_decode`` / ``resolve_paged_chunk``,
the JAX resolvers' contract, and their ``*_levers`` forms that add the
port's own levers): the decode kernel's split size (``split_positions``),
the chunk kernel's query tile (``block_c``, SIMT and fp32 designs) and
its key-walk splits (``splits``, sm90 design). A cold cache gives
``PAGED_DECODE_DEFAULTS`` / ``paged_chunk_tune_defaults()``: the shape
rules above.
"""

import ctypes
import functools
import math

import torch

NEG_INF = -1e30
# chunk-kernel q tile (chunk tokens per CTA) when the caller says "auto":
# a 256-token chunk then spreads over 4 tiles x KVH heads
PAGED_CHUNK_BLOCK_C = 64

# cache positions a decode split covers (rounded down to whole table
# blocks, at least one); a split size of 0 is the whole table (one split)
DECODE_SPLIT_POSITIONS = 512
# positions a step of the decode kernel's pipeline (16 keys a warp)
DECODE_STEP = 64

LAUNCHES = {"paged_decode": 0, "paged_chunk": 0}
DESIGN_LAUNCHES = {"paged_decode": {"split": 0, "single": 0},
                   "paged_chunk": {"sm90": 0, "simt": 0, "fp32": 0}}
# launches by the lever each ran with (what the winner cache steers): the
# decode's split count "S=<n>"; the chunk's key-walk splits "S=<n>" (sm90)
# or query tile "block_c=<n>" (SIMT, fp32)
LEVER_LAUNCHES = {"paged_decode": {}, "paged_chunk": {}}

# the chunk kernel's designs, as paged_chunk_launch's design codes
CHUNK_DESIGN_CODE = {"fp32": 0, "simt": 1, "sm90": 2}
# the sm90 chunk design's head dims and KV block sizes (one or two blocks
# make its 128-key tile), its items' folded rows, and its key-walk splits:
# at most CHUNK_MAX_SPLITS, each of at least CHUNK_SPLIT_TILES key tiles
CHUNK_SM90_HEAD_DIMS = (64, 128)
CHUNK_SM90_BLOCK_SIZES = (64, 128)
CHUNK_TILE = 128
CHUNK_MAX_SPLITS = 8
CHUNK_SPLIT_TILES = 8
CHUNK_SMS = 132               # H100 SXM; the wrapper reads the card's own

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# 80, 96 and 256 (phi-2, gpt-neox-20b, gpt-j-6b) on the decode kernel and
# the chunk kernel's SIMT / fp32 designs; the pools keep the model's d
_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
_TODO_F32_256 = "(ROADMAP Queue 2, K4 / K5 fp32 at d = 256)"
# a CTA's dynamic shared memory on the H100 (bytes)
_SMEM_LIMIT = 232448

# the autotune ops' cold-cache levers: the kernels, the shape rules
PAGED_DECODE_DEFAULTS = {"mode": "kernel",
                         "split_positions": DECODE_SPLIT_POSITIONS}


def paged_chunk_tune_defaults():
    """Cold-cache defaults of the 'paged_chunk' autotune op: the kernel,
    the SIMT / fp32 designs' query tile PAGED_CHUNK_BLOCK_C and the sm90
    design's key-walk splits by ``chunk_splits`` ("rule")."""
    return {"mode": "kernel", "block_c": PAGED_CHUNK_BLOCK_C,
            "splits": "rule"}


def resolve_paged_decode_levers(setting, B, MB, BS, KVH, G, d, dtype,
                                device=None):
    """(use_kernel, split_positions) of a decode step: ``setting`` is the
    engine's ``paged_kernel`` ("auto" | True | False); "auto" takes the
    winner cache's mode for this decode bucket, True / False force it. The
    split size has no knob of its own: it comes from the winner cache
    whenever the kernel runs (the cold answer is DECODE_SPLIT_POSITIONS)."""
    if setting is False:
        return False, PAGED_DECODE_DEFAULTS["split_positions"]
    from ._common import dispatch, dtype_name, paged_decode_bucket
    win = dispatch("paged_decode", paged_decode_bucket(B, MB, BS, KVH, G, d),
                   dtype_name(dtype), dict(PAGED_DECODE_DEFAULTS),
                   device=device)
    use = win["mode"] == "kernel" if setting == "auto" else bool(setting)
    return use, int(win["split_positions"])


def resolve_paged_decode(setting, B, MB, BS, KVH, G, d, dtype, device=None):
    """The JAX ``resolve_paged_decode``: whether the decode step runs the
    kernel ("auto": the winner cache's choice for this bucket; True / False
    force)."""
    return resolve_paged_decode_levers(setting, B, MB, BS, KVH, G, d, dtype,
                                       device)[0]


def resolve_paged_chunk_levers(setting, block_c, C, MB, BS, KVH, G, d, dtype,
                               device=None):
    """(use_kernel, block_c, splits) of a chunk program (prefill, split-fuse
    chunk, verify): ``setting`` the engine's ``paged_kernel``, ``block_c``
    its ``paged_block_c`` ("auto" | int), both resolved against the winner
    cache for this chunk bucket as JAX's ``resolve_paged_chunk``; ``splits``
    (None = ``chunk_splits``' rule) always from the cache when the kernel
    can run. A forced-off kernel never consults the cache."""
    if setting is False:
        return False, (PAGED_CHUNK_BLOCK_C if block_c == "auto"
                       else int(block_c)), None
    from ._common import dispatch, dtype_name, paged_chunk_bucket
    win = dispatch("paged_chunk", paged_chunk_bucket(C, MB, BS, KVH, G, d),
                   dtype_name(dtype), paged_chunk_tune_defaults(),
                   device=device)
    use = win["mode"] == "kernel" if setting == "auto" else bool(setting)
    bc = int(win["block_c"]) if block_c == "auto" else int(block_c)
    splits = None if win["splits"] == "rule" else int(win["splits"])
    return use, bc, splits


def resolve_paged_chunk(setting, block_c, C, MB, BS, KVH, G, d, dtype,
                        device=None):
    """The JAX ``resolve_paged_chunk``: (use_kernel, block_c)."""
    return resolve_paged_chunk_levers(setting, block_c, C, MB, BS, KVH, G, d,
                                      dtype, device)[:2]


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_design in DESIGN_LAUNCHES.values():
        for k in by_design:
            by_design[k] = 0
    for by_lever in LEVER_LAUNCHES.values():
        by_lever.clear()


def _count_lever(name, lever):
    LEVER_LAUNCHES[name][lever] = LEVER_LAUNCHES[name].get(lever, 0) + 1


def alibi_slopes(n_head):
    """Per-head ALiBi slopes (the bloom formula): for the leading
    power-of-two count cp, slope_h = 2^(-8(h+1)/cp); extra heads
    interleave the 2cp sequence: 2^(-4(2(h-cp)+1)/cp)."""
    cp = 2 ** math.floor(math.log2(n_head))
    return [2.0 ** (-8.0 * (h + 1) / cp) if h < cp
            else 2.0 ** (-4.0 * (2 * (h - cp) + 1) / cp)
            for h in range(n_head)]


def _check_bloom_slopes(slopes, n_head, name, offset=0, heads=None):
    """The kernel computes bloom-formula slopes from the head index, so
    it takes no others: the ``n_head`` slopes of global heads ``offset``
    ... ``offset + n_head - 1`` of a model of ``heads`` heads (default
    ``n_head``: a rank of a tensor-parallel world holds a slice of them)."""
    heads = n_head if heads is None else heads
    if not 0 <= offset <= heads - n_head:
        raise ValueError(f"{name}: heads {offset} .. {offset + n_head - 1} "
                         f"are not heads of a {heads}-head model")
    expect = alibi_slopes(heads)[offset:offset + n_head]
    if len(slopes) != n_head or any(
            abs(a - b) > 1e-6 * max(abs(b), 1e-9)
            for a, b in zip(slopes, expect)):
        raise NotImplementedError(
            f"{name} computes bloom-formula ALiBi slopes in-kernel; custom "
            "per-head slopes are not supported")


class _DecodeArgs(ctypes.Structure):
    """Mirror of ``struct DecodeArgs`` in csrc/paged_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "tables", "lengths", "out", "part")]
        + [(n, ctypes.c_int) for n in ("B", "H", "KVH", "BS", "MB", "S",
                                       "bps")]
        + [("scale", ctypes.c_float), ("window", ctypes.c_int),
           ("alibi", ctypes.c_int), ("alibi_scale", ctypes.c_float),
           ("alibi_bf16", ctypes.c_int), ("alibi_cp", ctypes.c_float),
           ("alibi_h0", ctypes.c_int)])


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
        lib.paged_decode_launch.argtypes = [ctypes.POINTER(_DecodeArgs), I,
                                            I, P]
        lib.paged_decode_launch.restype = I
        lib.paged_chunk_launch.argtypes = [
            P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, I, I, I, I, I, P,
            P]
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
                           alibi_scale=1.0, alibi_bf16=False,
                           alibi_offset=0, alibi_heads=None,
                           split_positions=None):
    """One decode step of attention over a paged KV cache.

    q: (B, H, d); k_cache/v_cache: (NB, KVH, BS, d) with H % KVH == 0;
    block_tables: (B, MB) int32; lengths: (B,) int32 = the new token's
    position (attends cache slots 0..lengths inclusive). The new token's
    K/V must already be in the cache. ``window`` > 0 keeps the trailing
    ``window`` positions; ``alibi_slopes`` (len H, bloom formula only —
    the kernel computes them from the head index) adds slope_h * k_pos,
    optionally rounded through bf16 (``alibi_bf16``) and scaled
    (``alibi_scale``); a tensor-parallel rank's H heads are the global
    heads ``alibi_offset`` ... of an ``alibi_heads``-head model (default
    H), whose slopes the kernel computes (the power-of-two count from
    ``alibi_heads``). ``split_positions``: the cache positions a split of
    the kernel covers (``decode_splits``; None = DECODE_SPLIT_POSITIONS, 0 =
    the whole table). Returns (B, H, d) in q's dtype."""
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
    heads = H if alibi_heads is None else int(alibi_heads)
    if alibi_slopes is not None:
        _check_bloom_slopes(alibi_slopes, H, name, alibi_offset, heads)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_cache, v_cache, block_tables, lengths, scale=scale,
            window=window, alibi_slopes=alibi_slopes,
            alibi_scale=alibi_scale, alibi_bf16=alibi_bf16,
            alibi_offset=alibi_offset, alibi_heads=alibi_heads)
    _check_cuda((q, k_cache, v_cache, block_tables, lengths), q, name)
    if q.dtype == torch.float32 and d == 256:
        raise NotImplementedError(
            f"{name}: fp32 at d = 256 needs a 416 KB ring a CTA "
            f"{_TODO_F32_256}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel stages K/V rows by 16-byte "
                         "copies; the pools must be 16-byte aligned")
    S, bps = decode_splits(MB, BS, split_positions)
    out = torch.empty_like(q)
    part = (torch.empty(B * H * S * (d + 2), dtype=torch.float32,
                        device=q.device) if S > 1 else None)
    args = _DecodeArgs(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), B, H, KVH, BS, MB, S,
        bps, float(scale), int(window), int(alibi_slopes is not None),
        float(alibi_scale), int(alibi_bf16),
        float(2 ** math.floor(math.log2(heads))), int(alibi_offset))
    rc = _kernels().paged_decode_launch(
        ctypes.byref(args), d, _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, name)
    LAUNCHES["paged_decode"] += 1
    DESIGN_LAUNCHES["paged_decode"]["split" if S > 1 else "single"] += 1
    _count_lever("paged_decode", f"S={S}")
    return out


def decode_splits(MB, BS, split_positions=None):
    """(S, bps): the decode kernel's splits of a (B, MB) table of BS-position
    blocks, from the shape alone (no host sync): bps whole blocks a split
    (``split_positions``, default DECODE_SPLIT_POSITIONS, rounded down to
    whole blocks, at least one; 0 = the whole table) and S = ceil(MB / bps)
    splits."""
    if split_positions is None:
        split_positions = DECODE_SPLIT_POSITIONS
    bps = MB if split_positions == 0 else max(1, split_positions // BS)
    return -(-MB // bps), bps


def paged_decode_attention_reference(q, k_cache, v_cache, block_tables,
                                     lengths, *, scale=None, window=0,
                                     alibi_slopes=None, alibi_scale=1.0,
                                     alibi_bf16=False, alibi_offset=0,
                                     alibi_heads=None, split_positions=None):
    """Dense-gather plain version (the JAX reference's math, plus the
    kernel's alibi_scale/alibi_bf16 options); it takes the kernel's
    ``split_positions`` and ignores it, so it can stand in for the kernel
    wherever that is called with its levers. ``alibi_slopes`` are the
    slopes of its H heads, checked as the kernel checks them (global heads
    ``alibi_offset`` ... of an ``alibi_heads``-head model)."""
    B, H, d = q.shape
    if alibi_slopes is not None:
        _check_bloom_slopes(alibi_slopes, H, "paged_decode_attention",
                            alibi_offset, alibi_heads)
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


def paged_decode_split_partials(q, k_cache, v_cache, block_tables, lengths,
                                *, scale=None, window=0, alibi_slopes=None,
                                alibi_scale=1.0, alibi_bf16=False,
                                alibi_offset=0, alibi_heads=None,
                                splits=None):
    """The decode kernel's split partials, in torch: for each split s of
    ``splits`` = (S, bps) (default ``decode_splits``), its valid positions
    [lo, hi) (pos <= L, pos > L - window, inside the split's blocks) in
    steps of DECODE_STEP, each step one online-softmax update (scores in
    fp32, p rounded to q's dtype for PV, l summing the unrounded p).
    Returns fp32 (m (B, H, S), l (B, H, S), acc (B, H, S, d)); a split with
    no valid position has m = -1e30, l = 0, acc = 0."""
    B, H, d = q.shape
    NB, KVH, BS, _ = k_cache.shape
    MB = block_tables.shape[1]
    S, bps = decode_splits(MB, BS) if splits is None else splits
    G = H // KVH
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.float()
    L = lengths.long()
    tb = block_tables.long()
    if alibi_slopes is not None:
        _check_bloom_slopes(alibi_slopes, H, "paged_decode_attention",
                            alibi_offset, alibi_heads)
        slopes = torch.tensor(alibi_slopes, dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, S, dtype=torch.float32, device=dev)
    acc = torch.zeros(B, H, S, d, dtype=torch.float32, device=dev)
    for s in range(S):
        p0 = s * bps * BS
        hi = torch.clamp(L + 1, max=min(s * bps + bps, MB) * BS)
        lo = torch.clamp(L - window + 1, min=p0) if window else \
            torch.full_like(L, p0)
        for t in range(-(-bps * BS // DECODE_STEP)):
            pos = lo[:, None] + t * DECODE_STEP + torch.arange(
                DECODE_STEP, device=dev)                       # (B, STEP)
            valid = pos < hi[:, None]
            pc = pos.clamp(0, MB * BS - 1)
            blk = tb.gather(1, pc // BS)
            kr = k_cache[blk, :, pc % BS]                      # (B, STEP, KVH, d)
            vr = v_cache[blk, :, pc % BS]
            kr = torch.where(valid[..., None, None], kr, 0)
            vr = torch.where(valid[..., None, None], vr, 0)
            kr = kr.repeat_interleave(G, dim=2).float()
            vr = vr.repeat_interleave(G, dim=2).float()
            sc = torch.einsum("bhd,bthd->bht", qf, kr) * scale
            if alibi_slopes is not None:
                ab = slopes[None, :, None] * pos.float()[:, None, :]
                if alibi_bf16:
                    ab = ab.to(torch.bfloat16).float()
                if alibi_scale != 1.0:
                    ab = ab * alibi_scale
                sc = sc + ab
            sc = torch.where(valid[:, None, :], sc, NEG_INF)
            m_new = torch.maximum(m[..., s], sc.amax(-1))
            alpha = torch.exp(m[..., s] - m_new)
            p = torch.where(valid[:, None, :],
                            torch.exp(sc - m_new[..., None]), 0.0)
            l[..., s] = l[..., s] * alpha + p.sum(-1)
            pv = torch.einsum("bht,bthd->bhd", p.to(q.dtype).float(), vr)
            acc[..., s, :] = acc[..., s, :] * alpha[..., None] + pv
            m[..., s] = m_new
    return m, l, acc


def merge_decode_partials(m, l, acc, dtype):
    """The decode kernel's merge, in torch: the S partials of each (slot,
    head) folded in split order (m* = max m_s; l = sum l_s e^(m_s - m*),
    acc likewise), out = acc / max(l, 1e-30) rounded once to ``dtype``."""
    mx = m.amax(-1)
    w = torch.exp(m - mx[..., None])
    lt = torch.zeros_like(mx)
    at = torch.zeros_like(acc[..., 0, :])
    for s in range(m.shape[-1]):
        lt = lt + l[..., s] * w[..., s]
        at = at + acc[..., s, :] * w[..., s, None]
    return (at / torch.clamp(lt, min=1e-30)[..., None]).to(dtype)


def paged_decode_split_reference(q, k_cache, v_cache, block_tables, lengths,
                                 **kw):
    """Plain version of the decode kernel's split-and-merge arithmetic
    (``paged_decode_split_partials`` then ``merge_decode_partials``)."""
    return merge_decode_partials(*paged_decode_split_partials(
        q, k_cache, v_cache, block_tables, lengths, **kw), q.dtype)


# ------------------------------------------------------------------- chunk


def paged_chunk_attention(q, k_cache, v_cache, table, start, true_len, *,
                          scale=None, window=0, block_c="auto", splits=None):
    """A C-token query chunk of ONE sequence attends causally over that
    sequence's paged KV blocks (the split-fuse chunk program and the
    bucketed prefill).

    q: (C, H, d) chunk queries at positions start..start+C-1 (rows past
    ``true_len`` are don't-care but finite); k_cache/v_cache: (NB, KVH,
    BS, d) pools that ALREADY hold the chunk's own K/V; table: (MB,)
    int32, scratch-padded; start/true_len: ints. ``window`` > 0 keeps
    the trailing window; ``block_c``: chunk tokens per CTA of the SIMT /
    fp32 designs ("auto" = PAGED_CHUNK_BLOCK_C); ``splits``: the sm90
    design's key-walk splits (None = ``chunk_splits``). Returns (C, H, d) in
    q's dtype."""
    name = "paged_chunk_attention"
    _check_common(q, k_cache, v_cache, table, name)
    if table.dim() != 1:
        raise ValueError(f"{name}: table must be (MB,), got "
                         f"{tuple(table.shape)}")
    start, true_len = int(start), int(true_len)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[2])
    if q.device.type == "cpu":
        return paged_chunk_attention_reference(
            q, k_cache, v_cache, table, start, true_len, scale=scale,
            window=window)
    _check_cuda((q, k_cache, v_cache, table), q, name)
    return paged_chunk_launch(q, k_cache, v_cache, table, start, true_len,
                              scale, window, block_c,
                              _chunk_design(q, k_cache, v_cache, scale),
                              splits=splits)


def _chunk_design(q, k_cache, v_cache, scale=None):
    """The chunk kernel's design, from dtypes, shapes and addresses only:
    "fp32" for fp32; "sm90" (``paged_chunk_sm90_kernel``: wgmma + TMA) for
    bf16 at a head dim of CHUNK_SM90_HEAD_DIMS and a KV block size of
    CHUNK_SM90_BLOCK_SIZES, G = H / KVH dividing 64 (its q box holds G
    heads of 128 / G tokens), q and both pools contiguous with 16-byte
    aligned bases (TMA), and a positive scale (it goes into the exp's FMA);
    else "simt" (``paged_chunk_kernel`` on the CUDA cores: d = 32, other
    block sizes)."""
    if q.dtype == torch.float32:
        return "fp32"
    G = q.shape[1] // k_cache.shape[1]
    if (q.dtype == torch.bfloat16 and q.shape[-1] in CHUNK_SM90_HEAD_DIMS
            and k_cache.shape[2] in CHUNK_SM90_BLOCK_SIZES and 64 % G == 0
            and (scale is None or scale > 0)
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in (q, k_cache, v_cache))):
        return "sm90"
    return "simt"


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=4096)
def chunk_splits(C, H, KVH, BS, MB, start, true_len, window, sms=CHUNK_SMS):
    """Key-walk splits S of the sm90 chunk design, from the call's shape
    and its host-side start / true_len alone: the design runs KVH ceil(C G
    / 128) items of 128 folded rows, one CTA an SM, so a 256-token chunk
    (64 items under MHA or G = 4) leaves half of 132 SMs idle; each item's
    walk of 128-key tiles is then cut in S runs (as many as fill the SMs,
    at most CHUNK_MAX_SPLITS, each of at least CHUNK_SPLIT_TILES tiles of
    the longest walk, the last item's) whose fp32 partials a second kernel
    merges in split order."""
    G = H // KVH
    tt = CHUNK_TILE // G
    nq = -(-C // tt)
    items = KVH * nq
    q_lo, q_hi = start + (nq - 1) * tt, start + C - 1
    k_hi = min(start + true_len, MB * BS, q_hi + 1)
    k_lo = max(0, q_lo - window + 1) if window > 0 else 0
    nt = 1
    if k_hi > k_lo:
        bpt = CHUNK_TILE // BS
        nt = -(-(-(-k_hi // BS) - k_lo // BS) // bpt)
    return max(1, min(CHUNK_MAX_SPLITS, sms // items,
                      nt // CHUNK_SPLIT_TILES))


def paged_chunk_launch(q, k_cache, v_cache, table, start, true_len, scale,
                       window, block_c, design, splits=None):
    """One launch of the chunk kernel on CUDA tensors under ``design`` (a
    key of CHUNK_DESIGN_CODE; anything else raises here, and the launcher
    refuses a code it does not know), counted in LAUNCHES and by design.
    ``block_c`` is the SIMT kernel's query tile; the sm90 design has its
    own, and its key-walk splits (``chunk_splits``; ``splits``, 1 to
    CHUNK_MAX_SPLITS, overrides them: the winner cache's lever)."""
    name = "paged_chunk_attention"
    if design not in CHUNK_DESIGN_CODE:
        raise ValueError(f"{name}: unknown design {design!r}")
    C, H, d = q.shape
    NB, KVH, BS, _ = k_cache.shape
    if design != "sm90" and (BS % 16 or BS > 128):
        raise ValueError(f"{name}: kernel takes a KV block size that is a "
                         f"multiple of 16 up to 128, got {BS}")
    bc = PAGED_CHUNK_BLOCK_C if block_c == "auto" else int(block_c)
    bc = max(1, min(bc, C))
    rt = 16 if bc * (H // KVH) <= 16 else 64
    if design != "sm90" and chunk_smem(design, d, BS, rt) > _SMEM_LIMIT:
        raise NotImplementedError(
            f"{name}: the {design} design at d = {d}, BS = {BS} needs "
            f"{chunk_smem(design, d, BS, rt)} bytes of shared memory a CTA "
            f"{_TODO_F32_256}")
    S, part = 1, None
    if design == "sm90":
        S = chunk_splits(C, H, KVH, BS, table.shape[0], start, true_len,
                         window, _sm_count(q.device.index))
        if splits is not None:
            if not 1 <= int(splits) <= CHUNK_MAX_SPLITS:
                raise ValueError(f"{name}: splits must be 1 to "
                                 f"{CHUNK_MAX_SPLITS}, got {splits}")
            S = int(splits)
        if S > 1:
            units = KVH * -(-C * (H // KVH) // CHUNK_TILE) * S
            part = torch.empty(units * CHUNK_TILE * (d + 2),
                               dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    rc = _kernels().paged_chunk_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        table.data_ptr(), out.data_ptr(), C, H, KVH, d, BS, NB,
        table.shape[0], int(start), int(true_len), float(scale), int(window),
        bc, rt, CHUNK_DESIGN_CODE[design], S,
        None if part is None else part.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({design}): "
                           f"cudaError {rc}")
    LAUNCHES["paged_chunk"] += 1
    DESIGN_LAUNCHES["paged_chunk"][design] += 1
    _count_lever("paged_chunk", f"S={S}" if design == "sm90"
                 else f"block_c={bc}")
    return out


def chunk_smem(design, d, BS, rt):
    """Dynamic shared memory of a SIMT / fp32 chunk CTA (the launcher's
    sum: the score tile and row state in fp32, q / K tiles padded by one
    32-bit word, the V tile)."""
    es = 4 if design == "fp32" else 2
    return 4 * (rt * (BS + 1) + 3 * rt) + es * (
        (rt + BS) * (d + 4 // es) + BS * d)


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
