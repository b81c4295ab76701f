"""Block-sparse attention: Hopper CUDA kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py`` (K11:
forward, dq, dk/dv); the kernels are ``csrc/block_sparse_attention.cu``
(design and bounds are noted there). Attention is restricted to an (H, n,
n) boolean block layout (``ops/sparse_attention/sparsity_config.py``),
preprocessed on the host into per-row lists of present key blocks and
their column-wise transpose (:func:`layout_lists`); the kernels walk only
those blocks, so work scales with the layout's density.

:func:`block_sparse_attention` has the JAX signature: q, k, v (B, T, H,
d), T a multiple of ``block``; it folds them to (B*H, T, d) with q
pre-scaled, as the JAX wrapper does, and is differentiable through one
``torch.autograd.Function``. A fully masked row gives o = 0 and lse =
-1e30, and the backward never visits it.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
PyTorch version (``bsa_forward_reference``, ``bsa_dq_reference``,
``bsa_dkv_reference``, which walk the same lists in fp32 and never build a
T x T buffer); a CUDA
tensor launches the kernels or raises — there is no fallback.
``LAUNCHES`` counts kernel launches: ``bsa_fwd`` one per forward,
``bsa_dq`` and ``bsa_dkv`` one each per backward. Each pass takes one of
three designs (``_bsa_fwd_design``, ``_bsa_bwd_design``): bf16 at d = 64
or 128 and block 64 that TMA can address goes to the Hopper kernels
(``bsa_fwd_sm90_kernel``, which walks the union of two query blocks'
lists: :func:`union_lists`; ``bsa_dq_sm90_kernel`` and
``bsa_dkv_sm90_kernel``, which split one block's list between two
consumers, in the order of :func:`row_col_orders`; both kept with the
lists by :func:`lists_on`), other bf16 to the mma.sync kernels, fp32 to
their scalar-FMA instances; ``DESIGN_LAUNCHES`` counts them by pass.
"""

import ctypes
import math

import numpy as np
import torch

from .flash_attention import scale_q
from .flash_attention import _check_cuda as _check_operands
from .grouped_matmul import tma_ok

NEG_INF = -1e30

LAUNCHES = {"bsa_fwd": 0, "bsa_dq": 0, "bsa_dkv": 0}
DESIGN_LAUNCHES = {name: {"sm90": 0, "mma_sync": 0, "fp32": 0}
                   for name in LAUNCHES}
# bsa_launch's design codes (0 and 1 are the mma.sync kernels' fp32 and
# bf16 instances, 2 the Hopper kernels)
DESIGN_CODE = {"fp32": 0, "mma_sync": 1, "sm90": 2}

BLOCKS = (16, 32, 64, 128)
_LIST_KEYS = ("rows", "row_cnt", "cols", "col_cnt")
_UNION_KEYS = ("urows", "ubits", "ucnt", "uorder")
_ORDER_KEYS = ("rorder", "corder")


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_design in DESIGN_LAUNCHES.values():
        for k in by_design:
            by_design[k] = 0


class _BsaArgs(ctypes.Structure):
    """Mirror of ``struct BsaArgs`` in csrc/block_sparse_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "o", "lse", "dout", "delta", "dq", "dk",
                  "dv", "rows", "row_cnt", "cols", "col_cnt")]
                + [(n, ctypes.c_int) for n in
                   ("BH", "H", "T", "D", "block", "causal", "max_row",
                    "max_col")]
                + [(n, ctypes.c_void_p) for n in
                   ("urows", "ubits", "ucnt", "uorder", "next_item")]
                + [("max_u", ctypes.c_int)]
                + [(n, ctypes.c_void_p) for n in ("rorder", "corder")])


_builder = None


def kernel_builder():
    """The block-sparse library's builder; the first call builds the
    library (nvcc, see op_builder) and binds its ctypes signature."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import BlockSparseAttentionBuilder
        b = BlockSparseAttentionBuilder()
        lib = b.load()
        lib.bsa_launch.argtypes = [ctypes.POINTER(_BsaArgs), ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
        lib.bsa_launch.restype = ctypes.c_int
        _builder = b
    return _builder


# ------------------------------------------------------------------- lists


def layout_lists(layout, causal, nq, nk):
    """(H, nq, nk) bool layout -> row/col present-block lists (own copy of
    the JAX ``layout_lists``).

    Returns dict of int32 arrays: rows (H, nq, mr), row_cnt (H, nq),
    cols (H, nk, mc), col_cnt (H, nk). With ``causal`` blocks above the
    diagonal are dropped here (block b_q attends b_k <= b_q)."""
    lay = np.asarray(layout[:, :nq, :nk], bool).copy()
    if causal:
        tri = np.tril(np.ones((nq, nk), bool))
        lay &= tri[None]
    H = lay.shape[0]
    mr = max(1, int(lay.sum(axis=2).max()))
    mc = max(1, int(lay.sum(axis=1).max()))
    rows = np.zeros((H, nq, mr), np.int32)
    row_cnt = np.zeros((H, nq), np.int32)
    cols = np.zeros((H, nk, mc), np.int32)
    col_cnt = np.zeros((H, nk), np.int32)
    for h in range(H):
        for i in range(nq):
            ids = np.nonzero(lay[h, i])[0]
            rows[h, i, :len(ids)] = ids
            row_cnt[h, i] = len(ids)
        for j in range(nk):
            ids = np.nonzero(lay[h, :, j])[0]
            cols[h, j, :len(ids)] = ids
            col_cnt[h, j] = len(ids)
    return {"rows": rows, "row_cnt": row_cnt,
            "cols": cols, "col_cnt": col_cnt}


def union_lists(rows, row_cnt):
    """The Hopper forward's walk: per head h and pair p of query blocks (2p,
    2p + 1; a last block without a partner pairs with an empty list), the
    sorted union of the two rows' present key blocks and, per entry, which
    of the two lists hold it.

    Returns dict of int32 arrays: urows (H, n2, mu) the union ascending,
    ubits (H, n2, mu) bit 0 set where row 2p's list holds the entry, bit 1
    where row 2p + 1's does, ucnt (H, n2) the union's length, and uorder
    (H * n2,) the entries h * n2 + p longest union first (ties in index
    order): the persistent kernel's item order (each entry's instances
    side by side). n2 = ceil(n / 2), mu the longest union (at least 1)."""
    rows, row_cnt = np.asarray(rows), np.asarray(row_cnt)
    H, n = row_cnt.shape
    n2 = (n + 1) // 2
    walks = []
    for h in range(H):
        for p in range(n2):
            even = rows[h, 2 * p, :row_cnt[h, 2 * p]]
            odd = (rows[h, 2 * p + 1, :row_cnt[h, 2 * p + 1]]
                   if 2 * p + 1 < n else even[:0])
            u = np.union1d(even, odd)
            walks.append((u, np.isin(u, even) | (np.isin(u, odd) << 1)))
    mu = max(1, max(len(u) for u, _ in walks))
    urows = np.zeros((H * n2, mu), np.int32)
    ubits = np.zeros((H * n2, mu), np.int32)
    ucnt = np.zeros(H * n2, np.int32)
    for i, (u, bits) in enumerate(walks):
        urows[i, :len(u)] = u
        ubits[i, :len(u)] = bits
        ucnt[i] = len(u)
    order = np.argsort(-ucnt, kind="stable").astype(np.int32)
    return {"urows": urows.reshape(H, n2, mu),
            "ubits": ubits.reshape(H, n2, mu),
            "ucnt": ucnt.reshape(H, n2), "uorder": order}


def row_col_orders(row_cnt, col_cnt):
    """The Hopper backward's item orders: rorder (H * n,) the entries h * n
    + i of the row lists longest first (dq), corder the same of the column
    lists (dk/dv), ties in index order (a stable sort); the kernels run each
    entry's BH / H instances side by side."""
    def order(cnt):
        c = np.asarray(cnt).reshape(-1)
        return np.argsort(-c, kind="stable").astype(np.int32)
    return {"rorder": order(row_cnt), "corder": order(col_cnt)}


def lists_on(lists, device):
    """The lists, their union walk (:func:`union_lists`) and the backward's
    orders (:func:`row_col_orders`), built on the host from the lists where
    ``lists`` lacks them, as contiguous int32 tensors on ``device`` (numpy
    arrays are uploaded; tensors already there are kept)."""
    if not all(k in lists for k in _UNION_KEYS + _ORDER_KEYS):
        host = {k: np.asarray(torch.as_tensor(lists[k]).cpu())
                for k in _LIST_KEYS}
        lists = dict(lists, **union_lists(host["rows"], host["row_cnt"]),
                     **row_col_orders(host["row_cnt"], host["col_cnt"]))
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device=device, dtype=torch.int32)
            .contiguous() for k, v in ((k, lists[k]) for k in
                                       _LIST_KEYS + _UNION_KEYS
                                       + _ORDER_KEYS)}


# ------------------------------------------------------------------- plain


def _by_instance(t, BH):
    """(H, n, ...) per-head lists -> (BH, n, ...): instance bh reads head
    bh mod H."""
    H = t.shape[0]
    return t[torch.arange(BH, device=t.device) % H].long()


def _blocks(x, block):
    BH, T, d = x.shape
    return x.reshape(BH, T // block, block, d)


def _gather(xb, ids):
    """xb (BH, n, block, d), ids (BH, n) -> xb[bh, ids[bh, i]] (BH, n,
    block, d)."""
    bidx = torch.arange(xb.shape[0], device=xb.device)[:, None]
    return xb[bidx, ids]


def _causal_off(qblk, kblk, block, device):
    """(BH, n, block, block) bool: key > query for query block ``qblk`` and
    key block ``kblk`` (both (BH, n))."""
    r = torch.arange(block, device=device)
    qpos = qblk[..., None, None] * block + r[:, None]
    kpos = kblk[..., None, None] * block + r[None, :]
    return kpos > qpos


def bsa_forward_reference(q, k, v, lists, block, causal=False):
    """Plain version of the forward on folded (BH, T, d) operands (scale
    already in q): each query block streams over its row's present key
    blocks in list order, fp32 (m, l, acc), p rounded to v's dtype before
    P.V. Returns (o in q's dtype, lse (BH, T) fp32); a row with no present
    block gets o = 0, lse = NEG_INF."""
    BH, T, d = q.shape
    n = T // block
    rows = _by_instance(lists["rows"], BH)
    cnt = _by_instance(lists["row_cnt"], BH)
    qb = _blocks(q.float(), block)
    kb, vb = _blocks(k.float(), block), _blocks(v, block)
    qblk = torch.arange(n, device=q.device).expand(BH, n)
    m = torch.full((BH, n, block), NEG_INF, device=q.device)
    l = torch.zeros(BH, n, block, device=q.device)
    acc = torch.zeros(BH, n, block, d, device=q.device)
    for jj in range(rows.shape[-1]):
        live = (jj < cnt)[..., None]
        j = rows[..., jj]
        s = torch.matmul(qb, _gather(kb, j).transpose(-1, -2))
        if causal:
            s = torch.where(_causal_off(qblk, j, block, q.device), NEG_INF, s)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        pv = torch.matmul(p.to(v.dtype).float(), _gather(vb, j).float())
        l = torch.where(live, l * alpha + p.sum(-1), l)
        acc = torch.where(live[..., None], acc * alpha[..., None] + pv, acc)
        m = torch.where(live, m_new, m)
    ok = l > 0
    o = torch.where(ok[..., None], acc / torch.where(ok, l, 1.0)[..., None],
                    0.0)
    lse = torch.where(ok, m + torch.log(torch.where(ok, l, 1.0)), NEG_INF)
    return o.reshape(BH, T, d).to(q.dtype), lse.reshape(BH, T)


def _p_ds(qi, ki, qx, dox, kx, vx, lse_x, delta_x, block, causal, dtype):
    """(p, round(ds)) of query blocks ``qi`` against key blocks ``ki`` (each
    (BH, n)), fp32, p = 0 above the causal diagonal."""
    s = torch.matmul(qx, kx.transpose(-1, -2))
    p = torch.exp(s - lse_x[..., None])
    if causal:
        p = torch.where(_causal_off(qi, ki, block, qx.device), 0.0, p)
    dp = torch.matmul(dox, vx.transpose(-1, -2))
    return p, (p * (dp - delta_x[..., None])).to(dtype).float()


def bsa_dq_reference(q, k, v, o, lse, do, lists, block, causal=False):
    """Plain version of the dq pass on folded (BH, T, d) operands (scale
    already in q): delta = rowsum(do*o) in fp32, then per row's list
    dq += round(p (dp - delta)) k in fp32. Returns (dq in q's dtype, delta
    (BH, T) fp32)."""
    BH, T, d = q.shape
    n = T // block
    qf, kf, vf, dof = (_blocks(x.float(), block) for x in (q, k, v, do))
    lse_b = lse.float().reshape(BH, n, block)
    delta = (do.float() * o.float()).sum(-1)
    delta_b = delta.reshape(BH, n, block)
    idx = torch.arange(n, device=q.device).expand(BH, n)
    rows = _by_instance(lists["rows"], BH)
    rcnt = _by_instance(lists["row_cnt"], BH)
    dq = torch.zeros(BH, n, block, d, device=q.device)
    for jj in range(rows.shape[-1]):
        j = rows[..., jj]
        kx = _gather(kf, j)
        _, ds = _p_ds(idx, j, qf, dof, kx, _gather(vf, j), lse_b, delta_b,
                      block, causal, q.dtype)
        dq = torch.where((jj < rcnt)[..., None, None],
                         dq + torch.matmul(ds, kx), dq)
    return dq.reshape(BH, T, d).to(q.dtype), delta


def bsa_dkv_reference(q, k, v, lse, delta, do, lists, block, causal=False):
    """Plain version of the dk/dv pass on folded (BH, T, d) operands (scale
    already in q) from the dq pass's delta: per column's list
    dv += round(p)^T do, dk += round(ds)^T q in fp32. Returns (dk, dv) in
    the inputs' dtypes."""
    BH, T, d = q.shape
    n = T // block
    qf, kf, vf, dof = (_blocks(x.float(), block) for x in (q, k, v, do))
    lse_b = lse.float().reshape(BH, n, block)
    delta_b = delta.float().reshape(BH, n, block)
    idx = torch.arange(n, device=q.device).expand(BH, n)
    cols = _by_instance(lists["cols"], BH)
    ccnt = _by_instance(lists["col_cnt"], BH)
    dk = torch.zeros(BH, n, block, d, device=q.device)
    dv = torch.zeros_like(dk)
    bidx = torch.arange(BH, device=q.device)[:, None]
    for ii in range(cols.shape[-1]):
        i = cols[..., ii]
        qx, dox = _gather(qf, i), _gather(dof, i)
        p, ds = _p_ds(i, idx, qx, dox, kf, vf, lse_b[bidx, i],
                      delta_b[bidx, i], block, causal, q.dtype)
        live = (ii < ccnt)[..., None, None]
        dv = torch.where(live, dv + torch.matmul(
            p.to(do.dtype).float().transpose(-1, -2), dox), dv)
        dk = torch.where(live, dk + torch.matmul(ds.transpose(-1, -2), qx),
                         dk)
    return dk.reshape(BH, T, d).to(k.dtype), dv.reshape(BH, T, d).to(v.dtype)


def bsa_backward_reference(q, k, v, o, lse, do, lists, block, causal=False):
    """Plain version of the backward (:func:`bsa_dq_reference`, then
    :func:`bsa_dkv_reference`). Returns (dq, dk, dv)."""
    dq, delta = bsa_dq_reference(q, k, v, o, lse, do, lists, block, causal)
    return (dq,) + bsa_dkv_reference(q, k, v, lse, delta, do, lists, block,
                                     causal)


# ----------------------------------------------------------------- kernels


def _check_cuda(tensors, lists, block, name, keys=_LIST_KEYS):
    """The flash kernels' operand checks, then the block and the lists
    (``keys``)."""
    _check_operands(tensors, name)
    dev = tensors[0].device
    if block not in BLOCKS:
        raise ValueError(f"{name}: kernel takes block in {BLOCKS}, got "
                         f"{block}")
    for key in keys:
        t = lists[key]
        if not torch.is_tensor(t) or t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name}: lists['{key}'] must be an int32 "
                             f"tensor on {dev} (see lists_on)")


def _bsa_fwd_design(q, k, v, block, heads):
    """The forward's design for folded contiguous (BH, T, d) operands:
    "fp32" for fp32; "sm90" (TMA + wgmma over the union walk) for bf16 at d
    = 64 or 128 and block 64 that TMA can address (``tma_ok``: 16-byte
    aligned bases) with BH a multiple of the layout's ``heads`` (the
    kernel's item order runs over each head's instances): both
    SparseSelfAttention cells; else "mma_sync" (d = 32, blocks 16, 32 and
    128)."""
    if q.dtype == torch.float32:
        return "fp32"
    if (q.shape[-1] in (64, 128) and block == 64 and q.shape[0] % heads == 0
            and all(map(tma_ok, (q, k, v)))):
        return "sm90"
    return "mma_sync"


def _bsa_bwd_design(q, k, v, do, block, heads, o=None):
    """The backward's design (dq and dk/dv alike) for folded contiguous
    (BH, T, d) operands: "fp32" for fp32; "sm90" (TMA + wgmma over the
    split walk) for bf16 at d = 64 or 128 and block 64 that TMA can
    address (``tma_ok`` on q, k, v, do and, where given, o, which dq reads
    by 16-byte loads; the wrapper allocates dq, dk and dv contiguous) with
    BH a multiple of the layout's ``heads``: both SparseSelfAttention
    cells; else "mma_sync" (d = 32, blocks 16, 32 and 128)."""
    if q.dtype == torch.float32:
        return "fp32"
    ops = (q, k, v, do) + (() if o is None else (o,))
    if (q.shape[-1] in (64, 128) and block == 64 and q.shape[0] % heads == 0
            and all(map(tma_ok, ops))):
        return "sm90"
    return "mma_sync"


def _launch(which, name, block, causal, lists, design=None, **tensors):
    """One bsa_launch of pass ``which`` under ``design`` (default: the
    mma.sync kernels' instance of q's dtype; a name DESIGN_CODE lacks
    raises)."""
    q = tensors["q"]
    BH, T, D = q.shape
    if design is None:
        design = "fp32" if q.dtype == torch.float32 else "mma_sync"
    if design not in DESIGN_CODE:
        raise ValueError(f"{name}: unknown design {design!r}")
    a = _BsaArgs()
    a.BH, a.T, a.D, a.block, a.causal = BH, T, D, block, int(bool(causal))
    a.H = lists["rows"].shape[0]
    a.max_row, a.max_col = lists["rows"].shape[-1], lists["cols"].shape[-1]
    keys = _LIST_KEYS
    if design == "sm90":
        keys = _LIST_KEYS + _UNION_KEYS + _ORDER_KEYS
        a.max_u = lists["urows"].shape[-1]
        # the persistent CTAs' work counter
        tensors["next_item"] = torch.zeros(1, dtype=torch.int32,
                                           device=q.device)
    for key, t in list(tensors.items()) + [(k, lists[k]) for k in keys]:
        setattr(a, key, t.data_ptr())
    lib = kernel_builder().load()
    rc = lib.bsa_launch(ctypes.byref(a), DESIGN_CODE[design], which,
                        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({design}): "
                           f"cudaError {rc}"
                           + (" (fp32 tiles of this block and head dim do "
                              "not fit a CTA's shared memory)" if rc == 9
                              else ""))


def bsa_forward(q, k, v, lists, block, causal=False, design=None):
    """Forward on folded contiguous (BH, T, d) operands (scale already in
    q); ``lists`` from :func:`lists_on` on q's device. Returns (o, lse
    (BH, T) fp32). CPU tensors take the plain version; CUDA tensors launch
    the kernel of ``_bsa_fwd_design`` (or of ``design``, so the card's
    checks can time one design beside the other) or raise."""
    if q.device.type == "cpu":
        return bsa_forward_reference(q, k, v, lists, block, causal)
    name = "bsa_forward"
    _check_cuda((q, k, v), lists, block, name)
    q, k, v = (x.contiguous() for x in (q, k, v))
    if design is None:
        design = _bsa_fwd_design(q, k, v, block, lists["rows"].shape[0])
    if design == "sm90":
        _check_cuda((q, k, v), lists, block, name, _UNION_KEYS)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(0, name, block, causal, lists, design, q=q, k=k, v=v, o=o,
            lse=lse)
    LAUNCHES["bsa_fwd"] += 1
    DESIGN_LAUNCHES["bsa_fwd"][design] += 1
    return o, lse


def _bwd_design(name, q, k, v, do, lists, block, design, o=None):
    """The operand checks, then the pass's design (``_bsa_bwd_design``
    unless ``design`` forces one) with its order checked for sm90."""
    _check_cuda((q, k, v, do) + (() if o is None else (o,)), lists, block,
                name)
    if design is None:
        design = _bsa_bwd_design(q, k, v, do, block, lists["rows"].shape[0],
                                 o)
    if design == "sm90":
        _check_cuda((q,), lists, block, name, _ORDER_KEYS)
    return design


def bsa_dq(q, k, v, o, lse, do, lists, block, causal=False, design=None):
    """The dq kernel on folded (BH, T, d) operands from the saved o and lse;
    it also writes delta = rowsum(do*o) for the dk/dv kernel. Returns (dq,
    delta (BH, T) fp32). CPU tensors take the plain version; CUDA tensors
    launch the kernel of ``_bsa_bwd_design`` (or of ``design``, so the
    card's checks can time one design beside the other) or raise."""
    if q.device.type == "cpu":
        return bsa_dq_reference(q, k, v, o, lse, do, lists, block, causal)
    name = "bsa_dq"
    q, k, v, o, do = (x.contiguous() for x in (q, k, v, o, do))
    design = _bwd_design(name, q, k, v, do, lists, block, design, o)
    lse = lse.float().contiguous()
    delta = torch.empty_like(lse)
    dq = torch.empty_like(q)
    _launch(1, name, block, causal, lists, design, q=q, k=k, v=v, o=o,
            lse=lse, dout=do, delta=delta, dq=dq)
    LAUNCHES["bsa_dq"] += 1
    DESIGN_LAUNCHES["bsa_dq"][design] += 1
    return dq, delta


def bsa_dkv(q, k, v, lse, delta, do, lists, block, causal=False,
            design=None):
    """The dk/dv kernel on folded (BH, T, d) operands from lse and the dq
    kernel's delta. Returns (dk, dv). CPU tensors take the plain version;
    CUDA tensors launch the kernel of ``_bsa_bwd_design`` (or of
    ``design``) or raise."""
    if q.device.type == "cpu":
        return bsa_dkv_reference(q, k, v, lse, delta, do, lists, block,
                                 causal)
    name = "bsa_dkv"
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    design = _bwd_design(name, q, k, v, do, lists, block, design)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(2, name, block, causal, lists, design, q=q, k=k, v=v, lse=lse,
            dout=do, delta=delta, dk=dk, dv=dv)
    LAUNCHES["bsa_dkv"] += 1
    DESIGN_LAUNCHES["bsa_dkv"][design] += 1
    return dk, dv


def bsa_backward(q, k, v, o, lse, do, lists, block, causal=False):
    """Backward on folded (BH, T, d) operands from the saved o and lse: the
    dq kernel, then the dk/dv kernel (their plain versions on CPU tensors).
    Returns (dq, dk, dv)."""
    dq, delta = bsa_dq(q, k, v, o, lse, do, lists, block, causal)
    return (dq,) + bsa_dkv(q, k, v, lse, delta, do, lists, block, causal)


class _BlockSparse(torch.autograd.Function):
    """(q scaled, k, v) folded (BH, T, d) -> o; saves q, k, v, o and lse
    and runs the dq and dk/dv kernels on them."""

    @staticmethod
    def forward(ctx, q, k, v, lists, block, causal):
        o, lse = bsa_forward(q, k, v, lists, block, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.lists, ctx.block, ctx.causal = lists, block, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = bsa_backward(q, k, v, o, lse, do, ctx.lists, ctx.block,
                                  ctx.causal)
        return dq, dk, dv, None, None, None


def block_sparse_attention(q, k, v, layout, block, *, causal=False,
                           scale=None, lists=None, interpret=None):
    """Attention restricted to a (H, T//block, T//block) bool layout.

    q/k/v: (B, T, H, d); T must divide by ``block``. ``lists`` may carry
    the precomputed :func:`layout_lists` (numpy, uploaded on each call) or
    their :func:`lists_on` tensors on q's device (no upload: callers should
    cache these per (layout, T), as ``SparseSelfAttention`` does). Zero
    output for fully masked rows, as the masked-dense op. Differentiable.
    ``interpret`` is accepted and changes nothing."""
    B, T, H, d = q.shape
    if T % block:
        raise ValueError(f"seq {T} not divisible by block {block}")
    n = T // block
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if lists is None:
        lists = layout_lists(np.asarray(layout), causal, n, n)
    lists = lists_on(lists, q.device)
    if lists["rows"].shape[0] != H:
        raise ValueError(f"layout has {lists['rows'].shape[0]} heads, q "
                         f"has {H}")

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, T, d)

    o = _BlockSparse.apply(fold(scale_q(q, scale)), fold(k), fold(v), lists,
                           int(block), bool(causal))
    return o.reshape(B, H, T, d).transpose(1, 2)
