"""Zigzag ring attention: blockwise context parallelism over a process
group.

Counterpart of ``deepspeed_tpu/sequence/ring.py``. KV chunks rotate around
the ranks of the ``seq`` axis (``comm.ppermute``: ``batch_isend_irecv``
between ring neighbours) while each rank carries the flash-style online
softmax state of its own queries, so no rank materializes the full (T, T)
scores or the full KV.

1. **Zigzag layout**: rank r holds one early chunk and its mirrored late
   chunk (chunks r and 2R-1-r of 2R), so every rank does the same causal
   work: step 0 is plain causal attention on the local [early|late]
   buffer, every later step two unmasked chunk pairs, and fully-masked
   pairs are never computed (``ring_flops_info``). Inputs and outputs stay
   contiguous-sharded; the redistribution is internal (two chunk
   ppermutes each way, differentiable: a permutation's gradient is the
   inverse permutation).
2. **Block steps**: with the kernel (``block_kernel`` True / "auto") each
   pair runs K10 (``flash_block_fwd``), chaining the (m, l, acc) state in
   place, and the backward replays each pair through K2
   (``flash_block_bwd``) from the global lse and o; ``block_kernel=False``
   runs the dense einsum steps with the same state algebra. As every
   wrapper of the port, the kernels run on CUDA tensors and their plain
   versions on CPU tensors.
3. **Rotation**: k and v travel as ONE stacked buffer; with
   ``double_buffer`` the exchange for step i+1 is posted before step i's
   kernels, and the last step posts none. In the backward the dk/dv
   accumulators travel with the kv buffer and one extra rotation brings
   them home.

Each JAX ``custom_vjp`` is one ``torch.autograd.Function`` whose backward
does its own rotations. ``rotate_chunks`` takes an int (the head dim split
into that many exchanges a rotation); "auto" is 1 and ``block_kernel``
"auto" the kernel, the JAX package's cold-cache choices (ring.py:509-547):
the port has no winner cache.
"""

import functools
import math

import torch

from .. import comm
from ..ops.cuda.flash_attention import (flash_block_bwd, flash_block_finalize,
                                        flash_block_fwd, flash_block_state,
                                        scale_q)
from ..utils import groups
from ..utils.logging import logger
from .layer import gather_sequence, shard_sequence

NEG_INF = -1e30


# ------------------------------------------------------------ zigzag layout

def _zig_owner(c, R):
    """Rank owning global chunk c (of 2R) under the zigzag layout."""
    return c if c < R else 2 * R - 1 - c


def zigzag_perms(R):
    """ppermute perms routing the contiguous layout's (2r, 2r+1) chunk
    pair to the zigzag owners: perm_even carries the even chunk 2r,
    perm_odd the odd chunk 2r+1."""
    perm_even = [(r, _zig_owner(2 * r, R)) for r in range(R)]
    perm_odd = [(r, _zig_owner(2 * r + 1, R)) for r in range(R)]
    return perm_even, perm_odd


class _PPermute(torch.autograd.Function):
    """``comm.ppermute`` with its gradient: the inverse permutation."""

    @staticmethod
    def forward(ctx, x, axis_name, perm):
        ctx.axis_name = axis_name
        ctx.inverse = [(d, s) for s, d in perm]
        return comm.ppermute(x, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        return comm.ppermute(g, ctx.axis_name, ctx.inverse), None, None


def _ppermute(x, axis_name, perm):
    return _PPermute.apply(x, axis_name, perm)


def _to_zigzag(x, axis_name, R, axis=1):
    """Contiguous-sharded local chunk (global [2r*C, (2r+2)*C)) -> zigzag
    local [chunk r | chunk 2R-1-r]."""
    C = x.shape[axis] // 2
    pe, po = zigzag_perms(R)
    a = _ppermute(x.narrow(axis, 0, C), axis_name, pe)
    b = _ppermute(x.narrow(axis, C, C), axis_name, po)
    even = comm.axis_index(axis_name) % 2 == 0
    return torch.cat([a, b] if even else [b, a], dim=axis)


def _from_zigzag(x, axis_name, R, axis=1):
    """Inverse of :func:`_to_zigzag`."""
    C = x.shape[axis] // 2
    pe, po = zigzag_perms(R)
    inv_e = [(d, s) for (s, d) in pe]
    inv_o = [(d, s) for (s, d) in po]
    early, late = x.narrow(axis, 0, C), x.narrow(axis, C, C)
    even = comm.axis_index(axis_name) % 2 == 0
    a = _ppermute(early if even else late, axis_name, inv_e)
    b = _ppermute(late if even else early, axis_name, inv_o)
    return torch.cat([a, b], dim=axis)


# ------------------------------------------------------------- block steps
# The per-chunk-pair step in two interchangeable backends sharing the
# (m, l, acc) state algebra: K10 / K2 and a dense einsum reference. A
# forward step returns the updated state (K10 updates it in place).

def _fold(x):
    """(B, t, H, D) -> (B*H, t, D)."""
    B, t, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, t, D)


def _unfold(x, B, H):
    BH, t, D = x.shape
    return x.reshape(B, H, t, D).transpose(1, 2)


def _causal(T, device):
    return torch.ones(T, T, dtype=torch.bool, device=device).tril()


def _step_einsum(q, k, v, state, causal):
    """Dense-einsum block step: q (BH, T, d) pre-scaled; state (m, l, acc)
    fp32."""
    m, l, acc = state
    s = torch.einsum("gtd,gsd->gts", q.float(), k.float())
    if causal:
        s = torch.where(_causal(q.shape[1], q.device)[None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l = l * alpha + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("gts,gsd->gtd", p,
                                                v.float())
    return m_new, l, acc


def _bwd_einsum(q, k, v, o, lse, do, causal):
    """Dense-einsum pair backward from the GLOBAL lse/o: exact
    contributions, fp32 throughout."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("gtd,gsd->gts", qf, kf)
    if causal:
        s = torch.where(_causal(q.shape[1], q.device)[None], s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dof, of = do.float(), o.float()
    delta = (dof * of).sum(-1)
    dv = torch.einsum("gts,gtd->gsd", p, dof)
    dp = torch.einsum("gtd,gsd->gts", dof, vf)
    ds = p * (dp - delta[..., None])
    dk = torch.einsum("gts,gtd->gsd", ds, qf)
    dq = torch.einsum("gts,gsd->gtd", ds, kf)
    return dq, dk, dv


def _step_kernel(q, k, v, state, causal):
    return flash_block_fwd(q, k, v, state, causal=causal)


def _bwd_kernel(q, k, v, o, lse, do, causal):
    return flash_block_bwd(q, k, v, o, lse, do, causal=causal)


def _make_steps(use_kernel):
    return (_step_kernel, _bwd_kernel) if use_kernel else \
        (_step_einsum, _bwd_einsum)


def _assign(dst, new):
    """Write a step's new state into the state views ``dst`` (a no-op for
    K10, which updated them in place)."""
    for d, n in zip(dst, new):
        if n is not d:
            d.copy_(n)


def _halves(state, C):
    return (tuple(x[:, :C] for x in state), tuple(x[:, C:] for x in state))


# --------------------------------------------------------- rotation driver

class _Rotation:
    """A posted ring rotation of a buffer, split along its last dim into
    ``chunks`` exchanges (1: one exchange); ``wait()`` returns the
    buffer that arrived."""

    def __init__(self, x, axis_name, perm, chunks):
        parts = [x] if chunks <= 1 else x.chunk(chunks, -1)
        self.pending = [comm.ppermute_start(p.contiguous(), axis_name, perm)
                        for p in parts]

    def wait(self):
        parts = [p.wait() for p in self.pending]
        return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def _ring_perm(R):
    return [(j, (j + 1) % R) for j in range(R)]


def _ring_scan(kv, state, step0_fn, step_fn, axis_name, R, double_buffer,
               rotate_chunks=1):
    """R compute steps, R-1 KV rotations, no dead last rotation;
    ``double_buffer`` posts each rotation BEFORE the compute it overlaps
    (the compute reads the buffer already held)."""
    if R == 1:
        return step0_fn(state, kv)
    perm = _ring_perm(R)
    if double_buffer:
        nxt = _Rotation(kv, axis_name, perm, rotate_chunks)
        state = step0_fn(state, kv)
        for s in range(1, R - 1):
            kvb = nxt.wait()
            nxt = _Rotation(kvb, axis_name, perm, rotate_chunks)
            state = step_fn(state, kvb, s)
        return step_fn(state, nxt.wait(), R - 1)
    state = step0_fn(state, kv)
    for s in range(1, R):
        kv = _Rotation(kv, axis_name, perm, rotate_chunks).wait()
        state = step_fn(state, kv, s)
    return state


def _ring_bwd_scan(kv, dq0, dkv0, step_bwd, axis_name, R, rotate_chunks=1):
    """Backward rotation driver: the dk/dv accumulators travel WITH the kv
    buffer (each rank adds its contribution to whatever kv it holds), and
    ONE extra rotation after the last step brings them home."""
    if R == 1:
        return dq0, dkv0
    perm = _ring_perm(R)
    dq, kvb, dkvb = dq0, kv, dkv0
    for s in range(1, R):
        rk = _Rotation(kvb, axis_name, perm, rotate_chunks)
        rd = _Rotation(dkvb, axis_name, perm, rotate_chunks)
        kvb, dkvb = rk.wait(), rd.wait()
        dq, dkvb = step_bwd(dq, kvb, dkvb, s)
    return dq, _Rotation(dkvb, axis_name, perm, rotate_chunks).wait()


# ------------------------------------------------------ zigzag causal core

def _zig_step(st, kvb, s, *, qf, r, C, step):
    """One zigzag ring step s >= 1: the (q_late x kv_early) full pair,
    then (q_early x kv_early) when the kv came from an earlier rank
    (s <= r), else (q_late x kv_late): two C x C unmasked pairs a step on
    every rank."""
    kf, vf = kvb[0], kvb[1]
    early, late = _halves(st, C)
    _assign(late, step(qf[:, C:], kf[:, :C], vf[:, :C], late, False))
    if s <= r:
        _assign(early, step(qf[:, :C], kf[:, :C], vf[:, :C], early, False))
    else:
        _assign(late, step(qf[:, C:], kf[:, C:], vf[:, C:], late, False))
    return st


def _zig_step_bwd(dq, kvb, dkvb, s, *, qf, of, lsef, dof, r, C, bstep):
    kf, vf = kvb[0], kvb[1]
    E, L = slice(0, C), slice(C, None)
    dqa, dka, dva = bstep(qf[:, L], kf[:, E], vf[:, E], of[:, L],
                          lsef[:, L], dof[:, L], False)
    dq[:, L] += dqa.float()
    dkvb[0, :, E] += dka.float()
    dkvb[1, :, E] += dva.float()
    half = E if s <= r else L   # q early x kv early, or q late x kv late
    dqc, dkc, dvc = bstep(qf[:, half], kf[:, half], vf[:, half],
                          of[:, half], lsef[:, half], dof[:, half], False)
    dq[:, half] += dqc.float()
    dkvb[0, :, half] += dkc.float()
    dkvb[1, :, half] += dvc.float()
    return dq, dkvb


def _prep(q, k, v, scale):
    """(qf pre-scaled in q's dtype, the stacked kv rotation buffer)."""
    return (scale_q(_fold(q), scale),
            torch.stack([_fold(k), _fold(v)]))


def _zig_fwd_impl(q, k, v, axis_name, R, scale, use_kernel, double_buffer,
                  rotate_chunks):
    """Zigzag-local (B, 2C, H, D) q/k/v -> (o, (o folded, lse)). Step 0 is
    plain causal attention on the local buffer (the zigzag pair's local
    order IS the global causal order), later steps unmasked pairs."""
    B, Tl, H, D = q.shape
    C = Tl // 2
    r = comm.axis_index(axis_name)
    step, _ = _make_steps(use_kernel)
    qf, kv = _prep(q, k, v, scale)
    state = flash_block_state(B * H, Tl, D, device=q.device)

    def step0(st, kvb):
        return step(qf, kvb[0], kvb[1], st, True)

    state = _ring_scan(
        kv, state, step0,
        functools.partial(_zig_step, qf=qf, r=r, C=C, step=step),
        axis_name, R, double_buffer, rotate_chunks)
    of, lse = flash_block_finalize(state)
    o = of.to(q.dtype)
    return _unfold(o, B, H), (o, lse)


class _RingZigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis_name, R, scale, use_kernel,
                double_buffer, rotate_chunks):
        o, (of, lsef) = _zig_fwd_impl(q, k, v, axis_name, R, scale,
                                      use_kernel, double_buffer,
                                      rotate_chunks)
        ctx.save_for_backward(q, k, v, of, lsef)
        ctx.args = (axis_name, R, scale, use_kernel, rotate_chunks)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, of, lsef = ctx.saved_tensors
        axis_name, R, scale, use_kernel, rotate_chunks = ctx.args
        B, Tl, H, D = q.shape
        C = Tl // 2
        r = comm.axis_index(axis_name)
        _, bstep = _make_steps(use_kernel)
        qf, kv = _prep(q, k, v, scale)
        dof = _fold(do.to(q.dtype))
        dq0, dk0, dv0 = bstep(qf, kv[0], kv[1], of, lsef, dof, True)
        dq, dkv = _ring_bwd_scan(
            kv, dq0.float(), torch.stack([dk0, dv0]).float(),
            functools.partial(_zig_step_bwd, qf=qf, of=of, lsef=lsef,
                              dof=dof, r=r, C=C, bstep=bstep),
            axis_name, R, rotate_chunks)
        dq = dq * scale                # q was pre-scaled into the steps
        return (_unfold(dq, B, H).to(q.dtype),
                _unfold(dkv[0], B, H).to(k.dtype),
                _unfold(dkv[1], B, H).to(v.dtype),
                None, None, None, None, None, None)


# -------------------------------------------------- non-causal (full) core

def _full_fwd_impl(q, k, v, axis_name, R, scale, use_kernel, double_buffer,
                   rotate_chunks):
    B, Tl, H, D = q.shape
    step, _ = _make_steps(use_kernel)
    qf, kv = _prep(q, k, v, scale)
    state = flash_block_state(B * H, Tl, D, device=q.device)

    def pair(st, kvb):
        return step(qf, kvb[0], kvb[1], st, False)

    state = _ring_scan(kv, state, pair, lambda st, kvb, s: pair(st, kvb),
                       axis_name, R, double_buffer, rotate_chunks)
    of, lse = flash_block_finalize(state)
    o = of.to(q.dtype)
    return _unfold(o, B, H), (o, lse)


class _RingFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, axis_name, R, scale, use_kernel,
                double_buffer, rotate_chunks):
        o, (of, lsef) = _full_fwd_impl(q, k, v, axis_name, R, scale,
                                       use_kernel, double_buffer,
                                       rotate_chunks)
        ctx.save_for_backward(q, k, v, of, lsef)
        ctx.args = (axis_name, R, scale, use_kernel, rotate_chunks)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, of, lsef = ctx.saved_tensors
        axis_name, R, scale, use_kernel, rotate_chunks = ctx.args
        B, Tl, H, D = q.shape
        _, bstep = _make_steps(use_kernel)
        qf, kv = _prep(q, k, v, scale)
        dof = _fold(do.to(q.dtype))

        def pair_bwd(dq, kvb, dkvb, s):
            dqs, dks, dvs = bstep(qf, kvb[0], kvb[1], of, lsef, dof, False)
            dq += dqs.float()
            dkvb[0] += dks.float()
            dkvb[1] += dvs.float()
            return dq, dkvb

        dq0, dkv0 = pair_bwd(torch.zeros(qf.shape, device=q.device),
                             kv, torch.zeros(kv.shape, device=q.device), 0)
        dq, dkv = _ring_bwd_scan(kv, dq0, dkv0, pair_bwd, axis_name, R,
                                 rotate_chunks)
        dq = dq * scale
        return (_unfold(dq, B, H).to(q.dtype),
                _unfold(dkv[0], B, H).to(k.dtype),
                _unfold(dkv[1], B, H).to(v.dtype),
                None, None, None, None, None, None)


# -------------------------------------------- contiguous causal (fallback)

def _ring_contiguous(q, k, v, axis_name, ring, scale):
    """The pre-zigzag dense path, kept for ``layout='contiguous'``: every
    block pair is computed and then positionally masked (~2x the causal
    FLOPs zigzag removes); KV rotates as one stacked buffer. Plain torch
    ops differentiated by autograd through :class:`_PPermute`."""
    my_block = comm.axis_index(axis_name)
    B, T, H, D = q.shape
    dev = q.device
    m = torch.full((B, H, T), NEG_INF, device=dev)
    l = torch.zeros(B, H, T, device=dev)
    acc = torch.zeros(B, T, H, D, device=dev)
    perm = _ring_perm(ring)
    kv = torch.stack([k, v])
    pos = torch.arange(T, device=dev)
    for i in range(ring):
        if i:
            kv = _ppermute(kv, axis_name, perm)
        # after i rotations this rank holds block (my_block - i) mod ring
        src = (my_block - i) % ring
        scores = torch.einsum("bthd,bshd->bhts", q.float(),
                              kv[0].float()) * scale
        mask = (my_block * T + pos)[:, None] >= (src * T + pos)[None, :]
        scores = torch.where(mask[None, None], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhts,bshd->bthd", p, kv[1].float())
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


# ------------------------------------------------------------- public API

def _resolve_blocks(block_kernel):
    """True / "auto" -> the K10 / K2 steps ("auto": the JAX package's
    choice on a winner-cache miss); False -> the einsum steps."""
    if block_kernel not in (True, False, "auto"):
        raise ValueError(f"block_kernel must be True|False|'auto', got "
                         f"{block_kernel!r}")
    return block_kernel is not False


def _resolve_rotate(rotate_chunks, R, D):
    """Exchanges a rotation is split into: "auto" -> 1 (one stacked
    exchange, the JAX cold-cache choice); a count that does not divide
    the head dim degrades to 1."""
    if R <= 1:
        return 1
    rc = 1 if rotate_chunks == "auto" else int(rotate_chunks or 1)
    if rc > 1 and D % rc:
        rc = 1
    return max(1, rc)


def ring_attention(q, k, v, axis_name="seq", causal=True, *,
                   layout="zigzag", block_kernel="auto", double_buffer=True,
                   rotate_chunks="auto", interpret=None, scale=None):
    """Blockwise ring attention over the ranks of ``axis_name``.

    q, k, v: (B, T_local, H, D) — this rank's contiguous sequence block.
    Returns (B, T_local, H, D), exact (the carried online-softmax state is
    algebraically dense softmax attention). ``layout='zigzag'`` (causal
    only) rebalances the causal triangle internally; ``block_kernel``:
    True / "auto" (K10 / K2 steps) | False (dense einsum steps).
    ``interpret`` is accepted and changes nothing."""
    ring = groups.get_topology().axis_size(axis_name)
    B, Tl, H, D = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    use_kernel = _resolve_blocks(block_kernel)
    rc = _resolve_rotate(rotate_chunks, ring, D)
    args = (axis_name, ring, float(scale), use_kernel, bool(double_buffer),
            rc)
    if not causal:
        return _RingFull.apply(q, k, v, *args)
    if ring == 1:
        return _RingZigzag.apply(q, k, v, *args)
    if layout not in ("zigzag", "contiguous"):
        raise ValueError(
            f"ring layout must be 'zigzag'|'contiguous', got {layout!r}")
    if layout == "zigzag" and Tl % 2 == 0:
        qkv = _to_zigzag(torch.stack([q, k, v]), axis_name, ring, axis=2)
        o = _RingZigzag.apply(qkv[0], qkv[1], qkv[2], *args)
        return _from_zigzag(o, axis_name, ring, axis=1)
    if layout == "zigzag":
        logger.warning(
            f"ring zigzag needs an even per-rank chunk (got T_local={Tl}); "
            f"falling back to the contiguous masked-einsum path")
    return _ring_contiguous(q, k, v, axis_name, ring, scale)


def ring_flops_info(ring, T_local, causal=True, layout="zigzag"):
    """Static block-pair accounting for one rank, in C x C chunk-pair units
    (C = T_local // 2 under zigzag): ``computed_pairs`` the kernel calls'
    coverage, ``skipped_pairs`` the fully-masked pairs never computed."""
    R = int(ring)
    if R == 1 and causal:
        return {"computed_pairs": 4, "diagonal_pairs": 4,
                "skipped_pairs": 0, "total_pairs": 4}
    if not causal or layout != "zigzag":
        return {"computed_pairs": 4 * R, "diagonal_pairs": 0,
                "skipped_pairs": 0, "total_pairs": 4 * R}
    computed = 4 + 2 * (R - 1)
    total = 4 * R
    return {"computed_pairs": computed, "diagonal_pairs": 4,
            "skipped_pairs": total - computed, "total_pairs": total}


def ring_attention_sharded(q, k, v, *, axis_name="seq", causal=True,
                           layout="zigzag", block_kernel="auto",
                           double_buffer=True, rotate_chunks="auto",
                           interpret=None):
    """Global-tensor entry: every rank of ``axis_name`` passes the same
    (B, T, H, D) q/k/v; each takes its contiguous sequence block, the ring
    runs over the group, and the blocks' outputs are gathered back to the
    global (B, T, H, D) on every rank. Gradients reach each rank's own
    block of q/k/v (sum them over the group for the global gradient)."""
    q, k, v = (shard_sequence(x, axis_name) for x in (q, k, v))
    o = ring_attention(q, k, v, axis_name, causal, layout=layout,
                       block_kernel=block_kernel,
                       double_buffer=double_buffer,
                       rotate_chunks=rotate_chunks)
    return gather_sequence(o, axis_name)
