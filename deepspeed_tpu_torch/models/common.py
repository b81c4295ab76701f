"""Helpers shared by the port's training models.

Counterpart of ``deepspeed_tpu/models/common.py``: the remat policy names,
next-token cross entropy, the chunked and the fused (gradient-in-forward)
linear + cross-entropy heads. ``jax.custom_vjp`` becomes
``torch.autograd.Function``; ``lax.scan`` over chunks becomes a loop.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.cuda.fused_ce import unembed_logits_stats

_TODO_REMAT = "(ROADMAP Queue 1, M3: more remat policies)"

# the JAX package's named policies (common.py:60-75); the port carries
# whole-block remat and save_flash
_JAX_POLICIES = ("save_attn", "save_mid", "save_mid_up", "save_flash",
                 "save_carry_flash", "save_both_flash", "save_flash_up",
                 "save_flash_qkv", "nothing_saveable", "everything_saveable",
                 "dots_saveable", "dots_with_no_batch_dims_saveable")
REMAT_POLICIES = ("nothing_saveable", "save_flash")


def resolve_flash(value, device):
    """Resolve a use_flash_attention value: "auto" -> the flash kernels
    when the model lives on a CUDA device, dense elsewhere; True/False
    force."""
    if value == "auto":
        return torch.device(device).type == "cuda"
    return bool(value)


def resolve_remat_policy(name):
    """Model remat_policy name -> the policy the port runs.

    'nothing_saveable': each block runs under torch.utils.checkpoint and is
    recomputed whole in backward (the flash forward runs again, as under a
    whole-block jax.checkpoint). 'save_flash': each block keeps its input,
    the post-attention residual ('attn_mid') and the flash o/lse, and
    backward recomputes ln1 + qkv and ln2 + MLP only, never the flash
    forward. Other JAX policy names raise NotImplementedError."""
    if name in REMAT_POLICIES:
        return name
    if name in _JAX_POLICIES:
        raise NotImplementedError(
            f"remat_policy {name!r} is not ported yet {_TODO_REMAT}")
    raise ValueError(f"unknown remat_policy {name!r}")


class _MmF32(torch.autograd.Function):
    """a @ b in fp32 from bf16 operands on the card (``torch.mm`` with
    ``out_dtype``, which has no autograd formula), with the gradient JAX
    gives a dot with ``preferred_element_type=float32``: the fp32
    cotangent times the other operand in fp32, rounded to each operand's
    dtype (what the CPU path's ``a.float() @ b.float()`` computes)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.mm(g, b.float().t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.mm(a.float().t(), g).to(b.dtype)
        return da, db


def mm_f32(a, b):
    """a @ b with an fp32 result: bf16 operands accumulate in fp32 on the
    card (``preferred_element_type=float32``) without an fp32 copy of
    either in the forward; fp32 operands multiply as they are."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if a.is_cuda:
        return _MmF32.apply(a, b)
    return a.float() @ b.float()


def next_token_xent(logits, ids):
    """Mean next-token cross entropy from dense (B, T, V) fp32 logits."""
    targets = ids[:, 1:].long()
    logits = logits[:, :-1]
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (logz - gold).mean()


def _xent_chunks(hidden, targets, chunk):
    """Pad (B, T, D)/(B, T) to a chunk multiple: (hidden (B, n*c, D),
    targets (B, n*c), valid (n*c,) bool, n)."""
    B, T, D = hidden.shape
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
    valid = torch.arange(n * chunk, device=hidden.device) < T
    return hidden, targets, valid, n


def _chunk(x, i, chunk):
    return x[:, i * chunk:(i + 1) * chunk]


def chunked_softmax_xent(head_fn, hidden, targets, chunk):
    """Mean next-token CE over (B, T, D) hidden states computed ``chunk``
    tokens at a time; ``head_fn(x_chunk)`` gives fp32 logits for just that
    chunk and is recomputed in backward (torch.utils.checkpoint), so peak
    logits memory is (B, chunk, V). Padded positions are masked out."""
    B, T, D = hidden.shape
    xs, ts, valid, n = _xent_chunks(hidden, targets, chunk)

    def chunk_loss(x, t, m):
        logits = head_fn(x)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, t.long()[..., None])[..., 0]
        return torch.where(m, logz - gold, 0.0).sum()

    total = hidden.new_zeros((), dtype=torch.float32)
    for i in range(n):
        total = total + checkpoint(chunk_loss, _chunk(xs, i, chunk),
                                   _chunk(ts, i, chunk),
                                   valid[i * chunk:(i + 1) * chunk],
                                   use_reentrant=False)
    return total / (B * T)


def _scale_by(g, t):
    return (g * t.float()).to(t.dtype)


def fused_linear_xent(head_fn, chunk, head_params, hidden, targets):
    """Mean next-token CE over (B, T, D) hidden states with the head's
    gradients computed IN FORWARD: the loss is a scalar, so backward only
    multiplies the pre-scaled d_hidden and d_head_params by the incoming
    g. ``head_fn(params_list, x)`` -> fp32 logits reads only
    ``head_params`` (a dict), so the accumulator is head-sized. Without
    any input needing a gradient the forward computes the loss only."""
    keys = list(head_params)
    return _FusedXent.apply(head_fn, chunk, keys, hidden, targets,
                            *[head_params[k] for k in keys])


class _FusedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, head_fn, chunk, keys, hidden, targets, *params):
        B, T, D = hidden.shape
        xs, ts, valid, n = _xent_chunks(hidden, targets, chunk)
        denom = B * T
        want_grad = any(ctx.needs_input_grad)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params] if want_grad else None
        d_xs = torch.empty_like(xs) if want_grad else None
        for i in range(n):
            x, t = _chunk(xs, i, chunk), _chunk(ts, i, chunk).long()
            m = valid[i * chunk:(i + 1) * chunk]
            if not want_grad:
                logits = head_fn(list(params), x)
            else:
                with torch.enable_grad():
                    ps = [p.detach().requires_grad_() for p in params]
                    xr = x.detach().requires_grad_()
                    logits = head_fn(ps, xr)
            lg = logits.detach()
            logz = torch.logsumexp(lg, dim=-1)
            gold = torch.gather(lg, -1, t[..., None])[..., 0]
            total = total + torch.where(m, logz - gold, 0.0).sum()
            if not want_grad:
                continue
            p = torch.exp(lg - logz[..., None])
            onehot = (t[..., None] == torch.arange(
                lg.shape[-1], device=t.device)).to(p.dtype)
            d_logits = torch.where(m[:, None], p - onehot, 0.0) / denom
            if hidden.dtype == torch.bfloat16:
                d_logits = d_logits.to(torch.bfloat16).to(lg.dtype)
            grads = torch.autograd.grad(logits, ps + [xr], d_logits,
                                        allow_unused=True)
            for a, g in zip(acc, grads[:-1]):
                if g is not None:
                    a += g.float()
            _chunk(d_xs, i, chunk).copy_(grads[-1])
        if want_grad:
            ctx.d_params = [a.to(p.dtype) for a, p in zip(acc, params)]
            ctx.d_hidden = d_xs[:, :T].to(hidden.dtype)
        return total / denom

    @staticmethod
    def backward(ctx, g):
        return (None, None, None, _scale_by(g, ctx.d_hidden), None,
                *[_scale_by(g, d) for d in ctx.d_params])


def fused_linear_xent_kernel(norm_fn, chunk, norm_params, w, hidden,
                             targets):
    """``fused_linear_xent`` with the unembed computed by the fused CE
    kernel (ops/cuda/fused_ce.py): logits come out once in the hidden
    dtype with exact fp32 logz/gold, and d_logits forms from those returned
    logits. ``norm_fn(params_list, x)`` is the pre-unembed final norm;
    ``w`` the (V, D) unembed matrix. The two backward products (d_w, d_h)
    are plain matmuls, as the JAX package leaves them to XLA."""
    keys = list(norm_params)
    return _FusedXentKernel.apply(norm_fn, chunk, w, hidden, targets,
                                  *[norm_params[k] for k in keys])


class _FusedXentKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, norm_fn, chunk, w, hidden, targets, *params):
        B, T, D = hidden.shape
        xs, ts, valid, n = _xent_chunks(hidden, targets, chunk)
        denom = B * T
        V = w.shape[0]
        want_grad = any(ctx.needs_input_grad)
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        if want_grad:
            acc_np = [torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for p in params]
            acc_w = torch.zeros(w.shape, dtype=torch.float32,
                                device=w.device)
            d_xs = torch.empty_like(xs)
        for i in range(n):
            x, t = _chunk(xs, i, chunk), _chunk(ts, i, chunk)
            m = valid[i * chunk:(i + 1) * chunk]
            c = x.shape[1]
            mflat = m[None, :].expand(B, c).reshape(-1)
            tf = t.reshape(-1)
            if not want_grad:
                hf = norm_fn(list(params), x).reshape(-1, D)
                _, logz, gold = unembed_logits_stats(hf, w, tf)
                total = total + torch.where(mflat, logz - gold, 0.0).sum()
                continue
            with torch.enable_grad():
                ps = [p.detach().requires_grad_() for p in params]
                xr = x.detach().requires_grad_()
                h = norm_fn(ps, xr)
            hf = h.detach().reshape(-1, D)
            logits, logz, gold = unembed_logits_stats(hf, w, tf)
            total = total + torch.where(mflat, logz - gold, 0.0).sum()
            # d_logits = where(valid, softmax - onehot, 0) / denom, formed in
            # place from the kernel's returned logits (fused_ce's rounding)
            p = logits.float().sub_(logz[:, None]).exp_()
            tl = tf.long()
            hit = mflat & (tl >= 0) & (tl < V)
            p.scatter_add_(1, tl.clamp(0, V - 1)[:, None],
                           -hit.to(p.dtype)[:, None])
            p.masked_fill_(~mflat[:, None], 0.0)
            d_logits = p.div_(denom).to(hidden.dtype)
            del p, logits
            acc_w += mm_f32(d_logits.t(), hf)
            d_h = mm_f32(d_logits, w).to(hidden.dtype).reshape(h.shape)
            del d_logits
            grads = torch.autograd.grad(h, ps + [xr], d_h)
            for a, g in zip(acc_np, grads[:-1]):
                a += g.float()
            _chunk(d_xs, i, chunk).copy_(grads[-1])
        if want_grad:
            ctx.d_params = [a.to(p.dtype) for a, p in zip(acc_np, params)]
            ctx.d_w = acc_w.to(w.dtype)
            ctx.d_hidden = d_xs[:, :T].to(hidden.dtype)
        return total / denom

    @staticmethod
    def backward(ctx, g):
        return (None, None, _scale_by(g, ctx.d_w),
                _scale_by(g, ctx.d_hidden), None,
                *[_scale_by(g, d) for d in ctx.d_params])
