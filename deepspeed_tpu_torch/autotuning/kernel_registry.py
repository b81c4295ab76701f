"""Tunable-parameter registry over the port's kernels.

Counterpart of ``deepspeed_tpu/autotuning/kernel_registry.py``: one entry
per autotunable op, with JAX's op names and bucket strings, whose
parameters are the port's own levers (not the TPU's tile sizes). Each entry
owns, for a shape bucket (the strings of ``ops/cuda/_common``):

  ``defaults(b)``     what the port runs without a cache: what dispatch
                      falls back to on a miss, and the baseline candidate
                      every search times first
  ``candidates(b, dtype)``
                      the measured search space: levers the port's
                      kernels really have (a lever a design ignores is not
                      offered, so no two candidates run the same code)
  ``make_step(b, dtype, params, device)``
                      -> (step_fn, args): a step whose output feeds its
                      next input (forward and backward where the op has
                      one), chained by ``kernel_autotuner.time_step``;
                      None for an op with one candidate, never searched
  ``parity(b, dtype, params, device)``
                      the candidate against the plain version in fp32 on
                      the same inputs (raises on a mismatch), at the limits
                      of PERF.md §2: bf16 outputs' rows within a relative
                      error norm of 1e-2, gradients within 2e-2, fp32
                      within 1e-4; None with ``make_step``

No candidate puts a plain (step-by-step) version where a kernel runs:
paged decode / chunk ``dense`` and the MoE ``ragged`` backend stay explicit
opt-ins (``paged_kernel=False``, ``grouped_kernel=False``), and
``names_plain`` names such a winner so that dispatch refuses it on a card.
The non-kernel candidates that remain are what the JAX package computes
outside any Pallas kernel: the MLP's plain products and the plain
LayerNorm.

An op whose bucket offers one candidate is not searched (dispatch takes
its defaults; a cached entry still applies). The MoE op has one: K8 takes
no lever. So have the serving policies (``prefix_cache``,
``spec_decode``): JAX prices them
on a synthetic matmul under assumed traffic (a shared half of every
prompt, a fixed acceptance rate), which measures nothing of the port's
traffic; a search decides them once a step replays measured traffic
(ROADMAP). Each step runs at its bucket's own size; where the bucket
holds no batch (flash, MLP), at GPT-2 350M training's.

JAX's ``fused_ce`` and ``ring_block`` ops have no entry: K3 and K10 take
no lever, so no call of the port would read a winner. Nor has
``kv_handoff``: its one reader is the planner, not ported (M14).
"""

import math

import torch
import torch.nn.functional as F

from ..inference.v2.prefix_cache import PREFIX_CACHE_DEFAULTS
from ..inference.v2.speculative import SPEC_DEFAULTS
from ..moe.sharded_moe import TUNE_DEFAULTS as MOE_GROUPED_DEFAULTS
from ..ops.cuda.flash_attention import QMAJOR_HEAD_DIMS
from ..ops.cuda.flash_attention import TUNE_DEFAULTS as FLASH_DEFAULTS
from ..ops.cuda.paged_attention import (CHUNK_MAX_SPLITS,
                                        CHUNK_SM90_BLOCK_SIZES,
                                        CHUNK_SM90_HEAD_DIMS,
                                        PAGED_DECODE_DEFAULTS, decode_splits,
                                        paged_chunk_tune_defaults)

# small perturbation chaining step i's gradients (or output) into step
# i + 1's inputs: the steps stay data-dependent without drifting the
# activations out of a realistic range
_EPS = 1e-3

ROW_REL_NORM = 1e-2          # bf16 / fp16 outputs, row by row
GRAD_REL_NORM = 2e-2         # bf16 / fp16 gradients, tensor by tensor
FP32_TOL = 1e-4

# the defaults of the ops no kernel module owns (a kernel module's
# TUNE_DEFAULTS is the one source of its op's): the model-level knobs
MLP_DEFAULTS = {"mode": "plain", "fuse_dw": True}
LN_DEFAULTS = {"variant": "plain"}
# the buckets of flash and the MLP hold no batch (flash no heads): their
# steps take GPT-2 350M training's (micro batch 8, 16 heads)
_FLASH_BH = (8, 16)
_MLP_BATCH = 8


def parse_bucket(bucket):
    """'T1024,d64,c1,q1' -> {'T': 1024, 'd': 64, 'c': 1, 'q': 1}."""
    out = {}
    for part in bucket.split(","):
        i = 1
        while i < len(part) and not (part[i].isdigit() or part[i] == "-"):
            i += 1
        out[part[:i]] = int(part[i:])
    return out


def _dedup(cands):
    seen, out = set(), []
    for c in cands:
        key = tuple(sorted((k, repr(v)) for k, v in c.items()))
        if key not in seen:
            seen.add(key)
            out.append(dict(c))
    return out


def _dt(dtype):
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def _gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def _randn(g, shape, dtype, device, scale=1.0):
    return (torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32) * scale).to(_dt(dtype))


def _close(got, ref, what, grad=False):
    """``got`` (any dtype) against the fp32 ``ref``: fp32 at FP32_TOL
    element by element; 16-bit by relative error norms (rows of the last
    dim for outputs, the tensor for gradients)."""
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{what}: non-finite values")
    if got.dtype == torch.float32:
        torch.testing.assert_close(g, r, rtol=FP32_TOL, atol=FP32_TOL,
                                   msg=lambda m: f"{what}: {m}")
        return
    diff = g - r
    if grad:
        rel = (torch.linalg.vector_norm(diff)
               / torch.linalg.vector_norm(r).clamp_min(1e-30)).item()
        limit = GRAD_REL_NORM
    else:
        d2, r2 = diff.reshape(-1, diff.shape[-1]), r.reshape(-1, r.shape[-1])
        rel = (torch.linalg.vector_norm(d2, dim=-1)
               / torch.linalg.vector_norm(r2, dim=-1).clamp_min(1e-30)
               ).max().item()
        limit = ROW_REL_NORM
    if rel > limit:
        raise AssertionError(f"{what}: relative error norm {rel:.3g} > "
                             f"{limit}")


def _grads_step(f, n):
    """A step over an n-tuple of tensors: the gradients of sum(f(*a)^2)
    nudge every operand (the JAX steps' chaining)."""
    def step(carry):
        with torch.enable_grad():
            a = [t.detach().requires_grad_() for t in carry]
            loss = f(*a).float().square().sum()
            grads = torch.autograd.grad(loss, a)
        return tuple((t + _EPS * gr.to(t.dtype)).detach()
                     for t, gr in zip(carry, grads))
    return step


def _grad_parity(f, ref, args, what, do_seed=2):
    """f and the fp32 ``ref`` on ``args``: outputs row by row, then the
    gradients of <out, do> for a seeded do."""
    with torch.enable_grad():
        a = [t.detach().requires_grad_() for t in args]
        out = f(*a)
        a32 = [t.detach().float().requires_grad_() for t in args]
        out32 = ref(*a32)
        do = _randn(_gen(do_seed, out.device), out.shape, torch.float32,
                    out.device)
        ga = torch.autograd.grad(out.float(), a, do)
        gr = torch.autograd.grad(out32, a32, do)
    _close(out, out32, f"{what} output")
    for i, (x, y) in enumerate(zip(ga, gr)):
        _close(x, y, f"{what} d(arg {i})", grad=True)


# ------------------------------------------------------------------ flash


def _flash_defaults(b):
    return dict(FLASH_DEFAULTS)


def _flash_candidates(b, dtype):
    """K2 (the key-major backward) vs K2-qmajor, on qkv_t layouts only (the
    JAX rule), at the head dims and dtypes K2-qmajor takes."""
    cands = [dict(FLASH_DEFAULTS)]
    if b["q"] and b["d"] in QMAJOR_HEAD_DIMS \
            and str(dtype) in ("bfloat16", "float32"):
        cands.append({"bwd_qmajor": True})
    return _dedup(cands)


def _flash_fn(b, params):
    from ..ops.cuda.flash_attention import flash_attention
    causal, qkv_t = bool(b["c"]), bool(b["q"])

    def f(q, k, v):
        return flash_attention(q, k, v, causal=causal, qkv_t=qkv_t,
                               heads_major=not qkv_t,
                               bwd_qmajor=bool(params["bwd_qmajor"]))
    return f


def _flash_ref(b):
    causal, qkv_t = bool(b["c"]), bool(b["q"])

    def f(q, k, v):
        if qkv_t:
            q, k, v = (t.transpose(-1, -2) for t in (q, k, v))
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        if causal:
            T = s.shape[-1]
            s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool,
                                          device=s.device).tril(), -1e30)
        return torch.matmul(torch.softmax(s, -1), v)
    return f


def _flash_args(b, dtype, device, seed):
    B, H = _FLASH_BH
    shape = (B, H, b["d"], b["T"]) if b["q"] else (B, H, b["T"], b["d"])
    g = _gen(seed, device)
    return tuple(_randn(g, shape, dtype, device) for _ in range(3))


def _flash_step(b, dtype, params, device):
    return (_grads_step(_flash_fn(b, params), 3),
            _flash_args(b, dtype, device, 0))


def _flash_parity(b, dtype, params, device):
    bp = dict(b, T=min(b["T"], 1024))
    _grad_parity(_flash_fn(bp, params), _flash_ref(bp),
                 _flash_args(bp, dtype, device, 1),
                 f"flash_attention {params}")


# ------------------------------------------------------------------- mlp


def _mlp_defaults(b):
    return dict(MLP_DEFAULTS)


def _mlp_candidates(b, dtype):
    """The plain products (the JAX XLA einsums), K6 on the down projection,
    K6 on both, each with the fused and the plain dW."""
    cands = [dict(MLP_DEFAULTS)]
    for mode in ("down", "both"):
        cands.append(dict(MLP_DEFAULTS, mode=mode))
        cands.append(dict(MLP_DEFAULTS, mode=mode, fuse_dw=False))
    return _dedup(cands)


def _gelu(u):
    return F.gelu(u, approximate="tanh")


def _mlp_fn(params):
    mode = params["mode"]

    def f(h, wu, wd):
        if mode == "plain":
            return _gelu(h @ wu) @ wd
        from ..ops.cuda.mlp_matmul import mlp_matmul
        fuse = bool(params["fuse_dw"])
        if mode == "both":
            u = mlp_matmul(h, wu, out_t=True, fuse_dw=fuse)
        else:
            u = torch.einsum("btd,df->bft", h, wu)
        return mlp_matmul(_gelu(u), wd, x_t=True, fuse_dw=fuse)
    return f


def _mlp_args(b, dtype, device, seed):
    T, D, Fd = b["T"], b["D"], b["F"]
    g = _gen(seed, device)
    return (_randn(g, (_MLP_BATCH, T, D), dtype, device),
            _randn(g, (D, Fd), dtype, device, 1 / math.sqrt(D)),
            _randn(g, (Fd, D), dtype, device, 1 / math.sqrt(Fd)))


def _mlp_step(b, dtype, params, device):
    return (_grads_step(_mlp_fn(params), 3),
            _mlp_args(b, dtype, device, 0))


def _mlp_parity(b, dtype, params, device):
    _grad_parity(_mlp_fn(params), _mlp_fn(MLP_DEFAULTS),
                 _mlp_args(b, dtype, device, 1), f"mlp_matmul {params}")


# ------------------------------------------------------------- layernorm


def _ln_defaults(b):
    return dict(LN_DEFAULTS)


def _ln_candidates(b, dtype):
    """The plain LayerNorm (XLA's fusion in JAX) vs K13 forward and backward
    vs the plain forward with K13's backward; K13 needs D % 128 == 0."""
    cands = [dict(LN_DEFAULTS)]
    if b["D"] % 128 == 0:
        cands.append({"variant": "fused"})
        cands.append({"variant": "bwd"})
    return _dedup(cands)


def _ln_fn(params):
    from ..ops.cuda.layernorm import (fused_layernorm, layernorm_fused_bwd,
                                      layernorm_reference)
    return {"fused": fused_layernorm, "bwd": layernorm_fused_bwd,
            "plain": layernorm_reference}[params["variant"]]


def _ln_args(b, dtype, device, seed):
    R, D = b["R"], b["D"]
    g = _gen(seed, device)
    return (_randn(g, (R, D), dtype, device),
            (1 + _randn(g, (D,), torch.float32, device, 0.1)).to(_dt(dtype)),
            _randn(g, (D,), dtype, device, 0.1))


def _ln_step(b, dtype, params, device):
    return (_grads_step(_ln_fn(params), 3), _ln_args(b, dtype, device, 0))


def _ln_parity(b, dtype, params, device):
    _grad_parity(_ln_fn(params), _ln_fn(LN_DEFAULTS),
                 _ln_args(b, dtype, device, 1), f"layernorm {params}")


# ------------------------------------------------- paged serving kernels
# The v2 engine's decode step and chunk programs, forward only: steps
# chain the attention output back into q.


def _pgd_defaults(b):
    return dict(PAGED_DECODE_DEFAULTS)


def _pgd_candidates(b, dtype):
    """K4's split size: 256, 512, 1024 positions or the whole table (one
    split), each kept once per distinct split of the bucket's table."""
    cands, seen = [], set()
    for sp in (PAGED_DECODE_DEFAULTS["split_positions"], 256, 512, 1024, 0):
        S, bps = decode_splits(b["MB"], b["BS"], sp)
        eff = (S, min(bps, b["MB"]))        # a split past the table: whole
        if eff not in seen:
            seen.add(eff)
            cands.append({"mode": "kernel", "split_positions": sp})
    return cands


def _pgd_args(b, dtype, device, seed):
    B, MB, BS = b["B"], b["MB"], b["BS"]
    KVH, G, d = b["kh"], b["g"], b["d"]
    NB = 2 * MB + 1
    g = _gen(seed, device)
    q = _randn(g, (B, KVH * G, d), dtype, device)
    kc = _randn(g, (NB, KVH, BS, d), dtype, device)
    vc = _randn(g, (NB, KVH, BS, d), dtype, device)
    tables = torch.randint(0, NB, (B, MB), generator=g, device=device,
                           dtype=torch.int32)
    lengths = torch.randint(0, MB * BS, (B,), generator=g, device=device,
                            dtype=torch.int32)
    return q, kc, vc, tables, lengths


def _pgd_fn(params):
    from ..ops.cuda.paged_attention import (paged_decode_attention,
                                            paged_decode_attention_reference)
    if params["mode"] != "kernel":
        return paged_decode_attention_reference

    def f(q, kc, vc, tables, lengths):
        return paged_decode_attention(
            q, kc, vc, tables, lengths,
            split_positions=int(params["split_positions"]))
    return f


def _pgd_step(b, dtype, params, device):
    f = _pgd_fn(params)

    def step(carry):
        q, kc, vc, tables, lengths = carry
        o = f(q, kc, vc, tables, lengths)
        return (q + _EPS * o.to(q.dtype), kc, vc, tables, lengths)

    return step, _pgd_args(b, dtype, device, 0)


def _pgd_parity(b, dtype, params, device):
    from ..ops.cuda.paged_attention import paged_decode_attention_reference
    q, kc, vc, tables, lengths = _pgd_args(b, dtype, device, 1)
    got = _pgd_fn(params)(q, kc, vc, tables, lengths)
    ref = paged_decode_attention_reference(q.float(), kc.float(), vc.float(),
                                           tables, lengths)
    _close(got, ref, f"paged_decode {params}")


def _pgc_defaults(b):
    return paged_chunk_tune_defaults()


def _chunk_sm90(b, dtype):
    """Whether the bucket's bf16 calls take K5's sm90 design (its shape
    rule, ``_chunk_design``, for contiguous aligned operands)."""
    return (str(dtype) == "bfloat16" and b["d"] in CHUNK_SM90_HEAD_DIMS
            and b["BS"] in CHUNK_SM90_BLOCK_SIZES and 64 % b["g"] == 0)


def _pgc_candidates(b, dtype):
    """The sm90 design's key-walk splits (the rule, or 1 / 2 / 4 / 8), or
    the SIMT / fp32 designs' query tile (16, 32, 64, 128 chunk tokens a
    CTA, clamped to C as the wrapper clamps it, each executed tile once)."""
    d = _pgc_defaults(b)
    cands = [d]
    if _chunk_sm90(b, dtype):
        for s in (1, 2, 4, 8):
            if s <= CHUNK_MAX_SPLITS:
                cands.append(dict(d, splits=s))
        return _dedup(cands)
    C = b["C"]
    seen = {min(int(d["block_c"]), C)}
    for bc in (16, 32, 64, 128):
        eff = min(bc, C)
        if eff not in seen:
            seen.add(eff)
            cands.append(dict(d, block_c=eff))
    return _dedup(cands)


def _pgc_starts(b):
    """(start, true_len) of the step's chunks: at a quarter, half and three
    quarters of the bucket's table (clamped so the chunk fits), each
    chunk's last row a pad, as JAX's mid-sequence chunk: the bucket holds
    no start, and a key-walk split count pays differently along it."""
    C, S = b["C"], b["MB"] * b["BS"]
    out = []
    for frac in (1, 2, 3):
        start = min(max(S * frac // 4, 1), max(S - C, 0))
        out.append((start, max(1, min(C - 1, S - start))))
    return out


def _pgc_args(b, dtype, device, seed):
    C, MB, BS = b["C"], b["MB"], b["BS"]
    KVH, G, d = b["kh"], b["g"], b["d"]
    NB = 2 * MB + 1
    g = _gen(seed, device)
    q = _randn(g, (C, KVH * G, d), dtype, device)
    kc = _randn(g, (NB, KVH, BS, d), dtype, device)
    vc = _randn(g, (NB, KVH, BS, d), dtype, device)
    table = torch.randint(0, NB, (MB,), generator=g, device=device,
                          dtype=torch.int32)
    return q, kc, vc, table


def _pgc_fn(params):
    from ..ops.cuda.paged_attention import (paged_chunk_attention,
                                            paged_chunk_attention_reference)
    if params["mode"] != "kernel":
        return paged_chunk_attention_reference
    splits = None if params["splits"] == "rule" else int(params["splits"])

    def f(q, kc, vc, table, start, true_len):
        return paged_chunk_attention(q, kc, vc, table, start, true_len,
                                     block_c=int(params["block_c"]),
                                     splits=splits)
    return f


def _pgc_step(b, dtype, params, device):
    f = _pgc_fn(params)
    starts = _pgc_starts(b)

    def step(carry):
        q, kc, vc, table = carry
        for start, true_len in starts:
            q = q + _EPS * f(q, kc, vc, table, start, true_len).to(q.dtype)
        return (q, kc, vc, table)

    return step, _pgc_args(b, dtype, device, 0)


def _pgc_parity(b, dtype, params, device):
    from ..ops.cuda.paged_attention import paged_chunk_attention_reference
    q, kc, vc, table = _pgc_args(b, dtype, device, 1)
    f = _pgc_fn(params)
    for start, true_len in _pgc_starts(b):
        got = f(q, kc, vc, table, start, true_len)
        ref = paged_chunk_attention_reference(
            q.float(), kc.float(), vc.float(), table, start, true_len)
        # pad rows (>= true_len) attend partly garbage positions by design;
        # the chunk program discards them
        _close(got[:true_len], ref[:true_len],
               f"paged_chunk {params} start {start}")


# ---------------------------------------------------------------- table


def _entry(prefix):
    g = globals()
    return {k: g[f"_{prefix}_{k2}"] for k, k2 in (
        ("defaults", "defaults"), ("candidates", "candidates"),
        ("make_step", "step"), ("parity", "parity"))}


def _single(defaults):
    """An op with one candidate, its defaults: nothing to search, so no
    step and no parity check."""
    return {"defaults": lambda b: dict(defaults),
            "candidates": lambda b, dtype: [dict(defaults)],
            "make_step": None, "parity": None}


REGISTRY = {
    "flash_attention": _entry("flash"),
    "mlp_matmul": _entry("mlp"),
    "layernorm": _entry("ln"),
    "paged_decode": _entry("pgd"),
    "paged_chunk": _entry("pgc"),
    "moe_grouped_mm": _single(MOE_GROUPED_DEFAULTS),
    "prefix_cache": _single(PREFIX_CACHE_DEFAULTS),
    "spec_decode": _single(SPEC_DEFAULTS),
}

# the params naming a plain (step-by-step) version where a kernel runs
_PLAIN = {"paged_decode": ("mode", "kernel"),
          "paged_chunk": ("mode", "kernel"),
          "moe_grouped_mm": ("backend", "kernel")}


def names_plain(op, params):
    """``"key=value"`` if ``params`` put a plain version where ``op``'s
    kernel runs (refused on a card), else None."""
    key, kernel = _PLAIN.get(op, (None, None))
    if key is not None and key in params and params[key] != kernel:
        return f"{key}={params[key]!r}"
    return None
