"""Flash attention (online softmax, fused backward): Hopper CUDA kernels and
their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py`` (K1 forward,
K2 fused backward, K2's query-major variant); the kernels are
``csrc/flash_attention.cu`` (design and bounds are noted there). Same
public signatures and layouts as the JAX functions: q, k, v (B, T, H, d),
or (B, H, T, d) with ``heads_major``, or (B, H, d, T) with ``qkv_t``; o
comes back in the input layout and lse is (B, H, T) fp32. The softmax scale is folded into q outside the kernel in
q's dtype, as the JAX wrapper does, so autograd chains dq through it.

The ring-attention block step (K10, flash_attention.py:1020-1189):
``flash_block_state`` / ``flash_block_fwd`` / ``flash_block_finalize`` carry
the online-softmax state (m, l, acc) across the chunk pairs of a ring
schedule on folded (B*H, T, d) operands, and ``flash_block_bwd`` replays a
pair through K2 (``flash_backward``) from the global lse and o.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
PyTorch version (``flash_forward_reference`` / ``flash_backward_reference``
/ ``flash_bwd_qmajor_reference`` / ``flash_block_fwd_reference``); a CUDA
tensor launches the kernel or raises — there is no fallback. ``LAUNCHES``
counts kernel launches: ``flash_fwd`` one per forward, ``flash_bwd`` one
per k-major backward call (its three kernels: delta, dk/dv, dq),
``flash_bwd_qmajor`` one per query-major backward (one kernel),
``flash_block_fwd`` one per ring chunk pair. The forward takes one of
three designs (``_fwd_design``): bf16 with D = 64 or 128 that TMA can
address goes to the Hopper wgmma kernel (``flash_fwd_sm90_kernel``), other
bf16 (D = 32) to the mma.sync kernel, fp32 to the scalar-FMA instance.
K10 (``flash_block_fwd``) takes the same rule on its folded (BH, 1, T, d)
views (``_block_design``): sm90 is ``flash_fwd_sm90_kernel`` with the
caller's (m, l, acc) carried in and out. Both backwards take the same rule
on their operands and gradients (``_bwd_design``): sm90 is
``flash_dkdv_sm90_kernel`` + ``flash_dq_sm90_kernel`` (k-major) or
``flash_bwd_qmajor_sm90_kernel`` (query-major), after the delta kernel;
``flash_block_bwd`` reaches it through ``flash_backward``.
``DESIGN_LAUNCHES["flash_fwd" | "flash_bwd" | "flash_bwd_qmajor" |
"flash_block_fwd"]`` counts launches by design.

fp16 operands (fp16 training) take the same rule and the same designs from
the library built with ``-DDS_ELEM_F16`` (``FlashAttentionF16Builder``:
csrc/elem16.cuh makes the 16-bit element fp16 and the wgmma / mma.sync
products their ``.f16`` forms): "sm90" at d = 64 / 128 that TMA can
address, else "mma_sync", counted in ``DESIGN_LAUNCHES`` with the rest;
``DTYPE_LAUNCHES[name]`` splits every name's launches by operand dtype
("float32" / "bfloat16" / "float16"). p and ds round to fp16 as the JAX
kernels' ``astype`` does: an overflow gives inf, never a clamped value.
K2-qmajor and K10 raise on fp16 (ROADMAP Queue 2, fp16 operands).

``bwd_qmajor`` picks the query-major backward under the JAX rule
(flash_attention.py:1578): ``qkv_t`` layouts with no bias or ALiBi only,
every other call k-major; "auto" resolves through the autotune winner
cache (op ``flash_attention``, the JAX bucket (T, d, causal, qkv_t);
``resolve_bwd_qmajor``), False on a miss (``TUNE_DEFAULTS``, JAX
flash_attention.py:46-47). The TPU tile knobs (block_q/k/h and their _bwd
twins) are accepted and change nothing. ``alibi`` (the bloom slopes) is
evaluated in every K1 / K2 design from the head index and added to the
scaled scores (bf16-rounded and scaled for falcon-rw); the query-major
backward takes none, as JAX never runs it so. The additive ``bias``
operand and ``bias_grad`` raise, naming their ROADMAP item. Head dims: 32, 64, 80, 96, 128 and 256 for K1
/ K2 (the sm90 designs at 64 / 128, mma_sync / fp32 at the rest; fp32 K2
at 256 raises), 32 / 64 / 128 for K2-qmajor and K10.
"""

import ctypes
import math

import torch

from .grouped_matmul import tma_ok
from .paged_attention import alibi_slopes

NEG_INF = -1e30

LAUNCHES = {"flash_fwd": 0, "flash_bwd": 0, "flash_bwd_qmajor": 0,
            "flash_block_fwd": 0}
DESIGN_LAUNCHES = {name: {"sm90": 0, "mma_sync": 0, "fp32": 0}
                   for name in LAUNCHES}
DTYPE_LAUNCHES = {name: {"float32": 0, "bfloat16": 0, "float16": 0}
                  for name in LAUNCHES}
# the launchers' design codes (flash_block_fwd_launch, flash_bwd_launch,
# flash_bwd_qmajor_launch)
_DESIGN_CODE = {"fp32": 0, "mma_sync": 1, "sm90": 2}

# the launchers' dtype codes; fp16 is code 1 of the fp16 library
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 1}
_TODO_F16 = "(ROADMAP Queue 2, fp16 operands: K2-qmajor and K10)"
# K1 / K2: 80, 96 and 256 (phi-2, gpt-neox-20b, gpt-j-6b) on the mma_sync /
# fp32 designs; K2-qmajor and K10 keep 32 / 64 / 128
_HEAD_DIMS = (32, 64, 80, 96, 128, 256)
_RING_HEAD_DIMS = (32, 64, 128)
_SM90_HEAD_DIMS = (64, 128)
_TODO_BIAS = "(ROADMAP Queue 2, K1/K2: additive bias operand)"
_TODO_DIMS = "(ROADMAP Queue 2, K2-qmajor / K10 / fp32 K2 at d = 80, 96, 256)"
_QMAJOR_TILE = 64      # the kernel's query tile; the plain version walks it
_SM90_TILE = 128       # the Hopper query-major kernel's query tile


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for counts in (*DESIGN_LAUNCHES.values(), *DTYPE_LAUNCHES.values()):
        for k in counts:
            counts[k] = 0


class _Strides(ctypes.Structure):
    _fields_ = [("b", ctypes.c_longlong), ("h", ctypes.c_longlong),
                ("t", ctypes.c_longlong)]


class _AlibiArgs(ctypes.Structure):
    """Mirror of ``struct AlibiArgs`` in csrc/flash_attention.cu."""
    _fields_ = [("on", ctypes.c_int), ("bf16", ctypes.c_int),
                ("scale", ctypes.c_float), ("cp", ctypes.c_float)]


class _FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in csrc/flash_attention.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "o", "lse", "dout", "delta", "dlse", "dq",
                  "dk", "dv", "acc")]
                + [(n, _Strides) for n in
                   ("sq", "sk", "sv", "so", "sdo", "sdq", "sdk", "sdv")]
                + [(n, ctypes.c_int) for n in
                   ("B", "H", "T", "D", "causal", "window")]
                + [("m", ctypes.c_void_p), ("l", ctypes.c_void_p),
                   ("sml", ctypes.c_longlong), ("sacc", _Strides),
                   ("alibi", _AlibiArgs)])


_builder = None        # the bf16 / fp32 library's
_builder_f16 = None    # the fp16 build's


def _bind(b):
    """Build and load ``b``'s library and bind its ctypes signatures."""
    lib = b.load()
    for fn in (lib.flash_fwd_launch, lib.flash_bwd_qmajor_launch):
        fn.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    for fn in (lib.flash_block_fwd_launch, lib.flash_bwd_launch):
        fn.argtypes = [ctypes.POINTER(_FlashArgs), ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.flash_fwd_sm90_launch.argtypes = [ctypes.POINTER(_FlashArgs),
                                          ctypes.c_void_p, ctypes.c_void_p]
    lib.flash_fwd_sm90_launch.restype = ctypes.c_int
    return b


def kernel_builder(dtype=torch.bfloat16):
    """The builder of the flash-attention library for ``dtype`` (the fp16
    build for torch.float16, else the bf16 / fp32 one); the first call
    builds the library (nvcc, see op_builder) and binds its ctypes
    signatures."""
    global _builder, _builder_f16
    from ...op_builder.builder import (FlashAttentionBuilder,
                                       FlashAttentionF16Builder)
    if dtype == torch.float16:
        if _builder_f16 is None:
            _builder_f16 = _bind(FlashAttentionF16Builder())
        return _builder_f16
    if _builder is None:
        _builder = _bind(FlashAttentionBuilder())
    return _builder


def _count(name, design, dtype):
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[name][design] += 1
    DTYPE_LAUNCHES[name][str(dtype).split(".")[-1]] += 1


# ------------------------------------------------------------------ plain


def _mask(T, causal, window, device):
    """(T, T) bool: query row i may attend key column j."""
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    ok = torch.ones(T, T, dtype=torch.bool, device=device)
    if causal:
        ok = ok & (j <= i)
    if window:
        ok = ok & (i - j < window)
    return ok


def check_alibi_slopes(alibi, n_head):
    """The kernels evaluate the bloom slopes from the head index, so they
    take no others (the JAX wrapper's rule, flash_attention.py:1428-1442):
    raises NotImplementedError for custom slopes."""
    got = [float(x) for x in (alibi.reshape(-1).tolist()
                              if torch.is_tensor(alibi) else alibi)]
    expect = alibi_slopes(n_head)
    if len(got) != n_head or any(abs(a - b) > 1e-6 * max(abs(b), 1e-9)
                                 for a, b in zip(got, expect)):
        raise NotImplementedError(
            "flash_attention computes bloom-formula ALiBi slopes in-kernel; "
            "custom per-head slopes are not supported (pass them as a bias "
            f"instead) {_TODO_BIAS}")


def alibi_term(H, T, device, scale=1.0, bf16=False):
    """(H, 1, T) fp32 ALiBi term slope_h * k_pos as the kernels form it: the
    slope by exp2 of the fp32 bloom exponent of head h, the product rounded
    through bf16 when ``bf16``, then times ``scale``."""
    h = torch.arange(H, dtype=torch.float32, device=device)
    cp = float(2 ** math.floor(math.log2(H)))
    expo = torch.where(h < cp, -(h + 1.0) * (8.0 / cp),
                       -(2.0 * (h - cp) + 1.0) * (4.0 / cp))
    ab = torch.exp2(expo)[:, None, None] * torch.arange(
        T, dtype=torch.float32, device=device)
    if bf16:
        ab = ab.to(torch.bfloat16).float()
    return ab * scale


def _scores(q, k, alibi, alibi_scale, alibi_bf16):
    """fp32 q k^T of (B, H, T, d) operands plus the ALiBi term when given."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if alibi is not None:
        check_alibi_slopes(alibi, q.shape[1])
        s = s + alibi_term(q.shape[1], k.shape[2], q.device, alibi_scale,
                           alibi_bf16)
    return s


def flash_forward_reference(q, k, v, *, causal=True, window=0, alibi=None,
                            alibi_scale=1.0, alibi_bf16=False):
    """Plain version of the forward kernel on (B, H, T, d) operands with the
    scale already in q: fp32 scores (plus the ALiBi term of ``alibi`` =
    the bloom slopes, see :func:`alibi_term`), masked to NEG_INF, p rounded
    to v's dtype before P.V and l summed from the unrounded p. Returns (o in
    q's dtype, lse (B, H, T) fp32)."""
    s = _scores(q, k, alibi, alibi_scale, alibi_bf16)
    s = torch.where(_mask(q.shape[2], causal, window, q.device), s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_backward_reference(q, k, v, o, lse, do, *, causal=True, window=0,
                             dlse=None, alibi=None, alibi_scale=1.0,
                             alibi_bf16=False):
    """Plain version of the fused backward on (B, H, T, d) operands (scale
    already in q): p = exp(s - lse) (0 where masked; s carries the ALiBi
    term again under ``alibi``), delta = rowsum(do*o) (- dlse), dv =
    round(p)^T do, ds = p (dp - delta), dk = round(ds)^T q, dq = round(ds)
    k, all accumulated in fp32 and cast to the inputs' dtypes."""
    s = _scores(q, k, alibi, alibi_scale, alibi_bf16)
    ok = _mask(q.shape[2], causal, window, q.device)
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    delta = (do.float() * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dq = torch.matmul(ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_qmajor_reference(q, k, v, o, lse, do, *, causal=True,
                               window=0, dlse=None):
    """Plain version of the query-major backward on (B, H, T, d) operands
    (scale already in q), walked as the kernel walks: per 64-query tile,
    delta = rowsum(do*o) (- dlse) once, then per 64-key tile between the
    forward's causal / window / padding bounds, in order, p = exp(s - lse)
    (0 where masked), dv += round(p)^T do, dp = do v^T, ds = p (dp -
    delta), dk += round(ds)^T q, dq += round(ds) k, all in fp32; dq is cast
    once per query tile, dk/dv once at the end, to the inputs' dtypes."""
    B, H, T, d = q.shape
    bt = _QMAJOR_TILE
    qf, kf, vf, of, dof = (x.float() for x in (q, k, v, o, do))
    dk = torch.zeros(B, H, T, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty_like(q)
    pos = torch.arange(T, device=q.device)
    for q0 in range(0, T, bt):
        q1 = min(T, q0 + bt)
        rows = slice(q0, q1)
        delta = (dof[:, :, rows] * of[:, :, rows]).sum(-1)
        if dlse is not None:
            delta = delta - dlse[:, :, rows].float()
        lse_t = lse[:, :, rows, None].float()
        k_hi = min(T, q0 + bt) if causal else T
        k_lo = max(0, q0 - window + 1) if window else 0
        acc = torch.zeros(B, H, q1 - q0, d, dtype=torch.float32,
                          device=q.device)
        for k0 in range(k_lo // bt * bt, k_hi, bt):
            keys = slice(k0, min(T, k0 + bt))
            i, j = pos[rows, None], pos[None, keys]
            ok = torch.ones_like(i >= j)
            if causal:
                ok = ok & (j <= i)
            if window:
                ok = ok & (i - j < window)
            s = torch.matmul(qf[:, :, rows],
                             kf[:, :, keys].transpose(-1, -2))
            p = torch.where(ok, torch.exp(s - lse_t), 0.0)
            dv[:, :, keys] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), dof[:, :, rows])
            dp = torch.matmul(dof[:, :, rows],
                              vf[:, :, keys].transpose(-1, -2))
            ds = (p * (dp - delta[..., None])).to(q.dtype).float()
            dk[:, :, keys] += torch.matmul(ds.transpose(-1, -2), qf[:, :, rows])
            acc += torch.matmul(ds, kf[:, :, keys])
        dq[:, :, rows] = acc.to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def attention_reference(q, k, v, *, causal=True, scale=None, bias=None):
    """Dense reference (own copy of the JAX ``attention_reference``): q, k, v
    (B, T, H, d); fp32 scores times ``scale``, plus ``bias`` (B|1, H|1, T|1,
    T) before the causal mask; p rounded to q's dtype before P.V."""
    B, T, H, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = torch.where(_mask(T, True, 0, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(q.dtype), v)


# ----------------------------------------------------------------- kernels


def _check_cuda(tensors, name):
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev}, got "
                             f"one on {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: q, k, v (and o, do) must share a "
                            f"dtype, got {dt} and {t.dtype}")
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32, bfloat16 or "
                        f"float16, got {dt}")
    if tensors[0].shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {tensors[0].shape[-1]}")


def _check_ring_dims(q, name):
    if q.shape[-1] not in _RING_HEAD_DIMS:
        raise NotImplementedError(
            f"{name}: kernel takes head dim in {_RING_HEAD_DIMS}, got "
            f"{q.shape[-1]} {_TODO_DIMS}")


def _kernel_view(x):
    """x (B, H, T, d) as the kernel reads it: head dim contiguous, 16-byte
    aligned base and (b, h, t) strides (else a contiguous copy)."""
    vec = 16 // x.element_size()
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(s % vec for s in x.stride()[:3])):
        x = x.contiguous()
    return x


def _strides(x):
    return _Strides(*x.stride()[:3])


def _fwd_design(q, k, v):
    """The forward's design for (B, H, T, d) operands as the kernel reads
    them: "fp32" for fp32; "sm90" (TMA + wgmma) for bf16 or fp16 with d =
    64 or 128 that TMA can address (``tma_ok``: d contiguous, a 16-byte
    aligned base, the t stride and each (b, h) stride of extent > 1 whole
    multiples of 16 bytes, as sm90_attention.cuh's ``make_bhtd_map``
    encodes them; every GPT-2 training call); else "mma_sync" (d = 32, or
    operands TMA cannot address)."""
    if q.dtype == torch.float32:
        return "fp32"
    if q.shape[-1] in _SM90_HEAD_DIMS and all(map(tma_ok, (q, k, v))):
        return "sm90"
    return "mma_sync"


def _bwd_design(q, k, v, o, do, grads=()):
    """The backward's design (both walks) for (B, H, T, d) operands as the
    kernels read them: ``_fwd_design``'s rule over every operand the Hopper
    kernels map by TMA (q, k, v, do and the gradients ``grads`` = (dq, dk,
    dv), each with d contiguous; o is read by the delta kernel's plain
    loads): "fp32" for fp32; "sm90" for bf16 or fp16 at d = 64 or 128 that
    TMA can address (every GPT-2 training call, the ring's folded pairs);
    else "mma_sync" (d = 32, or strides TMA cannot address)."""
    if q.dtype == torch.float32:
        return "fp32"
    mapped = (q, k, v, do, *grads)
    if (q.shape[-1] in _SM90_HEAD_DIMS
            and all(x.stride(-1) == 1 and tma_ok(x) for x in mapped)):
        return "sm90"
    return "mma_sync"


def _block_design(q, k, v):
    """K10's design for its folded (BH, 1, T, d) views as the kernel reads
    them: ``_fwd_design``'s rule ("sm90" for bf16 at d = 64 or 128 that TMA
    can address, the state read and written by plain loads; "mma_sync" for
    d = 32 or what TMA cannot address; "fp32")."""
    return _fwd_design(q, k, v)


def _args(B, H, T, D, causal, window, alibi=None, alibi_scale=1.0,
          alibi_bf16=False, **tensors):
    a = _FlashArgs()
    a.B, a.H, a.T, a.D = B, H, T, D
    a.causal, a.window = int(bool(causal)), int(window)
    if alibi is not None:
        check_alibi_slopes(alibi, H)
        a.alibi = _AlibiArgs(1, int(bool(alibi_bf16)), float(alibi_scale),
                             float(2 ** math.floor(math.log2(H))))
    for name, t in tensors.items():
        if t is None:
            continue
        setattr(a, name, t.data_ptr())
        skey = {"q": "sq", "k": "sk", "v": "sv", "o": "so", "dout": "sdo",
                "dq": "sdq", "dk": "sdk", "dv": "sdv"}.get(name)
        if skey:
            setattr(a, skey, _strides(t))
    return a


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def flash_forward(q, k, v, *, causal=True, window=0, alibi=None,
                  alibi_scale=1.0, alibi_bf16=False):
    """Forward on (B, H, T, d) operands with the scale already in q (any
    strides with the head dim contiguous); ``alibi`` (the bloom slopes)
    adds slope_h * k_pos to each score in the kernel. Returns (o laid out
    like q, lse (B, H, T) fp32). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    al = dict(alibi=alibi, alibi_scale=alibi_scale, alibi_bf16=alibi_bf16)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal=causal, window=window,
                                       **al)
    name = "flash_forward"
    _check_cuda((q, k, v), name)
    q, k, v = (_kernel_view(x) for x in (q, k, v))
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    a = _args(B, H, T, D, causal, window, q=q, k=k, v=v, o=o, lse=lse, **al)
    lib = kernel_builder(q.dtype).load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    design = _fwd_design(q, k, v)
    if design == "sm90":
        # the persistent CTAs' work counter
        next_item = torch.zeros(1, dtype=torch.int32, device=q.device)
        rc = lib.flash_fwd_sm90_launch(ctypes.byref(a), next_item.data_ptr(),
                                       stream)
    else:
        rc = lib.flash_fwd_launch(ctypes.byref(a), _DTYPE_CODE[q.dtype], stream)
    _raise_on(rc, f"{name} ({design})")
    _count("flash_fwd", design, q.dtype)
    return o, lse


def flash_backward(q, k, v, o, lse, do, *, causal=True, window=0,
                   dlse=None, alibi=None, alibi_scale=1.0, alibi_bf16=False):
    """Fused backward on (B, H, T, d) operands (scale already in q) from the
    saved o and lse; ``dlse`` is an optional cotangent on lse; ``alibi`` as
    the forward's (the kernels add the term again when they rebuild p; it
    has no gradient). Returns (dq, dk, dv) in the inputs' dtypes. CPU
    tensors take the plain version; CUDA tensors launch the kernels (delta,
    dk/dv, dq) or raise."""
    al = dict(alibi=alibi, alibi_scale=alibi_scale, alibi_bf16=alibi_bf16)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, causal=causal,
                                        window=window, dlse=dlse, **al)
    name = "flash_backward"
    _check_cuda((q, k, v, o, do), name)
    if q.dtype == torch.float32 and q.shape[-1] == 256:
        raise NotImplementedError(
            f"{name}: fp32 at d = 256 needs more shared memory than a CTA "
            f"has {_TODO_DIMS}")
    q, k, v, o, do = (_kernel_view(x) for x in (q, k, v, o, do))
    B, H, T, D = q.shape
    lse = lse.float().contiguous()
    dlse = None if dlse is None else dlse.float().contiguous()
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    design = _bwd_design(q, k, v, o, do, (dq, dk, dv))
    a = _args(B, H, T, D, causal, window, q=q, k=k, v=v, o=o, lse=lse,
              dout=do, delta=delta, dlse=dlse, dq=dq, dk=dk, dv=dv, **al)
    # the persistent dk/dv and dq kernels' work counters (sm90)
    next_item = (torch.zeros(2, dtype=torch.int32, device=q.device)
                 if design == "sm90" else None)
    rc = kernel_builder(q.dtype).load().flash_bwd_launch(
        ctypes.byref(a), _DESIGN_CODE[design],
        None if next_item is None else next_item.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, f"{name} ({design})")
    _count("flash_bwd", design, q.dtype)
    return dq, dk, dv


def flash_backward_qmajor(q, k, v, o, lse, do, *, causal=True, window=0,
                          dlse=None):
    """Query-major fused backward on (B, H, T, d) operands (scale already
    in q): the same (dq, dk, dv) as :func:`flash_backward` (bitwise, design
    for design), from one kernel that forms S and dP once per tile pair,
    writes dq once and carries dk/dv in an fp32 scratch of (B*H, 2, Tp, d)
    (Tp = T rounded up to the kernel's query tile: 128 on sm90, after the
    delta kernel; 64 otherwise). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_bwd_qmajor_reference(q, k, v, o, lse, do, causal=causal,
                                          window=window, dlse=dlse)
    name = "flash_backward_qmajor"
    _check_cuda((q, k, v, o, do), name)
    _check_ring_dims(q, name)
    if q.dtype == torch.float16:
        raise TypeError(f"{name}: fp16 operands are not ported yet "
                        f"{_TODO_F16}")
    lib = kernel_builder().load()
    q, k, v, o, do = (_kernel_view(x) for x in (q, k, v, o, do))
    B, H, T, D = q.shape
    lse = lse.float().contiguous()
    dlse = None if dlse is None else dlse.float().contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    design = _bwd_design(q, k, v, o, do, (dq, dk, dv))
    tile = _SM90_TILE if design == "sm90" else _QMAJOR_TILE
    tp = -(-T // tile) * tile
    acc = torch.empty(B * H, 2, tp, D, dtype=torch.float32, device=q.device)
    delta = (torch.empty(B, H, T, dtype=torch.float32, device=q.device)
             if design == "sm90" else None)
    a = _args(B, H, T, D, causal, window, q=q, k=k, v=v, o=o, lse=lse,
              dout=do, delta=delta, dlse=dlse, dq=dq, dk=dk, dv=dv, acc=acc)
    rc = lib.flash_bwd_qmajor_launch(
        ctypes.byref(a), _DESIGN_CODE[design],
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, f"{name} ({design})")
    _count("flash_bwd_qmajor", design, q.dtype)
    return dq, dk, dv


# ------------------------------------------- blockwise (ring) variant (K10)


def flash_block_state(BH, T, d, device=None):
    """Fresh (m, l, acc) carry for :func:`flash_block_fwd`: per-query
    running max / sum-exp ((BH, T) fp32) and the unnormalized output
    accumulator ((BH, T, d) fp32)."""
    return (torch.full((BH, T), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros(BH, T, dtype=torch.float32, device=device),
            torch.zeros(BH, T, d, dtype=torch.float32, device=device))


def flash_block_finalize(state):
    """(m, l, acc) -> (o fp32, lse fp32); call after the last chunk pair."""
    m, l, acc = state
    ls = l.clamp_min(1e-30)
    return acc / ls[..., None], m + torch.log(ls)


def flash_block_fwd_reference(q, k, v, state, *, causal=False):
    """Plain version of the K10 kernel: one chunk pair's online-softmax
    update of ``state`` (m, l, acc) from folded (BH, T, d) q (scale already
    in), k, v: fp32 scores, NEG_INF where masked (``causal``: the diagonal
    pair), p rounded to v's dtype before P.V and l summed from the
    unrounded p, as _fwd_block_kernel. Returns the new (m, l, acc)."""
    m, l, acc = state
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if causal:
        s = torch.where(_mask(q.shape[1], True, 0, q.device), s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(-1)
    acc_new = acc * alpha[..., None] + torch.matmul(p.to(v.dtype).float(),
                                                    v.float())
    return m_new, l_new, acc_new


def flash_block_fwd(q, k, v, state, *, causal=False, block_q=128,
                    block_k=128, block_h=2, interpret=None):
    """One ring chunk pair: q/k/v (BH, T, d) folded operands (q scaled by
    the caller), ``state`` from :func:`flash_block_state` (or a previous
    pair). Updates ``state`` IN PLACE and returns it: each tensor may be a
    view (the ring updates the halves of one buffer), with unit stride
    along T for m and l (one shared row stride) and along d for acc.
    ``causal=True`` is the diagonal pair (equal chunk lengths, shared
    offset); fully-masked pairs are the schedule's to skip. The tile knobs
    are accepted and change nothing. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    BH, T, d = q.shape
    if k.shape[1] != T:
        raise ValueError(
            f"flash_block_fwd needs equal chunk lengths, got q {T} vs kv "
            f"{k.shape[1]} (the ring schedule pairs equal chunks)")
    m, l, acc = state
    if q.device.type == "cpu":
        for dst, new in zip(state, flash_block_fwd_reference(
                q, k, v, state, causal=causal)):
            dst.copy_(new)
        return state
    name = "flash_block_fwd"
    _check_cuda((q, k, v), name)
    _check_ring_dims(q, name)
    if q.dtype == torch.float16:
        raise TypeError(f"{name}: fp16 operands are not ported yet "
                        f"{_TODO_F16}")
    if (any(t.dtype != torch.float32 or t.device != q.device
            for t in state)
            or m.stride(1) != 1 or l.stride(1) != 1
            or m.stride(0) != l.stride(0) or acc.stride(2) != 1
            or m.shape != (BH, T) or l.shape != (BH, T)
            or acc.shape != (BH, T, d)):
        raise ValueError(
            f"{name}: state must be fp32 m, l (BH, T) with one row stride "
            f"and unit stride along T, and acc (BH, T, d) with unit stride "
            f"along d, on {q.device}")
    q, k, v = (_kernel_view(x.unsqueeze(1)) for x in (q, k, v))
    a = _args(BH, 1, T, d, causal, 0, q=q, k=k, v=v)
    a.m, a.l, a.acc = m.data_ptr(), l.data_ptr(), acc.data_ptr()
    a.sml = m.stride(0)
    a.sacc = _Strides(acc.stride(0), 0, acc.stride(1))
    design = _block_design(q, k, v)
    # the persistent CTAs' work counter (sm90)
    next_item = (torch.zeros(1, dtype=torch.int32, device=q.device)
                 if design == "sm90" else None)
    rc = kernel_builder().load().flash_block_fwd_launch(
        ctypes.byref(a), _DESIGN_CODE[design],
        None if next_item is None else next_item.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, f"{name} ({design})")
    _count("flash_block_fwd", design, q.dtype)
    return state


def flash_block_bwd(q, k, v, o, lse, do, *, causal=False, block_q=128,
                    block_k=128, block_h=2, interpret=None):
    """Ring chunk-pair backward through K2 (:func:`flash_backward`, scale
    1: q already carries it): given the GLOBAL per-query ``lse`` ((BH, T)
    fp32) and the final ``o``, K2 recomputes this pair's probabilities as
    exp(s - lse) and its delta = rowsum(do * o) is the global delta, so
    (dq, dk, dv) are this pair's exact contributions, in q's dtype. The
    folded (1, BH, T, d) views take ``_bwd_design``'s rule (bf16 pairs at
    d = 64 / 128: sm90)."""
    cast = [x.to(q.dtype)[None] for x in (q, k, v, o, do)]
    dq, dk, dv = flash_backward(*cast[:4], lse.float()[None], cast[4],
                                causal=causal)
    return dq[0], dk[0], dv[0]


# the 'flash_attention' autotune op's cold-cache lever: the k-major K2
TUNE_DEFAULTS = {"bwd_qmajor": False}
# K2-qmajor's head dims (``_check_ring_dims``, as K10's)
QMAJOR_HEAD_DIMS = _RING_HEAD_DIMS


def resolve_bwd_qmajor(value, T, d, causal, qkv_t, dtype, device=None,
                       alibi=False):
    """A ``bwd_qmajor`` / ``flash_bwd_qmajor`` value for a call at sequence
    length T and head dim d: True / False as given; "auto" the winner
    cache's choice for the bucket (T, d, causal, qkv_t), consulted only
    where K2-qmajor can run (qkv_t without ALiBi, bf16 / fp32, d in
    QMAJOR_HEAD_DIMS), False on a miss."""
    if value != "auto":
        return bool(value)
    if not qkv_t or alibi or dtype not in (torch.bfloat16, torch.float32) \
            or d not in QMAJOR_HEAD_DIMS:
        return False
    from ._common import dispatch, dtype_name, flash_bucket
    win = dispatch("flash_attention", flash_bucket(T, d, causal, qkv_t),
                   dtype_name(dtype), TUNE_DEFAULTS, device=device)
    return bool(win["bwd_qmajor"])


class _Flash(torch.autograd.Function):
    """(q scaled, k, v) (B, H, T, d) -> (o, lse); saves q, k, v, o and lse
    and runs the fused backward kernel on them: the query-major one when
    ``qmajor``, else the k-major one (with the forward's ALiBi options
    ``al``, a dict)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, qmajor, al):
        o, lse = flash_forward(q, k, v, causal=causal, window=window, **al)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.qmajor, ctx.al = causal, window, qmajor, al
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if ctx.qmajor:
            dq, dk, dv = flash_backward_qmajor(
                q, k, v, o, lse, do, causal=ctx.causal, window=ctx.window,
                dlse=dlse)
        else:
            dq, dk, dv = flash_backward(q, k, v, o, lse, do,
                                        causal=ctx.causal, window=ctx.window,
                                        dlse=dlse, **ctx.al)
        return dq, dk, dv, None, None, None, None


def scale_q(q, scale):
    """q * scale with the scale rounded to q's dtype first, as the JAX
    wrapper's ``q * jnp.asarray(scale, q.dtype)``. The rounded scale goes
    in as a Python number: no tensor is copied to the card, so the call
    makes no host sync."""
    return q * torch.tensor(scale, dtype=q.dtype).item()


def _to_bhtd(x, heads_major, qkv_t):
    if qkv_t:
        return x.transpose(-1, -2)          # (B, H, d, T) -> (B, H, T, d)
    return x if heads_major else x.transpose(1, 2)


def flash_attention_with_lse(q, k, v, *, causal=True, scale=None,
                             block_q=128, block_k=128, block_h=2,
                             interpret=None, heads_major=False,
                             block_q_bwd=None, block_k_bwd=None, qkv_t=False,
                             window=0, bias=None, bias_grad=False,
                             alibi=None, alibi_scale=1.0, alibi_bf16=False,
                             bwd_qmajor=False):
    """Fused attention returning ``(o, lse)``; lse is the per-query
    logsumexp (B, H, T) fp32 and is differentiable (its cotangent shifts
    delta). Layouts as the JAX function: (B, T, H, d) by default, (B, H, T,
    d) with ``heads_major``, (B, H, d, T) with ``qkv_t`` (o then comes back
    (B, H, T, d), as in JAX). ``window`` > 0 is causal sliding-window
    attention. ``alibi``: the (H,) bloom-formula slopes (custom slopes
    raise), evaluated in the kernels from the head index; ``alibi_bf16``
    rounds slope * k_pos through bf16, then ``alibi_scale`` scales it
    (falcon-rw). ``bwd_qmajor``: the query-major backward, for ``qkv_t``
    without ALiBi only (see the module docstring)."""
    if bias is not None or bias_grad:
        raise NotImplementedError(
            f"flash_attention: the additive bias operand is not ported yet "
            f"{_TODO_BIAS}")
    if window and not causal:
        raise ValueError("sliding window requires causal attention")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: want q, k, v of one 4-d shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    qb, kb, vb = (_to_bhtd(x, heads_major, qkv_t) for x in (q, k, v))
    if scale is None:
        scale = 1.0 / math.sqrt(qb.shape[-1])
    al = {}
    if alibi is not None:
        check_alibi_slopes(alibi, qb.shape[1])
        al = dict(alibi=alibi_slopes(qb.shape[1]),
                  alibi_scale=float(alibi_scale),
                  alibi_bf16=bool(alibi_bf16))
    # the query-major backward serves qkv_t without bias or ALiBi only
    # (flash_attention.py:1255, :1578); JAX takes the key-major backward
    # under ALiBi, so an explicit request for it raises
    qmajor = resolve_bwd_qmajor(bwd_qmajor, qb.shape[2], qb.shape[3],
                                bool(causal), bool(qkv_t), qb.dtype,
                                qb.device, alibi=bool(al)) and bool(qkv_t)
    if qmajor and al:
        raise NotImplementedError(
            "flash_attention: the query-major backward takes no ALiBi (the "
            "JAX kernel never runs it so); use bwd_qmajor=False")
    o, lse = _Flash.apply(scale_q(qb, scale), kb, vb, bool(causal),
                          int(window), qmajor, al)
    if qkv_t or heads_major:
        return o, lse
    return o.transpose(1, 2), lse


def flash_attention(q, k, v, *, causal=True, scale=None, block_q=128,
                    block_k=128, block_h=2, interpret=None,
                    heads_major=False, block_q_bwd=None, block_k_bwd=None,
                    qkv_t=False, window=0, bias=None, bias_grad=False,
                    alibi=None, alibi_scale=1.0, alibi_bf16=False,
                    bwd_qmajor=False):
    """Fused attention; see :func:`flash_attention_with_lse` (this returns
    o only)."""
    o, _ = flash_attention_with_lse(
        q, k, v, causal=causal, scale=scale, heads_major=heads_major,
        qkv_t=qkv_t, window=window, bias=bias, bias_grad=bias_grad,
        alibi=alibi, alibi_scale=alibi_scale, alibi_bf16=alibi_bf16,
        bwd_qmajor=bwd_qmajor)
    return o
