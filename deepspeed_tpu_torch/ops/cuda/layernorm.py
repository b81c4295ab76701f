"""One-pass LayerNorm forward and backward and the RMSNorm forward (K13):
the Hopper CUDA kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/layernorm.py`` (``_run_fwd`` /
``_run_bwd``, the ``_ln`` and ``_ln_hybrid`` custom VJPs and the public
``fused_layernorm`` / ``layernorm_fused_bwd`` / ``fused_rmsnorm``); the
kernels are ``csrc/layernorm.cu`` (design and bound are noted there). Same
signatures:

  fused_layernorm(x, scale, bias, eps=1e-5, block_rows="auto")
      LayerNorm over the last dim, fp32 statistics, output in x's dtype;
      the kernel forward and the kernel backward (``_ln``).
  layernorm_fused_bwd(x, scale, bias, eps=1e-5, block_rows="auto")
      the plain forward and the kernel backward (``_ln_hybrid``).
  fused_rmsnorm(x, scale, eps=1e-5, block_rows=256)
      RMSNorm over the last dim, fp32 statistics, output in x's dtype;
      forward only, as the TPU kernel (no JAX model calls it: the serving
      models keep their plain norm).

The backward recomputes the statistics from x (nothing but x and scale
is saved) and returns dscale / dbias as fp32 sums over all rows cast to the
scale's dtype, as ``_ln_bwd``. ``block_rows`` is accepted and changes
nothing (the TPU row tiling). Both raise the JAX ``_row_blocked``
ValueError when D % 128 != 0, so a config that fails in JAX fails here.
Any row count works without padding (JAX pads with zero rows, which add
nothing to dscale / dbias).

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts
kernel launches (the backward's row pass and its partial-row reduction
count as one).
"""

import ctypes

import torch

LAUNCHES = {"layernorm_fwd": 0, "layernorm_bwd": 0, "rmsnorm_fwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _LnArgs(ctypes.Structure):
    """Mirror of ``struct LnArgs`` in csrc/layernorm.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("dy", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("part", ctypes.c_void_p),
                ("N", ctypes.c_int), ("D", ctypes.c_int),
                ("eps", ctypes.c_float), ("s_bf16", ctypes.c_int)]


_builder = None


def kernel_builder():
    """The K13 library's builder; the first call builds the library (nvcc,
    see op_builder) and binds its ctypes signatures."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import LayerNormBuilder
        b = LayerNormBuilder()
        lib = b.load()
        for fn in (lib.ln_fwd_launch, lib.rms_fwd_launch):
            fn.argtypes = [ctypes.POINTER(_LnArgs), ctypes.c_int,
                           ctypes.c_void_p]
        lib.ln_bwd_launch.argtypes = [ctypes.POINTER(_LnArgs), ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_void_p]
        lib.ln_bwd_partial_rows.argtypes = [ctypes.c_int]
        for fn in (lib.ln_fwd_launch, lib.rms_fwd_launch, lib.ln_bwd_launch,
                   lib.ln_bwd_partial_rows, lib.ln_bwd_max_d):
            fn.restype = ctypes.c_int
        _builder = b
    return _builder


# ----------------------------------------------------------------- plain


def layernorm_reference(x, scale, bias, eps=1e-5):
    """Plain forward (own copy of the JAX ``_ln_jnp``): fp32 statistics,
    output in x's dtype."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rmsnorm_reference(x, scale, eps=1e-5):
    """Plain RMSNorm forward (own copy of the JAX ``_rms_fwd_kernel``'s
    math, as the Llama ``_rms_norm``): fp32 statistics, output in x's
    dtype."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def layernorm_bwd_reference(x, scale, dy, eps=1e-5):
    """Plain backward (the math of ``_ln_bwd_kernel``) over rows of
    (N, D): (dx in x's dtype, dscale (D,) fp32, dbias (D,) fp32)."""
    x32, dy32 = x.float(), dy.float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt(xc.square().mean(-1, keepdim=True) + eps)
    xhat = xc * rstd
    g = dy32 * scale.float()
    mg = g.mean(-1, keepdim=True)
    mgx = (g * xhat).mean(-1, keepdim=True)
    dx = (rstd * (g - mg - xhat * mgx)).to(x.dtype)
    return dx, (dy32 * xhat).sum(0), dy32.sum(0)


# ---------------------------------------------------------------- kernels


def _aligned(t):
    """``t`` contiguous on a 16-byte boundary (the kernels' vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(x):
    """(..., D) -> contiguous (N, D) on a 16-byte boundary."""
    return _aligned(x.reshape(-1, x.shape[-1]))


def _check(name, x, params):
    if any(p.device != x.device for p in params):
        raise ValueError(f"{name}: every operand must be on {x.device}")
    if x.dtype not in _DTYPE_CODE or any(p.dtype not in _DTYPE_CODE
                                         for p in params):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype} / {[p.dtype for p in params]}")
    if len({p.dtype for p in params}) != 1:
        raise TypeError(f"{name}: scale and bias must share a dtype")


def _param(p):
    return _aligned(p.reshape(-1))


def _fwd(x2, scale, bias, eps):
    """LayerNorm forward over rows (N, D) on x's device."""
    if x2.device.type == "cpu":
        return layernorm_reference(x2, scale, bias, eps)
    return _launch_fwd("layernorm_fwd", x2, scale, bias, eps)


def _rms_fwd(x2, scale, eps):
    """RMSNorm forward over rows (N, D) on x's device."""
    if x2.device.type == "cpu":
        return rmsnorm_reference(x2, scale, eps)
    return _launch_fwd("rmsnorm_fwd", x2, scale, None, eps)


def _launch_fwd(name, x2, scale, bias, eps):
    """One forward kernel (``ln_fwd_launch``, or ``rms_fwd_launch`` with
    no bias) over the rows of a CUDA ``x2``."""
    params = (scale,) if bias is None else (scale, bias)
    _check(name, x2, params)
    lib = kernel_builder().load()
    x2 = _rows(x2)
    N, D = x2.shape
    out = torch.empty_like(x2)
    if N == 0:
        return out
    s = _param(scale)
    b = None if bias is None else _param(bias).data_ptr()
    a = _LnArgs(x2.data_ptr(), s.data_ptr(), b, None, out.data_ptr(), None,
                N, D, float(eps), int(s.dtype == torch.bfloat16))
    launch = lib.ln_fwd_launch if bias is not None else lib.rms_fwd_launch
    rc = launch(ctypes.byref(a), _DTYPE_CODE[x2.dtype],
                torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def _bwd(x2, scale, dy2, eps):
    """Backward over rows (N, D) on x's device: (dx, dscale, dbias), the
    sums in fp32 (plain) or already in the scale's dtype (kernel)."""
    if x2.device.type == "cpu":
        return layernorm_bwd_reference(x2, scale, dy2, eps)
    name = "layernorm_bwd"
    _check(name, x2, (scale,))
    if dy2.dtype != x2.dtype or dy2.device != x2.device:
        raise TypeError(f"{name}: dy must match x ({x2.dtype} on "
                        f"{x2.device}), got {dy2.dtype} on {dy2.device}")
    lib = kernel_builder().load()
    x2, dy2 = _rows(x2), _rows(dy2)
    N, D = x2.shape
    if D > lib.ln_bwd_max_d():
        raise ValueError(f"{name}: the kernel takes D <= "
                         f"{lib.ln_bwd_max_d()}, got {D}")
    dx = torch.empty_like(x2)
    ds = torch.zeros(D, dtype=scale.dtype, device=x2.device)
    db = torch.zeros(D, dtype=scale.dtype, device=x2.device)
    if N == 0:
        return dx, ds, db
    s = _param(scale)
    part = torch.empty(lib.ln_bwd_partial_rows(N), 2, D, dtype=torch.float32,
                       device=x2.device)
    a = _LnArgs(x2.data_ptr(), s.data_ptr(), None, dy2.data_ptr(),
                dx.data_ptr(), part.data_ptr(), N, D, float(eps),
                int(s.dtype == torch.bfloat16))
    rc = lib.ln_bwd_launch(ctypes.byref(a), _DTYPE_CODE[x2.dtype],
                           ds.data_ptr(), db.data_ptr(),
                           torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return dx, ds, db


class _LnBackward:
    """The shared backward of ``_ln`` and ``_ln_hybrid`` (``_ln_bwd``)."""

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        D = x.shape[-1]
        dx, ds, db = _bwd(x.reshape(-1, D), scale, dy.reshape(-1, D),
                          ctx.eps)
        return (dx.reshape(x.shape), ds.to(scale.dtype).reshape(scale.shape),
                db.to(scale.dtype).reshape(scale.shape), None)


class _LnFn(_LnBackward, torch.autograd.Function):
    """``_ln``: kernel forward, kernel backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        D = x.shape[-1]
        return _fwd(x.reshape(-1, D), scale, bias, eps).reshape(x.shape)


class _LnHybridFn(_LnBackward, torch.autograd.Function):
    """``_ln_hybrid``: plain forward, kernel backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return layernorm_reference(x, scale, bias, eps)


def _check_d(x):
    D = x.shape[-1]
    if D % 128:
        raise ValueError(f"fused norm kernels need D % 128 == 0, got {D}")


def fused_layernorm(x, scale, bias, *, eps=1e-5, block_rows="auto"):
    """LayerNorm over the last dim of ``x`` (any leading shape), fp32
    statistics, output in x's dtype; differentiable through the one-pass
    backward. D must be a multiple of 128. ``block_rows`` changes
    nothing."""
    _check_d(x)
    return _LnFn.apply(x, scale, bias, float(eps))


def layernorm_fused_bwd(x, scale, bias, *, eps=1e-5, block_rows="auto"):
    """Hybrid LayerNorm: the plain forward and the one-pass kernel backward
    (the same numerics as ``fused_layernorm``). D must be a multiple of
    128. ``block_rows`` changes nothing."""
    _check_d(x)
    return _LnHybridFn.apply(x, scale, bias, float(eps))


def fused_rmsnorm(x, scale, *, eps=1e-5, block_rows=256):
    """RMSNorm over the last dim of ``x`` (any leading shape):
    ``x * rsqrt(mean(x^2) + eps) * scale`` with fp32 statistics, output in
    x's dtype. Forward only, as the JAX ``fused_rmsnorm``. D must be a
    multiple of 128. ``block_rows`` changes nothing."""
    _check_d(x)
    D = x.shape[-1]
    return _rms_fwd(x.reshape(-1, D), scale, float(eps)).reshape(x.shape)
