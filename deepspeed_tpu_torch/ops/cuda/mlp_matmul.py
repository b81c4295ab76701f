"""The MLP projection kernels: the layout-owning projection (K6) and the
weight-only int8/int4 projection (K7), Hopper CUDA kernels and their plain
versions (``csrc/mlp_matmul.cu``).

Counterpart of ``deepspeed_tpu/ops/pallas/mlp_matmul.py``. K6 (``_mm``,
``_dw``, the ``_proj`` custom VJP and the public ``mlp_matmul``; design
and bound in csrc/mlp_matmul.cu), with JAX's signature, shapes and
ValueErrors:

  mlp_matmul(x, w, x_t=False, out_t=False, block_t=256, block_o=256,
             block_k=512, fuse_dw=True)
      y[b, t, m] = sum_k x[b, t, k] w[k, m]: x (B, T, K), or (B, K, T)
      with T minor when ``x_t``; w (K, M); y (B, T, M), or (B, M, T) when
      ``out_t``; fp32 accumulation, one rounding to x's dtype. The
      backward (``_proj_bwd``): dx through the same kernel (w read through
      its transposed view, dx emitted in x's own orientation) and dW
      through the dW kernel (fp32 over every (b, t) row, one rounding to
      w's dtype), or, with ``fuse_dw=False``, a plain fp32 ``torch.einsum``
      cast to w's dtype (JAX leaves that case to XLA).

Every orientation is a stride: no operand is copied for ``x_t``,
``out_t`` or the transposed w. The tile sizes are accepted and change
nothing. On a CUDA tensor the kernel runs at every shape; JAX falls back
to its jnp ``_ref_proj`` (the same math) for shapes its TPU tiles cannot
cover. Each K6 launch takes one of three designs (``_k6_design``): bf16
operands that TMA can address go to the Hopper wgmma kernel
(``proj_mm_sm90_kernel``), other bf16 operands to the mma.sync kernel,
fp32 to the scalar-FMA instance; ``DESIGN_LAUNCHES["mlp_mm" | "mlp_dw"]``
counts launches by design.

K7 (the ``_mm_wq`` kernel behind ``wq_matmul``; designs and bounds in
``csrc/wq_sm90.cuh`` and ``csrc/wq_gemm.cuh``):

  wq_matmul(x, w, x_t=False, out_t=False)   x (B, T, K) (or (T, K)) @
      dequant(w) for an ``Int8Weight`` / ``Int4Weight`` w with codes
      (K | K/2, M) and a (1, M) scale -> (B, T, M) in x's dtype: fp32
      accumulation over the codes, the scale on the accumulator, one
      rounding. ``x_t``: x is (B, K, T); ``out_t``: the result is (B, M, T)
      (served through transposed views, not kernel layouts).

Forward only (serving; the training path keeps full-precision weights).
Dispatch is by the tensor's device only: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises, at every shape
(decode's 8 rows included, where the JAX wrapper takes its jnp fallback:
the same math). ``LAUNCHES`` counts kernel launches. Each K7 call takes
one of three designs (``_wq_design``): bf16 x and codes that TMA can
address go to the Hopper kernel (``wq_matmul_sm90_kernel``: the codes as
wgmma's register operand; ``wq_plan`` picks its row tile and K split from
the shape, and a split call adds ``wq_merge_kernel``), other bf16 to the
mma.sync ``wq_kernel``, fp32 to its scalar-FMA instance;
``DESIGN_LAUNCHES["wq_matmul"]`` counts calls by design.
"""

import ctypes
import functools

import torch

from .grouped_matmul import WQ_ARGTYPES, check_quantized, launch_wq, tma_ok

LAUNCHES = {"wq_matmul": 0, "mlp_mm": 0, "mlp_dw": 0}
DESIGN_LAUNCHES = {name: {"sm90": 0, "mma_sync": 0, "fp32": 0}
                   for name in ("mlp_mm", "mlp_dw", "wq_matmul")}

# K7's sm90 design (csrc/wq_sm90.cuh): 128 features a CTA, 64 k a slice,
# the row tile (wgmma's n) one of WQ_ROW_TILES; bf16 calls of at least
# WQ_SM90_MIN_ROWS rows take it (the card measured it faster than wq_kernel
# at decode's 8 rows and at the 256-row chunk: chip_smoke.py phase 14)
WQ_FEATURE_TILE = 128
WQ_K_SLICE = 64
WQ_ROW_TILES = (8, 64, 128, 256)
WQ_SM90_MIN_ROWS = 1
WQ_MAX_SPLITS = 8             # bounds the (S, M, N) fp32 partials
WQ_SMS = 132                  # H100 SXM; the wrapper reads the card's own

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class _MmArgs(ctypes.Structure):
    """Mirror of ``struct MmArgs`` in csrc/mlp_matmul.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("a", "b", "out")]
                + [(n, ctypes.c_longlong) for n in (
                    "sa_z", "sa_q", "sa_i", "sa_c", "sb_z", "sb_q", "sb_c",
                    "sb_j", "so_z", "so_i", "so_j")]
                + [(n, ctypes.c_int) for n in (
                    "Z", "Q", "I", "J", "C", "a_t", "b_t", "vec_a",
                    "vec_b")])


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_design in DESIGN_LAUNCHES.values():
        for k in by_design:
            by_design[k] = 0


_builder = None


def kernel_builder():
    """The K6 / K7 library's builder; the first call builds the library (nvcc,
    see op_builder) and binds its ctypes signature."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import MlpMatmulBuilder
        b = MlpMatmulBuilder()
        lib = b.load()
        lib.wq_matmul_launch.argtypes = WQ_ARGTYPES
        lib.wq_matmul_launch.restype = ctypes.c_int
        lib.wq_matmul_sm90_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.wq_matmul_sm90_launch.restype = ctypes.c_int
        lib.mlp_mm_launch.argtypes = [ctypes.POINTER(_MmArgs), ctypes.c_int,
                                      ctypes.c_void_p]
        lib.mlp_mm_launch.restype = ctypes.c_int
        lib.mlp_mm_sm90_launch.argtypes = [ctypes.POINTER(_MmArgs),
                                           ctypes.c_void_p]
        lib.mlp_mm_sm90_launch.restype = ctypes.c_int
        _builder = b
    return _builder


def _rows(x, x_t):
    """x (B, T, K) | (B, K, T) (x_t) -> (B, T, K-rows (B*T, K))."""
    if x_t:
        x = x.transpose(1, 2)
    return x.shape[0], x.shape[1], x.reshape(-1, x.shape[2])


def _shape_out(out, B, T, out_t, squeeze):
    out = out.reshape(B, T, out.shape[-1])
    if out_t:
        out = out.transpose(1, 2)
    return out[0] if squeeze else out


def _plain_rows(x2, w):
    """(R, K) rows times dequant(w) with the kernel's math: fp32 products
    of x and the codes, the scale on the accumulator, one rounding."""
    acc = torch.matmul(x2.float(), w.codes().float())
    return (acc * w.scale.reshape(1, -1)).to(x2.dtype)


def wq_matmul_reference(x, w, x_t=False, out_t=False):
    """Plain version of ``wq_matmul`` (any device)."""
    squeeze = x.dim() == 2
    B, T, x2 = _rows(x[None] if squeeze else x, x_t)
    return _shape_out(_plain_rows(x2, w), B, T, out_t, squeeze)


@functools.lru_cache(maxsize=None)
def wq_plan(M, K, N, sms=WQ_SMS):
    """(row tile, splits) of the sm90 design for an (M, K) x (K, N) call:
    the smallest row tile of WQ_ROW_TILES that holds M rows (else 256);
    K splits in the most parts S <= WQ_MAX_SPLITS (at least 4 k slices
    each) whose (128-feature, row tile, split) items still run in one wave
    of ``sms`` CTAs (one CTA an SM: 384 threads of 168 registers): a
    second wave's start and the partials' round trip outweigh the work a
    split takes off each CTA (chip_smoke.py phase 14 times the other
    choice beside each call), so 86 tiles -> 1, 32 -> 4. Shape only."""
    rt = next((t for t in WQ_ROW_TILES if M <= t), WQ_ROW_TILES[-1])
    tiles = -(-N // WQ_FEATURE_TILE) * -(-M // rt)
    nst = -(-K // WQ_K_SLICE)
    most = min(WQ_MAX_SPLITS, nst // 4, sms // tiles)
    return rt, max(1, most)


def wq_split_bounds(K, splits):
    """The k ranges [lo, hi) of the sm90 design's ``splits`` K splits: split
    z takes the 64-deep slices [z nst / S, (z + 1) nst / S)."""
    nst = -(-K // WQ_K_SLICE)
    return [(min(K, z * nst // splits * WQ_K_SLICE),
             min(K, (z + 1) * nst // splits * WQ_K_SLICE))
            for z in range(splits)]


def wq_matmul_split_reference(x2, w, splits):
    """Plain version of the sm90 design's split arithmetic on (M, K) rows:
    each split's fp32 partial over its k range, the partials summed in
    split order, then the scale, then one rounding to x's dtype."""
    codes = w.codes().float()
    acc = None
    for lo, hi in wq_split_bounds(x2.shape[1], splits):
        p = torch.matmul(x2[:, lo:hi].float(), codes[lo:hi])
        acc = p if acc is None else acc + p
    return (acc * w.scale.reshape(1, -1)).to(x2.dtype)


def _wq_design(x2, w):
    """K7's design for x rows (M, K) and a quantized w, read from dtype,
    shape and ``tma_ok`` only: "fp32" for fp32 x; "sm90" for bf16 x of at
    least WQ_SM90_MIN_ROWS rows when TMA can address x (a 16-byte aligned
    base, K a multiple of 8) and the codes (N a multiple of 16), and the
    codes and scale are contiguous, the scale's base 16-byte aligned; else
    "mma_sync" (other bf16; other dtypes raise in its launch)."""
    if x2.dtype == torch.float32:
        return "fp32"
    if (x2.dtype == torch.bfloat16 and x2.shape[0] >= WQ_SM90_MIN_ROWS
            and tma_ok(x2) and w.q.is_contiguous() and tma_ok(w.q)
            and w.scale.is_contiguous() and w.scale.data_ptr() % 16 == 0):
        return "sm90"
    return "mma_sync"


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_wq_sm90(x2, w, splits=None):
    """One sm90 K7 call on contiguous bf16 rows ``x2`` (M, K): the plan of
    ``wq_plan`` (``splits`` overrides its K split, for measurement), the
    fp32 partials of a split call in a ``torch.empty`` scratch."""
    M, K = x2.shape
    N = w.scale.shape[-1]
    rt, S = wq_plan(M, K, N, _sm_count(x2.device.index))
    if splits is not None:
        S = splits
    out = torch.empty(M, N, dtype=x2.dtype, device=x2.device)
    part = (torch.empty(S, M, N, dtype=torch.float32, device=x2.device)
            if S > 1 else None)
    rc = kernel_builder().load().wq_matmul_sm90_launch(
        x2.data_ptr(), w.q.data_ptr(), w.scale.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, w.bits, rt, S,
        torch.cuda.current_stream(x2.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wq_matmul kernel launch failed (sm90): "
                           f"cudaError {rc}")
    return out


def wq_matmul(x, w, x_t=False, out_t=False):
    """Forward-only ``x @ dequant(w)`` for a quantized weight: x (B, T, K)
    (or (T, K); (B, K, T) when ``x_t``), w an ``Int8Weight`` (codes (K, M))
    or ``Int4Weight`` (codes (K/2, M)) with a (1, M) scale -> (B, T, M) in
    x's dtype ((B, M, T) when ``out_t``). One launch on the card."""
    squeeze = x.dim() == 2
    x3 = x[None] if squeeze else x
    if x3.dim() != 3:
        raise ValueError(f"wq_matmul: want x (B, T, K) or (T, K), got "
                         f"{tuple(x.shape)}")
    K = x3.shape[1] if x_t else x3.shape[2]
    check_quantized("wq_matmul", (w,), None, K, w.shape[-1], x.device)
    B, T, x2 = _rows(x3, x_t)
    if x.device.type == "cpu":
        out = _plain_rows(x2, w)
    elif x2.shape[0] == 0:
        out = torch.empty(0, w.shape[-1], dtype=x.dtype, device=x.device)
    else:
        out = _wq_cuda(x2, w)
    return _shape_out(out, B, T, out_t, squeeze)


def _wq_cuda(x2, w, design=None):
    """K7 on CUDA rows ``x2`` (M > 0, K) through ``_wq_design``'s design
    (``design`` overrides it, for measurement), counted."""
    x2 = x2.contiguous()
    design = design or _wq_design(x2, w)
    if design == "sm90":
        out = _launch_wq_sm90(x2, w)
        LAUNCHES["wq_matmul"] += 1
    else:
        out = launch_wq(kernel_builder().load().wq_matmul_launch,
                        "wq_matmul", LAUNCHES, x2, w)
    DESIGN_LAUNCHES["wq_matmul"][design] += 1
    return out


# ------------------------------------------------------------------- K6


def _log_a(a, a_t):
    """a (P, N, K), or its (P, K, N) layout when ``a_t`` -> the logical
    (P, N, K) view."""
    return a.transpose(1, 2) if a_t else a


def mm_reference(a, b, a_t, b_t, out_t, out_dtype):
    """Plain version of ``_mm``: out[p, n, m] = sum_k a[p, n, k] b[k, m] in
    fp32, rounded once; a (P, K, N) when ``a_t``, b (M, K) when ``b_t``,
    out (P, M, N) when ``out_t``."""
    out = torch.matmul(_log_a(a, a_t).float(),
                       (b.t() if b_t else b).float()).to(out_dtype)
    return out.transpose(1, 2) if out_t else out


def dw_reference(a, g, a_t, g_t, out_dtype):
    """Plain version of ``_dw``: dw[k, m] = sum over (p, n) of a[p, n, k]
    g[p, n, m] in fp32, rounded once; a (P, K, N) when ``a_t``, g
    (P, M, N) when ``g_t``."""
    return torch.einsum("pnk,pnm->km", _log_a(a, a_t).float(),
                        _log_a(g, g_t).float()).to(out_dtype)


def mlp_matmul_reference(x, w, x_t=False, out_t=False):
    """Plain version of ``mlp_matmul`` (the JAX ``_ref_proj``)."""
    return mm_reference(x, w, x_t, False, out_t, x.dtype)


def _staged(t, dims):
    """``t`` when one of its ``dims`` has stride 1 (the kernel stages along
    it), else a contiguous copy."""
    return t if any(t.stride(d) == 1 for d in dims) else t.contiguous()


def _vec_ok(t, strides):
    """16-byte cp.async staging: an aligned base and every non-unit stride
    a whole number of 16-byte vectors."""
    vec = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % vec == 0 for s in strides
                                          if s != 1)


def _k6_design(A, B, out):
    """The K6 design for operands ``A``, ``B`` and output ``out`` as the
    launch reads them: "fp32" for fp32; "sm90" (TMA + wgmma) for bf16 that
    TMA can address (``tma_ok``: every GPT-2 350M call); else
    "mma_sync" (e.g. K = 100, rows of 200 bytes; a dW over no rows)."""
    if A.dtype == torch.float32:
        return "fp32"
    return "sm90" if all(map(tma_ok, (A, B, out))) else "mma_sync"


def _launch_k6(name, A, B, out, sa, sb, so, dims, a_t, b_t):
    """One K6 launch: O[z, i, j] = sum_{q, c} A[z, q, i, c] B[z, q, c, j]
    with strides ``sa`` / ``sb`` = (z, q, i, c) / (z, q, c, j), ``so`` =
    (z, i, j) and ``dims`` = (Z, Q, I, J, C), through the design
    ``_k6_design`` picks."""
    lib = kernel_builder().load()
    args = _MmArgs(A.data_ptr(), B.data_ptr(), out.data_ptr(), *sa, *sb,
                   *so, *dims, int(a_t), int(b_t), int(_vec_ok(A, sa)),
                   int(_vec_ok(B, sb)))
    stream = torch.cuda.current_stream(A.device).cuda_stream
    design = _k6_design(A, B, out)
    if design == "sm90":
        rc = lib.mlp_mm_sm90_launch(ctypes.byref(args), stream)
    else:
        rc = lib.mlp_mm_launch(ctypes.byref(args), _DTYPE_CODE[A.dtype],
                               stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({design}): "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[name][design] += 1


def _check_k6(name, a, b, out_dtype):
    if b.device != a.device:
        raise ValueError(f"{name}: every operand must be on {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype or \
            out_dtype != a.dtype:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 operands "
                        f"and output of one dtype, got {a.dtype}, {b.dtype} "
                        f"-> {out_dtype}")


def _mm_operands(a, b, a_t, b_t, out_t, out_dtype):
    """``_mm``'s K6 launch: (A, B, out, A's (z, q, i, c) strides, B's (z, q,
    c, j), O's (z, i, j), (Z, Q, I, J, C), a_t, b_t), out allocated."""
    # A[z=p, i=n, c=k] staged [i][c] on a unit k stride, else [c][i];
    # B[c=k, j=m] staged [c][j] on a unit m stride, else [j][c]
    A = _staged(_log_a(a, a_t), (1, 2))
    B = _staged(b.t() if b_t else b, (0, 1))
    P, N, K = A.shape
    M = B.shape[1]
    out = torch.empty((P, M, N) if out_t else (P, N, M), dtype=out_dtype,
                      device=a.device)
    return (A, B, out, (A.stride(0), 0, A.stride(1), A.stride(2)),
            (0, 0, B.stride(0), B.stride(1)), _log_a(out, out_t).stride(),
            (P, 1, N, M, K), int(A.stride(2) != 1), int(B.stride(1) != 1))


def _dw_operands(a, g, a_t, g_t, out_dtype):
    """``_dw``'s K6 launch, as ``_mm_operands``."""
    # A[q=p, i=k, c=n] staged [c][i] on a unit k stride, else [i][c];
    # B[q=p, c=n, j=m] staged [c][j] on a unit m stride, else [j][c]
    A = _staged(_log_a(a, a_t), (1, 2))
    G = _staged(_log_a(g, g_t), (1, 2))
    P, N, K = A.shape
    M = G.shape[2]
    out = torch.empty(K, M, dtype=out_dtype, device=a.device)
    return (A, G, out, (0, A.stride(0), A.stride(2), A.stride(1)),
            (0, G.stride(0), G.stride(1), G.stride(2)), (0, M, 1),
            (1, P, K, M, N), int(A.stride(2) == 1), int(G.stride(2) != 1))


def _mm(a, b, a_t, b_t, out_t, out_dtype):
    """``_mm`` on a's device: out[p, n, m] = sum_k a[p, n, k] b[k, m]
    (orientations as ``mm_reference``)."""
    if a.device.type == "cpu":
        return mm_reference(a, b, a_t, b_t, out_t, out_dtype)
    name = "mlp_mm"
    _check_k6(name, a, b, out_dtype)
    launch = _mm_operands(a, b, a_t, b_t, out_t, out_dtype)
    if launch[2].numel():
        _launch_k6(name, *launch)
    return launch[2]


def _dw(a, g, a_t, g_t, out_dtype):
    """``_dw`` on a's device: dw[k, m] = sum over (p, n) of a[p, n, k]
    g[p, n, m] (orientations as ``dw_reference``)."""
    if a.device.type == "cpu":
        return dw_reference(a, g, a_t, g_t, out_dtype)
    name = "mlp_dw"
    _check_k6(name, a, g, out_dtype)
    launch = _dw_operands(a, g, a_t, g_t, out_dtype)
    if launch[2].numel():
        _launch_k6(name, *launch)
    return launch[2]


class _ProjFn(torch.autograd.Function):
    """``_proj``: forward through ``_mm``; backward as ``_proj_bwd``."""

    @staticmethod
    def forward(ctx, x, w, x_t, out_t, fuse_dw):
        ctx.save_for_backward(x, w)
        ctx.cfg = (x_t, out_t, fuse_dw)
        return _mm(x, w, x_t, False, out_t, x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        x_t, out_t, fuse_dw = ctx.cfg
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[p, n, k] = sum_m dy[p, n, m] w[k, m], in x's orientation
            dx = _mm(dy, w, out_t, True, x_t, x.dtype)
        if ctx.needs_input_grad[1]:
            dw = (_dw if fuse_dw else dw_reference)(x, dy, x_t, out_t,
                                                     w.dtype)
        return dx, dw, None, None, None


def mlp_matmul(x, w, *, x_t=False, out_t=False, block_t=256, block_o=256,
               block_k=512, fuse_dw=True):
    """Batched projection ``y[b, t, m] = sum_k x[b, t, k] w[k, m]`` with
    caller-chosen layouts: x (B, T, K), or (B, K, T) when ``x_t``; w (K, M);
    y (B, T, M), or (B, M, T) when ``out_t``. fp32 accumulation, y rounded
    once to x's dtype. Differentiable: dx in x's orientation, dW fused
    (``fuse_dw``) or a plain fp32 einsum. The block sizes change nothing;
    a CUDA tensor takes the kernel at every shape."""
    if x.dim() != 3 or w.dim() != 2:
        raise ValueError(
            f"mlp_matmul expects x (B, ., .) and w (K, M); got "
            f"{tuple(x.shape)} / {tuple(w.shape)}")
    K = x.shape[1] if x_t else x.shape[2]
    if w.shape[0] != K:
        raise ValueError(f"contract dim mismatch: x carries K={K}, w is "
                         f"{tuple(w.shape)}")
    return _ProjFn.apply(x, w, bool(x_t), bool(out_t), bool(fuse_dw))
