"""Grouped (ragged) matmul for the dropless-MoE expert FFN: Hopper CUDA
kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/grouped_matmul.py`` (K8: the
forward kernels ``_gmm`` and ``_swiglu_up`` and the weight-gradient kernel
``_tgmm``); the kernels are ``csrc/grouped_matmul.cu`` (design and bound
are noted there). Same signatures as the JAX functions:

  grouped_matmul(x, w, group_sizes)         x (S, K) rows sorted by group,
      w (E, K, N), group_sizes (E,) int -> (S, N), the ``lax.ragged_dot``
      contract: rows past ``sum(group_sizes)`` are exactly 0;
  grouped_swiglu(x, w1, w3, w2, group_sizes) ``gmm(silu(x w1) * (x w3), w2)``
      with the gate/up products fused into one launch;
  grouped_tgmm(x, dy, group_sizes)          the per-group weight gradient
      (E, K, N): sum over group e's rows of x^T dy, fp32 accumulation.

and the weight-only quantized forward (K9, ``_gmm_wq`` / ``_swiglu_up_wq``
behind the JAX ``grouped_swiglu_wq``):

  grouped_swiglu_wq(x, w1, w3, w2, group_sizes) the same chain with
      ``Int8Weight`` / ``Int4Weight`` experts (codes (E, K | K/2, N), scales
      (E, 1, N)): fp32 products of x and the codes, each expert's scales on
      the accumulators, one rounding per product. Forward only (serving).

Both differentiable entry points carry the JAX custom VJPs as
``torch.autograd.Function``s: ``_gmm_diff`` (grouped_matmul.py:323-349:
dx = gmm(dy, w^T) through a transposed view of w, dw = tgmm(x, dy)) and
``_swiglu_diff`` (:376-424, the remat backward: g and u recomputed, five
gmm and three tgmm). ``group_sizes`` gets no gradient.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises (there is no
shape-based fallback: the JAX ``_blocks_fit`` -> ``ragged_dot`` fallback is
a TPU tiling limit the CUDA kernel does not share). ``group_sizes`` stays
on the device: the kernels read it there, so a call never syncs the host.
``LAUNCHES`` counts kernel launches. ``grouped_tgmm`` takes one of three
designs (``_tgmm_design``): bf16 operands TMA can address go to the Hopper
wgmma kernel (``grouped_tgmm_sm90_kernel``), other bf16 (the expert-bias
row sums ``grouped_tgmm(ones, dy)``) to the mma.sync kernel, fp32 to the
scalar-FMA instance. ``grouped_gmm`` (the forward and the dx product on
w's transposed view) likewise (``_gmm_design``): bf16 that TMA can address
goes to ``grouped_gmm_sm90_kernel``, other bf16 to the mma.sync
``grouped_kernel``.
The quantized kernels (K9) likewise (``_wq_grouped_design``): bf16 x and
codes that TMA can address go to ``wq_grouped_sm90_kernel`` (K7's Hopper
CTA on the grouped walk, its row tile from ``wq_grouped_plan``), other
bf16 to the mma.sync ``wq_kernel``, fp32 to its scalar-FMA instance.
``grouped_swiglu_up`` likewise (``_swiglu_up_design``): bf16 that TMA can
address, from ``SWIGLU_UP_SM90_MIN_ROWS`` rows, goes to
``grouped_swiglu_up_sm90_kernel`` (the transposed product on wgmma, K9's
runs, the row tile from ``wq_grouped_plan``), other bf16 to the mma.sync
``grouped_kernel``. ``DESIGN_LAUNCHES`` counts launches by design.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..int8_weights import is_quantized

LAUNCHES = {"grouped_swiglu_up": 0, "grouped_gmm": 0, "grouped_tgmm": 0,
            "grouped_swiglu_up_wq": 0, "grouped_gmm_wq": 0}
DESIGN_LAUNCHES = {name: {"sm90": 0, "mma_sync": 0, "fp32": 0}
                   for name in ("grouped_swiglu_up", "grouped_gmm",
                                "grouped_tgmm", "grouped_gmm_wq",
                                "grouped_swiglu_up_wq")}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the design codes of K9's launchers (grouped_{gmm,swiglu_up}_wq_launch: 0
# and 1 are wq_kernel's fp32 and bf16 instances) and of
# grouped_swiglu_up_launch (0 and 1 grouped_kernel's)
DESIGN_CODE = {"fp32": 0, "mma_sync": 1, "sm90": 2}
# grouped_swiglu_up's sm90 design (grouped_swiglu_up_sm90_kernel): bf16
# calls of at least SWIGLU_UP_SM90_MIN_ROWS rows take it
SWIGLU_UP_SM90_MIN_ROWS = 1
# K9's sm90 design (wq_grouped_sm90_kernel on csrc/wq_sm90.cuh): the row
# tiles (wgmma's n) of its visits; bf16 calls of at least
# WQ_GROUPED_SM90_MIN_ROWS rows take it
WQ_GROUPED_ROW_TILES = (16, 80, 128)
WQ_GROUPED_SM90_MIN_ROWS = 1


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_design in DESIGN_LAUNCHES.values():
        for k in by_design:
            by_design[k] = 0


class _GroupedArgs(ctypes.Structure):
    """Mirror of ``struct GroupedArgs`` in csrc/grouped_matmul.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("w1", ctypes.c_void_p),
                ("w3", ctypes.c_void_p), ("group_sizes", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("sw_e", ctypes.c_longlong),
                ("sw_k", ctypes.c_longlong), ("sw_n", ctypes.c_longlong),
                ("M", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("E", ctypes.c_int), ("vec_x", ctypes.c_int),
                ("vec_w", ctypes.c_int), ("w_kmajor", ctypes.c_int)]


class WqArgs(ctypes.Structure):
    """Mirror of ``struct WqArgs`` in csrc/wq_gemm.cuh."""
    _fields_ = [("x", ctypes.c_void_p), ("q1", ctypes.c_void_p),
                ("q3", ctypes.c_void_p), ("s1", ctypes.c_void_p),
                ("s3", ctypes.c_void_p), ("group_sizes", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("M", ctypes.c_int),
                ("K", ctypes.c_int), ("N", ctypes.c_int), ("E", ctypes.c_int),
                ("vec_x", ctypes.c_int), ("vec_w", ctypes.c_int)]


WQ_ARGTYPES = [ctypes.POINTER(WqArgs), ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_void_p]

class _TgmmArgs(ctypes.Structure):
    """Mirror of ``struct TgmmArgs`` in csrc/grouped_matmul.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("dy", ctypes.c_void_p),
                ("group_sizes", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("M", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("E", ctypes.c_int), ("vec_x", ctypes.c_int),
                ("vec_dy", ctypes.c_int)]


_builder = None


def kernel_builder():
    """The grouped-matmul library's builder; the first call builds the
    library (nvcc, see op_builder) and binds its ctypes signatures."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import GroupedMatmulBuilder
        b = GroupedMatmulBuilder()
        lib = b.load()
        for fn in (lib.grouped_gmm_launch, lib.grouped_swiglu_up_launch):
            fn.argtypes = [ctypes.POINTER(_GroupedArgs), ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.grouped_tgmm_launch.argtypes = [ctypes.POINTER(_TgmmArgs),
                                            ctypes.c_int, ctypes.c_void_p]
        lib.grouped_tgmm_launch.restype = ctypes.c_int
        lib.grouped_tgmm_sm90_launch.argtypes = [ctypes.POINTER(_TgmmArgs),
                                                 ctypes.c_void_p]
        lib.grouped_tgmm_sm90_launch.restype = ctypes.c_int
        lib.grouped_gmm_sm90_launch.argtypes = [
            ctypes.POINTER(_GroupedArgs), ctypes.c_void_p]
        lib.grouped_gmm_sm90_launch.restype = ctypes.c_int
        for fn in (lib.grouped_gmm_wq_launch, lib.grouped_swiglu_up_wq_launch):
            fn.argtypes = WQ_ARGTYPES
            fn.restype = ctypes.c_int
        _builder = b
    return _builder


def block_m_for(rows):
    """The kernels' m-tile for a call of ``rows`` rows: 16 when one tile
    holds them all (decode: 8 slots x top-2), so each touched expert's
    weight tile streams once per call; else 64."""
    return 16 if rows <= 16 else 64


# ----------------------------------------------------------------- plain


def _group_bounds(group_sizes, M):
    """[(expert, first row, end row)] of the non-empty groups, clipped to M
    (host loop; the plain versions run on CPU tensors and in checks)."""
    out, start = [], 0
    for e, n in enumerate(group_sizes.tolist()):
        lo, hi = min(start, M), min(start + max(int(n), 0), M)
        if hi > lo:
            out.append((e, lo, hi))
        start = hi
    return out


def grouped_matmul_reference(x, w, group_sizes):
    """Plain version (the ``lax.ragged_dot`` math): each group's rows times
    its expert's weights in fp32, rounded once to x's dtype; rows past the
    groups are 0."""
    out = torch.zeros(x.shape[0], w.shape[2], dtype=x.dtype, device=x.device)
    for e, lo, hi in _group_bounds(group_sizes, x.shape[0]):
        out[lo:hi] = torch.matmul(x[lo:hi].float(), w[e].float()).to(x.dtype)
    return out


def grouped_swiglu_up_reference(x, w1, w3, group_sizes):
    """Plain version of the fused up chain: silu(x w1[g]) * (x w3[g]) with
    fp32 products and epilogue, rounded once; rows past the groups are 0."""
    out = torch.zeros(x.shape[0], w1.shape[2], dtype=x.dtype,
                      device=x.device)
    for e, lo, hi in _group_bounds(group_sizes, x.shape[0]):
        xs = x[lo:hi].float()
        g = torch.matmul(xs, w1[e].float())
        out[lo:hi] = (F.silu(g) * torch.matmul(xs, w3[e].float())).to(x.dtype)
    return out


def grouped_tgmm_reference(x, dy, group_sizes):
    """Plain version of ``grouped_tgmm``: per group, x^T dy in fp32 rounded
    once to x's dtype; an empty group's slab is 0."""
    E = group_sizes.shape[0]
    out = torch.zeros(E, x.shape[1], dy.shape[1], dtype=x.dtype,
                      device=x.device)
    for e, lo, hi in _group_bounds(group_sizes, x.shape[0]):
        out[e] = torch.matmul(x[lo:hi].float().t(),
                              dy[lo:hi].float()).to(x.dtype)
    return out


def grouped_matmul_wq_reference(x, w, group_sizes):
    """Plain version of the quantized grouped product: per group, fp32
    products of x and expert e's codes, times its scales, rounded once;
    rows past the groups are 0."""
    out = torch.zeros(x.shape[0], w.scale.shape[-1], dtype=x.dtype,
                      device=x.device)
    codes = w.codes()
    for e, lo, hi in _group_bounds(group_sizes, x.shape[0]):
        acc = torch.matmul(x[lo:hi].float(), codes[e].float())
        out[lo:hi] = (acc * w.scale[e]).to(x.dtype)
    return out


def grouped_swiglu_up_wq_reference(x, w1, w3, group_sizes):
    """Plain version of the quantized up chain: each expert's scales on
    the fp32 products, then silu(g) * u in fp32, rounded once."""
    out = torch.zeros(x.shape[0], w1.scale.shape[-1], dtype=x.dtype,
                      device=x.device)
    c1, c3 = w1.codes(), w3.codes()
    for e, lo, hi in _group_bounds(group_sizes, x.shape[0]):
        xs = x[lo:hi].float()
        g = torch.matmul(xs, c1[e].float()) * w1.scale[e]
        u = torch.matmul(xs, c3[e].float()) * w3.scale[e]
        out[lo:hi] = (F.silu(g) * u).to(x.dtype)
    return out


def grouped_swiglu_wq_reference(x, w1, w3, w2, group_sizes):
    """Plain version of ``grouped_swiglu_wq``."""
    h = grouped_swiglu_up_wq_reference(x, w1, w3, group_sizes)
    return grouped_matmul_wq_reference(h, w2, group_sizes)


def grouped_swiglu_reference(x, w1, w3, w2, group_sizes):
    """Plain version of ``grouped_swiglu``: the up chain, then the grouped
    down projection."""
    h = grouped_swiglu_up_reference(x, w1, w3, group_sizes)
    return grouped_matmul_reference(h, w2, group_sizes)


# ---------------------------------------------------------------- kernels


def _check_sizes(name, group_sizes, E):
    if group_sizes.shape != (E,) or group_sizes.dtype.is_floating_point:
        raise ValueError(f"{name}: want integer group_sizes ({E},), got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")


def _check_grouped(name, x, ws, group_sizes):
    E, K, N = ws[0].shape
    if x.dim() != 2 or x.shape[1] != K or any(w.shape != ws[0].shape
                                              for w in ws):
        raise ValueError(f"{name}: want x (S, K) and weights (E, K, N), got "
                         f"x {tuple(x.shape)}, weights "
                         f"{[tuple(w.shape) for w in ws]}")
    _check_sizes(name, group_sizes, E)
    if any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"{name}: x and the weights must share a dtype, got "
                        f"{x.dtype} and {[w.dtype for w in ws]}")


def _check_device(name, x, others):
    if any(t.device != x.device for t in others):
        raise ValueError(f"{name}: every operand must be on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")


def _aligned(t):
    return t.data_ptr() % 16 == 0


def tma_ok(t):
    """TMA can address ``t`` as sm90_gemm.cuh's ``make_operand_map`` encodes
    it: not empty (a tensor map needs a base and extents of at least 1), a
    16-byte aligned base, a unit stride on the axis the kernel reads along
    (the last, else the one before it), the stride of the other of the last
    two axes (always in the map, whatever its extent) and that of each
    leading axis longer than 1 (the map keeps those) a whole number of 16
    bytes."""
    vec = 16 // t.element_size()
    inner = t.dim() - 1 if t.stride(-1) == 1 else t.dim() - 2
    outer = 2 * t.dim() - 3 - inner
    return (t.numel() > 0 and t.data_ptr() % 16 == 0
            and t.stride(inner) == 1 and t.stride(outer) % vec == 0
            and all(t.stride(d) % vec == 0 for d in range(t.dim() - 2)
                    if t.shape[d] > 1))


def _tgmm_design(x, dy, out):
    """The ``grouped_tgmm`` design for contiguous x (M, K), dy (M, N) and out
    (E, K, N): "fp32" for fp32; "sm90" (TMA + wgmma, the group's row range
    resolved on the device) for bf16 that TMA can address (``tma_ok``: K
    and N multiples of 8, aligned bases, M > 0; both GPT2-MoE 350M expert
    products); else "mma_sync" (the expert-bias row sums of x = ones (M, 1),
    an odd K, an unaligned base, no rows)."""
    if x.dtype == torch.float32:
        return "fp32"
    return "sm90" if all(map(tma_ok, (x, dy, out))) else "mma_sync"


def _gmm_design(x, w):
    """The ``grouped_gmm`` design for a contiguous x (M, K) and w (E, K, N)
    through its strides: "fp32" for fp32; "sm90" (TMA + wgmma, the tiles
    resolved on the device) for bf16 that TMA can address (``tma_ok``: rows,
    K a multiple of 8, aligned bases, w with a unit n stride (the forward)
    or a unit k stride (the dx product's transposed view) and its other
    strides multiples of 8): both GPT2-MoE 350M training shapes and
    Mixtral's decode and chunk; else "mma_sync" (no rows, an odd K, any
    other stride). No row count splits bf16: at Mixtral-8x7B's down
    projection sm90 is the faster design at the 16-row decode as at the
    512-row chunk (chip_smoke.py phase 8 times both)."""
    if x.dtype == torch.float32:
        return "fp32"
    return "sm90" if tma_ok(x) and tma_ok(w) else "mma_sync"


def _swiglu_up_design(x, w1, w3):
    """The ``grouped_swiglu_up`` design for a contiguous x (M, K) and w1, w3
    (E, K, N) through their (shared) strides: "fp32" for fp32; "sm90" (TMA
    + wgmma, K9's runs resolved on the device) for bf16 of at least
    SWIGLU_UP_SM90_MIN_ROWS rows that TMA can address (``tma_ok``: K and N
    multiples of 8, aligned bases, w1 and w3 with a unit n stride and their
    other strides multiples of 8): Mixtral-8x7B's decode and chunk; else
    "mma_sync" (no rows, an odd K or N, a unit k stride, an unaligned
    base)."""
    if x.dtype == torch.float32:
        return "fp32"
    if (x.shape[0] >= SWIGLU_UP_SM90_MIN_ROWS and w1.shape[2] % 8 == 0
            and all(w.stride(-1) == 1 and tma_ok(w) for w in (w1, w3))
            and tma_ok(x)):
        return "sm90"
    return "mma_sync"


def _launch(fn_name, name, x, ws, group_sizes, design=None):
    """Launch one grouped kernel on CUDA tensors, counting it under
    ``name`` and by design (``grouped_gmm``: ``_gmm_design``;
    ``grouped_swiglu_up``: ``_swiglu_up_design``, or ``design`` when given;
    a name DESIGN_CODE lacks raises); returns its (M, N) output."""
    _check_device(name, x, (*ws, group_sizes))
    if ws[0].stride() != ws[-1].stride():
        raise ValueError(f"{name}: w1 and w3 must share their strides")
    M, K = x.shape
    E, _, N = ws[0].shape
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    x = x.contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    vec = 16 // x.element_size()
    se, sk, sn = ws[0].stride()
    # a unit k stride (the transposed view of the dx product) is staged
    # k-major by the gmm kernel; otherwise [k][n], vectorised on a unit n
    # stride
    kmajor = len(ws) == 1 and sk == 1 and sn != 1
    unit, lead = (sk, sn) if kmajor else (sn, sk)
    vec_w = (unit == 1 and lead % vec == 0 and se % vec == 0
             and all(_aligned(w) for w in ws))
    a = _GroupedArgs(x.data_ptr(), ws[0].data_ptr(), ws[-1].data_ptr(),
                     gs.data_ptr(), out.data_ptr(), se, sk, sn, M, K, N, E,
                     int(K % vec == 0 and _aligned(x)), int(vec_w),
                     int(kmajor))
    code, tile = _DTYPE_CODE[x.dtype], block_m_for(M)
    if name == "grouped_swiglu_up":
        if design is None:
            design = _swiglu_up_design(x, *ws)
        if design not in DESIGN_CODE:
            raise ValueError(f"{name}: unknown design {design!r}")
        code = DESIGN_CODE[design]
        if design == "sm90":
            tile = wq_grouped_plan(M, E)
    else:
        design = _gmm_design(x, ws[0])
    lib = kernel_builder().load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if name == "grouped_gmm" and design == "sm90":
        rc = lib.grouped_gmm_sm90_launch(ctypes.byref(a), stream)
    else:
        rc = getattr(lib, fn_name)(ctypes.byref(a), code, tile, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({design}): "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[name][design] += 1
    return out


def check_quantized(name, ws, E, K, N, device):
    """Raise unless every w in ``ws`` is a quantized weight of logical shape
    (E, K, N) (E None: (K, N)) with int8 codes and (E, 1, N) fp32 scales on
    ``device``."""
    lead = () if E is None else (E,)
    for w in ws:
        if not is_quantized(w):
            raise TypeError(f"{name}: want Int8Weight/Int4Weight, got "
                            f"{type(w).__name__}")
        if w.shape != lead + (K, N) or tuple(w.scale.shape) != lead + (1, N):
            raise ValueError(f"{name}: want a quantized {lead + (K, N)} "
                             f"weight, got {w!r}")
        if (w.q.dtype != torch.int8 or w.scale.dtype != torch.float32
                or w.q.device != device or w.scale.device != device):
            raise TypeError(f"{name}: want int8 codes and fp32 scales on "
                            f"{device}, got {w.q.dtype} / {w.scale.dtype} "
                            f"on {w.q.device}")


def launch_wq(lib_fn, name, counts, x, w1, w3=None, group_sizes=None,
              code=None, tile=None):
    """Launch one quantized-weight kernel on CUDA tensors, counting it as
    ``counts[name]``: x (M, K) times w1's codes (w3's too for the fused
    SwiGLU), grouped when ``group_sizes`` is given. ``code`` and ``tile``
    are the launcher's second and fourth arguments (default: x's dtype
    code and ``block_m_for`` rows, wq_gemm.cuh's wq_kernel). Returns the
    (M, N) output in x's dtype."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    M, K = x.shape
    N = w1.scale.shape[-1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    x = x.contiguous()
    ws = (w1,) if w3 is None else (w1, w3)
    q = [w.q.contiguous() for w in ws]
    s = [w.scale.contiguous() for w in ws]
    gs = None
    E = 1
    if group_sizes is not None:
        if group_sizes.device != x.device:
            raise ValueError(f"{name}: group_sizes must be on {x.device}")
        gs = group_sizes.to(torch.int32).contiguous()
        E = gs.shape[0]
    vec_x = K % (16 // x.element_size()) == 0 and _aligned(x)
    vec_w = N % 16 == 0 and all(_aligned(t) for t in q)
    a = WqArgs(x.data_ptr(), q[0].data_ptr(), q[-1].data_ptr(),
               s[0].data_ptr(), s[-1].data_ptr(),
               None if gs is None else gs.data_ptr(), out.data_ptr(),
               M, K, N, E, int(vec_x), int(vec_w))
    rc = lib_fn(ctypes.byref(a),
                _DTYPE_CODE[x.dtype] if code is None else code, w1.bits,
                block_m_for(M) if tile is None else tile,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    counts[name] += 1
    return out


def _gmm(x, w, group_sizes):
    """The forward grouped product on x's device (no autograd)."""
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, group_sizes)
    return _launch("grouped_gmm_launch", "grouped_gmm", x, (w,), group_sizes)


def _swiglu_up(x, w1, w3, group_sizes, design=None):
    """The fused up chain on x's device (no autograd); ``design`` (CUDA
    tensors: "fp32", "mma_sync" or "sm90") overrides ``_swiglu_up_design``,
    so the card's checks can time one design beside the other."""
    if x.device.type == "cpu":
        return grouped_swiglu_up_reference(x, w1, w3, group_sizes)
    return _launch("grouped_swiglu_up_launch", "grouped_swiglu_up", x,
                   (w1, w3), group_sizes, design)


def _tgmm(x, dy, group_sizes):
    if x.device.type == "cpu":
        return grouped_tgmm_reference(x, dy, group_sizes)
    name = "grouped_tgmm"
    _check_device(name, x, (dy, group_sizes))
    M, K = x.shape
    N = dy.shape[1]
    E = group_sizes.shape[0]
    out = torch.empty(E, K, N, dtype=x.dtype, device=x.device)
    x, dy = x.contiguous(), dy.contiguous()
    gs = group_sizes.to(torch.int32).contiguous()
    vec = 16 // x.element_size()
    a = _TgmmArgs(x.data_ptr(), dy.data_ptr(), gs.data_ptr(), out.data_ptr(),
                  M, K, N, E, int(K % vec == 0 and _aligned(x)),
                  int(N % vec == 0 and _aligned(dy)))
    lib = kernel_builder().load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    design = _tgmm_design(x, dy, out)
    if design == "sm90":
        rc = lib.grouped_tgmm_sm90_launch(ctypes.byref(a), stream)
    else:
        rc = lib.grouped_tgmm_launch(ctypes.byref(a), _DTYPE_CODE[x.dtype],
                                     stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed ({design}): "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1
    DESIGN_LAUNCHES[name][design] += 1
    return out


class _GroupedMatmulFn(torch.autograd.Function):
    """``_gmm_diff``: dx = gmm(dy, w^T) on a transposed view of w (the
    kernel stages it k-major, no (E, N, K) copy), dw = tgmm(x, dy)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _gmm(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dx = _gmm(dy, w.transpose(1, 2), gs) if ctx.needs_input_grad[0] \
            else None
        dw = _tgmm(x, dy, gs) if ctx.needs_input_grad[1] else None
        return dx, dw, None


class _GroupedSwigluFn(torch.autograd.Function):
    """``_swiglu_diff``: forward = the fused up chain, then the down gmm;
    backward recomputes g and u by two grouped products instead of keeping
    them, and rounds sil, dg, du and h to x's dtype where JAX does
    (grouped_matmul.py:391-421)."""

    @staticmethod
    def forward(ctx, x, w1, w3, w2, group_sizes):
        ctx.save_for_backward(x, w1, w3, w2, group_sizes)
        return _gmm(_swiglu_up(x, w1, w3, group_sizes), w2, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        return (*_swiglu_backward(*ctx.saved_tensors, dy, _gmm, _tgmm), None)


def _swiglu_backward(x, w1, w3, w2, gs, dy, gmm, tgmm):
    """(dx, dw1, dw3, dw2) of the SwiGLU chain through the product
    functions ``gmm`` (x, w, sizes) and ``tgmm`` (x, dy, sizes)."""
    g = gmm(x, w1, gs)
    u = gmm(x, w3, gs)
    gf = g.float()
    sg = torch.sigmoid(gf)
    sil = (gf * sg).to(x.dtype)
    dhf = gmm(dy, w2.transpose(1, 2), gs).float()
    uf = u.float()
    dg = (dhf * uf * (sg * (1 + gf * (1 - sg)))).to(x.dtype)
    du = (dhf * sil.float()).to(x.dtype)
    dx = gmm(dg, w1.transpose(1, 2), gs) + gmm(du, w3.transpose(1, 2), gs)
    h = (sil.float() * uf).to(x.dtype)
    return dx, tgmm(x, dg, gs), tgmm(x, du, gs), tgmm(h, dy, gs)


def grouped_swiglu_backward_reference(x, w1, w3, w2, group_sizes, dy):
    """Plain version of ``grouped_swiglu``'s backward: (dx, dw1, dw3, dw2)
    through the plain grouped products, on any device."""
    return _swiglu_backward(x, w1, w3, w2, group_sizes, dy,
                            grouped_matmul_reference, grouped_tgmm_reference)


def grouped_matmul(x, w, group_sizes):
    """x (S, K) rows sorted by group, w (E, K, N) (any strides),
    group_sizes (E,) int -> (S, N) in x's dtype; rows past
    ``sum(group_sizes)`` are 0. Differentiable in x and w."""
    _check_grouped("grouped_matmul", x, (w,), group_sizes)
    return _GroupedMatmulFn.apply(x, w, group_sizes)


def grouped_tgmm(x, dy, group_sizes):
    """The per-group weight gradient: x (M, K), dy (M, N) rows sorted by
    group, group_sizes (E,) int -> (E, K, N) in x's dtype, slab e = sum over
    group e's rows of x^T dy with fp32 accumulation; rows past the groups
    contribute nothing and an empty group's slab is 0."""
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"grouped_tgmm: want x (M, K) and dy (M, N), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    _check_sizes("grouped_tgmm", group_sizes, group_sizes.shape[0])
    if dy.dtype != x.dtype:
        raise TypeError(f"grouped_tgmm: x and dy must share a dtype, got "
                        f"{x.dtype} and {dy.dtype}")
    return _tgmm(x, dy, group_sizes)


def grouped_swiglu_up(x, w1, w3, group_sizes):
    """h = silu(x w1[g]) * (x w3[g]): x (S, K), w1/w3 (E, K, F) -> (S, F)
    in x's dtype, fp32 epilogue, rows past the groups 0. Forward only, as
    the JAX ``_swiglu_up``: differentiate ``grouped_swiglu``."""
    _check_grouped("grouped_swiglu_up", x, (w1, w3), group_sizes)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, w3)):
        raise RuntimeError("grouped_swiglu_up has no backward; "
                           "differentiate grouped_swiglu")
    return _swiglu_up(x, w1, w3, group_sizes)


def grouped_swiglu(x, w1, w3, w2, group_sizes):
    """The SwiGLU expert chain: x (S, K); w1/w3 (E, K, F); w2 (E, F, K')
    -> (S, K'). Two launches on the card forward (the fused up chain, then
    the grouped down projection); five gmm and three tgmm backward."""
    E, K, Fd = w1.shape
    if w2.dim() != 3 or tuple(w2.shape[:2]) != (E, Fd):
        raise ValueError(f"grouped_swiglu: want w2 ({E}, {Fd}, K'), got "
                         f"{tuple(w2.shape)}")
    _check_grouped("grouped_swiglu", x, (w1, w3), group_sizes)
    if w2.dtype != x.dtype:
        raise TypeError(f"grouped_swiglu: x and w2 must share a dtype, got "
                        f"{x.dtype} and {w2.dtype}")
    return _GroupedSwigluFn.apply(x, w1, w3, w2, group_sizes)


def wq_grouped_plan(M, E):
    """The row tile of K9's and ``grouped_swiglu_up``'s sm90 designs for M
    routed rows over E experts: the
    smallest of WQ_GROUPED_ROW_TILES that holds ceil(M / E) rows and a
    quarter more (top-k routing is uneven: a second run of a few rows
    costs a whole run's code and x reads), else the largest. So 16 at
    Mixtral's 16-row decode (one run a touched expert) and 80 at its
    512-row chunk (64 a group on average). Shape only: the sizes stay on
    the device."""
    per = -(-M // max(E, 1))
    per += -(-per // 4)
    return next((t for t in WQ_GROUPED_ROW_TILES if per <= t),
                WQ_GROUPED_ROW_TILES[-1])


def _wq_grouped_design(x, w):
    """K9's design for x rows (M, K) and quantized experts w, read from
    dtype, shape and addresses only: "fp32" for fp32 x; "sm90" for bf16 x
    of at least WQ_GROUPED_SM90_MIN_ROWS rows when TMA can address x (a
    16-byte aligned base, K a multiple of 8) and the codes (contiguous, N a
    multiple of 16), the scales are contiguous with a 16-byte aligned base;
    else "mma_sync" (wq_kernel)."""
    if x.dtype == torch.float32:
        return "fp32"
    if (x.dtype == torch.bfloat16 and x.shape[0] >= WQ_GROUPED_SM90_MIN_ROWS
            and tma_ok(x) and w.q.is_contiguous() and tma_ok(w.q)
            and w.scale.is_contiguous() and w.scale.data_ptr() % 16 == 0):
        return "sm90"
    return "mma_sync"


def _launch_wq_grouped(fn_name, name, x, ws, group_sizes, design=None):
    """One K9 launch on CUDA tensors under ``design`` (default
    ``_wq_grouped_design``'s; a name DESIGN_CODE lacks raises), counted
    in LAUNCHES and by design."""
    x = x.contiguous()
    if design is None:
        design = _wq_grouped_design(x, ws[0])
        if len(ws) > 1 and _wq_grouped_design(x, ws[1]) != design:
            design = "mma_sync"
    if design not in DESIGN_CODE:
        raise ValueError(f"{name}: unknown design {design!r}")
    tile = (wq_grouped_plan(x.shape[0], group_sizes.shape[0])
            if design == "sm90" else None)
    out = launch_wq(getattr(kernel_builder().load(), fn_name), name,
                    LAUNCHES, x, *ws, group_sizes=group_sizes,
                    code=DESIGN_CODE[design], tile=tile)
    if x.shape[0]:
        DESIGN_LAUNCHES[name][design] += 1
    return out


def _gmm_wq(x, w, group_sizes):
    if x.device.type == "cpu":
        return grouped_matmul_wq_reference(x, w, group_sizes)
    return _launch_wq_grouped("grouped_gmm_wq_launch", "grouped_gmm_wq", x,
                              (w,), group_sizes)


def _swiglu_up_wq(x, w1, w3, group_sizes):
    if x.device.type == "cpu":
        return grouped_swiglu_up_wq_reference(x, w1, w3, group_sizes)
    return _launch_wq_grouped("grouped_swiglu_up_wq_launch",
                              "grouped_swiglu_up_wq", x, (w1, w3),
                              group_sizes)


def _check_wq(name, x, ws, group_sizes):
    E, K, N = ws[0].shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"{name}: want x (S, {K}), got {tuple(x.shape)}")
    check_quantized(name, ws, E, K, N, x.device)
    _check_sizes(name, group_sizes, E)


def grouped_matmul_wq(x, w, group_sizes):
    """x (S, K) rows sorted by group times quantized experts w (logical
    (E, K, N)) -> (S, N) in x's dtype; rows past the groups are 0. One
    launch on the card; forward only."""
    _check_wq("grouped_matmul_wq", x, (w,), group_sizes)
    return _gmm_wq(x, w, group_sizes)


def grouped_swiglu_up_wq(x, w1, w3, group_sizes):
    """h = silu(s1 (x code1[g])) * (s3 (x code3[g])): x (S, K), quantized
    w1/w3 of one type (logical (E, K, F)) -> (S, F) in x's dtype."""
    if type(w1) is not type(w3):
        raise TypeError("grouped_swiglu_up_wq: w1 and w3 must share a "
                        "quantization type")
    _check_wq("grouped_swiglu_up_wq", x, (w1, w3), group_sizes)
    return _swiglu_up_wq(x, w1, w3, group_sizes)


def grouped_swiglu_wq(x, w1, w3, w2, group_sizes):
    """The SwiGLU expert chain over quantized experts (``Int8Weight`` /
    ``Int4Weight``): x (S, K); w1/w3 (E, K, F); w2 (E, F, K') -> (S, K').
    Two launches on the card, each product on its own weights' type (an
    odd F puts w2 in int8 beside int4 w1/w3); no dequantized expert ever
    exists. Forward only, as the JAX ``grouped_swiglu_wq``."""
    E, K, Fd = w1.shape
    if len(w2.shape) != 3 or tuple(w2.shape[:2]) != (E, Fd):
        raise ValueError(f"grouped_swiglu_wq: want w2 ({E}, {Fd}, K'), got "
                         f"{w2!r}")
    h = grouped_swiglu_up_wq(x, w1, w3, group_sizes)
    return grouped_matmul_wq(h, w2, group_sizes)
