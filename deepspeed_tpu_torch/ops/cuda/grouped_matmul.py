"""Grouped (ragged) matmul for the dropless-MoE expert FFN: Hopper CUDA
kernels and their plain versions.

Counterpart of ``deepspeed_tpu/ops/pallas/grouped_matmul.py`` (K8, the
forward kernels ``_gmm`` and ``_swiglu_up``); the kernels are
``csrc/grouped_matmul.cu`` (design and bound are noted there). Same
signatures as the JAX functions:

  grouped_matmul(x, w, group_sizes)         x (S, K) rows sorted by group,
      w (E, K, N), group_sizes (E,) int -> (S, N), the ``lax.ragged_dot``
      contract: rows past ``sum(group_sizes)`` are exactly 0;
  grouped_swiglu(x, w1, w3, w2, group_sizes) ``gmm(silu(x w1) * (x w3), w2)``
      with the gate/up products fused into one launch (``_swiglu_diff``,
      grouped_matmul.py:377-382).

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises (there is no
shape-based fallback: the JAX ``_blocks_fit`` -> ``ragged_dot`` fallback is
a TPU tiling limit the CUDA kernel does not share). ``group_sizes`` stays
on the device: the kernels read it there, so a call never syncs the host.
``LAUNCHES`` counts kernel launches. The backward (``_tgmm`` and the
transposed ``gmm``) is not ported yet: inputs that require grad raise.
"""

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = {"grouped_swiglu_up": 0, "grouped_gmm": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TODO_TRAIN = "MoE training (K8 `_tgmm`, ROADMAP Queue 1)"


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _GroupedArgs(ctypes.Structure):
    """Mirror of ``struct GroupedArgs`` in csrc/grouped_matmul.cu."""
    _fields_ = [("x", ctypes.c_void_p), ("w1", ctypes.c_void_p),
                ("w3", ctypes.c_void_p), ("group_sizes", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("sw_e", ctypes.c_longlong),
                ("sw_k", ctypes.c_longlong), ("sw_n", ctypes.c_longlong),
                ("M", ctypes.c_int), ("K", ctypes.c_int), ("N", ctypes.c_int),
                ("E", ctypes.c_int), ("vec_x", ctypes.c_int),
                ("vec_w", ctypes.c_int)]


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


def grouped_swiglu_reference(x, w1, w3, w2, group_sizes):
    """Plain version of ``grouped_swiglu``: the up chain, then the grouped
    down projection."""
    h = grouped_swiglu_up_reference(x, w1, w3, group_sizes)
    return grouped_matmul_reference(h, w2, group_sizes)


# ---------------------------------------------------------------- kernels


def _check_grouped(name, x, ws, group_sizes):
    E, K, N = ws[0].shape
    if x.dim() != 2 or x.shape[1] != K or any(w.shape != ws[0].shape
                                              for w in ws):
        raise ValueError(f"{name}: want x (S, K) and weights (E, K, N), got "
                         f"x {tuple(x.shape)}, weights "
                         f"{[tuple(w.shape) for w in ws]}")
    if group_sizes.shape != (E,) or group_sizes.dtype.is_floating_point:
        raise ValueError(f"{name}: want integer group_sizes ({E},), got "
                         f"{group_sizes.dtype} {tuple(group_sizes.shape)}")
    if any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"{name}: x and the weights must share a dtype, got "
                        f"{x.dtype} and {[w.dtype for w in ws]}")
    if x.requires_grad or any(w.requires_grad for w in ws):
        raise NotImplementedError(f"{name}: no backward yet ({_TODO_TRAIN})")


def _launch(fn_name, name, x, ws, group_sizes):
    """Launch one grouped kernel on CUDA tensors, counting it under
    ``name``; returns its (M, N) output."""
    if any(t.device != x.device for t in (*ws, group_sizes)):
        raise ValueError(f"{name}: every operand must be on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
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
    vec_w = (sn == 1 and sk % vec == 0 and se % vec == 0
             and all(w.data_ptr() % 16 == 0 for w in ws))
    a = _GroupedArgs(x.data_ptr(), ws[0].data_ptr(), ws[-1].data_ptr(),
                     gs.data_ptr(), out.data_ptr(), se, sk, sn, M, K, N, E,
                     int(K % vec == 0 and x.data_ptr() % 16 == 0),
                     int(vec_w))
    rc = getattr(kernel_builder().load(), fn_name)(
        ctypes.byref(a), _DTYPE_CODE[x.dtype], block_m_for(M),
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def grouped_matmul(x, w, group_sizes):
    """x (S, K) rows sorted by group, w (E, K, N) (any strides),
    group_sizes (E,) int -> (S, N) in x's dtype; rows past
    ``sum(group_sizes)`` are 0."""
    _check_grouped("grouped_matmul", x, (w,), group_sizes)
    if x.device.type == "cpu":
        return grouped_matmul_reference(x, w, group_sizes)
    return _launch("grouped_gmm_launch", "grouped_gmm", x, (w,), group_sizes)


def grouped_swiglu_up(x, w1, w3, group_sizes):
    """h = silu(x w1[g]) * (x w3[g]): x (S, K), w1/w3 (E, K, F) -> (S, F)
    in x's dtype, fp32 epilogue, rows past the groups 0."""
    _check_grouped("grouped_swiglu_up", x, (w1, w3), group_sizes)
    if x.device.type == "cpu":
        return grouped_swiglu_up_reference(x, w1, w3, group_sizes)
    return _launch("grouped_swiglu_up_launch", "grouped_swiglu_up", x,
                   (w1, w3), group_sizes)


def grouped_swiglu(x, w1, w3, w2, group_sizes):
    """The SwiGLU expert chain: x (S, K); w1/w3 (E, K, F); w2 (E, F, K')
    -> (S, K'). Two launches on the card: the fused up chain, then the
    grouped down projection."""
    E, K, Fd = w1.shape
    if w2.dim() != 3 or tuple(w2.shape[:2]) != (E, Fd):
        raise ValueError(f"grouped_swiglu: want w2 ({E}, {Fd}, K'), got "
                         f"{tuple(w2.shape)}")
    h = grouped_swiglu_up(x, w1, w3, group_sizes)
    return grouped_matmul(h, w2, group_sizes)
