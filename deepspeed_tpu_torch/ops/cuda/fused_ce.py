"""Fused unembed + online softmax statistics: Hopper CUDA kernel and its
plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_ce.py`` (K3); the kernel is
``csrc/fused_ce.cu`` (design and bound are noted there). Same signature as
the JAX function: ``unembed_logits_stats(h, w, targets)`` with h (N, D),
w (V, D), targets (N,) returns (logits (N, V) in h's dtype, logz (N,) fp32,
gold (N,) fp32), logz and gold from the pre-round fp32 scores; targets
outside [0, V) give gold = 0.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version (``unembed_logits_stats_reference``); a CUDA tensor launches the
kernel or raises. ``LAUNCHES["fused_ce"]`` counts kernel launches. The TPU
tile knobs ``block_m``/``block_n`` are accepted and change nothing.
"""

import ctypes

import torch

LAUNCHES = {"fused_ce": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class _CEArgs(ctypes.Structure):
    """Mirror of ``struct CEArgs`` in csrc/fused_ce.cu."""
    _fields_ = [("h", ctypes.c_void_p), ("w", ctypes.c_void_p),
                ("targets", ctypes.c_void_p), ("logits", ctypes.c_void_p),
                ("logz", ctypes.c_void_p), ("gold", ctypes.c_void_p),
                ("N", ctypes.c_longlong), ("V", ctypes.c_longlong),
                ("D", ctypes.c_int)]


_builder = None


def kernel_builder():
    """The fused-CE library's builder; the first call builds the library
    (nvcc, see op_builder) and binds its ctypes signature."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import FusedCEBuilder
        b = FusedCEBuilder()
        lib = b.load()
        lib.fused_ce_launch.argtypes = [ctypes.POINTER(_CEArgs), ctypes.c_int,
                                        ctypes.c_void_p]
        lib.fused_ce_launch.restype = ctypes.c_int
        _builder = b
    return _builder


def unembed_logits_stats_reference(h, w, targets):
    """Plain version: fp32 scores h @ w^T, logits rounded to h's dtype,
    logz = logsumexp of the fp32 scores, gold = the score at the target
    (0 for targets outside [0, V))."""
    V = w.shape[0]
    s = torch.matmul(h.float(), w.float().t())
    t = targets.long()
    ok = (t >= 0) & (t < V)
    gold = torch.gather(s, 1, t.clamp(0, V - 1)[:, None])[:, 0]
    return (s.to(h.dtype), torch.logsumexp(s, dim=-1),
            torch.where(ok, gold, 0.0))


def unembed_logits_stats(h, w, targets, *, block_m="auto", block_n="auto",
                         interpret=None):
    """h (N, D), w (V, D), targets (N,) integer -> (logits (N, V) in h's
    dtype, logz (N,) fp32, gold (N,) fp32)."""
    name = "unembed_logits_stats"
    if h.dim() != 2 or w.dim() != 2 or w.shape[1] != h.shape[1] \
            or targets.shape != (h.shape[0],):
        raise ValueError(f"{name}: want h (N, D), w (V, D), targets (N,), "
                         f"got {tuple(h.shape)}, {tuple(w.shape)}, "
                         f"{tuple(targets.shape)}")
    if h.dtype != w.dtype:
        raise TypeError(f"{name}: h and w must share a dtype, got {h.dtype} "
                        f"and {w.dtype}")
    if targets.dtype.is_floating_point or targets.dtype == torch.bool:
        raise TypeError(f"{name}: targets must be integer, got "
                        f"{targets.dtype}")
    if h.device.type == "cpu":
        return unembed_logits_stats_reference(h, w, targets)
    if w.device != h.device or targets.device != h.device:
        raise ValueError(f"{name}: every operand must be on {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, got "
                        f"{h.dtype}")
    N, D = h.shape
    V = w.shape[0]
    if D % 8:
        raise ValueError(f"{name}: kernel takes D a multiple of 8, got {D}")
    h, w = h.contiguous(), w.contiguous()
    t32 = targets.to(torch.int32).contiguous()
    logits = torch.empty(N, V, dtype=h.dtype, device=h.device)
    logz = torch.empty(N, dtype=torch.float32, device=h.device)
    gold = torch.empty(N, dtype=torch.float32, device=h.device)
    a = _CEArgs(h.data_ptr(), w.data_ptr(), t32.data_ptr(), logits.data_ptr(),
                logz.data_ptr(), gold.data_ptr(), N, V, D)
    rc = kernel_builder().load().fused_ce_launch(
        ctypes.byref(a), _DTYPE_CODE[h.dtype],
        torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES["fused_ce"] += 1
    return logits, logz, gold
