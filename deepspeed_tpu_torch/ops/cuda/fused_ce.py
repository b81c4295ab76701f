"""Fused unembed + online softmax statistics: Hopper CUDA kernel and its
plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_ce.py`` (K3); the kernels are
in ``csrc/fused_ce.cu`` (design and bound are noted there). Same signature as
the JAX function: ``unembed_logits_stats(h, w, targets)`` with h (N, D),
w (V, D), targets (N,) returns (logits (N, V) in h's dtype, logz (N,) fp32,
gold (N,) fp32), logz and gold from the pre-round fp32 scores; targets
outside [0, V) give gold = 0.

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version (``unembed_logits_stats_reference``); a CUDA tensor launches the
kernel or raises. bf16 runs the Hopper design (``fused_ce_sm90_kernel``, a
wgmma GEMM whose tile epilogue writes the logits and per-vocab-tile
partials, then ``fused_ce_merge_kernel`` folding them); fp32 runs the
scalar-FMA kernel the parity checks use. ``LAUNCHES["fused_ce"]`` counts
calls that launched, ``DESIGN_LAUNCHES["fused_ce"]`` which design each
took. ``unembed_logits_stats_tiled_reference`` is the bf16 design's
two-pass algorithm in plain PyTorch (the tests check its partials and
merge on the CPU). The TPU tile knobs ``block_m``/``block_n`` are accepted
and change nothing.
"""

import ctypes

import torch

LAUNCHES = {"fused_ce": 0}
DESIGN_LAUNCHES = {"fused_ce": {"sm90": 0, "fp32": 0}}
# the bf16 design's vocab tile (sm90_gemm.cuh BN): partials are
# (N, ceil(V / SM90_BLOCK_V), 3); the launcher rejects any other count
SM90_BLOCK_V = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_design in DESIGN_LAUNCHES.values():
        for k in by_design:
            by_design[k] = 0


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
                                        ctypes.c_void_p, ctypes.c_int,
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


def ce_tile_partials(s, targets, block_v):
    """The bf16 design's tile epilogue on fp32 scores ``s`` (N, V): columns
    cut into tiles of ``block_v`` (the last ragged, its columns >= V at
    -1e30), each row's (max, sum of exp(s - max), gold) per tile ->
    (N, ceil(V / block_v), 3) fp32."""
    N, V = s.shape
    n_vt = -(-V // block_v)
    sp = torch.full((N, n_vt * block_v), -1e30, dtype=torch.float32,
                    device=s.device)
    sp[:, :V] = s
    sp = sp.view(N, n_vt, block_v)
    m = sp.amax(dim=-1)
    l = torch.exp(sp - m[..., None]).sum(dim=-1)
    t = targets.long()
    ok = (t >= 0) & (t < V)
    tile = torch.where(ok, t // block_v, -1)
    g = torch.where(ok, torch.gather(s, 1, t.clamp(0, V - 1)[:, None])[:, 0],
                    0.0)
    gold = torch.where(
        torch.arange(n_vt, device=s.device)[None, :] == tile[:, None],
        g[:, None], 0.0)
    return torch.stack((m, l, gold), dim=-1)


def ce_merge_partials(partials):
    """``fused_ce_merge_kernel`` in plain PyTorch: each row's partials folded
    in vocab-tile order -> (logz = M + log L, gold)."""
    N = partials.shape[0]
    M = torch.full((N,), -1e30, dtype=torch.float32, device=partials.device)
    L = torch.zeros(N, dtype=torch.float32, device=partials.device)
    G = torch.zeros(N, dtype=torch.float32, device=partials.device)
    for t in range(partials.shape[1]):
        mt, lt, gt = partials[:, t].unbind(-1)
        m2 = torch.maximum(M, mt)
        L = L * torch.exp(M - m2) + lt * torch.exp(mt - m2)
        M = m2
        G = G + gt
    return M + torch.log(L), G


def unembed_logits_stats_tiled_reference(h, w, targets, block_v):
    """The bf16 design's two passes in plain PyTorch: fp32 scores, logits
    rounded to h's dtype, per-tile partials (``ce_tile_partials``) merged
    in tile order (``ce_merge_partials``). The same outputs as
    ``unembed_logits_stats_reference`` up to the order of the softmax sums
    (tests only)."""
    s = torch.matmul(h.float(), w.float().t())
    logz, gold = ce_merge_partials(ce_tile_partials(s, targets, block_v))
    return s.to(h.dtype), logz, gold


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
    design = "sm90" if h.dtype == torch.bfloat16 else "fp32"
    partials, n_vt = None, 0
    if design == "sm90":
        # TMA addresses 16-byte aligned bases only
        h = h if h.data_ptr() % 16 == 0 else h.clone()
        w = w if w.data_ptr() % 16 == 0 else w.clone()
        n_vt = -(-V // SM90_BLOCK_V)
        partials = torch.empty(N, n_vt, 3, dtype=torch.float32,
                               device=h.device)
    t32 = targets.to(torch.int32).contiguous()
    logits = torch.empty(N, V, dtype=h.dtype, device=h.device)
    logz = torch.empty(N, dtype=torch.float32, device=h.device)
    gold = torch.empty(N, dtype=torch.float32, device=h.device)
    a = _CEArgs(h.data_ptr(), w.data_ptr(), t32.data_ptr(), logits.data_ptr(),
                logz.data_ptr(), gold.data_ptr(), N, V, D)
    rc = kernel_builder().load().fused_ce_launch(
        ctypes.byref(a), _DTYPE_CODE[h.dtype],
        None if partials is None else partials.data_ptr(), n_vt,
        torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES["fused_ce"] += 1
    DESIGN_LAUNCHES["fused_ce"][design] += 1
    return logits, logz, gold
