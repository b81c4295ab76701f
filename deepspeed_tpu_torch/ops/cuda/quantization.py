"""Blockwise int8 quantization (K12): the Hopper CUDA kernels, their plain
versions, and the quantized collectives built on them.

Counterpart of ``deepspeed_tpu/ops/pallas/quantization.py:60-140``
(``QUANT_BLOCK``, ``quantize_blockwise``, ``dequantize_blockwise``) and
:286-325 (``quantized_all_gather``, ``quantized_psum_scatter``); the
kernels are ``csrc/quantization.cu`` (design and bound are noted there).
Symmetric absmax int8 per block of ``block`` elements with one fp32 scale
per block, bitwise equal to the Pallas kernel and to the jnp path as XLA
compiles them (every JAX caller runs them jitted): the scale is absmax
times the fp32 reciprocal of 127, the product XLA folds ``absmax / 127.0``
into (eager jnp divides, which differs by an ulp in some blocks), and the
codes divide by it in IEEE arithmetic:

  quantize_blockwise(x, block=QUANT_BLOCK) -> (q (nblocks, block) int8,
      scales (nblocks, 1) fp32, meta {"shape", "dtype", "pad"})
  dequantize_blockwise(q, s, meta) -> tensor of meta's shape and dtype

Dispatch is by the tensor's device only: a CPU tensor takes the plain
version (``quantize_rows_reference`` / ``dequantize_rows_reference``); a
CUDA tensor launches the kernel or raises. ``LAUNCHES`` counts kernel
launches. The JAX ``use_pallas`` / ``interpret`` arguments have no
counterpart: the device decides.

The collectives run over an axis's process group through the comm layer
(``comm/comm.py``, which moves the payload through host memory where the
backend needs it) and record nothing in the comms logger themselves: the
comm-layer wrappers (``comm/quantized.py``) log the int8 wire bytes.
"""

import ctypes
import math

import torch

QUANT_BLOCK = 2048   # elements per scale block (reference default group)
# fp32 1/127, as XLA folds the scale's division by 127 (module docstring)
_INV127 = float(torch.tensor(1.0) / 127)

LAUNCHES = {"quantize_blockwise": 0, "dequantize_blockwise": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_builder = None


def kernel_builder():
    """The K12 library's builder; the first call builds the library (nvcc,
    see op_builder) and binds its ctypes signatures."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import QuantizationBuilder
        b = QuantizationBuilder()
        lib = b.load()
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.quant_blockwise_launch.argtypes = [p, p, p, ll, ll, ll, i, i, p]
        lib.dequant_blockwise_launch.argtypes = [p, p, p, ll, ll, i, i, i,
                                                 p]
        lib.quant_blockwise_launch.restype = i
        lib.dequant_blockwise_launch.restype = i
        _builder = b
    return _builder


# ----------------------------------------------------------------- plain


def quantize_rows_reference(x2, block):
    """Plain version of the quantize kernel: ``x2`` (R, P), each row padded
    with zeros to nb = ceil(P / block) blocks -> (q (R * nb, block) int8,
    scales (R * nb, 1) fp32), the compiled jnp arithmetic
    (quantization.py:111-114) exactly."""
    R, P = x2.shape
    nb = -(-P // block)
    xf = x2.float()
    if nb * block != P:
        xf = torch.nn.functional.pad(xf, (0, nb * block - P))
    xf = xf.reshape(R * nb, block)
    absmax = xf.abs().amax(-1, keepdim=True)
    s = torch.where(absmax > 0, absmax * _INV127, 1.0)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def dequantize_rows_reference(q, s, R, P, dtype, sum_rows=False):
    """Plain version of the dequantize kernel: (R * nb, block) codes and
    their scales -> (R, P) ``(q * s).to(dtype)``, each row's padding
    dropped; with ``sum_rows`` -> (P,): acc = fma(q_r, s_r, acc) row by row
    from 0 (each step exact in float64 — q * s has at most 32 significant
    bits — then rounded to fp32; the double rounding can differ from one
    fma only where float64 cannot hold the sum and lands on an fp32
    midpoint)."""
    if not sum_rows:
        out = (q.float() * s).to(dtype).reshape(R, -1)
        return out[:, :P]
    prod = (q.double() * s.double()).reshape(R, -1)[:, :P]
    acc = torch.zeros(P, dtype=torch.float32, device=q.device)
    for r in range(R):
        acc = (prod[r] + acc.double()).float()
    return acc.to(dtype)


# ---------------------------------------------------------------- kernels


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def quantize_rows(x2, block=QUANT_BLOCK):
    """Quantize each row of ``x2`` (R, P) in blocks of ``block``: (q
    (R * nb, block) int8, scales (R * nb, 1) fp32). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if x2.device.type == "cpu":
        return quantize_rows_reference(x2, block)
    if x2.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_blockwise: kernel takes float32, bfloat16 "
                        f"or float16, got {x2.dtype}")
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    R, P = x2.shape
    nb = -(-P // block)
    lib = kernel_builder().load()
    q = torch.empty(R * nb, block, dtype=torch.int8, device=x2.device)
    s = torch.empty(R * nb, 1, dtype=torch.float32, device=x2.device)
    rc = lib.quant_blockwise_launch(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), R, P,
        x2.stride(0) if R > 1 else P, block, _DTYPE_CODE[x2.dtype],
        _stream(x2))
    _raise_on(rc, "quantize_blockwise")
    LAUNCHES["quantize_blockwise"] += 1
    return q, s


def dequantize_rows(q, s, R, P, dtype, sum_rows=False):
    """(R * nb, block) codes and scales -> (R, P) in ``dtype``; with
    ``sum_rows``, their fma-accumulated sum over the rows, (P,) (the
    reduce-scatter's dequantize-then-reduce). CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return dequantize_rows_reference(q, s, R, P, dtype, sum_rows)
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_blockwise: kernel writes float32, "
                        f"bfloat16 or float16, got {dtype}")
    lib = kernel_builder().load()
    q, s = q.contiguous(), s.float().contiguous()
    out = torch.empty((P,) if sum_rows else (R, P), dtype=dtype,
                      device=q.device)
    rc = lib.dequant_blockwise_launch(
        q.data_ptr(), s.data_ptr(), out.data_ptr(), R, P, q.shape[1],
        int(sum_rows), _DTYPE_CODE[dtype], _stream(q))
    _raise_on(rc, "dequantize_blockwise")
    LAUNCHES["dequantize_blockwise"] += 1
    return out


def quantize_blockwise(x, block=QUANT_BLOCK):
    """x: any-shape float tensor -> (q int8 (nblocks, block), scales
    (nblocks, 1) fp32, meta). Symmetric absmax scaling per block of the
    flattened tensor, the last block padded with zeros."""
    n = x.numel()
    q, s = quantize_rows(x.reshape(1, n), block)
    meta = {"shape": tuple(x.shape), "dtype": x.dtype,
            "pad": q.shape[0] * block - n}
    return q, s, meta


def dequantize_blockwise(q, s, meta):
    """Inverse of :func:`quantize_blockwise`."""
    n = math.prod(meta["shape"])
    return dequantize_rows(q, s, 1, n, meta["dtype"]).reshape(meta["shape"])


# ------------------------------------------------- quantized collectives


def quantized_all_gather(x, axis_name, block=QUANT_BLOCK):
    """all_gather moving int8 codes + scales instead of full precision (the
    ZeRO++ quantized-weight gather): each rank's ``x`` quantized, gathered
    and dequantized. Returns the ranks' tensors stacked on a leading axis
    (like ``lax.all_gather``) in x's dtype."""
    from ...comm import comm
    q, s, meta = quantize_blockwise(x, block)
    # the comm functions unwrapped: the caller logs the wire bytes
    qg = comm.all_gather.__wrapped__(q[None], axis_name)
    sg = comm.all_gather.__wrapped__(s[None], axis_name)
    W, n = qg.shape[0], math.prod(meta["shape"])
    out = dequantize_rows(qg.reshape(-1, block), sg.reshape(-1, 1), W, n,
                          meta["dtype"])
    return out.reshape((W,) + meta["shape"])


def quantized_psum_scatter(x, axis_name, block=QUANT_BLOCK):
    """reduce_scatter with int8 transport: each destination piece
    quantized on its own, all_to_all, dequantized and summed here in fp32
    in rank order — int8 cannot be summed over the wire without overflow —
    in one dequantize launch (``sum_rows``). Returns this rank's reduced
    piece, (x.shape[0] // world, *x.shape[1:]) in x's dtype."""
    from ...comm import comm
    from ...utils import groups
    world = groups.get_topology().axis_size(axis_name)
    if x.shape[0] % world:
        raise ValueError(f"leading dim {x.shape[0]} not divisible by axis "
                         f"size {world}")
    piece_shape = (x.shape[0] // world,) + tuple(x.shape[1:])
    P = math.prod(piece_shape)
    q, s = quantize_rows(x.reshape(world, P), block)
    nb = q.shape[0] // world
    a2a = comm.all_to_all.__wrapped__
    qx = a2a(q.view(world, nb, block), axis_name, 0, 0)
    sx = a2a(s.view(world, nb, 1), axis_name, 0, 0)
    out = dequantize_rows(qx.reshape(-1, block), sx.reshape(-1, 1), world,
                          P, torch.float32, sum_rows=True)
    return out.reshape(piece_shape).to(x.dtype)
