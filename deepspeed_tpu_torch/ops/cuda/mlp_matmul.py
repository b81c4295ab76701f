"""Weight-only int8/int4 projection (K7): the Hopper CUDA kernel and its
plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/mlp_matmul.py`` ``wq_matmul``
(the ``_mm_wq`` kernel; the kernel is ``csrc/mlp_matmul.cu``, design and
bound in ``csrc/wq_gemm.cuh``):

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
the same math). ``LAUNCHES`` counts kernel launches.
"""

import ctypes

import torch

from .grouped_matmul import WQ_ARGTYPES, check_quantized, launch_wq

LAUNCHES = {"wq_matmul": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_builder = None


def kernel_builder():
    """The K7 library's builder; the first call builds the library (nvcc,
    see op_builder) and binds its ctypes signature."""
    global _builder
    if _builder is None:
        from ...op_builder.builder import MlpMatmulBuilder
        b = MlpMatmulBuilder()
        lib = b.load()
        lib.wq_matmul_launch.argtypes = WQ_ARGTYPES
        lib.wq_matmul_launch.restype = ctypes.c_int
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
    else:
        out = launch_wq(kernel_builder().load().wq_matmul_launch,
                        "wq_matmul", LAUNCHES, x2, w)
    return _shape_out(out, B, T, out_t, squeeze)
