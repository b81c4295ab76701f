"""Quantized collectives — ZeRO++ communication compression.

Counterpart of ``deepspeed_tpu/comm/quantized.py``: gradients and weights
cross the wire as int8 blocks + fp32 scales (4x less than fp32), reduced in
fp32 after dequantization. This module adds the comms-logger accounting
(the int8 wire bytes, ``_record_wire``) and the hierarchical two-stage
composition on top of the transport in ``ops/cuda/quantization.py``
(``quantized_all_gather`` / ``quantized_psum_scatter``), whose K12 kernels
run on CUDA tensors and whose plain versions run on CPU tensors, as every
wrapper of the port (the JAX ``_resolve_pallas`` choice has no
counterpart: the device decides). Each function runs over the process
group of its axis.
"""

import torch

from ..ops.cuda import quantization as q8
from ..utils import groups
from .logging import get_comms_logger


def _record_wire(op_name, n_elems, block, axis_name):
    """Log the bytes on the wire: int8 payload + one fp32 scale per
    block."""
    lg = get_comms_logger()
    if lg.enabled:
        nblocks = -(-n_elems // block)
        lg.append(op_name, n_elems + 4 * nblocks, axis_name)


def quantized_reduce_scatter(x, axis_name, average=False,
                             block=q8.QUANT_BLOCK):
    """Reduce-scatter with int8-compressed exchange. x: (N, ...) with N
    divisible by the axis size W; returns this rank's reduced (N // W, ...)
    fp32 piece (the piece order of ``reduce_scatter``)."""
    _record_wire("quantized_reduce_scatter", x.numel(), block, axis_name)
    out = q8.quantized_psum_scatter(x.float(), axis_name, block=block)
    if average:
        return out / groups.get_topology().axis_size(axis_name)
    return out


def quantized_all_gather(x, axis_name, block=q8.QUANT_BLOCK):
    """All-gather with int8-compressed exchange (reference quantized weight
    allgather). Returns the gathered tensors stacked on a leading axis."""
    _record_wire("quantized_all_gather", x.numel(), block, axis_name)
    return q8.quantized_all_gather(x, axis_name, block=block)


def dcn_precision_clamp(x, block=q8.QUANT_BLOCK):
    """int8 block quantize->dequantize round trip: the values an int8 wire
    would carry across the outer (data_outer) hop."""
    if x.dtype == torch.int8 or x.numel() == 0:
        return x
    _record_wire("dcn_precision_clamp", x.numel(), block, "data_outer")
    q, s, meta = q8.quantize_blockwise(x.float(), block=block)
    return q8.dequantize_blockwise(q, s, meta).to(x.dtype)


def all_to_all_quant_reduce(x, inner_axis="data", outer_axis="data_outer",
                            average=False, block=q8.QUANT_BLOCK):
    """Hierarchical quantized reduce-scatter (reference
    coalesced_collectives.py:32): stage 1 over the inner axis, stage 2 over
    the outer axis, each hop int8-compressed.

    x: (N,) flat, N divisible by inner*outer. Returns this rank's
    (N // (inner*outer),) fp32 chunk, ordered so the rank at (o, i) holds
    global chunk ``o * Wi + i`` — the layout of one reduce_scatter over the
    combined (outer, inner) axes."""
    topo = groups.get_topology()
    Wi, Wo = topo.axis_size(inner_axis), topo.axis_size(outer_axis)
    N = x.shape[0]
    if N % (Wi * Wo):
        raise ValueError(f"size {N} not divisible by {inner_axis}*"
                         f"{outer_axis}={Wi * Wo}")
    # stage 1 keeps contiguous chunk i, stage 2 sub-chunk o of it: group
    # the Wo chunks {o*Wi+i : o} under stage-1 chunk i first
    M2 = N // (Wi * Wo)
    x = x.reshape(Wo, Wi, M2).transpose(0, 1).reshape(N)
    stage1 = quantized_reduce_scatter(x, inner_axis, block=block)
    out = quantized_reduce_scatter(stage1, outer_axis, block=block)
    return out / (Wi * Wo) if average else out
