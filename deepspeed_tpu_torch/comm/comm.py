"""Collective communication over ``torch.distributed`` process groups.

Counterpart of ``deepspeed_tpu/comm/comm.py``. The JAX collectives are
``jax.lax`` ops over named mesh axes inside ``shard_map``; here each is an
eager call over the process group of that axis (``utils/groups.py``), with
the JAX package's tiled semantics and return values: every function takes
a tensor and returns a new one, leaving its input as it was. Without an
initialized world an axis has one rank and each function computes that
rank's result locally.

Every call records its payload's bytes with the comms logger (when
enabled), as the JAX wrappers register theirs at trace time.

Backend and device. ``init_distributed`` picks the backend from the device
this process runs on: ``nccl`` for a card, ``gloo`` for ``device="cpu"``.
Gloo runs collectives on CUDA tensors only when the caller names it
(``dist_backend="gloo"``), for example two processes that share one card,
which NCCL refuses. Gloo takes ``GLOO_CUDA_OPS`` on CUDA tensors; for every
other op the payload goes through host memory, in one place
(``_to_wire``), and the comms logger's ``host_staged`` records each such
copy. No backend or device is chosen silently.
"""

import datetime
import os
from functools import wraps

import torch
import torch.distributed as dist

from ..utils import groups
from ..utils.device import resolve_device
from ..utils.logging import log_dist, logger
from .logging import get_comms_logger

# the ops gloo runs on CUDA tensors itself; the rest go through host memory
GLOO_CUDA_OPS = ("all_reduce", "broadcast")

_REDUCE_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN"}


def _nbytes(x):
    return x.numel() * x.element_size() if torch.is_tensor(x) else 0


def _record(op_name, tensor, axis_name):
    lg = get_comms_logger()
    if lg.enabled:
        lg.append(op_name, _nbytes(tensor), axis_name)


def _traced_op(fn):
    @wraps(fn)
    def wrapper(tensor, axis_name, *args, **kwargs):
        _record(fn.__name__, tensor, axis_name)
        return fn(tensor, axis_name, *args, **kwargs)
    return wrapper


def _group(axis_name):
    """(process group or None, size, topology) of ``axis_name``."""
    topo = groups.get_topology()
    return topo.group(axis_name), topo.axis_size(axis_name), topo


def _to_wire(op_name, x, group):
    """The tensor the backend moves for ``op_name``: ``x`` itself, or, when
    gloo does not take ``op_name`` on CUDA tensors, its copy in host memory
    (recorded in the comms logger's ``host_staged``)."""
    if (x.is_cuda and op_name not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo"):
        get_comms_logger().append_host_staged(op_name, _nbytes(x))
        return x.cpu()
    return x


def _buffer(op_name, x, group):
    """A contiguous copy of ``x`` for an op that works in place."""
    wire = _to_wire(op_name, x, group)
    return (wire.clone(memory_format=torch.contiguous_format)
            if wire is x else wire.contiguous())


# --- collectives over an axis ----------------------------------------------

@_traced_op
def all_reduce(tensor, axis_name, op="sum"):
    if op not in _REDUCE_OPS:
        raise ValueError(f"unsupported reduce op {op}")
    g, size, _ = _group(axis_name)
    if g is None:
        return tensor.clone()
    buf = _buffer("all_reduce", tensor, g)
    dist.all_reduce(buf, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                    group=g)
    out = buf.to(tensor.device)
    return out / size if op == "avg" else out


@_traced_op
def reduce_scatter(tensor, axis_name, scatter_dimension=0):
    """reduce_scatter_tensor (reference comm/comm.py:246): sum, then this
    rank's contiguous piece of ``scatter_dimension``."""
    g, size, _ = _group(axis_name)
    x = tensor.movedim(scatter_dimension, 0)
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: dim {scatter_dimension} of size "
                         f"{x.shape[0]} does not split over {size} ranks")
    if g is None:
        return tensor.clone()
    wire = _to_wire("reduce_scatter", x.contiguous(), g)
    out = wire.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, wire, group=g)
    return out.to(tensor.device).movedim(0, scatter_dimension).contiguous()


@_traced_op
def all_gather(tensor, axis_name, gather_dimension=0):
    """all_gather_into_tensor (reference comm/comm.py:315), tiled: the
    ranks' tensors concatenated along ``gather_dimension``."""
    g, size, _ = _group(axis_name)
    if g is None:
        return tensor.clone()
    x = tensor.movedim(gather_dimension, 0).contiguous()
    wire = _to_wire("all_gather", x, g)
    out = wire.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=g)
    return out.to(tensor.device).movedim(0, gather_dimension).contiguous()


@_traced_op
def all_to_all(tensor, axis_name, split_dimension, concat_dimension):
    """all_to_all_single, tiled (``lax.all_to_all(..., tiled=True)``): piece
    j of ``split_dimension`` goes to rank j; the pieces received are
    concatenated along ``concat_dimension`` in rank order."""
    g, size, _ = _group(axis_name)
    if tensor.shape[split_dimension] % size:
        raise ValueError(f"all_to_all: dim {split_dimension} of size "
                         f"{tensor.shape[split_dimension]} does not split "
                         f"over {size} ranks")
    if g is None:
        return tensor.clone()
    x = torch.stack(tensor.chunk(size, split_dimension)).contiguous()
    wire = _to_wire("all_to_all", x, g)
    out = torch.empty(wire.shape, dtype=wire.dtype, device=wire.device)
    dist.all_to_all_single(out, wire, group=g)
    return torch.cat(out.to(tensor.device).unbind(0), dim=concat_dimension)


@_traced_op
def broadcast(tensor, axis_name, src=0):
    """Every member of the axis gets the value of the member at axis index
    ``src``."""
    g, _, topo = _group(axis_name)
    if g is None:
        return tensor.clone()
    buf = _buffer("broadcast", tensor, g)
    dist.broadcast(buf, src=topo.group_ranks(axis_name)[src], group=g)
    return buf.to(tensor.device)


class Pending:
    """A posted point-to-point exchange; ``wait()`` returns the tensor that
    arrived (zeros where no rank sends to this one, as ``lax.ppermute``)."""

    def __init__(self, works, recv, like):
        self.works, self.recv, self.like = works, recv, like

    def wait(self):
        for w in self.works:
            w.wait()
        if self.recv is None:
            return torch.zeros_like(self.like)
        return self.recv.to(self.like.device)


def ppermute_start(tensor, axis_name, perm):
    """Post ``ppermute`` (isend / irecv to and from this rank's partners in
    ``perm``, pairs of axis indices) and return a :class:`Pending`."""
    _record("ppermute", tensor, axis_name)
    g, _, topo = _group(axis_name)
    me = topo.axis_index(axis_name)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if dsts == [me] and srcs == [me]:
        return Pending([], tensor.clone(), tensor)
    if g is None:
        raise ValueError(f"ppermute {perm} needs a world of more than one "
                         f"rank")
    ranks = topo.group_ranks(axis_name)
    wire = _to_wire("ppermute", tensor.contiguous(), g)
    recv = (torch.empty(wire.shape, dtype=wire.dtype, device=wire.device)
            if srcs else None)
    ops = [dist.P2POp(dist.isend, wire, ranks[d], g) for d in dsts]
    ops += [dist.P2POp(dist.irecv, recv, ranks[s], g) for s in srcs]
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, recv, tensor)


def ppermute(tensor, axis_name, perm):
    """Point-to-point permutation over the axis (``lax.ppermute``): the
    pipe engine's send/recv and the ring's KV rotation."""
    return ppermute_start(tensor, axis_name, perm).wait()


def send_forward(tensor, axis_name):
    n = groups.get_topology().axis_size(axis_name)
    return ppermute(tensor, axis_name, [(i, (i + 1) % n) for i in range(n)])


def send_backward(tensor, axis_name):
    n = groups.get_topology().axis_size(axis_name)
    return ppermute(tensor, axis_name, [(i, (i - 1) % n) for i in range(n)])


def axis_index(axis_name):
    return groups.get_topology().axis_index(axis_name)


# --- host-level API ---------------------------------------------------------

_DEVICE = None


def init_distributed(dist_backend=None, timeout=None, init_method=None,
                     rank=-1, world_size=-1, auto_mpi_discovery=True,
                     verbose=True, device=None):
    """Counterpart of reference comm/comm.py:604: join the world over
    ``init_method`` (default ``env://``: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``). Without ``WORLD_SIZE`` (or
    ``world_size``) the process runs alone and no world is made.

    ``device``: this process's device (``resolve_device``: default
    ``cuda:$LOCAL_RANK``, which also becomes the current card).
    ``dist_backend``: default ``nccl`` on a card, ``gloo`` on the CPU;
    ``"gloo"`` on a card must be named (see the module docstring). A second
    call returns at once."""
    global _DEVICE
    if dist.is_initialized():
        return
    rank = rank if rank >= 0 else int(os.environ.get("RANK", "0"))
    world_size = (world_size if world_size > 0
                  else int(os.environ.get("WORLD_SIZE", "0")))
    if world_size < 1 and init_method is None:
        if verbose:
            logger.info("init_distributed: single process (no WORLD_SIZE); "
                        "no process group")
        return
    dev = resolve_device(device)
    backend = dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a card, got device {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(backend=backend, init_method=init_method or "env://",
                  rank=rank, world_size=max(world_size, 1))
    if timeout is not None:
        kwargs["timeout"] = (timeout if isinstance(timeout,
                                                   datetime.timedelta)
                             else datetime.timedelta(seconds=timeout))
    dist.init_process_group(**kwargs)
    _DEVICE = dev
    if verbose:
        log_dist(f"initialized torch.distributed: backend {backend}, "
                 f"world size {dist.get_world_size()}, device {dev}",
                 ranks=[0])


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def get_rank():
    return dist.get_rank() if is_initialized() else 0


def get_world_size():
    return dist.get_world_size() if is_initialized() else 1


def get_local_device_count():
    return torch.cuda.device_count()


def get_backend():
    return dist.get_backend() if is_initialized() else None


# Byte-transport payload ceiling (the JAX package's contract): one padded
# buffer per process, so an unbounded payload would size every process's
# buffer by the largest one; callers moving more must chunk.
MAX_PAYLOAD_BYTES = 1 << 30


class CommPayloadError(ValueError):
    """Payload exceeds the byte-transport contract (``MAX_PAYLOAD_BYTES``)."""


def _check_payload(payload, fn):
    n = len(payload)
    if n > MAX_PAYLOAD_BYTES:
        raise CommPayloadError(
            f"{fn}: payload of {n} bytes exceeds MAX_PAYLOAD_BYTES="
            f"{MAX_PAYLOAD_BYTES}; chunk at the caller")


def _padded_bytes(payload):
    """(uint8 buffer padded to the world's longest payload (at least one
    byte) on the backend's device, every process's length)."""
    dev = _DEVICE if get_backend() == "nccl" else torch.device("cpu")
    # the payload's bytes as one uint8 tensor (no Python int per byte)
    data = torch.frombuffer(bytearray(payload), dtype=torch.uint8) \
        if len(payload) else torch.empty(0, dtype=torch.uint8)
    n = torch.tensor([data.numel()], dtype=torch.int64, device=dev)
    lengths = torch.empty(get_world_size(), dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(lengths, n)
    lengths = lengths.tolist()
    buf = torch.zeros(max(1, max(lengths)), dtype=torch.uint8, device=dev)
    buf[:data.numel()] = data.to(dev)
    return buf, lengths


def ring_exchange_bytes(payload, shift=1):
    """Send ``payload`` to process ``(rank + shift) % world`` and receive
    the one from ``shift`` behind: ``(received bytes, origin rank)``, or
    ``(None, None)`` in a single-process world. Collective: every process
    calls it with the same ``shift``. Zero-length payloads are legal;
    payloads above ``MAX_PAYLOAD_BYTES`` raise before anything moves."""
    _check_payload(payload, "ring_exchange_bytes")
    n = get_world_size()
    if n <= 1:
        return None, None
    me = get_rank()
    origin = (me - shift) % n
    if origin == me:
        return bytes(payload), me
    buf, lengths = _padded_bytes(payload)
    recv = torch.empty_like(buf)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, buf, (me + shift) % n),
            dist.P2POp(dist.irecv, recv, origin)]):
        w.wait()
    return recv[:lengths[origin]].cpu().numpy().tobytes(), origin


def allgather_bytes(payload):
    """Every process's ``payload``, in rank order, or None in a
    single-process world; same contract as :func:`ring_exchange_bytes`."""
    _check_payload(payload, "allgather_bytes")
    n = get_world_size()
    if n <= 1:
        return None
    buf, lengths = _padded_bytes(payload)
    out = buf.new_empty(n * buf.numel())
    dist.all_gather_into_tensor(out, buf)
    rows = out.view(n, -1).cpu()
    return [rows[i, :lengths[i]].numpy().tobytes() for i in range(n)]


def barrier(name="dstpu_barrier"):
    """Host-level barrier across all processes (a no-op alone)."""
    if is_initialized():
        dist.barrier()


def configure(config=None):
    """Enable/disable comms logging from config (reference comm.py:221
    area)."""
    if config is not None and getattr(config, "comms_logger",
                                      None) is not None:
        get_comms_logger().configure(config.comms_logger)


def log_summary(show_straggler=False):
    get_comms_logger().log_summary(show_straggler=show_straggler)
