"""KV-block handoff for disaggregated prefill/decode serving.

Own copy of ``deepspeed_tpu/inference/v2/kv_transfer.py``: the same DSKV
wire format, transports and fault points, so a payload packed by either
package unpacks in the other.

A prefill-role replica runs chunked prefill to the last prompt token,
posts the first generated token, and then hands the sequence off instead
of decoding: this module serializes the sequence's paged KV blocks plus
its descriptor state (token history, ``cached_len``, sampling params, the
original submit timestamp) into the checkpoint format's byte image,
streams the payload prefill -> decode, and imports it into the decode
replica's ``BlockedAllocator`` and block table
(``engine_v2.InferenceEngineV2.import_handoff``: the received blocks are
written into each layer's pool in place).

Wire format::

    [4s magic "DSKV"][u16 version][u64 body_len][u32 crc32(body)][body]

where ``body`` is a ``serialization.save_file`` image (npz + JSON header)
of the per-layer KV tree ``{"k": [...], "v": [...]}`` sliced to the blocks
the sequence wrote, with the descriptor state in
``extra_meta={"handoff": state}``. The inner image carries its own
per-entry CRC manifest, so corruption is detected at both framing and
tensor granularity and surfaces as the typed :class:`KVWireError`: a
corrupt handoff is refused, never imported.

bfloat16: npz keeps numpy dtypes only, and numpy has no bfloat16. The
engine hands bf16 pools over as raw 2-byte words (``np.dtype("V2")``);
the header's ``kv_dtypes`` names those leaves ``"bfloat16"``, as the JAX
package names its ``bfloat16`` leaves, and :func:`unpack_handoff` returns
them as ``V2`` words, which the import views back as ``torch.bfloat16``.

Transports:

* :class:`InProcQueueTransport` — an in-process byte queue. Single-host
  fleets run on it; sender and receiver share one clock, so the submit
  stamp carried for TTFT anchoring is exact.
* :class:`DcnRingTransport` — the payload rides
  ``comm.ring_exchange_bytes`` between processes. Clocks of two processes
  are not comparable: latency windows anchored on a remote stamp are
  advisory there (counters stay exact); see
  ``ServingTelemetry.on_handoff_in``.

Failure semantics: the ``kv_stream`` fault point fires once per payload
send and ``kv_import`` once per import, both before any state moves — the
prefill replica keeps ownership until the decode side confirms the
import, so a failed stream or import retries next router round from
unchanged state. A decode-replica death mid-transfer (``replica_death``
at ``Replica.import_handoff``) is handled by the router: the request goes
back to the front of its queue for a re-prefill replay, byte-identical
for greedy requests since the handoff moves KV bytes and never changes
the program.
"""

import collections
import io
import struct
import zlib

import numpy as np

from ...comm import comm as dist
from ...runtime.checkpoint_engine import serialization as ser
from ...utils import fault_injection

MAGIC = b"DSKV"
WIRE_VERSION = 1

# magic, version, body length, crc32(body)
_HEADER = struct.Struct("<4sHQI")


class KVWireError(ValueError):
    """The payload is not a well-formed handoff image (truncated frame,
    bad magic/version, CRC mismatch, or a KV tree whose layout does not
    match the importing engine's cache). A corrupt handoff is refused
    before any decode-side state changes."""


class KVTransferError(RuntimeError):
    """Transport misuse (receive on an empty queue, DCN transport in a
    single-process world) — a wiring bug, not a data fault."""


# ---------------------------------------------------------------- wire

def _wire_dtype_name(dtype):
    """The header's name of an extension-dtype leaf: the port's only one
    is bf16, as raw 2-byte words."""
    if dtype.itemsize == 2:
        return "bfloat16"
    return dtype.name


def pack_handoff(state, kv_tree):
    """Serialize ``(descriptor state, per-layer KV tree)`` into one
    framed byte payload. ``state`` must be JSON-serializable (ints,
    floats, lists, None); ``kv_tree`` leaves are host ndarrays sliced
    to the blocks the sequence wrote."""
    # npz round-trips only numpy-native dtypes: bfloat16 leaves (2-byte
    # words, kind 'V') come back as raw void bytes, so their name rides
    # the header and unpack_handoff restores it
    flat, _ = ser.flatten_state(kv_tree)
    kv_dtypes = {k: _wire_dtype_name(np.asarray(v).dtype)
                 for k, v in flat.items()
                 if np.asarray(v).dtype.kind == "V"}
    body_io = io.BytesIO()
    ser.save_file(body_io, kv_tree,
                  extra_meta={"handoff": state, "kv_dtypes": kv_dtypes})
    body = body_io.getvalue()
    return _HEADER.pack(MAGIC, WIRE_VERSION, len(body),
                        zlib.crc32(body) & 0xFFFFFFFF) + body


def unpack_handoff(payload):
    """Inverse of :func:`pack_handoff`: verify framing + CRC and return
    ``(state, flat)`` where ``flat`` maps tree paths (``"k/0"``, ...)
    to host arrays (bfloat16 leaves as 2-byte ``V2`` words). Raises
    :class:`KVWireError` on any corruption."""
    if len(payload) < _HEADER.size:
        raise KVWireError(
            f"handoff payload truncated: {len(payload)} bytes < "
            f"{_HEADER.size}-byte header")
    magic, version, body_len, crc = _HEADER.unpack_from(payload)
    if magic != MAGIC:
        raise KVWireError(f"bad handoff magic {magic!r}")
    if version != WIRE_VERSION:
        raise KVWireError(
            f"handoff wire version {version} != {WIRE_VERSION}")
    body = payload[_HEADER.size:]
    if len(body) != body_len:
        raise KVWireError(
            f"handoff body length {len(body)} != framed {body_len}")
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise KVWireError("handoff body CRC mismatch")
    try:
        flat, header = ser.load_file(io.BytesIO(body))
    except ser.CheckpointCorruptionError as e:
        raise KVWireError(f"handoff tensor image corrupt: {e}") from e
    state = header.get("extra", {}).get("handoff")
    if state is None:
        raise KVWireError("handoff payload carries no descriptor state")
    for k, name in header.get("extra", {}).get("kv_dtypes", {}).items():
        try:
            flat[k] = flat[k].view(
                np.dtype("V2") if name == "bfloat16" else np.dtype(name))
        except (KeyError, TypeError, ValueError) as e:
            raise KVWireError(
                f"handoff dtype map names {k!r}/{name!r} the tensor "
                f"image cannot satisfy: {e}") from e
    return state, flat


# ----------------------------------------------------------- transports

class InProcQueueTransport:
    """In-process byte queue (single-host fleets and the tests). FIFO; ``send`` fires the retryable
    ``kv_stream`` fault point before the payload is enqueued, so an
    injected stream failure moves nothing."""

    def __init__(self):
        self._q = collections.deque()
        self.sent_bytes = 0

    def send(self, payload):
        fault_injection.fire("kv_stream")
        self._q.append(bytes(payload))
        self.sent_bytes += len(payload)

    def recv(self):
        if not self._q:
            raise KVTransferError("recv on empty handoff queue")
        return self._q.popleft()


class DcnRingTransport:
    """Transport between processes over ``comm.ring_exchange_bytes``.
    ``send`` is COLLECTIVE — every process must call it in the same
    order; the payload received from the ring
    peer is stashed for the matching ``recv``. Payloads are bounded by
    ``comm.MAX_PAYLOAD_BYTES`` (typed ``CommPayloadError`` beyond it);
    zero-length payloads are legal. Cross-process clock domains make
    remote submit stamps advisory for latency windows — see the module
    docstring."""

    def __init__(self, shift=1):
        self.shift = int(shift)
        self._q = collections.deque()
        self.sent_bytes = 0

    def send(self, payload):
        fault_injection.fire("kv_stream")
        received, _origin = dist.ring_exchange_bytes(
            bytes(payload), shift=self.shift)
        if received is None:
            raise KVTransferError(
                "DcnRingTransport needs a multi-process world "
                "(torch.distributed world size > 1); single-host fleets "
                "use InProcQueueTransport")
        self._q.append(received)
        self.sent_bytes += len(payload)

    def recv(self):
        if not self._q:
            raise KVTransferError("recv on empty handoff queue")
        return self._q.popleft()


# ------------------------------------------------------- engine bridge

def export_sequence(engine, uid):
    """Serialize ``uid``'s KV blocks + descriptor state out of
    ``engine`` (the prefill side). The sequence is NOT removed — the
    caller releases it only after the decode side confirms the
    import, so a failed stream retries from unchanged state."""
    state, kv_host = engine.export_handoff(uid)
    return pack_handoff(state, kv_host)


def import_sequence(engine, payload):
    """Import a handoff payload into ``engine`` (the decode side) and
    return the sequence uid. Fires the retryable ``kv_import`` fault
    point BEFORE unpacking — an injected import failure leaves both
    replicas unchanged."""
    fault_injection.fire("kv_import")
    state, flat = unpack_handoff(payload)
    return engine.import_handoff(state, flat)
