"""The port's KV handoff (``inference/v2/kv_transfer.py`` and the engine's
export / import half) held against the JAX package on CPU: the DSKV wire
format (round trips in fp32 and bf16, typed refusal of truncated, foreign
or corrupt payloads), the transports, payloads crossing the two packages
bitwise in both directions, and engine handoffs port -> port, port -> JAX
and JAX -> port whose decoded greedy streams equal the colocated
``generate_all``; refusals before any state moves; a two-process
``DcnRingTransport`` handoff over gloo.

Tiny fp32 Llamas (``LLAMA_TINY``) with the same weights in both packages;
the JAX engines take the dense-gather path (``paged_kernel=False``: the
Pallas kernels in interpret mode are held in
``test_torch_paged_attention.py``)."""

import dataclasses
import hashlib
import io
import struct
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import kv_transfer as jkv
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.inference.v2 import kv_transfer
from deepspeed_tpu_torch.inference.v2.engine_v2 import _host_leaf
from deepspeed_tpu_torch.inference.v2.kv_transfer import (DcnRingTransport,
                                                          InProcQueueTransport,
                                                          KVTransferError,
                                                          KVWireError,
                                                          pack_handoff,
                                                          unpack_handoff)
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy
from deepspeed_tpu_torch.runtime.checkpoint_engine import serialization as ser
from deepspeed_tpu_torch.utils import fault_injection
from test_torch_dist_worker import run_world

BASE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
            max_batch_size=2, splitfuse_tokens=16,
            decode_steps_per_dispatch=2)
NEW = 8


@pytest.fixture(autouse=True)
def _no_armed_faults():
    fault_injection.reset()
    yield
    fault_injection.reset()


_MODELS = {}


def _models(**over):
    """The same fp32 Llama in both packages (weights from a JAX seed):
    (JAX model, its params, the port's model, the params as numpy)."""
    key = tuple(sorted(over.items()))
    if key not in _MODELS:
        jm = JLlama(dataclasses.replace(J_TINY, dtype="float32", **over))
        params = jm.init(jax.random.key(0))
        tree = jax.tree.map(np.asarray, params)
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32", **over),
                   device="cpu", dtype=torch.float32)
        pm.load_state_dict(llama_params_from_numpy(tree, "cpu",
                                                   torch.float32))
        _MODELS[key] = (jm, params, pm, tree)
    return _MODELS[key]


def _port_engine(**kw):
    return InferenceEngineV2(_models()[2], dict(BASE, **kw), device="cpu")


def _jax_engine(**kw):
    jm, params, _, _ = _models()
    return JEngine(jm, params=params,
                   config=dict(BASE, paged_kernel=False, prefix_cache=False,
                               **kw))


def _prompts(seed=3, n=4, lo=6, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 255, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


_REF = []


def _refs():
    """Colocated greedy streams of ``_prompts()`` on one port engine."""
    if not _REF:
        _REF.extend(_port_engine().generate_all(_prompts(),
                                                max_new_tokens=NEW))
    return _REF


def _pool_closed(eng):
    alloc = eng.state_mgr.allocator
    assert alloc.free_blocks == alloc.total_blocks, (
        f"leaked blocks: free={alloc.free_blocks} "
        f"total={alloc.total_blocks}")


def _prefill_until_first_token(eng, prompt, max_new=NEW, uid=None):
    uid = eng.put(prompt, max_new_tokens=max_new, eos_token_id=-1, uid=uid)
    eng.hold_decode(uid)
    for _ in range(64):
        eng.step()
        seq = eng.state_mgr._seqs.get(uid)
        if seq is not None and seq.generated:
            return uid
    raise AssertionError("prefill never posted a first token")


def _decode_to_end(eng, uid):
    for _ in range(256):
        if eng.is_done(uid):
            return np.asarray(eng.get(uid))
        eng.step()
    raise AssertionError("decode never finished")


def _tree():
    return {"k": [np.arange(12, dtype=np.float32).reshape(3, 4)],
            "v": [np.full((3, 4), 0.5, np.float32)]}


_STATE = {"uid": 3, "prompt": [1, 2], "generated": [9],
          "cached_len": 0, "max_new_tokens": 8, "eos_token_id": -1,
          "temperature": 0.0, "top_k": 0, "klass": 1, "t_submit": 12.5}


def _bf16_words(shape, seed=0):
    """Random bf16 values as (torch bf16 tensor, uint16 words)."""
    rs = np.random.RandomState(seed)
    t = torch.from_numpy(rs.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    return t, t.view(torch.int16).numpy().view(np.uint16)


# ------------------------------------------------------------- wire format

class TestWireFormat:
    def test_roundtrip(self):
        tree = _tree()
        state, flat = unpack_handoff(pack_handoff(_STATE, tree))
        assert state == _STATE
        assert set(flat) == {"k/0", "v/0"}
        np.testing.assert_array_equal(flat["k/0"], tree["k"][0])
        np.testing.assert_array_equal(flat["v/0"], tree["v"][0])

    def test_bfloat16_roundtrip(self):
        """bf16 leaves go over as 2-byte words named "bfloat16" in the
        header and come back as the same words."""
        t, words = _bf16_words((2, 3, 4))
        tree = {"k": [_host_leaf(t)], "v": [_host_leaf(t * 0.5)]}
        payload = pack_handoff(_STATE, tree)
        _, header = ser.load_file(io.BytesIO(payload[jkv._HEADER.size:]))
        assert header["extra"]["kv_dtypes"] == {"k/0": "bfloat16",
                                                "v/0": "bfloat16"}
        state, flat = unpack_handoff(payload)
        assert state == _STATE
        assert flat["k/0"].dtype == np.dtype("V2")
        np.testing.assert_array_equal(flat["k/0"].view(np.uint16), words)
        np.testing.assert_array_equal(
            flat["v/0"].view(np.uint16),
            (t * 0.5).view(torch.int16).numpy().view(np.uint16))

    def test_truncated_rejected(self):
        payload = pack_handoff(_STATE, _tree())
        with pytest.raises(KVWireError, match="truncated"):
            unpack_handoff(payload[:8])
        with pytest.raises(KVWireError, match="truncated"):
            unpack_handoff(b"")
        with pytest.raises(KVWireError, match="body length"):
            unpack_handoff(payload[:-3])

    def test_bad_magic_and_version_rejected(self):
        payload = bytearray(pack_handoff(_STATE, _tree()))
        bad = bytearray(payload)
        bad[:4] = b"NOPE"
        with pytest.raises(KVWireError, match="magic"):
            unpack_handoff(bytes(bad))
        bad = bytearray(payload)
        bad[4] = 0xEE                      # version field
        with pytest.raises(KVWireError, match="version"):
            unpack_handoff(bytes(bad))

    def test_crc_flip_rejected(self):
        payload = bytearray(pack_handoff(_STATE, _tree()))
        payload[-1] ^= 0xFF
        with pytest.raises(KVWireError):
            unpack_handoff(bytes(payload))

    def test_missing_descriptor_state_rejected(self):
        body_io = io.BytesIO()
        ser.save_file(body_io, _tree())    # no extra_meta
        body = body_io.getvalue()
        payload = kv_transfer._HEADER.pack(
            kv_transfer.MAGIC, kv_transfer.WIRE_VERSION, len(body),
            zlib.crc32(body) & 0xFFFFFFFF) + body
        with pytest.raises(KVWireError, match="descriptor"):
            unpack_handoff(payload)

    def test_frame_is_the_jax_frame(self):
        assert (kv_transfer.MAGIC, kv_transfer.WIRE_VERSION) == \
            (jkv.MAGIC, jkv.WIRE_VERSION)
        assert kv_transfer._HEADER.format == jkv._HEADER.format == "<4sHQI"
        assert struct.calcsize(kv_transfer._HEADER.format) == 18


class TestTransports:
    def test_inproc_queue_fifo_and_counters(self):
        t = InProcQueueTransport()
        t.send(b"abc")
        t.send(b"defg")
        assert t.sent_bytes == 7
        assert t.recv() == b"abc"
        assert t.recv() == b"defg"
        with pytest.raises(KVTransferError, match="empty"):
            t.recv()

    def test_dcn_transport_needs_multi_process(self):
        with pytest.raises(KVTransferError, match="multi-process"):
            DcnRingTransport().send(b"abc")

    def test_kv_stream_fault_moves_nothing(self):
        t = InProcQueueTransport()
        fault_injection.arm("kv_stream", fails=1)
        with pytest.raises(fault_injection.FaultError):
            t.send(b"abc")
        assert t.sent_bytes == 0
        with pytest.raises(KVTransferError, match="empty"):
            t.recv()
        t.send(b"abc")                     # healed
        assert t.recv() == b"abc"


# ------------------------------------------------- payloads across packages

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_payload_unpacks_in_jax(dtype):
    rs = np.random.RandomState(1)
    if dtype == "float32":
        leaves = [rs.standard_normal((3, 2, 8, 4)).astype(np.float32)
                  for _ in range(4)]
        words = [a.view(np.uint32) for a in leaves]
    else:
        pairs = [_bf16_words((3, 2, 8, 4), seed=i) for i in range(4)]
        leaves = [_host_leaf(t) for t, _ in pairs]
        words = [w for _, w in pairs]
    tree = {"k": leaves[:2], "v": leaves[2:]}
    state, flat = jkv.unpack_handoff(pack_handoff(_STATE, tree))
    assert state == _STATE
    want = {"k/0": words[0], "k/1": words[1], "v/0": words[2],
            "v/1": words[3]}
    assert set(flat) == set(want)
    for k, w in want.items():
        if dtype == "bfloat16":
            assert flat[k].dtype == jnp.bfloat16
            got = flat[k].view(np.uint16)
        else:
            assert flat[k].dtype == np.float32
            got = flat[k].view(np.uint32)
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_payload_unpacks_in_port(dtype):
    rs = np.random.RandomState(2)
    vals = [rs.standard_normal((3, 2, 8, 4)).astype(np.float32)
            for _ in range(4)]
    if dtype == "bfloat16":
        leaves = [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in vals]
        words = [a.view(np.uint16) for a in leaves]
    else:
        leaves = vals
        words = [a.view(np.uint32) for a in leaves]
    state, flat = unpack_handoff(jkv.pack_handoff(
        _STATE, {"k": leaves[:2], "v": leaves[2:]}))
    assert state == _STATE
    for k, w in zip(("k/0", "k/1", "v/0", "v/1"), words):
        view = np.uint16 if dtype == "bfloat16" else np.uint32
        assert flat[k].dtype == (np.dtype("V2") if dtype == "bfloat16"
                                 else np.float32)
        np.testing.assert_array_equal(flat[k].view(view), w)


# ------------------------------------------------------- engine handoffs

def test_colocated_streams_match_jax():
    """The reference every handoff is held to: one port engine's greedy
    streams equal one JAX engine's on the same prompts and weights."""
    want = _jax_engine().generate_all(_prompts(), max_new_tokens=NEW)
    for a, b in zip(_refs(), want):
        np.testing.assert_array_equal(a, np.asarray(b))


class TestEngineHandoff:
    def test_port_to_port_byte_identity(self):
        P, D = _port_engine(), _port_engine()
        for i, (prompt, want) in enumerate(zip(_prompts(), _refs())):
            uid = _prefill_until_first_token(P, prompt, uid=7000 + i)
            payload = kv_transfer.export_sequence(P, uid)
            assert kv_transfer.import_sequence(D, payload) == uid
            P.release_handoff(uid)
            _pool_closed(P)
            np.testing.assert_array_equal(_decode_to_end(D, uid), want)
        _pool_closed(D)
        assert P.telemetry_snapshot()["handoffs_out"] == 4
        assert D.telemetry_snapshot()["handoffs_in"] == 4

    def test_port_to_jax_byte_identity(self):
        P, J = _port_engine(), _jax_engine()
        prompt, want = _prompts()[1], _refs()[1]
        uid = _prefill_until_first_token(P, prompt, uid=7101)
        payload = kv_transfer.export_sequence(P, uid)
        assert jkv.import_sequence(J, payload) == uid
        P.release_handoff(uid)
        _pool_closed(P)
        np.testing.assert_array_equal(_decode_to_end(J, uid), want)
        _pool_closed(J)

    def test_jax_to_port_byte_identity(self):
        J, D = _jax_engine(), _port_engine()
        prompt, want = _prompts()[2], _refs()[2]
        uid = _prefill_until_first_token(J, prompt, uid=7201)
        payload = jkv.export_sequence(J, uid)
        assert kv_transfer.import_sequence(D, payload) == uid
        J.release_handoff(uid)
        _pool_closed(J)
        np.testing.assert_array_equal(_decode_to_end(D, uid), want)
        _pool_closed(D)

    def test_export_state_matches_jax(self):
        """Both packages export the same descriptor state and blocks
        (within fp32 rounding) for the same prefilled sequence."""
        P, J = _port_engine(), _jax_engine()
        prompt = _prompts()[3]
        pu = _prefill_until_first_token(P, prompt, uid=7301)
        ju = _prefill_until_first_token(J, prompt, uid=7301)
        ps, pkv = P.export_handoff(pu)
        js, jkv_host = J.export_handoff(ju)
        for k in ("uid", "prompt", "generated", "cached_len",
                  "max_new_tokens", "eos_token_id", "temperature", "top_k",
                  "klass"):
            assert ps[k] == js[k], k
        for name in ("k", "v"):
            for a, b in zip(pkv[name], jkv_host[name]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                           atol=1e-4)
        assert P.cancel(pu) and J.cancel(ju)
        _pool_closed(P)
        _pool_closed(J)

    def test_bf16_handoff_byte_identity(self):
        """A bf16 engine hands off its pools as raw words: the decode side
        gets the blocks bitwise and its stream equals one engine's."""
        base = dict(BASE, dtype="bfloat16")
        pm = _models()[2]
        prompt = _prompts()[0]
        want = InferenceEngineV2(pm, base, device="cpu").generate_all(
            [prompt], max_new_tokens=NEW)[0]
        P = InferenceEngineV2(pm, base, device="cpu")
        D = InferenceEngineV2(pm, base, device="cpu")
        uid = _prefill_until_first_token(P, prompt, uid=7401)
        payload = kv_transfer.export_sequence(P, uid)
        state, flat = unpack_handoff(payload)
        assert flat["k/0"].dtype == np.dtype("V2")
        kv_transfer.import_sequence(D, payload)
        src = P.state_mgr.get_sequence(uid).blocks
        dst = D.state_mgr.get_sequence(uid).blocks
        n = len(flat["k/0"])
        for name in ("k", "v"):
            for a, b in zip(P.cache[name], D.cache[name]):
                assert torch.equal(a[src[:n]].view(torch.int16),
                                   b[dst[:n]].view(torch.int16))
        P.release_handoff(uid)
        np.testing.assert_array_equal(_decode_to_end(D, uid), want)
        _pool_closed(P)
        _pool_closed(D)
        # and into the JAX package, words bitwise
        _, jflat = jkv.unpack_handoff(payload)
        np.testing.assert_array_equal(jflat["v/1"].view(np.uint16),
                                      flat["v/1"].view(np.uint16))

    def test_export_before_first_token_rejected(self):
        P = _port_engine()
        rs = np.random.RandomState(9)
        prompt = rs.randint(1, 255, size=40).astype(np.int32)
        uid = P.put(prompt, max_new_tokens=4, uid=7002)
        P.hold_decode(uid)
        P.step()                # admits + first chunk: mid-prefill
        assert P.state_mgr._seqs[uid].generated == []
        with pytest.raises(RuntimeError, match="first token"):
            P.export_handoff(uid)
        assert P.cancel(uid) is True
        _pool_closed(P)

    def test_duplicate_import_rejected(self):
        P, D = _port_engine(), _port_engine()
        uid = _prefill_until_first_token(P, _prompts()[2], uid=7003)
        payload = kv_transfer.export_sequence(P, uid)
        kv_transfer.import_sequence(D, payload)
        free = D.state_mgr.allocator.free_blocks
        with pytest.raises(RuntimeError, match="already live"):
            kv_transfer.import_sequence(D, payload)
        assert D.state_mgr.allocator.free_blocks == free
        P.release_handoff(uid)
        assert D.cancel(uid) is True
        _pool_closed(P)
        _pool_closed(D)

    def test_gqa_mismatch_rejected(self):
        """A payload of a model with other KV heads is refused before any
        allocation or write."""
        P = _port_engine()
        other = InferenceEngineV2(_models(n_kv_heads=4)[2], dict(BASE),
                                  device="cpu")
        before = [t.clone() for t in other.cache["k"]]
        uid = _prefill_until_first_token(P, _prompts()[3], uid=7004)
        state, flat = unpack_handoff(kv_transfer.export_sequence(P, uid))
        with pytest.raises(KVWireError, match="layout"):
            other.import_handoff(state, flat)
        _pool_closed(other)
        assert not other.state_mgr._seqs
        for a, b in zip(before, other.cache["k"]):
            assert torch.equal(a, b)
        assert P.cancel(uid) is True
        _pool_closed(P)

    def test_block_size_mismatch_rejected(self):
        P = _port_engine()
        other = _port_engine(kv_block_size=16)
        uid = _prefill_until_first_token(P, _prompts()[3], uid=7005)
        state, flat = unpack_handoff(kv_transfer.export_sequence(P, uid))
        with pytest.raises(KVWireError, match="layout"):
            other.import_handoff(state, flat)
        _pool_closed(other)
        assert P.cancel(uid) is True
        _pool_closed(P)

    def test_kv_import_fault_moves_nothing(self):
        P, D = _port_engine(), _port_engine()
        uid = _prefill_until_first_token(P, _prompts()[0], uid=7006)
        payload = kv_transfer.export_sequence(P, uid)
        fault_injection.arm("kv_import", fails=1)
        with pytest.raises(fault_injection.FaultError):
            kv_transfer.import_sequence(D, payload)
        _pool_closed(D)
        assert not D.state_mgr._seqs
        kv_transfer.import_sequence(D, payload)       # healed: retry
        P.release_handoff(uid)
        np.testing.assert_array_equal(_decode_to_end(D, uid), _refs()[0])
        _pool_closed(D)

    def test_no_room_refused_before_allocation(self):
        P = _port_engine()
        D = _port_engine(max_batch_size=1)
        busy = D.put(_prompts(5, 1)[0], max_new_tokens=4)
        D.step()
        uid = _prefill_until_first_token(P, _prompts()[1], uid=7007)
        state, flat = unpack_handoff(kv_transfer.export_sequence(P, uid))
        free = D.state_mgr.allocator.free_blocks
        with pytest.raises(RuntimeError, match="cannot admit"):
            D.import_handoff(state, flat)
        assert D.state_mgr.allocator.free_blocks == free
        assert P.cancel(uid)
        _decode_to_end(D, busy)
        _pool_closed(P)
        _pool_closed(D)

    def test_cancel_parked_sequence_closes_pool(self):
        P = _port_engine()
        uid = _prefill_until_first_token(P, _prompts()[0], uid=7008)
        assert uid in P._decode_hold
        for _ in range(3):
            assert P.step() == []          # parked: no decode
        assert P.cancel(uid) is True
        assert uid not in P._decode_hold
        _pool_closed(P)
        assert P.telemetry_snapshot()["rejected"] == 1


# -------------------------------------------------- two processes (gloo)

RING_BYTES = 8 << 20


def test_dcn_handoff_between_two_processes(tmp_path):
    """World 2 over gloo: an 8 MiB payload through ring_exchange_bytes
    both ways, then rank 0's engine hands a sequence to rank 1's through
    DcnRingTransport; rank 1 receives rank 0's payload bitwise and decodes
    it to the colocated stream."""
    tree = _models()[3]
    prompt = _prompts()[3]
    outs = run_world("kv_handoff", 2, {"params": tree, "prompt": prompt,
                                       "base": BASE, "new": NEW,
                                       "ring_bytes": RING_BYTES}, tmp_path)
    for r, o in enumerate(outs):
        src = (r - 1) % 2
        want = np.random.RandomState(src).bytes(RING_BYTES)
        assert o["ring_len"] == RING_BYTES
        assert o["ring_sha"] == hashlib.sha256(want).hexdigest()
        assert o["ring_origin"] == src
    assert outs[0]["received_len"] == 0          # rank 1 sends nothing
    assert outs[1]["received_sha"] == outs[0]["sent_sha"]
    assert outs[0]["sent_len"] > 0
    assert outs[0]["pool_closed"] and outs[1]["pool_closed"]
    np.testing.assert_array_equal(outs[1]["tokens"], _refs()[3])
