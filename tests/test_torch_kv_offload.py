"""The port's KV host offload (``inference/v2/kv_offload.py``, the offload
half of ``engine_v2.py``) on CPU, held against the JAX package:

  * the pool: the same prepare / ensure / mark_dirty / release sequence on
    the JAX ``OffloadKVPool`` and the port's leaves the same slot maps,
    dirty bits and counters, the same device slots and the same host
    blocks after write-back; a stale ``prepare`` handle raises;
  * fp32 greedy streams of tiny Llama engines whose device pool is far
    smaller than the batch's KV (grouped decode, eviction, write-back,
    re-upload): identical to the same engine resident and to the JAX
    offload engine, with the same swap counters, bucketed prefill and
    split-fuse chunks;
  * the refusals: a request too big for the device pool,
    ``device_kv_blocks < 2``, the KV handoff under offload."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.inference.v2.kv_offload import OffloadKVPool
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy

_MODELS = []


def _models():
    """(JAX Llama, its params, the port's Llama with the same weights)."""
    if not _MODELS:
        jm = JLlama(dataclasses.replace(J_TINY, dtype="float32"))
        params = jm.init(jax.random.key(0))
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                   device="cpu", dtype=torch.float32)
        pm.load_state_dict(llama_params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu", torch.float32))
        _MODELS.extend((jm, params, pm))
    return _MODELS


ENGINE = dict(dtype="float32", kv_block_size=16, max_batch_size=4,
              prompt_bucket=16, decode_steps_per_dispatch=2)


def _port(**kw):
    return InferenceEngineV2(_models()[2], dict(ENGINE, **kw), device="cpu")


def _jax(**kw):
    jm, params, _ = _models()
    return JEngine(jm, params=params,
                   config=dict(ENGINE, paged_kernel=False, prefix_cache=False,
                               telemetry=False, **kw))


def _prompts(n, seed=0, lo=6, hi=40):
    r = np.random.RandomState(seed)
    return [r.randint(0, 500, (r.randint(lo, hi),)).astype(np.int32)
            for _ in range(n)]


# ----------------------------------------------------------------- pool

def _pool_pair(NL=12, D=5):
    """The JAX pool of a JAX offload engine and a port pool over the same
    geometry, their host stores filled with the same random blocks."""
    jeng = _jax(num_kv_blocks=NL, kv_host_offload=True, device_kv_blocks=D)
    pm = _models()[2]
    pool = OffloadKVPool(pm, NL, D, 16, torch.float32, "cpu")
    cache = pm.init_paged_cache(D, 16)
    rs = np.random.RandomState(0)
    jp = jeng.kv_pool
    for li in range(pm.config.n_layer):
        for kv_i, kv in enumerate(("k", "v")):
            blocks = rs.standard_normal(
                (NL,) + jp.host[kv][li].shape[1:]).astype(np.float32)
            jp.host[kv][li][:] = blocks
            pool.host[:, li, kv_i] = torch.from_numpy(blocks)
    return jeng, pool, cache


def _same_pools(jeng, pool, cache):
    jp = jeng.kv_pool
    np.testing.assert_array_equal(pool.logical_of, jp.logical_of)
    np.testing.assert_array_equal(pool.slot_of, jp.slot_of)
    np.testing.assert_array_equal(pool.dirty, jp.dirty)
    assert (pool.swapped_in, pool.swapped_out) == \
        (jp.swapped_in, jp.swapped_out)
    for kv_i, kv in enumerate(("k", "v")):
        for li, c in enumerate(jeng.cache[kv]):
            live = [s for s in range(1, pool.D) if pool.logical_of[s] >= 0]
            np.testing.assert_array_equal(cache[kv][li][live].numpy(),
                                          np.asarray(c)[live])
            np.testing.assert_array_equal(pool.host[:, li, kv_i].numpy(),
                                          jp.host[kv][li])


def test_pool_operations_match_jax():
    """Uploads with a prefetched handle, skip-upload slots, LRU eviction
    of a dirty block (its device rows written to the host first), a
    re-upload of it, a release, the translation of a table."""
    jeng, pool, cache = _pool_pair()
    jp = jeng.kv_pool
    steps = [
        ("ensure", [1, 2, 3], (), True),
        ("write", [2]),
        ("ensure", [4, 5], [5], False),
        ("ensure", [6, 7], (), True),            # evicts 1, 2 (2 dirty)
        ("ensure", [2, 3], (), False),           # re-uploads 2
        ("release", [3]),
        ("ensure", [8, 9, 10, 11], (), True)]
    for step in steps:
        if step[0] == "ensure":
            _, ids, skip, prefetch = step
            jh = jp.prepare(ids, skip) if prefetch else None
            ph = pool.prepare(ids, skip) if prefetch else None
            jeng.cache = jp.ensure(jeng.cache, ids, jh, skip_upload=skip)
            pool.ensure(cache, ids, ph, skip_upload=skip)
        elif step[0] == "write":
            # a dispatch writes the blocks: the same rows on both sides
            for b in step[1]:
                s = int(pool.slot_of[b])
                assert s == int(jp.slot_of[b]) > 0
                jeng.cache = {kv: [c.at[s].set(c[s] + 1.0)
                                   for c in jeng.cache[kv]]
                              for kv in ("k", "v")}
                for pools in cache.values():
                    for c in pools:
                        c[s] += 1.0
            jp.mark_dirty(step[1])
            pool.mark_dirty(step[1])
        else:
            jp.release(step[1])
            pool.release(step[1])
        _same_pools(jeng, pool, cache)
    assert pool.swapped_out == 1 and pool.swapped_in >= 7
    table = np.array([[8, 9, 0, 3], [11, 10, 2, 0]], np.int32)
    np.testing.assert_array_equal(pool.translate(table), jp.translate(table))


def test_stale_prepare_handle_raises():
    """A handle built for another block list must make ensure fail
    loudly, never route the extra block to the scratch slot."""
    eng = _port(kv_host_offload=True, device_kv_blocks=8)
    pool = eng.kv_pool
    handle = pool.prepare([1])
    with pytest.raises(RuntimeError, match="stale prepare"):
        pool.ensure(eng.cache, [1, 2], prepared=handle)


def test_fresh_handle_commits():
    eng = _port(kv_host_offload=True, device_kv_blocks=8)
    pool = eng.kv_pool
    pool.host[2] = 3.0
    pool.ensure(eng.cache, [1, 2], pool.prepare([1, 2]))
    assert pool.slot_of[1] > 0 and pool.slot_of[2] > 0
    s = int(pool.slot_of[2])
    assert (eng.cache["v"][1][s] == 3.0).all()
    assert pool.pinned_bytes == 0          # nothing pinned on the CPU


# -------------------------------------------------------------- engines

def _streams(eng, prompts, max_new=12):
    return [np.asarray(t) for t in
            eng.generate_all(prompts, max_new_tokens=max_new)]


@pytest.mark.parametrize("case", ["grouped", "splitfuse", "footprint"])
def test_offload_streams_match_resident_and_jax(case):
    """grouped: 6 requests, 4 at a time, on a device pool of 8 blocks (7
    usable) against ~4 sequences x 3 blocks: grouped decode, eviction,
    write-back. splitfuse: a 90-token prompt in 32-token chunks beside
    short ones on 9 device blocks. footprint: 4 requests on 6 device
    blocks out of 64 logical. Offload == resident == JAX offload, with the
    same swap counters and slot maps."""
    kw, prompts = {
        "grouped": (dict(device_kv_blocks=8), _prompts(6)),
        "splitfuse": (dict(device_kv_blocks=9, splitfuse_tokens=32,
                           max_batch_size=3), None),
        "footprint": (dict(device_kv_blocks=6, num_kv_blocks=64),
                      _prompts(4, seed=5))}[case]
    if prompts is None:
        prompts = _prompts(4, seed=3)
        prompts[0] = np.arange(100, 190).astype(np.int32) % 500
    resident = dict(kw)
    resident.pop("device_kv_blocks")
    ref = _streams(_port(**resident), prompts)
    eng = _port(kv_host_offload=True, **kw)
    jeng = _jax(kv_host_offload=True, **kw)
    got = _streams(eng, prompts)
    want = _streams(jeng, prompts)
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, w)
    pool, jp = eng.kv_pool, jeng.kv_pool
    assert pool.swapped_in > 0, "pool never swapped"
    assert (pool.swapped_in, pool.swapped_out) == \
        (jp.swapped_in, jp.swapped_out)
    np.testing.assert_array_equal(pool.slot_of, jp.slot_of)
    if case == "grouped":
        assert pool.swapped_out > 0, "no dirty write-backs"
        assert max(eng.offload_group_counts) > 1, "decode never grouped"
    if case == "footprint":
        need = sum(-(-(len(p) + 12) // 16) for p in prompts)
        assert need > 6 - 1, "the test must oversubscribe the device pool"
    alloc = eng.state_mgr.allocator
    assert alloc.free_blocks == alloc.total_blocks
    assert (pool.logical_of[1:] < 0).all()     # every slot released


def test_cancel_under_offload_releases_residency():
    eng = _port(kv_host_offload=True, device_kv_blocks=8)
    uids = [eng.put(p, 12) for p in _prompts(3, seed=7)]
    eng.step()
    eng.step()
    assert (eng.kv_pool.logical_of[1:] >= 0).any()
    for u in uids:
        eng.cancel(u)
    assert (eng.kv_pool.logical_of[1:] < 0).all()
    alloc = eng.state_mgr.allocator
    assert alloc.free_blocks == alloc.total_blocks


class TestRefusals:
    def test_request_too_big_for_the_device_pool(self):
        eng = _port(kv_host_offload=True, device_kv_blocks=4)
        with pytest.raises(ValueError, match="device pool"):
            eng.put(np.arange(60).astype(np.int32), max_new_tokens=40)

    @pytest.mark.parametrize("blocks", [0, 1])
    def test_device_kv_blocks_below_two(self, blocks):
        with pytest.raises(ValueError, match="device_kv_blocks"):
            _port(kv_host_offload=True, device_kv_blocks=blocks)
        with pytest.raises(ValueError, match="device_kv_blocks"):
            OffloadKVPool(_models()[2], 8, blocks, 16, torch.float32, "cpu")

    def test_handoff_refused_under_offload(self):
        eng = _port(kv_host_offload=True, device_kv_blocks=8)
        uid = eng.put(np.arange(1, 9).astype(np.int32), 4)
        eng.hold_decode(uid)
        eng.step()
        with pytest.raises(RuntimeError, match="kv_host_offload"):
            eng.export_handoff(uid)
        with pytest.raises(RuntimeError, match="kv_host_offload"):
            eng.import_handoff({"uid": 99}, {})
