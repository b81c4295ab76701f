"""The port's radix prefix cache (``inference/v2/prefix_cache.py``, the
prefix branches of ``ragged.py`` and ``engine_v2.py``) on CPU, held
against the JAX package:

  * the host parts: the same operation sequences on the JAX
    ``BlockedAllocator`` / ``PrefixCache`` and the port's give the same
    matches, claims, refcounts, evictions, errors and ``stats()`` (the
    cases of the JAX ``tests/unit/test_prefix_cache.py``);
  * fp32 greedy streams of tiny Llama engines, cache on, identical to the
    JAX engine's with the cache on (dense-gather path) and to the port's
    with the cache off, with the same tree statistics: shared prefix,
    divergent prompts, partial-tail copy-on-write, a resubmitted prompt,
    bucketed prefill, a full pool of cached leaves still admitting, a
    ``sliding_window`` Llama;
  * the refusals, the router's prefix affinity and a prefix-hit prompt
    handed off prefill -> decode, over the port's engines."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import PrefixCache as JPrefixCache
from deepspeed_tpu.inference.v2.blocked_allocator import \
    BlockedAllocator as JAllocator
from deepspeed_tpu.inference.v2.prefix_cache import \
    PREFIX_CACHE_DEFAULTS as J_DEFAULTS
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.inference.v2 import Replica, Router
from deepspeed_tpu_torch.inference.v2.blocked_allocator import \
    BlockedAllocator
from deepspeed_tpu_torch.inference.v2.prefix_cache import (
    PREFIX_CACHE_DEFAULTS, PrefixCache, resolve_prefix_cache)
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy

JAX_SIDE = (JAllocator, JPrefixCache)
PORT_SIDE = (BlockedAllocator, PrefixCache)
BS = 4


def _toks(*ints):
    return np.asarray(ints, np.int32)


def _m(m):
    return (list(m.blocks), m.cached_len, m.cow_src, m.cow_plen, m.hit)


def _err(fn):
    """(exception type, message) of a call that must raise."""
    with pytest.raises((ValueError, RuntimeError)) as e:
        fn()
    return type(e.value).__name__, str(e.value)


# ------------------------------------------------------- host scenarios
# Each takes (allocator class, cache class), asserts what the JAX test
# asserts, and returns what it observed; both packages must observe the
# same.

def _double_free(A, _C):
    a = A(8)
    blocks = a.allocate(2)
    a.free(blocks)
    return [_err(lambda: a.free(blocks))]


def _duplicate_in_one_free(A, _C):
    a = A(8)
    (b,) = a.allocate(1)
    return [_err(lambda: a.free([b, b]))]


def _free_while_referenced(A, _C):
    a = A(8)
    (b,) = a.allocate(1)
    a.ref(b)
    out = [_err(lambda: a.free([b]))]
    a.unref(b)
    a.free([b])
    return out + [a.refcount(b), a.free_blocks]


def _free_validates_whole_list(A, _C):
    a = A(8)
    good, = a.allocate(1)
    out = [_err(lambda: a.free([good, 999]))]
    assert a.refcount(good) == 1
    a.free([good])
    return out


def _unref_past_zero(A, _C):
    a = A(8)
    (b,) = a.allocate(1)
    assert a.unref(b) is True
    return [_err(lambda: a.unref(b))]


def _ref_of_unallocated(A, _C):
    return [_err(lambda: A(8).ref(3))]


def _scratch_reserved(A, _C):
    a = A(4)
    got = a.allocate(3)
    assert A.SCRATCH not in got
    return [got, _err(lambda: a.free([A.SCRATCH]))]


def _reclaims_from_evictor(A, _C):
    class Evictor:
        def __init__(self, alloc, held):
            self.alloc, self.held = alloc, held

        @property
        def evictable_blocks(self):
            return len(self.held)

        def evict(self, n):
            for _ in range(min(n, len(self.held))):
                self.alloc.unref(self.held.pop())

    a = A(6)
    held = a.allocate(5)
    a.set_evictor(Evictor(a, held))
    assert a.free_blocks == 0 and a.available_blocks == 5
    got = a.allocate(3)
    assert len(got) == 3 and a.available_blocks == 2
    return [got, _err(lambda: a.allocate(5))]


def _mk(A, C, num_blocks=32, mm=1, max_blocks=0, watermark=0):
    a = A(num_blocks)
    return a, C(a, BS, min_match_blocks=mm, max_blocks=max_blocks,
                evict_watermark_pct=watermark)


def _empty_tree(A, C):
    _, c = _mk(A, C)
    m = c.match(_toks(*range(10)))
    assert not m.hit and m.blocks == [] and m.cached_len == 0
    return [_m(m)]


def _full_block_match(A, C):
    a, c = _mk(A, C)
    toks = np.arange(3 * BS, dtype=np.int32)
    blocks = a.allocate(3)
    c.release(toks, blocks)
    assert c.tree_blocks == 3
    assert all(a.refcount(b) == 1 for b in blocks)
    m = c.match(np.concatenate([toks, _toks(77)]))
    assert m.blocks == blocks and m.cached_len == 3 * BS
    assert m.cow_src is None
    return [_m(m), c.stats()]


def _last_token_recomputed(A, C):
    a, c = _mk(A, C)
    toks = np.arange(3 * BS, dtype=np.int32)
    c.release(toks, a.allocate(3))
    m = c.match(toks)
    assert len(m.blocks) == 2 and m.cow_plen == BS - 1
    assert m.cached_len == 3 * BS - 1 == len(toks) - 1
    return [_m(m)]


def _partial_tail_cow(A, C):
    a, c = _mk(A, C)
    toks = np.arange(2 * BS, dtype=np.int32)
    blocks = a.allocate(2)
    c.release(toks, blocks)
    m = c.match(np.concatenate([toks[:BS + 2], _toks(90, 91, 92, 93)]))
    assert m.blocks == blocks[:1] and m.cow_src == blocks[1]
    assert m.cow_plen == 2 and m.cached_len == BS + 2
    return [_m(m)]


def _min_match_gates(A, C):
    a, c = _mk(A, C, mm=2)
    c.release(np.arange(BS, dtype=np.int32), a.allocate(1))
    m = c.match(np.concatenate([np.arange(BS, dtype=np.int32),
                                _toks(50, 51)]))
    assert not m.hit and m.blocks == [] and m.cow_src is None
    return [_m(m)]


def _claim_and_cow_release(A, C):
    a, c = _mk(A, C)
    toks = np.arange(2 * BS, dtype=np.int32)
    blocks = a.allocate(2)
    c.release(toks, blocks)
    m = c.match(toks)
    c.claim(m)
    assert a.refcount(blocks[0]) == 2 and a.refcount(blocks[1]) == 2
    c.cow_release(m.cow_src)
    assert a.refcount(blocks[1]) == 1 and c.cow_copies == 1
    assert c.hits == 1 and c.lookups == 1
    return [_m(m), [a.refcount(b) for b in blocks], c.stats()]


def _match_is_pure(A, C):
    a, c = _mk(A, C)
    toks = np.arange(2 * BS, dtype=np.int32)
    blocks = a.allocate(2)
    c.release(toks, blocks)
    before = [a.refcount(b) for b in blocks]
    c.match(toks)
    assert [a.refcount(b) for b in blocks] == before
    assert c.lookups == 0 and c.hits == 0
    return [before, c.stats()]


def _insert_dedups(A, C):
    a, c = _mk(A, C)
    toks = np.arange(2 * BS, dtype=np.int32)
    first = a.allocate(2)
    c.release(toks, first)
    dup = a.allocate(2)
    c.release(toks, dup)
    assert c.tree_blocks == 2
    assert all(a.refcount(b) == 0 for b in dup)
    assert all(a.refcount(b) == 1 for b in first)
    return [first, dup, c.stats()]


def _eviction_lru(A, C):
    a, c = _mk(A, C)
    t1 = np.arange(2 * BS, dtype=np.int32)
    t2 = np.concatenate([t1[:BS], _toks(60, 61, 62, 63)])
    c.release(t1, a.allocate(2))
    c.release(t2, a.allocate(2))
    assert c.tree_blocks == 3 and c.evictable_blocks == 3
    freed = c.evict(1)
    assert c.tree_blocks == 2
    m = c.match(np.concatenate([t1[:BS], _toks(99, 98)]))
    assert len(m.blocks) == 1
    m2 = c.match(np.concatenate([t2, _toks(7)]))
    c.claim(m2)
    assert c.evictable_blocks == 0
    assert c.evict(5) == 0
    return [freed, _m(m), _m(m2), a.free_blocks, c.stats()]


def _max_blocks_cap(A, C):
    a, c = _mk(A, C, max_blocks=2)
    c.release(np.arange(4 * BS, dtype=np.int32), a.allocate(4))
    assert c.tree_blocks <= 2
    return [a.free_blocks, c.stats()]


def _watermark_evicts_after_release(A, C):
    a, c = _mk(A, C, num_blocks=9, watermark=50)      # 8 usable, want 4
    c.release(np.arange(3 * BS, dtype=np.int32), a.allocate(3))
    c.release(np.arange(100, 100 + 3 * BS, dtype=np.int32), a.allocate(3))
    assert a.free_blocks >= 4
    return [a.free_blocks, c.stats()]


def _release_exactly_once(A, C):
    a, c = _mk(A, C)
    counts = {}
    inner = a.unref

    def audited(b):
        counts[b] = counts.get(b, 0) + 1
        return inner(b)

    a.unref = audited
    toks = np.arange(2 * BS, dtype=np.int32)
    first = a.allocate(3)
    c.release(np.concatenate([toks, _toks(5, 6)]), first)
    for b in first:
        assert counts.get(b, 0) == 1, f"block {b}: {counts}"
    counts.clear()
    dup = a.allocate(3)
    c.release(np.concatenate([toks, _toks(5, 6)]), dup)
    for b in dup:
        assert counts.get(b, 0) == 1, f"block {b}: {counts}"
    assert a.free_blocks + c.tree_blocks == a.total_blocks
    return [first, dup, c.stats()]


HOST_SCENARIOS = [
    _double_free, _duplicate_in_one_free, _free_while_referenced,
    _free_validates_whole_list, _unref_past_zero, _ref_of_unallocated,
    _scratch_reserved, _reclaims_from_evictor, _empty_tree,
    _full_block_match, _last_token_recomputed, _partial_tail_cow,
    _min_match_gates, _claim_and_cow_release, _match_is_pure,
    _insert_dedups, _eviction_lru, _max_blocks_cap,
    _watermark_evicts_after_release, _release_exactly_once]


@pytest.mark.parametrize("scenario", HOST_SCENARIOS,
                         ids=[f.__name__.strip("_") for f in HOST_SCENARIOS])
def test_host_operations_match_jax(scenario):
    assert scenario(*PORT_SIDE) == scenario(*JAX_SIDE)


def test_auto_resolves_to_the_jax_cold_defaults(tmp_path):
    from deepspeed_tpu_torch.autotuning import kernel_dispatch
    assert PREFIX_CACHE_DEFAULTS == J_DEFAULTS
    kernel_dispatch.configure(mode="cache_only",
                              cache_path=str(tmp_path / "winners.json"))
    try:
        pool = dict(B=4, NB=64, BS=8, dtype="float32", device="cpu")
        assert resolve_prefix_cache("auto", "auto", **pool) == (False, 1, 0)
        assert resolve_prefix_cache(True, 3, **pool) == (True, 3, 0)
    finally:
        kernel_dispatch.reset()


# ------------------------------------------------------------- engines

ENGINE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
              max_batch_size=4, splitfuse_tokens=16,
              decode_steps_per_dispatch=2, prefix_cache_min_match=1)
_MODELS = {}


def _models(**over):
    """(JAX Llama, its params, the port's Llama with the same weights)."""
    key = tuple(sorted(over.items()))
    if key not in _MODELS:
        jm = JLlama(dataclasses.replace(J_TINY, dtype="float32", **over))
        params = jm.init(jax.random.key(0))
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32", **over),
                   device="cpu", dtype=torch.float32)
        pm.load_state_dict(llama_params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu", torch.float32))
        _MODELS[key] = (jm, params, pm)
    return _MODELS[key]


class _Trio:
    """A JAX engine and a port engine with the cache on, and a port engine
    with it off, driven through the same sequence of requests."""

    def __init__(self, model_over=(), **kw):
        jm, params, pm = _models(**dict(model_over))
        conf = dict(ENGINE, **kw)
        self.jax = JEngine(jm, params=params,
                           config=dict(conf, prefix_cache=True,
                                       paged_kernel=False))
        self.on = InferenceEngineV2(pm, dict(conf, prefix_cache=True),
                                    device="cpu")
        self.off = InferenceEngineV2(pm, dict(conf, prefix_cache=False),
                                     device="cpu")

    def run(self, prompts, max_new=6):
        """One prompt at a time, each to completion (later prompts see the
        prefixes earlier ones released into the tree); -> the port's
        cache-on stats."""
        for p in prompts:
            got = self.on.generate_all([p], max_new_tokens=max_new)[0]
            want = self.jax.generate_all([p], max_new_tokens=max_new)[0]
            ref = self.off.generate_all([p], max_new_tokens=max_new)[0]
            np.testing.assert_array_equal(got, np.asarray(want))
            np.testing.assert_array_equal(got, ref)
        stats = self.on.prefix_cache.stats()
        assert stats == self.jax.prefix_cache.stats()
        return stats


_TRIO = {}


def _trio(name="main", **kw):
    if name not in _TRIO:
        _TRIO[name] = _Trio(**kw)
    return _TRIO[name]


def _closed(eng):
    alloc = eng.state_mgr.allocator
    tree = eng.prefix_cache.tree_blocks if eng.prefix_cache else 0
    return alloc.free_blocks + tree == alloc.total_blocks


class TestEngineStreams:
    def test_shared_prefix_hits(self):
        rs = np.random.RandomState(0)
        template = rs.randint(0, 512, (17,)).astype(np.int32)
        prompts = [np.concatenate([template,
                                   rs.randint(0, 512, (6,)).astype(np.int32)])
                   for _ in range(3)]
        before = dict(_trio().on.prefix_cache.stats())
        s = _trio().run(prompts)
        assert s["hits"] - before["hits"] >= 2
        assert s["cached_tokens"] - before["cached_tokens"] >= 2 * 16

    def test_divergent_prompts(self):
        rs = np.random.RandomState(1)
        prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
                   for n in (5, 21, 33)]
        before = _trio().on.prefix_cache.stats()["lookups"]
        assert _trio().run(prompts)["lookups"] == before + 3

    def test_partial_tail_cow(self):
        rs = np.random.RandomState(2)
        p1 = rs.randint(0, 512, (20,)).astype(np.int32)
        # diverges 4 tokens into p1's second block: a CoW slice copy
        p2 = np.concatenate([p1[:12], rs.randint(0, 512, (8,))]) \
            .astype(np.int32)
        before = dict(_trio().on.prefix_cache.stats())
        s = _trio().run([p1, p2])
        assert s["cow_copies"] - before["cow_copies"] == 1
        assert s["hits"] - before["hits"] == 1

    def test_identical_prompt_resubmitted(self):
        """The T-1 cap end to end: the whole prompt is cached but its last
        token, which is recomputed."""
        rs = np.random.RandomState(3)
        p = rs.randint(0, 512, (24,)).astype(np.int32)
        before = dict(_trio().on.prefix_cache.stats())
        s = _trio().run([p, p])
        assert s["hits"] - before["hits"] == 1
        assert s["cow_copies"] - before["cow_copies"] == 1
        assert s["cached_tokens"] - before["cached_tokens"] == len(p) - 1
        assert _closed(_trio().on)

    def test_bucketed_prefill(self):
        """Split-fuse off: misses take the bucketed prefill, hits the chunk
        path from their cached length."""
        rs = np.random.RandomState(4)
        template = rs.randint(0, 512, (17,)).astype(np.int32)
        prompts = [np.concatenate([template,
                                   rs.randint(0, 512, (5,)).astype(np.int32)])
                   for _ in range(2)]
        t = _trio("bucketed", splitfuse_tokens=0)
        s = t.run(prompts)
        assert s["hits"] >= 1
        assert t.on.forward_counts["prefill"] == 1
        assert t.on.forward_counts["chunk"] >= 1

    def test_full_pool_of_cached_leaves_still_admits(self):
        rs = np.random.RandomState(5)
        p1 = rs.randint(0, 512, (40,)).astype(np.int32)
        p2 = rs.randint(0, 512, (40,)).astype(np.int32)
        t = _trio("small-pool", num_kv_blocks=8)            # 7 usable
        s = t.run([p1, p2])
        assert s["evicted_blocks"] >= 1
        assert _closed(t.on)

    def test_sliding_window_llama(self):
        """A ``sliding_window`` Llama is served with the cache on, as the
        JAX engine serves it (it refuses only per-layer windows)."""
        rs = np.random.RandomState(6)
        template = rs.randint(0, 512, (25,)).astype(np.int32)
        prompts = [np.concatenate([template,
                                   rs.randint(0, 512, (7,)).astype(np.int32)])
                   for _ in range(2)]
        s = _trio("window", model_over=(("sliding_window", 8),)).run(prompts)
        assert s["hits"] >= 1

    def test_concurrent_requests_and_telemetry(self):
        """Several requests in flight at once (admitted against a tree that
        earlier tests filled): the same streams and stats as JAX, and the
        serving snapshot's prefix keys read the tree."""
        t = _trio()
        rs = np.random.RandomState(0)
        template = rs.randint(0, 512, (17,)).astype(np.int32)
        prompts = [np.concatenate([template, rs.randint(0, 512, (n,))])
                   .astype(np.int32) for n in (3, 9, 14)]
        got = t.on.generate_all(prompts, max_new_tokens=5)
        want = t.jax.generate_all(prompts, max_new_tokens=5)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert t.on.prefix_cache.stats() == t.jax.prefix_cache.stats()
        snap, jsnap = t.on.telemetry_snapshot(), t.jax.telemetry_snapshot()
        keys = [k for k in jsnap if k.startswith("prefix")]
        assert keys and {k: snap[k] for k in keys} == \
            {k: jsnap[k] for k in keys}
        assert _closed(t.on)


class TestRefusals:
    def test_forced_cache_with_offload_raises(self):
        with pytest.raises(ValueError, match="kv_host_offload"):
            InferenceEngineV2(_models()[2], dict(
                ENGINE, prefix_cache=True, kv_host_offload=True,
                device_kv_blocks=8), device="cpu")

    def test_auto_resolves_off_and_under_offload(self):
        pm = _models()[2]
        assert InferenceEngineV2(pm, dict(ENGINE), device="cpu") \
            .prefix_cache is None
        eng = InferenceEngineV2(pm, dict(
            ENGINE, kv_host_offload=True, device_kv_blocks=8), device="cpu")
        assert eng.prefix_cache is None

    @pytest.mark.parametrize("bad", [
        dict(prefix_cache="yes-please"),
        dict(prefix_cache=True, prefix_cache_min_match=0),
        dict(prefix_cache=True, prefix_cache_blocks=-1)])
    def test_config_junk_rejected(self, bad):
        with pytest.raises(ValueError):
            InferenceEngineV2(_models()[2], dict(ENGINE, **bad),
                              device="cpu")

    def test_cancel_after_cow_admission_closes_the_pool(self):
        """A request cancelled right after a CoW admission drops its claim
        refs without inserting anything."""
        pm = _models()[2]
        eng = InferenceEngineV2(pm, dict(ENGINE, prefix_cache=True),
                                device="cpu")
        rs = np.random.RandomState(7)
        p1 = rs.randint(0, 512, (20,)).astype(np.int32)
        eng.generate_all([p1], max_new_tokens=4)
        tree = eng.prefix_cache.tree_blocks
        uid = eng.put(np.concatenate([p1[:12], [1, 2, 3]]), 4)
        eng._admit_pending()
        assert eng.state_mgr.get_sequence(uid).cached_len == 12
        assert eng.cancel(uid)
        assert eng.prefix_cache.tree_blocks == tree
        assert _closed(eng)


# ------------------------------------------------------ router, handoff

ROUTER = dict(ENGINE, max_batch_size=2)


def _port_engine(**kw):
    return InferenceEngineV2(_models()[2], dict(ROUTER, **kw), device="cpu")


def _run(router, max_rounds=400):
    rounds = 0
    while router.has_work:
        router.step()
        rounds += 1
        assert rounds < max_rounds, "router failed to drain"


def test_prefix_affinity_routes_to_the_cached_replica():
    router = Router([_port_engine(prefix_cache=True),
                     _port_engine(prefix_cache=True)])
    assert router._affinity_on() is True
    template = np.arange(1, 33, dtype=np.int32)          # 4 full blocks
    uid = router.put(template, max_new_tokens=4)
    _run(router)
    home = router._reqs[uid].replica
    router.get(uid)
    assert home is not None
    scores = {r.name: r.prefix_score(np.concatenate([template, [100]]))
              for r in router.replicas}
    assert scores[home] == 32 and sum(scores.values()) == 32
    for i in range(3):
        ext = np.concatenate([template, np.asarray([100 + i], np.int32)])
        u2 = router.put(ext, max_new_tokens=4)
        router.step()                  # dispatch boundary
        assert router._reqs[u2].replica == home, \
            "affinity ignored the radix-tree match"
        _run(router)
        router.get(u2)
    for rep in router.replicas:
        assert _closed(rep.engine)


def test_prefix_hit_prompt_hands_off_identically():
    """A handed-off sequence whose prompt hits the prefill replica's tree
    (claimed shared blocks in its table) streams as one engine does: the
    export gathers the claimed blocks read-only, ``release_handoff``
    inserts the verified prefix, the import re-owns the KV."""
    rs = np.random.RandomState(3)
    prompt = rs.randint(1, 255, size=15).astype(np.int32)
    want = _port_engine().generate_all([prompt], max_new_tokens=8)[0]
    P, D = _port_engine(prefix_cache=True), _port_engine()
    router = Router([Replica("p0", P, role="prefill"),
                     Replica("d0", D, role="decode")])
    u1 = router.put(prompt, max_new_tokens=8)
    _run(router)
    assert P.prefix_cache.tree_blocks > 0
    u2 = router.put(prompt, max_new_tokens=8)
    _run(router)
    np.testing.assert_array_equal(router.get(u1), want)
    np.testing.assert_array_equal(router.get(u2), want)
    assert router.snapshot()["handoffs"] == 2
    assert P.prefix_cache.stats()["hits"] == 1
    assert _closed(P) and _closed(D)
