"""The port's draft-model speculative decoding
(``inference/v2/speculative.py``, the speculation half of ``ragged.py`` and
``engine_v2.py``, ``Llama.apply_paged_verify``) on CPU, held against the
JAX package:

  * the acceptance rule and the knob resolution ("auto" = the JAX cold
    defaults);
  * the host bookkeeping (the cases of the JAX
    ``tests/unit/test_speculative.py``): the same begin / rollback / draft
    allocation sequences on both packages' ``DSStateManager`` leave the
    same ``generated``, ``seen_tokens``, draft pools and prefix-cache
    refcounts;
  * ``apply_paged_verify`` logits and pools against the JAX model's (the
    Pallas chunk kernel in interpret mode, and the dense path) at 1e-5;
  * fp32 greedy streams of tiny Llama engines with a draft, identical to
    the JAX engine's with the same draft and to plain decode, with the
    same speculation counters; the acceptance-floor latch; a self-draft
    (every proposal accepted); sampled requests never speculating; the
    prefix cache and speculation together;
  * the refusals, and the router's ``serve_verify`` fault point, deadline
    withdrawal mid-speculation and spec-off snapshots over port
    engines."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.autotuning import kernel_dispatch
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2.blocked_allocator import \
    BlockedAllocator as JAllocator
from deepspeed_tpu.inference.v2.prefix_cache import \
    PrefixCache as JPrefixCache
from deepspeed_tpu.inference.v2.ragged import DSStateManager as JManager
from deepspeed_tpu.inference.v2.speculative import \
    SPEC_DEFAULTS as J_DEFAULTS
from deepspeed_tpu.inference.v2.speculative import \
    longest_accept as j_longest_accept
from deepspeed_tpu.inference.v2.speculative import \
    resolve_spec as j_resolve_spec
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.inference.v2 import DeadlineExceeded, Router
from deepspeed_tpu_torch.inference.v2.blocked_allocator import \
    BlockedAllocator
from deepspeed_tpu_torch.inference.v2.prefix_cache import PrefixCache
from deepspeed_tpu_torch.inference.v2.ragged import DSStateManager
from deepspeed_tpu_torch.inference.v2.speculative import (
    SPEC_DEFAULTS, SPEC_EMA_ALPHA, SPEC_MIN_ROUNDS, longest_accept,
    resolve_spec)
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy
from deepspeed_tpu_torch.autotuning import kernel_dispatch as t_dispatch
from deepspeed_tpu_torch.utils import fault_injection

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _pristine(tmp_path, monkeypatch):
    """A private winner cache for the JAX engines ("auto" knobs consult
    it) and no armed fault points."""
    monkeypatch.setenv("DSTPU_AUTOTUNE_CACHE",
                       str(tmp_path / "kernel_autotune.json"))
    monkeypatch.delenv("DSTPU_AUTOTUNE", raising=False)
    kernel_dispatch.reset()
    t_dispatch.reset()
    fault_injection.reset()
    yield
    fault_injection.reset()
    kernel_dispatch.reset()
    t_dispatch.reset()


# ------------------------------------------------------ acceptance, knobs

@pytest.mark.parametrize("proposed,target", [
    ([1, 2, 3], [1, 2, 3, 4]), ([1, 9, 3], [1, 2, 3, 4]),
    ([9, 2, 3], [1, 2, 3, 4]), ([], [7]), ([1, 9, 3, 4], [1, 2, 3, 4, 5]),
    ([5, 5, 5, 5], [5, 5, 5, 5, 5])])
def test_longest_accept_matches_jax(proposed, target):
    assert longest_accept(proposed, target) == \
        j_longest_accept(proposed, target)


def test_resolve_spec_matches_the_jax_cold_cache():
    assert SPEC_DEFAULTS == J_DEFAULTS
    assert (SPEC_EMA_ALPHA, SPEC_MIN_ROUNDS) == (0.25, 3)
    kernel_dispatch.configure(mode="cache_only")      # empty cache
    t_dispatch.configure(mode="cache_only")
    for knobs in (("auto", "auto"), (False, 8), (True, 2), ("auto", 6),
                  (True, "auto")):
        assert resolve_spec(*knobs, B=4, NB=64, BS=8, dtype="float32",
                            device="cpu") == j_resolve_spec(
            *knobs, B=4, NB=64, BS=8, dtype="float32")


# ------------------------------------------------- host bookkeeping

PORT = (DSStateManager, BlockedAllocator, PrefixCache)
JAX = (JManager, JAllocator, JPrefixCache)


def _mgr(M, A, draft_blocks=17):
    m = M(num_blocks=17, block_size=4, max_batch=2, max_blocks_per_seq=4)
    m.draft_allocator = A(draft_blocks)
    return m


def _rollback_unwinds(M, A, _C):
    m = _mgr(M, A)
    _, seq = m.admit(1, np.arange(6), max_new_tokens=8)
    seq.generated.append(42)
    pre = seq.seen_tokens
    m.begin_spec(seq, [7, 8, 9, 10])
    assert seq.seen_tokens == pre + 4
    with pytest.raises(AssertionError):
        m.begin_spec(seq, [1])          # nested span forbidden
    dropped = m.rollback_spec(seq)
    assert seq.seen_tokens == pre and seq.spec_inflight == 0
    return [dropped, list(seq.generated), seq.seen_tokens]


def _rollback_keeps_prefix(M, A, _C):
    m = _mgr(M, A)
    _, seq = m.admit(1, np.arange(6), max_new_tokens=8)
    seq.generated.append(42)
    m.begin_spec(seq, [7, 8, 9, 10])
    return [m.rollback_spec(seq, keep=2), list(seq.generated)]


def _draft_blocks_freed(M, A, _C):
    m = _mgr(M, A)
    da = m.draft_allocator
    total = da.free_blocks
    _, s1 = m.admit(1, np.arange(6), max_new_tokens=8)
    _, s2 = m.admit(2, np.arange(6), max_new_tokens=8)
    assert m.alloc_draft(s1) and m.alloc_draft(s2)
    mid = da.free_blocks
    assert mid == total - len(s1.blocks) - len(s2.blocks)
    m.retire(1)
    m.flush(1)
    m.flush(2)                          # cancel exit (no retire first)
    assert da.free_blocks == total
    assert s1.draft_blocks == [] and s2.draft_blocks == []
    return [mid, da.free_blocks]


def _draft_pool_exhaustion(M, A, _C):
    m = _mgr(M, A, draft_blocks=3)      # room for 2 blocks
    _, s1 = m.admit(1, np.arange(9), max_new_tokens=7)     # 4 blocks
    assert not m.alloc_draft(s1)
    assert s1.spec_on is False
    assert not m.alloc_draft(s1)        # the latch is sticky
    return [s1.spec_on, m.draft_allocator.free_blocks]


def _prefix_refcounts_survive_rollback(M, A, C):
    m = _mgr(M, A)
    m.prefix_cache = C(m.allocator, 4, min_match_blocks=1)
    toks = np.arange(8, dtype=np.int32)
    m.prefix_cache.release(toks.tolist(), m.allocator.allocate(2))
    _, seq = m.admit(1, np.concatenate([toks, [99, 98, 97]]),
                     max_new_tokens=5)
    assert seq.cached_len > 0, "prefix hit expected"
    shared = seq.blocks[0]
    before = m.allocator.refcount(shared)
    assert before == 2                  # tree ref + sequence ref
    seq.generated.append(42)
    m.begin_spec(seq, [7, 8, 9])
    m.rollback_spec(seq)
    assert m.allocator.refcount(shared) == before
    m.retire(1)
    m.flush(1)
    assert m.allocator.free_blocks + m.prefix_cache.tree_blocks \
        == m.allocator.total_blocks
    return [before, seq.cached_len, m.prefix_cache.stats()]


def _batches(M, A, _C):
    """propose_batch / verify_batch / decode_batch(uids=) of two
    sequences, one of them the spec set."""
    m = _mgr(M, A)
    _, s1 = m.admit(1, np.arange(6), max_new_tokens=8)
    _, s2 = m.admit(2, np.arange(3, 10), max_new_tokens=8)
    s1.generated.extend([40, 41])
    s2.generated.append(50)
    m.alloc_draft(s1)
    pb = m.propose_batch({1})
    vb = m.verify_batch({1: [7, 8, 9]}, 3)
    db = m.decode_batch(uids={2})
    return [[b.tokens.tolist(), b.lengths.tolist(), b.block_tables.tolist(),
             b.active.tolist()] for b in (pb, vb, db)]


HOST = [_rollback_unwinds, _rollback_keeps_prefix, _draft_blocks_freed,
        _draft_pool_exhaustion, _prefix_refcounts_survive_rollback,
        _batches]


@pytest.mark.parametrize("scenario", HOST,
                         ids=[f.__name__.strip("_") for f in HOST])
def test_host_bookkeeping_matches_jax(scenario):
    assert scenario(*PORT) == scenario(*JAX)


# ------------------------------------------------------------ models

DRAFT_OVER = dict(n_layer=1, d_model=64, n_head=2, n_kv_heads=1)
_MODELS = {}


def _models(draft=False, **over):
    """(JAX Llama, its params, the port's Llama with the same weights);
    ``draft``: the narrow draft (other weights)."""
    over = dict(DRAFT_OVER, **over) if draft else over
    key = (draft,) + tuple(sorted(over.items()))
    if key not in _MODELS:
        jm = JLlama(dataclasses.replace(J_TINY, dtype="float32", **over))
        params = jm.init(jax.random.key(1 if draft else 0))
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32", **over),
                   device="cpu", dtype=torch.float32)
        pm.load_state_dict(llama_params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu", torch.float32))
        _MODELS[key] = (jm, params, pm)
    return _MODELS[key]


@pytest.mark.parametrize("kernel,window", [(True, 0), (False, 0),
                                           (False, 8)])
def test_apply_paged_verify_matches_jax(kernel, window):
    """Three slots (one inactive) with histories of 13 and 21 tokens
    prefilled, then C = 5 tokens each verified in one pass: logits and
    every pool agree at 1e-5 (the JAX side through its Pallas chunk kernel
    in interpret mode, or its dense path)."""
    jm, params, pm = _models(sliding_window=window)
    jm._paged_kernel = kernel
    jm._paged_block_c = 8
    NB, BS, MB, C = 16, 8, 5, 5
    jc = jm.init_paged_cache(NB, BS, dtype=jnp.float32)
    pc = pm.init_paged_cache(NB, BS)
    rs = np.random.RandomState(2)
    tables = np.zeros((3, MB), np.int32)
    tables[0, :4] = [3, 9, 5, 12]
    tables[2, :4] = [1, 14, 7, 2]
    lengths = np.array([13, 0, 21], np.int32)
    for slot in (0, 2):
        T = int(lengths[slot])
        ids = np.zeros((1, 24), np.int32)
        ids[0, :T] = rs.randint(0, 512, (T,))
        tb = np.zeros((24,), np.int32)
        to = np.zeros((24,), np.int32)
        tb[:T] = tables[slot][np.arange(T) // BS]
        to[:T] = np.arange(T) % BS
        _, jc = jax.jit(jm.apply_paged_prefill)(
            params, jnp.asarray(ids), jc, jnp.asarray(tb), jnp.asarray(to),
            jnp.int32(T))
        _, pc = pm.apply_paged_prefill(torch.from_numpy(ids), pc,
                                       torch.from_numpy(tb),
                                       torch.from_numpy(to), T)
    tokens = rs.randint(0, 512, (3, C)).astype(np.int32)
    tokens[1] = 0
    jl, jc = jax.jit(jm.apply_paged_verify)(
        params, jnp.asarray(tokens), jnp.asarray(lengths), jc,
        jnp.asarray(tables))
    pm.paged_kernel = kernel
    pl_, pc = pm.apply_paged_verify(torch.from_numpy(tokens), lengths, pc,
                                    torch.from_numpy(tables))
    assert pl_.shape == (3, C, 512)
    for slot in (0, 2):
        np.testing.assert_allclose(pl_[slot].numpy(), np.asarray(jl)[slot],
                                   **TOL)
    for name in ("k", "v"):
        for a, b in zip(jc[name], pc[name]):
            np.testing.assert_allclose(b[1:].numpy(), np.asarray(a)[1:],
                                       **TOL)


def test_mixtral_inherits_apply_paged_verify():
    """Mixtral's verify is Llama's with its MoE FFN: two slots of C = 5
    after a 10-token prefill, against the JAX Mixtral's dense path
    (``lax.ragged_dot`` experts) at the Mixtral serving tests' 1e-4."""
    from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as JM_TINY
    from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
    from deepspeed_tpu.runtime.config import MoEConfig
    from deepspeed_tpu_torch import Mixtral
    from deepspeed_tpu_torch.models import (MIXTRAL_TINY,
                                            mixtral_params_from_numpy)
    jm = JMixtral(dataclasses.replace(JM_TINY, dtype="float32"))
    jm._paged_kernel = False
    jm._moe_cfg = MoEConfig(grouped_kernel=False)
    params = jm.init(jax.random.key(0))
    pm = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"),
                 device="cpu", dtype=torch.float32)
    pm.load_state_dict(mixtral_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    pm.grouped_kernel = False
    jc = jm.init_paged_cache(8, 8, dtype=jnp.float32)
    pc = pm.init_paged_cache(8, 8)
    rs = np.random.RandomState(4)
    T = 10
    ids = np.zeros((1, 16), np.int32)
    ids[0, :T] = rs.randint(0, 512, (T,))
    tb = np.zeros((16,), np.int32)
    to = np.zeros((16,), np.int32)
    tb[:T] = np.array([2, 5])[np.arange(T) // 8]
    to[:T] = np.arange(T) % 8
    _, jc = jax.jit(jm.apply_paged_prefill)(
        params, jnp.asarray(ids), jc, jnp.asarray(tb), jnp.asarray(to),
        jnp.int32(T))
    _, pc = pm.apply_paged_prefill(torch.from_numpy(ids), pc,
                                   torch.from_numpy(tb),
                                   torch.from_numpy(to), T)
    tables = np.array([[2, 5, 0], [0, 0, 0]], np.int32)
    lengths = np.array([T, 0], np.int32)
    tokens = rs.randint(0, 512, (2, 5)).astype(np.int32)
    jl, _ = jax.jit(jm.apply_paged_verify)(
        params, jnp.asarray(tokens), jnp.asarray(lengths), jc,
        jnp.asarray(tables))
    pl_, _ = pm.apply_paged_verify(torch.from_numpy(tokens), lengths, pc,
                                   torch.from_numpy(tables))
    np.testing.assert_allclose(pl_[0].numpy(), np.asarray(jl)[0],
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ engines

ENGINE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
              max_batch_size=2, splitfuse_tokens=16,
              decode_steps_per_dispatch=2)
SPEC = dict(spec_draft=True, spec_k=4)


def _jax_engine(spec=True, draft="narrow", **kw):
    jm, params, _ = _models()
    extra = {}
    if spec:
        dj, dparams, _ = _models(draft=True) if draft == "narrow" \
            else _models()
        extra = dict(draft_model=dj, draft_params=dparams)
        kw = dict(SPEC, **kw)
    conf = dict(ENGINE, paged_kernel=False, prefix_cache=False)
    conf.update(kw)
    return JEngine(jm, params=params, config=conf, **extra)


def _port_engine(spec=True, draft="narrow", **kw):
    pm = _models()[2]
    extra = {}
    if spec:
        extra = dict(draft_model=_models(draft=True)[2]
                     if draft == "narrow" else pm)
        kw = dict(SPEC, **kw)
    return InferenceEngineV2(pm, dict(ENGINE, **kw), device="cpu", **extra)


_SHARED = {}


def _shared(key):
    """Engines reused by the clean-completion tests (a drained engine
    keeps no request state): "plain", "spec", "jax-spec"."""
    if key not in _SHARED:
        _SHARED[key] = {"plain": lambda: _port_engine(spec=False),
                        "spec": _port_engine,
                        "jax-spec": _jax_engine}[key]()
    return _SHARED[key]


def _prompts(seed, n, lo=6, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 255, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _pools_closed(eng):
    alloc = eng.state_mgr.allocator
    tree = eng.prefix_cache.tree_blocks if eng.prefix_cache else 0
    assert alloc.free_blocks + tree == alloc.total_blocks
    da = eng.state_mgr.draft_allocator
    if da is not None:
        assert da.free_blocks == da.total_blocks, "leaked draft blocks"


def _spec_keys(snap):
    return {k: v for k, v in snap.items() if k.startswith("spec")}


class TestEngineStreams:
    def test_spec_on_matches_jax_and_plain_decode(self):
        prompts = _prompts(1, 3)
        ref = _shared("plain").generate_all(prompts, max_new_tokens=10)
        eng, jeng = _shared("spec"), _shared("jax-spec")
        assert eng.draft_model is not None and eng._spec_k == 4
        got = eng.generate_all(prompts, max_new_tokens=10)
        want = jeng.generate_all(prompts, max_new_tokens=10)
        for g, w, r in zip(got, want, ref):
            np.testing.assert_array_equal(g, np.asarray(w))
            np.testing.assert_array_equal(g, r)
        _pools_closed(eng)
        snap = eng.telemetry_snapshot()
        assert snap["spec_rounds"] > 0
        assert snap["spec_tokens_per_verify_step"] >= 1.0
        assert _spec_keys(snap) == _spec_keys(jeng.telemetry_snapshot())
        assert eng.forward_counts["verify"] > 0
        assert eng.draft_forward_counts["decode"] % (eng._spec_k + 1) == 0

    def test_acceptance_floor_latch(self):
        """With the floor above any reachable EMA every sequence latches to
        plain decode after SPEC_MIN_ROUNDS rounds, returns its draft
        blocks, and streams as JAX and plain decode do."""
        prompts = _prompts(1, 2)
        ref = _shared("plain").generate_all(prompts, max_new_tokens=18)
        eng, jeng = _port_engine(), _jax_engine()
        eng._spec_floor = jeng._spec_floor = 1.1
        latched = {}
        uids = [eng.put(p, max_new_tokens=18) for p in prompts]
        juids = [jeng.put(p, max_new_tokens=18) for p in prompts]
        while eng.has_work:
            eng.step()
            for uid in uids:
                seq = eng.state_mgr._seqs.get(uid)
                if seq is not None and not seq.spec_on:
                    latched[uid] = (seq.spec_rounds, list(seq.draft_blocks))
        while jeng.has_work:
            jeng.step()
        for u, ju, r in zip(uids, juids, ref):
            got = eng.get(u)
            np.testing.assert_array_equal(got, r)
            np.testing.assert_array_equal(got, np.asarray(jeng.get(ju)))
        assert set(latched) == set(uids), "floor never latched"
        for rounds, blocks in latched.values():
            assert rounds == SPEC_MIN_ROUNDS and blocks == []
        _pools_closed(eng)
        assert _spec_keys(eng.telemetry_snapshot()) == \
            _spec_keys(jeng.telemetry_snapshot())

    def test_self_draft_accepts_every_proposal(self):
        """The target as its own draft (its own draft pool): every
        proposal is accepted and a round commits k+1 tokens."""
        prompts = _prompts(2, 2)
        ref = _shared("plain").generate_all(prompts, max_new_tokens=16)
        eng = _port_engine(draft="self")
        assert eng.draft_model is eng.model
        got = eng.generate_all(prompts, max_new_tokens=16)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        snap = eng.telemetry_snapshot()
        assert snap["spec_acceptance_pct"] == 100.0
        assert snap["spec_tokens_per_verify_step"] == eng._spec_k + 1
        _pools_closed(eng)

    def test_sampled_sequences_never_speculate(self):
        eng = _shared("spec")
        uid = eng.put(_prompts(2, 1)[0], max_new_tokens=6,
                      temperature=0.8, top_k=4)
        rounds0 = eng.telemetry.spec_rounds
        while eng.has_work:
            eng.step()
        assert len(eng.get(uid)) == 6
        assert eng.telemetry.spec_rounds == rounds0
        _pools_closed(eng)

    def test_prefix_cache_and_speculation_together(self):
        """A prefix hit's cached tokens were never recomputed by the
        target; the draft's catch-up replays them from the token history.
        Streams equal JAX's with both features on."""
        rs = np.random.RandomState(9)
        template = rs.randint(1, 255, (19,)).astype(np.int32)
        prompts = [np.concatenate([template, rs.randint(1, 255, (4,))])
                   .astype(np.int32) for _ in range(2)]
        eng = _port_engine(prefix_cache=True, prefix_cache_min_match=1)
        jeng = _jax_engine(prefix_cache=True, prefix_cache_min_match=1)
        for p in prompts:
            got = eng.generate_all([p], max_new_tokens=12)[0]
            np.testing.assert_array_equal(
                got, np.asarray(jeng.generate_all([p],
                                                  max_new_tokens=12)[0]))
        assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
        assert eng.prefix_cache.stats()["hits"] == 1
        _pools_closed(eng)


class TestRefusals:
    def test_spec_draft_true_without_a_draft_raises(self):
        with pytest.raises(ValueError, match="requires a draft model"):
            _port_engine(spec=False, spec_draft=True)

    def test_vocab_mismatch_raises(self):
        bad = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32",
                                        vocab_size=128, **DRAFT_OVER),
                    device="cpu")
        with pytest.raises(ValueError, match="vocab mismatch"):
            InferenceEngineV2(_models()[2], dict(ENGINE, **SPEC),
                              device="cpu", draft_model=bad)

    def test_draft_with_offload(self):
        with pytest.raises(ValueError, match="kv_host_offload"):
            _port_engine(kv_host_offload=True, device_kv_blocks=8)
        eng = _port_engine(spec_draft="auto", kv_host_offload=True,
                           device_kv_blocks=8)
        assert eng.draft_model is None      # "auto" resolves off

    def test_spec_off_and_auto(self):
        assert _port_engine(spec_draft=False).draft_model is None
        eng = _port_engine(spec_draft="auto", spec_k="auto")
        assert eng.draft_model is not None and eng._spec_k == 4
        assert eng._spec_floor == pytest.approx(0.35)
        with pytest.raises(ValueError):
            _port_engine(spec_k=0)


# ------------------------------------------------------------- router

def _run(router, max_rounds=400):
    rounds = 0
    while router.has_work:
        router.step()
        rounds += 1
        assert rounds < max_rounds, "router failed to drain"


class TestRouter:
    def test_serve_verify_fault_absorbed_with_identical_output(self):
        prompts = _prompts(1, 1)
        ref = _shared("plain").generate_all(prompts, max_new_tokens=10)
        eng = _shared("spec")
        router = Router([eng], max_step_failures=3)
        fault_injection.arm("serve_verify", fails=2)   # absorbed: 2 < 3
        uid = router.put(prompts[0], max_new_tokens=10)
        _run(router)
        assert router.replicas[0].live
        assert router.replicas[0].step_failures == 2
        assert fault_injection.injector.hits("serve_verify") == 2
        np.testing.assert_array_equal(router.get(uid), ref[0])
        _pools_closed(eng)
        snap = router.snapshot()
        assert 0.0 <= snap["spec_acceptance_ema"]["r0"] <= 1.0

    def test_interrupted_verify_rolls_back(self, monkeypatch):
        """A verify that raises leaves no speculative token behind."""
        eng = _port_engine()
        uid = eng.put(_prompts(3, 1)[0], max_new_tokens=12)
        while not eng.spec_pending:
            eng.step()
        seq = eng.state_mgr.get_sequence(uid)
        before = list(seq.generated)

        def boom(_vb):
            raise RuntimeError("verify lost")

        monkeypatch.setattr(eng, "_verify", boom)
        with pytest.raises(RuntimeError, match="verify lost"):
            eng.step()
        assert seq.generated == before and seq.spec_inflight == 0

    def test_deadline_withdrawal_mid_speculation(self):
        eng = _shared("spec")
        router = Router([eng])
        clock = {"t": 0.0}
        router._now = lambda: clock["t"]
        uid = router.put(_prompts(3, 1)[0], max_new_tokens=64,
                         deadline_ms=5000)
        for _ in range(3):
            router.step()
        req = router._reqs[uid]
        assert req.state == "inflight" and req.n_tokens > 0
        assert eng.state_mgr._seqs[uid].draft_blocks, \
            "speculation never engaged"
        clock["t"] = 10.0
        router.step()
        with pytest.raises(DeadlineExceeded):
            router.get(uid)
        assert uid not in eng.state_mgr._seqs
        _pools_closed(eng)
        assert not router.has_work

    def test_spec_off_snapshot_has_no_spec_keys(self):
        eng = _shared("plain")
        router = Router([eng])
        uid = router.put(_prompts(4, 1)[0], max_new_tokens=4)
        _run(router)
        router.get(uid)
        assert "spec_acceptance_ema" not in router.snapshot()
        assert not _spec_keys(eng.telemetry.percentiles())
        assert not eng.spec_pending
