"""The port's serving front-end (``inference/v2/router.py``,
``replica.py``) on CPU: the JAX package's router tests over tiny fp32
Llama engines (config validation, queue-depth resolution, round trips
byte-identical to one engine, failover, drains, heartbeats, dispatch
faults, shedding, the advisory ``router_overload`` point, deadlines on a
fake clock, ``cancel`` at every stage, the ``Serve/Router/*`` tags,
disaggregated prefill/decode dispatch with its chaos paths), and one
scripted scenario run through the JAX router over JAX engines and the
port's router over the port's engines: the same per-request outcome
(tokens, or the typed exception), the same placement round by round, and
the same ``snapshot()``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.autotuning import kernel_dispatch
from deepspeed_tpu.inference.v2 import DeadlineExceeded as JDeadline
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import Overloaded as JOverloaded
from deepspeed_tpu.inference.v2 import Router as JRouter
from deepspeed_tpu.inference.v2 import RouterConfig as JRouterConfig
from deepspeed_tpu.inference.v2.replica import Replica as JReplica
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.monitor.tag_schema import TAG_SCHEMA
from deepspeed_tpu.utils import fault_injection as jfi
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.inference.v2 import (DeadlineExceeded, Overloaded,
                                              Replica, ReplicaDead, Router,
                                              RouterConfig)
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy
from deepspeed_tpu_torch.utils import fault_injection

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
            max_batch_size=2, splitfuse_tokens=16,
            decode_steps_per_dispatch=2)


@pytest.fixture(autouse=True)
def _no_armed_faults():
    fault_injection.reset()
    yield
    fault_injection.reset()


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


def _engine(**kw):
    return InferenceEngineV2(_models()[2], dict(BASE, **kw), device="cpu")


def _prompts(seed, n, lo=6, hi=20):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 255, size=rs.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


_REF = []


def _ref_outputs():
    """One engine's streams for _prompts(1, 4) at max_new 8."""
    if not _REF:
        _REF.extend(_engine().generate_all(_prompts(1, 4), max_new_tokens=8))
    return _REF


def _run(router, max_rounds=400):
    rounds = 0
    while router.has_work:
        router.step()
        rounds += 1
        assert rounds < max_rounds, "router failed to drain"
    return rounds


def _pool_closed(eng):
    alloc = eng.state_mgr.allocator
    assert alloc.free_blocks == alloc.total_blocks, (
        f"leaked blocks: free={alloc.free_blocks} "
        f"total={alloc.total_blocks}")


def _disagg_router(**kw):
    P, D = _engine(), _engine()
    reps = [Replica("p0", P, role="prefill"), Replica("d0", D, role="decode")]
    return Router(reps, **kw), reps


# ------------------------------------------------------------ config

class TestRouterConfig:
    def test_auto_knobs_accept_auto_and_reject_junk(self):
        RouterConfig(router_queue_depth="auto", shed_policy="auto",
                     prefix_affinity="auto", disaggregate="auto")
        for field in ("router_queue_depth", "shed_policy",
                      "prefix_affinity", "disaggregate"):
            with pytest.raises(ValueError):
                RouterConfig(**{field: "___junk___"})

    @pytest.mark.parametrize("bad", [
        dict(router_queue_depth=0), dict(router_queue_depth=True),
        dict(breach_rounds=0), dict(max_step_failures=1.5),
        dict(emit_interval=0), dict(shed_low_pct=80, shed_high_pct=50),
        dict(shed_high_pct=101), dict(slo_ttft_ms=-1),
        dict(slo_tpot_ms=True), dict(shed_policy="oldest")])
    def test_errors_match_jax(self, bad):
        with pytest.raises(ValueError) as ours:
            RouterConfig(**bad)
        with pytest.raises(ValueError) as theirs:
            JRouterConfig(**bad)
        assert str(ours.value) == str(theirs.value)

    def test_defaults_match_jax(self):
        assert dataclasses.asdict(RouterConfig()) == \
            dataclasses.asdict(JRouterConfig())

    def test_queue_depth_resolution(self):
        r = Router([_engine(), _engine()])
        assert r.resolved_queue_depth() == 16   # 4 x (2 replicas x 2)
        r.replicas[1].mark_dead("test")
        assert r.resolved_queue_depth() == 8
        r2 = Router([r.replicas[0]], router_queue_depth=5)
        assert r2.resolved_queue_depth() == 5


# ------------------------------------------------------------- basics

class TestRouterBasics:
    def test_roundtrip_matches_single_engine(self):
        prompts = _prompts(1, 4)
        want = _ref_outputs()
        router = Router([_engine(), _engine()])
        uids = [router.put(p, max_new_tokens=8) for p in prompts]
        _run(router)
        for uid, w in zip(uids, want):
            assert router.is_done(uid)
            np.testing.assert_array_equal(router.get(uid), w)
        snap = router.snapshot()
        assert snap["admitted"] == snap["completed"] == 4
        assert snap["shed"] == snap["expired"] == 0
        assert snap["failovers"] == snap["replayed"] == 0
        assert all(r.steps > 0 for r in router.replicas)
        for rep in router.replicas:
            _pool_closed(rep.engine)

    def test_prefix_affinity_resolves_off_without_a_prefix_cache(self):
        """No prefix cache in the port yet: "auto" resolves off and every
        replica scores 0, as the JAX router does for such a fleet."""
        router = Router([_engine(), _engine()])
        assert router._affinity_on() is False
        assert all(r.prefix_score(np.arange(1, 33)) == 0
                   for r in router.replicas)


# -------------------------------------------------------------- chaos

@pytest.mark.chaos
class TestChaosFailover:
    def test_replica_death_mid_decode_replays_byte_identical(self):
        prompts = _prompts(1, 4)
        want = _ref_outputs()
        router = Router([_engine(), _engine()])
        uids = [router.put(p, max_new_tokens=8) for p in prompts]
        for _ in range(3):
            router.step()
        victim = next(r for r in router.replicas if r.has_work)
        n_inflight = len(victim.inflight)
        assert n_inflight > 0, "nothing in flight before the kill"
        fault_injection.arm("replica_death", fails=1)
        _run(router)
        snap = router.snapshot()
        assert snap["failovers"] == 1
        assert snap["replayed"] == n_inflight
        assert snap["completed"] == 4
        assert snap["replicas"][victim.name] == "dead"
        assert not victim.drained
        survivors = [r for r in router.replicas if not r.dead]
        assert len(survivors) == 1 and survivors[0].live
        for uid, w in zip(uids, want):
            np.testing.assert_array_equal(router.get(uid), w)
        _pool_closed(survivors[0].engine)
        assert len(router._cstat(0)["ttft_ms"]) == 4   # one a request

    def test_drain_finishes_inflight_without_replay(self):
        prompts = _prompts(2, 4)
        router = Router([_engine(), _engine()])
        uids = [router.put(p, max_new_tokens=6) for p in prompts]
        router.step()
        router.drain("r0")
        assert router.snapshot()["draining"] == 1
        _run(router)
        snap = router.snapshot()
        assert snap["completed"] == 4
        assert snap["failovers"] == 0 and snap["replayed"] == 0
        assert snap["replicas"]["r0"] == "dead"
        assert router.replicas[0].drained
        for uid in uids:
            assert len(router.get(uid)) == 6
        u_new = router.put(prompts[0], max_new_tokens=4)
        _run(router)
        assert len(router.get(u_new)) == 4
        assert router._reqs.get(u_new) is None
        assert router.snapshot()["replicas"]["r1"] == "live"
        with pytest.raises(KeyError):
            router.drain("nope")

    def test_step_failures_break_the_heartbeat_then_fail_over(self):
        router = Router([_engine(), _engine()], max_step_failures=3)
        uid = router.put(_prompts(3, 1)[0], max_new_tokens=6)
        fault_injection.arm("serve_step", fails=2)      # absorbed: 2 < 3
        _run(router)
        assert router.replicas[0].live
        assert router.replicas[0].step_failures == 2
        assert len(router.get(uid)) == 6
        assert router.snapshot()["failovers"] == 0

        uid2 = router.put(_prompts(4, 1)[0], max_new_tokens=6)
        fault_injection.arm("serve_step", fails=3)      # breaks it
        _run(router)
        snap = router.snapshot()
        assert snap["failovers"] == 1 and snap["replayed"] == 1
        assert sum(r.dead for r in router.replicas) == 1
        assert sum(r.live for r in router.replicas) == 1
        assert len(router.get(uid2)) == 6

    def test_serve_verify_fires_only_with_a_verify_pending(self):
        """``serve_verify`` fires where a speculative verify dispatch would
        run (``engine.spec_pending``); the port has no speculation, so an
        armed point stays unfired until an engine says one is pending."""
        eng = _engine()
        rep = Replica("r0", eng)
        fault_injection.arm("serve_verify", fails=1)
        eng.put(_prompts(5, 1)[0], max_new_tokens=2)
        rep.step()
        assert fault_injection.injector.hits("serve_verify") == 0
        eng.spec_pending = True
        assert rep.step() == []                          # absorbed
        assert rep.step_failures == 1 and rep.live
        del eng.spec_pending
        while eng.has_work:
            rep.step()

    def test_dispatch_fault_requeues_and_retries(self):
        router = Router([_engine()])
        fault_injection.arm("serve_dispatch", fails=1)
        uid = router.put(_prompts(5, 1)[0], max_new_tokens=4)
        router.step()
        assert router._reqs[uid].state == "queued"
        assert router.snapshot()["dispatch_retries"] == 1
        _run(router)
        assert len(router.get(uid)) == 4
        assert router.snapshot()["failovers"] == 0

    def test_all_replicas_dead_fails_loudly(self):
        router = Router([_engine()])
        router.put(_prompts(6, 1)[0], max_new_tokens=4)
        fault_injection.arm("replica_death", fails=1)
        with pytest.raises(RuntimeError, match="no live replicas"):
            _run(router)
        with pytest.raises(ReplicaDead):
            router.replicas[0].step()
        with pytest.raises(RuntimeError, match="no live replicas"):
            router.put(_prompts(6, 1)[0], max_new_tokens=4)


# ----------------------------------------------------------- overload

class TestRouterOverload:
    def test_admission_and_shedding_protect_the_admitted_class(self):
        eng = _engine()
        router = Router([eng], router_queue_depth=8, breach_rounds=1,
                        shed_high_pct=75, shed_low_pct=50)
        base_uids = [router.put(p, max_new_tokens=6)
                     for p in _prompts(7, 4)]
        _run(router)
        for uid in base_uids:
            router.get(uid)
        baseline = router.snapshot()["classes"][0]["tpot_ms_p99"]
        assert baseline is not None

        keep = [router.put(p, max_new_tokens=6, klass=1)
                for p in _prompts(8, 4)]
        low = [router.put(p, max_new_tokens=6, klass=2)
               for p in _prompts(9, 4)]
        with pytest.raises(Overloaded) as exc:
            router.put(_prompts(10, 1)[0], max_new_tokens=6, klass=2)
        assert exc.value.klass == 2 and exc.value.queue_depth == 8
        _run(router)
        snap = router.snapshot()
        assert snap["classes"][2]["shed"] == 5
        assert snap["classes"][2]["completed"] == 0
        for uid in low:
            with pytest.raises(Overloaded) as err:
                router.get(uid)
            assert err.value.klass == 2
        assert snap["classes"][1]["completed"] == 4
        assert snap["classes"][1]["shed"] == 0
        for uid in keep:
            assert len(router.get(uid)) == 6
        admitted = snap["classes"][1]["tpot_ms_p99"]
        assert admitted is not None
        assert admitted <= max(10 * baseline, baseline + 500), \
            f"admitted-class p99 TPOT {admitted} vs baseline {baseline}"
        assert snap["replicas"]["r0"] == "live"
        _pool_closed(eng)

    @pytest.mark.chaos
    def test_router_overload_point_is_advisory(self):
        router = Router([_engine()])
        fault_injection.arm("router_overload", fails=10_000)
        uids = [router.put(p, max_new_tokens=4) for p in _prompts(11, 3)]
        _run(router)
        assert fault_injection.injector.hits("router_overload") > 0
        snap = router.snapshot()
        assert snap["completed"] == 3 and snap["shed"] == 0
        assert all(s == "live" for s in snap["replicas"].values())
        for uid in uids:
            assert len(router.get(uid)) == 4

    def test_shed_policy_newest_first_ignores_class(self):
        router = Router([_engine()], router_queue_depth=4,
                        breach_rounds=1, shed_high_pct=75,
                        shed_low_pct=25, shed_policy="newest-first")
        uids = [router.put(p, max_new_tokens=4, klass=k)
                for k, p in enumerate(_prompts(12, 4))]
        router.step()
        states = [router._reqs[u].state for u in uids]
        assert states[1] == states[2] == states[3] == "shed"
        assert states[0] in ("queued", "inflight", "done")
        _run(router)
        assert len(router.get(uids[0])) == 4

    def test_slo_breach_sheds_from_engine_telemetry(self):
        """The SLO half of overload detection reads each replica's
        ``telemetry_snapshot()``: a p99 TTFT above the SLO for
        ``breach_rounds`` rounds sheds the queue to the low watermark."""
        eng = _engine()
        router = Router([eng], router_queue_depth=8, breach_rounds=1,
                        shed_low_pct=25, slo_ttft_ms=1e-6)
        warm = router.put(_prompts(13, 1)[0], max_new_tokens=2)
        _run(router)
        router.get(warm)
        assert eng.telemetry_snapshot()["ttft_ms_p99"] > 1e-6
        uids = [router.put(p, max_new_tokens=2, klass=k)
                for k, p in enumerate(_prompts(14, 4))]
        router.step()
        assert router.snapshot()["shed"] == 2
        assert [router._reqs[u].state for u in uids[2:]] == ["shed"] * 2
        _run(router)
        for uid in uids[:2]:
            assert len(router.get(uid)) == 2


# ---------------------------------------------------------- deadlines

class TestDeadlines:
    def _router(self, eng=None, **kw):
        eng = eng if eng is not None else _engine()
        router = Router([eng], **kw)
        self.clock = {"t": 0.0}
        router._now = lambda: self.clock["t"]
        return router, eng

    def test_queued_ttft_deadline_expires_before_dispatch(self):
        router, eng = self._router()
        uid = router.put(_prompts(13, 1)[0], max_new_tokens=4,
                         ttft_deadline_ms=100)
        self.clock["t"] = 0.2
        router.step()
        assert router.is_done(uid)
        with pytest.raises(DeadlineExceeded) as exc:
            router.get(uid)
        assert exc.value.which == "ttft"
        assert not eng.state_mgr._seqs and not eng._pending
        assert router.snapshot()["expired"] == 1

    def test_inflight_deadline_flushes_through_cancel(self):
        router, eng = self._router()
        uid = router.put(_prompts(14, 1)[0], max_new_tokens=32,
                         deadline_ms=5000)
        for _ in range(3):
            router.step()
        req = router._reqs[uid]
        assert req.state == "inflight" and req.n_tokens > 0
        self.clock["t"] = 10.0
        router.step()
        assert router.is_done(uid)
        with pytest.raises(DeadlineExceeded) as exc:
            router.get(uid)
        assert exc.value.which == "total"
        snap = router.snapshot()
        assert snap["expired"] == 1 and snap["completed"] == 0
        _pool_closed(eng)
        assert not eng.state_mgr._seqs
        assert uid not in eng._results
        assert eng.telemetry.completed == 0
        assert eng.telemetry.rejected == 1
        assert router.replicas[0].live
        assert not router.has_work


# -------------------------------------------------------- engine cancel

class TestEngineCancel:
    def test_cancel_every_lifecycle_stage(self):
        eng = _engine()
        u1 = eng.put(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
        assert eng.cancel(u1) is True
        assert not eng._pending
        with pytest.raises(KeyError):
            eng.is_done(u1)

        long_prompt = np.arange(1, 41, dtype=np.int32) % 255 + 1
        u2 = eng.put(long_prompt, max_new_tokens=8)
        eng.step()
        assert u2 in eng._prefill_q
        assert eng.cancel(u2) is True
        assert u2 not in eng._prefill_q
        _pool_closed(eng)

        u3 = eng.put(np.arange(50, 60, dtype=np.int32), max_new_tokens=16)
        for _ in range(2):
            eng.step()
        assert len(eng.get(u3, flush=False)) > 0
        assert eng.cancel(u3) is True
        _pool_closed(eng)
        assert eng.telemetry.rejected == 3
        assert eng.telemetry.completed == 0

        u4 = eng.put(np.arange(70, 80, dtype=np.int32), max_new_tokens=2)
        while eng.has_work:
            eng.step()
        assert eng.cancel(u4) is True
        with pytest.raises(KeyError):
            eng.get(u4)
        assert eng.cancel(12345) is False

        out = eng.generate_all([np.arange(5, 15, dtype=np.int32)],
                               max_new_tokens=4)
        assert len(out[0]) == 4
        _pool_closed(eng)


# ---------------------------------------------------------- telemetry

class _Mon:
    enabled = True

    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


class TestRouterTelemetry:
    def test_emitted_tags_are_documented_and_complete(self):
        mon = _Mon()
        router = Router([_engine()], monitor=mon, emit_interval=1)
        uids = [router.put(p, max_new_tokens=4) for p in _prompts(15, 2)]
        _run(router)
        for uid in uids:
            router.get(uid)
        tags = {t for t, _v, _s in mon.events}
        assert not tags - set(TAG_SCHEMA)
        assert tags == {"Serve/Router/shed", "Serve/Router/expired",
                        "Serve/Router/replayed", "Serve/Router/failovers",
                        "Serve/Router/queue_depth", "Serve/Router/draining"}
        assert all(isinstance(s, int) for _t, _v, s in mon.events)

    def test_disaggregated_fleet_emits_the_handoff_tags(self):
        mon = _Mon()
        router, _ = _disagg_router(monitor=mon, emit_interval=1)
        uids = [router.put(p, max_new_tokens=4) for p in _prompts(15, 2)]
        _run(router)
        for uid in uids:
            router.get(uid)
        tags = {t for t, _v, _s in mon.events}
        assert not tags - set(TAG_SCHEMA)
        assert {"Serve/Router/handoffs", "Serve/Router/kv_stream_bytes",
                "Serve/Router/kv_stream_ms", "Serve/Router/prefill_inflight",
                "Serve/Router/decode_inflight"} <= tags

    def test_router_off_engine_snapshot_keys(self):
        eng = _engine()
        eng.generate_all(_prompts(16, 2), max_new_tokens=4)
        assert set(eng.telemetry_snapshot()) == {
            "ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50", "tpot_ms_p99",
            "completed", "active"}


class TestReplicaHandle:
    def test_named_replica_wrapping_and_duplicate_names_raise(self):
        e = _engine()
        router = Router([Replica("decode-a", e)])
        assert router.replicas[0].name == "decode-a"
        with pytest.raises(ValueError, match="duplicate"):
            Router([Replica("x", e), Replica("x", e)])
        with pytest.raises(ValueError, match="at least one"):
            Router([])

    def test_oversized_request_refused_at_the_router(self):
        router = Router([_engine()])
        with pytest.raises(ValueError, match="never fit"):
            router.put(np.arange(1, 100, dtype=np.int32),
                       max_new_tokens=120)
        with pytest.raises(ValueError, match="max_new_tokens"):
            router.put(np.arange(1, 10, dtype=np.int32), max_new_tokens=0)


# -------------------------------------- disaggregated prefill / decode

class TestDisaggRouter:
    def test_auto_resolution_and_validation(self):
        P, D = _engine(), _engine()
        r_colo = Router([Replica("a", P), Replica("b", D)])
        assert r_colo._disagg_on() is False
        assert "roles" not in r_colo.snapshot()
        r_dis, _ = _disagg_router()
        assert r_dis._disagg_on() is True
        r_off, _ = _disagg_router(config={"disaggregate": False})
        assert r_off._disagg_on() is False
        with pytest.raises(ValueError, match="prefill"):
            Router([Replica("a", P, role="prefill")],
                   config={"disaggregate": True})
        with pytest.raises(ValueError, match="role"):
            Replica("x", P, role="verifier")

    def test_greedy_byte_identity_and_single_ttft_sample(self):
        router, (p_rep, d_rep) = _disagg_router()
        want = _ref_outputs()
        uids = [router.put(p, max_new_tokens=8) for p in _prompts(1, 4)]
        _run(router)
        for uid, w in zip(uids, want):
            np.testing.assert_array_equal(router.get(uid), w)
        snap = router.snapshot()
        assert snap["handoffs"] == 4
        assert snap["kv_stream_bytes"] == router._kv_transport.sent_bytes > 0
        assert snap["kv_stream_retries"] == 0
        assert snap["completed"] == 4 and snap["admitted"] == 4
        assert len(router._cstat(0)["ttft_ms"]) == 4
        assert snap["roles"] == {"p0": "prefill", "d0": "decode"}
        assert snap["prefill_inflight"] == snap["decode_inflight"] == 0
        _pool_closed(p_rep.engine)
        _pool_closed(d_rep.engine)
        assert d_rep.engine.telemetry_snapshot()["handoffs_in"] == 4
        assert p_rep.engine.telemetry_snapshot()["handoffs_out"] == 4
        # the prefill side ran no decode forward
        assert p_rep.engine.forward_counts["decode"] == 0

    @pytest.mark.chaos
    @pytest.mark.parametrize("point", ["kv_stream", "kv_import"])
    def test_handoff_fault_retries_next_round(self, point):
        router, (p_rep, d_rep) = _disagg_router()
        fault_injection.arm(point, fails=1)
        uid = router.put(_prompts(1, 4)[1], max_new_tokens=8)
        _run(router)
        np.testing.assert_array_equal(router.get(uid), _ref_outputs()[1])
        snap = router.snapshot()
        assert snap["kv_stream_retries"] == 1
        assert snap["handoffs"] == 1 and snap["failovers"] == 0
        _pool_closed(p_rep.engine)
        _pool_closed(d_rep.engine)

    @pytest.mark.chaos
    def test_decode_death_mid_transfer_replays_byte_identical(self):
        router, (p_rep, d_rep) = _disagg_router()
        prompt, want = _prompts(1, 4)[3], _ref_outputs()[3]
        uid = router.put(prompt, max_new_tokens=8)
        router._disagg = router._disagg_on()
        for rep in router.replicas:
            rep.set_disaggregated(True)
        router._dispatch(router._now())
        for _ in range(64):
            if p_rep.handoff_ready():
                break
            p_rep.engine.step()
        assert p_rep.handoff_ready() == [uid]
        # P's step fires replica_death once (skipped), then D's import
        fault_injection.arm("replica_death", fails=1, skip=1)
        router.step()
        assert d_rep.dead and not p_rep.dead
        assert router._reqs[uid].replays == 1
        _run(router)
        np.testing.assert_array_equal(router.get(uid), want)
        snap = router.snapshot()
        assert snap["failovers"] == 1 and snap["replayed"] == 1
        assert snap["handoffs"] == 0
        assert snap["completed"] == snap["admitted"] == 1
        assert len(router._cstat(0)["ttft_ms"]) == 1
        _pool_closed(p_rep.engine)
        _pool_closed(d_rep.engine)

    @pytest.mark.chaos
    def test_cancel_while_parked_awaiting_handoff(self):
        router, (p_rep, d_rep) = _disagg_router()
        P, D = p_rep.engine, d_rep.engine
        busy = [D.put(p, max_new_tokens=48, eos_token_id=-1, uid=u)
                for p, u in zip(_prompts(5, 2), (9101, 9102))]
        for _ in range(2):
            D.step()
        uid = router.put(_prompts(1, 4)[0], max_new_tokens=8)
        router.step()
        for _ in range(64):
            if p_rep.handoff_ready():
                break
            P.step()
        router.step()                      # no decode capacity: parked
        assert router._reqs[uid].state == "inflight"
        assert router.snapshot()["handoffs"] == 0
        router._reqs[uid].deadline_ms = 1e-9
        router.step()
        with pytest.raises(DeadlineExceeded):
            router.get(uid)
        assert uid not in P._decode_hold
        _pool_closed(P)
        snap = router.snapshot()
        assert snap["expired"] == 1 and snap["handoffs"] == 0
        while not all(D.is_done(u) for u in busy):
            D.step()
        for u in busy:
            D.get(u)
        _pool_closed(D)

    def test_losing_the_decode_side_degrades_to_colocated(self):
        """With its decode replica dead the fleet is colocated again: the
        prefill replica releases its parks and decodes them itself."""
        router, (p_rep, d_rep) = _disagg_router()
        uids = [router.put(p, max_new_tokens=8) for p in _prompts(1, 4)[:2]]
        d_rep.mark_dead("test")
        _run(router)
        for uid, w in zip(uids, _ref_outputs()[:2]):
            np.testing.assert_array_equal(router.get(uid), w)
        assert router.snapshot()["handoffs"] == 0
        _pool_closed(p_rep.engine)


# ---------------------------------------------------- serving fault points

@pytest.mark.parametrize("point", fault_injection.SERVING_POINTS)
def test_serving_points_fired_and_armed(point):
    """Every serving point is fired in deepspeed_tpu_torch/ and armed by a
    test of this file or of test_torch_kv_transfer.py, with the JAX blast
    radius."""
    pkg = os.path.join(ROOT, "deepspeed_tpu_torch")
    fired = False
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    fired |= f'fire("{point}")' in fh.read()
    assert fired, point
    text = ""
    for name in ("test_torch_router.py", "test_torch_kv_transfer.py"):
        with open(os.path.join(ROOT, "tests", name)) as fh:
            text += fh.read()
    assert f'arm("{point}"' in text or (
        point in ("kv_stream", "kv_import")
        and '"point", ["kv_stream", "kv_import"]' in text), point
    assert fault_injection.BLAST_RADIUS[point] == jfi.BLAST_RADIUS[point]


# --------------------------------------------- the JAX router, scripted

def _port_side():
    return dict(Router=Router, Replica=Replica, fi=fault_injection,
                errors=(Overloaded, DeadlineExceeded), engine=_engine)


def _jax_side():
    jm, params, _ = _models()

    def engine():
        return JEngine(jm, params=params,
                       config=dict(BASE, paged_kernel=False,
                                   prefix_cache=False))

    return dict(Router=JRouter, Replica=JReplica, fi=jfi,
                errors=(JOverloaded, JDeadline), engine=engine)


def _scripted(side, roles):
    """Requests of three classes with deadlines on a fake clock (10 ms a
    round) through a two-replica fleet (``roles``), with a dispatch fault,
    a replica death or handoff faults armed; -> (outcome per put, the
    placement of every request after every round, snapshot)."""
    fi = side["fi"]
    fi.reset()
    reps = [side["Replica"](f"r{i}", side["engine"](), role=role)
            for i, role in enumerate(roles)]
    router = side["Router"](reps, config=dict(router_queue_depth=6))
    clock = [0.0]
    router._now = lambda: clock[0]
    fi.arm("serve_dispatch", fails=1, skip=1)
    if roles[0] == "colocated":
        fi.arm("replica_death", fails=1, skip=5)
    else:
        fi.arm("kv_stream", fails=1, skip=1)
        fi.arm("kv_import", fails=1, skip=2)
    requests = [dict(klass=k % 3) for k in range(7)]
    requests[4]["ttft_deadline_ms"] = 25.0       # expires while queued
    requests[2]["deadline_ms"] = 80.0            # expires mid-flight
    outcome = {}
    uids = []
    for i, (p, kw) in enumerate(zip(_prompts(21, 7), requests)):
        try:
            uids.append(router.put(p, max_new_tokens=6, **kw))
        except side["errors"][0] as e:
            outcome[f"put{i}"] = ("Overloaded", e.klass, e.queue_depth)
    placement = []
    rounds = 0
    while router.has_work:
        clock[0] += 0.01
        router.step()
        placement.append({u: (r.state, r.replica)
                          for u, r in router._reqs.items()})
        rounds += 1
        assert rounds < 400
    snap = router.snapshot()
    for u in uids:
        try:
            outcome[u] = [int(t) for t in router.get(u)]
        except side["errors"] as e:
            outcome[u] = (type(e).__name__, e.klass,
                          getattr(e, "which", None))
    fi.reset()
    return outcome, placement, snap


@pytest.mark.chaos
@pytest.mark.parametrize("roles", [("colocated", "colocated"),
                                   ("prefill", "decode")])
def test_scripted_scenario_matches_jax_router(tmp_path, monkeypatch, roles):
    monkeypatch.setenv("DSTPU_AUTOTUNE_CACHE",
                       str(tmp_path / "kernel_autotune.json"))
    monkeypatch.delenv("DSTPU_AUTOTUNE", raising=False)
    kernel_dispatch.reset()
    try:
        want = _scripted(_jax_side(), roles)
    finally:
        kernel_dispatch.reset()
    got = _scripted(_port_side(), roles)
    assert got[0] == want[0]
    assert got[1] == want[1]
    # a payload's byte count holds decimal CRCs and a host clock stamp in
    # its JSON header, so it may differ by a few bytes between the two
    ours, theirs = dict(got[2]), dict(want[2])
    assert abs(ours.pop("kv_stream_bytes")
               - theirs.pop("kv_stream_bytes")) < 64 * ours["handoffs"] + 1
    assert ours == theirs
    # the scenario exercised what it arms
    kinds = {v[0] for v in got[0].values() if isinstance(v, tuple)}
    assert {"Overloaded", "DeadlineExceeded"} <= kinds
    assert ours["dispatch_retries"] == 1
    if roles[0] == "colocated":
        assert ours["failovers"] == 1 and ours["replayed"] > 0
    else:
        assert ours["handoffs"] > 0 and ours["kv_stream_retries"] == 2
