"""The port's serving telemetry (``monitor/telemetry.py``
``ServingTelemetry`` and the engine's hooks) held against the JAX
package on CPU: one scripted event sequence under a fake clock gives the
same windows, percentiles, counters and monitor events in both; the JAX
package's own unit cases; and the v2 engine with telemetry on gives the
same snapshot keys and counts as the JAX engine on the same requests
(tiny fp32 Llamas, the JAX engine on its dense-gather path)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.monitor import telemetry as jtel
from deepspeed_tpu.monitor.tag_schema import TAG_SCHEMA
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy
from deepspeed_tpu_torch.monitor import telemetry as ptel
from deepspeed_tpu_torch.monitor.telemetry import ServingTelemetry

BASE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
            max_batch_size=2, splitfuse_tokens=16,
            decode_steps_per_dispatch=2)


class _Mon:
    enabled = True

    def __init__(self):
        self.events = []

    def write_events(self, events):
        self.events.extend(events)


@pytest.fixture
def clock(monkeypatch):
    """A fake ``time.perf_counter`` (both packages' telemetry read it)."""
    now = {"t": 100.0}
    monkeypatch.setattr(time, "perf_counter", lambda: now["t"])
    return now


def _script(tel_cls, clock):
    """One serving story: submits of three classes, first tokens,
    multi-token dispatches, a reject while queued and one after a token,
    a handoff out and one in at the original stamp, speculative rounds,
    completions; -> (telemetry, monitor, snapshots after each phase)."""
    mon = _Mon()
    st = tel_cls(monitor=mon, interval=2, max_samples=16)
    peer = tel_cls(interval=1)
    snaps = []

    def tick(ms):
        clock["t"] += ms / 1e3

    for uid in range(6):
        st.on_submit(uid, klass=uid % 3)
        tick(1.5)
    peer.on_submit(50, klass=2)
    tick(4.0)
    peer.on_token(50)
    stamp = peer.submit_stamp(50)
    peer.on_handoff_out(50)
    for uid in (0, 1, 2):
        tick(7.25)
        st.on_token(uid)
    st.on_handoff_in(50, klass=peer.klass_of(50), submit_ts=stamp)
    st.on_dispatch(active=4)
    snaps.append(st.percentiles())
    for step in range(5):
        tick(3.0 + step)
        for uid in (0, 1, 2, 50):
            for _ in range(step + 1):
                st.on_token(uid)
        st.on_spec_round(1, accepted=step % 3, proposed=3,
                         committed=step % 3 + 1)
        st.on_dispatch(active=4)
        st.maybe_emit()
    st.on_reject(3)                       # queued: never started
    st.on_token(4)
    st.on_reject(4)                       # after a token
    st.on_reject(4)                       # idempotent
    for uid in (0, 50, 1):
        tick(2.0)
        st.on_finish(uid)
        st.maybe_emit()
    st.on_token(99)                       # unknown uid: ignored
    st.on_finish(99)
    snaps.append(st.percentiles())
    snaps.append(peer.percentiles())
    return st, mon, snaps


def test_scripted_sequence_matches_jax(clock):
    t0 = clock["t"]
    ours, our_mon, our_snaps = _script(ServingTelemetry, clock)
    clock["t"] = t0
    theirs, their_mon, their_snaps = _script(jtel.ServingTelemetry, clock)
    assert our_snaps == their_snaps
    assert list(ours._ttft_ms) == list(theirs._ttft_ms)
    assert list(ours._tpot_ms) == list(theirs._tpot_ms)
    assert our_mon.events == their_mon.events
    assert {t for t, _, _ in our_mon.events} <= set(TAG_SCHEMA)
    for k in (None, 0, 1, 2):
        assert ours.spec_acceptance_ema(k) == theirs.spec_acceptance_ema(k)
    for name in ("completed", "rejected", "active", "handoffs_in",
                 "handoffs_out", "spec_rounds", "spec_proposed",
                 "spec_accepted", "spec_committed"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert set(ours._live) == set(theirs._live) == {2, 5}
    assert our_snaps[1]["rejected"] == 2
    assert our_snaps[1]["handoffs_in"] == 1


@pytest.mark.parametrize("samples", [[], [3.0], [1.0, 5.0, 2.0, 9.5]])
@pytest.mark.parametrize("p", [50, 99])
def test_percentile_matches_jax(samples, p):
    assert ptel.percentile(samples, p) == jtel.percentile(samples, p)


class TestServingTelemetry:
    def test_ttft_tpot_accounting(self, clock):
        st = ServingTelemetry(interval=1)
        st.on_submit(1)
        clock["t"] += 0.02
        st.on_token(1)                     # first token -> TTFT
        clock["t"] += 0.01
        for _ in range(4):
            st.on_token(1)                 # one dispatch, 4 tokens
        st.on_dispatch(active=1)
        p = st.percentiles()
        assert p["ttft_ms_p50"] == pytest.approx(20.0)
        assert p["tpot_ms_p50"] == pytest.approx(2.5)
        st.on_finish(1)
        assert st.percentiles()["completed"] == 1

    def test_emits_through_monitor(self):
        mon = _Mon()
        st = ServingTelemetry(monitor=mon, interval=1)
        st.on_submit(5)
        st.on_token(5)
        st.on_finish(5)
        st.maybe_emit()
        tags = {t for t, _, _ in mon.events}
        assert {"Serve/Telemetry/completed",
                "Serve/Telemetry/ttft_ms_p50"} <= tags <= set(TAG_SCHEMA)

    def test_shed_heavy_traffic_does_not_poison_the_windows(self):
        st = ServingTelemetry(interval=1)
        for uid in range(10):
            st.on_submit(uid)
        for uid in (0, 1):
            st.on_token(uid)
            st.on_token(uid)
        st.on_dispatch(active=2)
        ttft, tpot = len(st._ttft_ms), len(st._tpot_ms)
        for uid in (0, 1):
            st.on_finish(uid)
        st.on_token(5)
        st.on_reject(5)
        for uid in (2, 3, 4, 6, 7, 8, 9):
            st.on_reject(uid)
        p = st.percentiles()
        assert p["completed"] == 2 and p["rejected"] == 8
        assert not st._live and not st._started
        st.on_dispatch(active=0)
        assert len(st._ttft_ms) == ttft + 1
        assert len(st._tpot_ms) == tpot
        st.on_reject(5)
        st.on_reject(0)
        assert st.percentiles()["rejected"] == 8

    def test_handoff_anchoring_spans_replicas(self, clock):
        tel_p = ServingTelemetry(interval=1)
        tel_d = ServingTelemetry(interval=1)
        tel_p.on_submit(7, klass=2)
        clock["t"] += 0.01
        tel_p.on_token(7)
        stamp = tel_p.submit_stamp(7)
        n = len(tel_p._ttft_ms)
        tel_p.on_handoff_out(7)
        p = tel_p.percentiles()
        assert p.get("rejected", 0) == 0 and p["handoffs_out"] == 1
        assert len(tel_p._ttft_ms) == n
        tel_d.on_handoff_in(7, klass=2, submit_ts=stamp)
        assert tel_d.klass_of(7) == 2 and tel_d.submit_stamp(7) == stamp
        tel_d.on_token(7)
        tel_d.on_token(7)
        clock["t"] += 0.004
        tel_d.on_dispatch(active=1)
        d = tel_d.percentiles()
        assert d["ttft_ms_p50"] is None      # no second TTFT sample
        assert d["tpot_ms_p50"] == pytest.approx(2.0)
        assert d["handoffs_in"] == 1

    def test_keys_absent_until_used(self):
        st = ServingTelemetry()
        st.on_submit(1)
        st.on_token(1)
        st.on_finish(1)
        p = st.percentiles()
        assert set(p) == {"ttft_ms_p50", "ttft_ms_p99", "tpot_ms_p50",
                          "tpot_ms_p99", "completed", "active"}

    def test_dispatch_skips_queued_requests(self):
        st = ServingTelemetry()
        for uid in range(50):
            st.on_submit(uid)
        st.on_submit("hot")
        st.on_token("hot")
        st.on_token("hot")
        assert set(st._started) == {"hot"}
        st.on_dispatch(active=1)
        st.on_finish("hot")
        assert not st._started and len(st._live) == 50


# ------------------------------------------------------ engine telemetry

_MODELS = []


def _models():
    if not _MODELS:
        jm = JLlama(dataclasses.replace(J_TINY, dtype="float32"))
        params = jm.init(jax.random.key(0))
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                   device="cpu", dtype=torch.float32)
        pm.load_state_dict(llama_params_from_numpy(
            jax.tree.map(np.asarray, params), "cpu", torch.float32))
        _MODELS.extend((jm, params, pm))
    return _MODELS


def _drive(eng, prompts):
    """Submit, cancel one queued and one decoding request, finish the
    rest; -> (snapshot after each phase, streams)."""
    uids = [eng.put(p, max_new_tokens=24 if i == 0 else 6, klass=i % 2)
            for i, p in enumerate(prompts)]
    snaps = [eng.telemetry_snapshot()]
    eng.cancel(uids[-1])                   # still queued
    for _ in range(4):
        eng.step()
    snaps.append(eng.telemetry_snapshot())
    assert not eng.is_done(uids[0]) and len(eng.get(uids[0], flush=False))
    eng.cancel(uids[0])                    # decoding
    while eng.has_work:
        eng.step()
    snaps.append(eng.telemetry_snapshot())
    return snaps, [np.asarray(eng.get(u)) for u in uids[1:-1]]


def test_engine_snapshots_match_jax():
    jm, params, pm = _models()
    rs = np.random.RandomState(5)
    prompts = [rs.randint(1, 255, size=n).astype(np.int32)
               for n in (7, 12, 20, 9, 5)]
    jmon, pmon = _Mon(), _Mon()
    jeng = JEngine(jm, params=params, monitor=jmon,
                   config=dict(BASE, paged_kernel=False, prefix_cache=False,
                               telemetry_interval=1))
    peng = InferenceEngineV2(pm, dict(BASE, telemetry_interval=1),
                             device="cpu", monitor=pmon)
    assert peng.config.telemetry is True   # the JAX default
    want, jstreams = _drive(jeng, prompts)
    got, pstreams = _drive(peng, prompts)
    for a, b in zip(pstreams, jstreams):
        np.testing.assert_array_equal(a, b)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("completed", "active", "rejected"):
            assert g.get(k) == w.get(k), k
        for k in ("ttft_ms_p50", "tpot_ms_p50"):
            assert (g[k] is None) == (w[k] is None), k
    assert got[-1]["completed"] == 3 and got[-1]["rejected"] == 2
    steps = [s for _, _, s in pmon.events]
    assert steps == [s for _, _, s in jmon.events]
    assert [t for t, _, _ in pmon.events] == [t for t, _, _ in jmon.events]
    assert {t for t, _, _ in pmon.events} <= set(TAG_SCHEMA)


def test_engine_telemetry_off():
    eng = InferenceEngineV2(_models()[2], dict(BASE, telemetry=False),
                            device="cpu", monitor=_Mon())
    assert eng.telemetry is None and eng.telemetry_snapshot() is None
    out = eng.generate_all([np.arange(1, 9)], max_new_tokens=3)
    assert len(out[0]) == 3
