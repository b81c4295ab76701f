"""Serving telemetry: per-request TTFT / TPOT accounting for the v2
engine.

Own copy of the serving half of ``deepspeed_tpu/monitor/telemetry.py``
(``percentile``, ``_ReqTimes``, ``ServingTelemetry``), standard library and
numpy only. The training collector, the cluster aggregator and the
profiler control of that module are not ported (ROADMAP Queue 1, M14:
monitor and profiling). Emitted tags are the JAX package's
``Serve/Telemetry/*``; ``monitor`` is any object with ``enabled`` and
``write_events(events)``.
"""

import time
from collections import deque

import numpy as np


def percentile(samples, p):
    """Guarded percentile: None on an empty window (never a NaN in a
    report)."""
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, np.float64), p))


# -------------------------------------------------------------- serving side
class _ReqTimes:
    __slots__ = ("t_put", "t_first", "t_last", "pending")

    def __init__(self, t_put):
        self.t_put = t_put
        self.t_first = None
        self.t_last = None
        self.pending = 0


class ServingTelemetry:
    """Per-request TTFT/TPOT accounting for the v2 serving engine.

    TPOT is dispatch-amortized: the engine produces tokens in multi-step
    dispatches, so per-token deltas inside one dispatch are meaningless
    — tokens accumulate as ``pending`` and the wall time since the
    previous dispatch is split across them at :meth:`on_dispatch` (one
    call per ``engine.step()``). Sample windows are bounded deques;
    percentiles come from the window (the histogram the fan-out
    exports). With a ``monitor``, ``Serve/Telemetry/*`` events are
    written every ``interval`` completed requests, stepped by the
    completion count."""

    def __init__(self, monitor=None, interval=32, max_samples=4096):
        self.monitor = monitor
        self.interval = max(1, int(interval))
        self._live = {}
        # requests past their first token — the only ones on_dispatch
        # must visit; iterating _live would make every dispatch O(queued)
        # under an admission backlog
        self._started = {}
        self._ttft_ms = deque(maxlen=max_samples)
        self._tpot_ms = deque(maxlen=max_samples)
        self.completed = 0
        self.rejected = 0
        self.active = 0
        self._emitted_at = 0
        # engine-attached PrefixCache (inference/v2/prefix_cache.py);
        # when set, its hit/eviction/CoW counters ride percentiles()
        # and the Serve/Telemetry fan-out
        self._prefix_cache = None
        # speculative decoding: per-round counters plus acceptance-rate
        # EMAs keyed by request class (the router's priority klass) —
        # all zero/empty and absent from percentiles() until the first
        # on_spec_round, so spec-off snapshots stay byte-identical
        self._klass = {}                 # uid -> request class
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self._spec_ema = None            # global acceptance EMA
        self._spec_class_ema = {}        # klass -> acceptance EMA
        # disaggregated serving: requests that left via a prefill->
        # decode handoff (out) or arrived through one (in). Zero and
        # absent from percentiles() on colocated engines, so
        # disagg-off snapshots stay byte-identical.
        self.handoffs_in = 0
        self.handoffs_out = 0
        self._t0 = time.perf_counter()

    def attach_prefix_cache(self, cache):
        self._prefix_cache = cache

    def on_submit(self, uid, klass=0):
        self._live[uid] = _ReqTimes(time.perf_counter())
        self._klass[uid] = int(klass)

    def on_token(self, uid):
        """First token => TTFT sample; later tokens accumulate for the
        dispatch-boundary TPOT split."""
        st = self._live.get(uid)
        if st is None:
            return
        now = time.perf_counter()
        if st.t_first is None:
            st.t_first = st.t_last = now
            self._started[uid] = st
            self._ttft_ms.append((now - st.t_put) * 1e3)
        else:
            st.pending += 1

    def _flush_pending(self, st, now):
        if st.pending and st.t_last is not None:
            per_ms = (now - st.t_last) * 1e3 / st.pending
            # one sample per token, capped so a giant dispatch cannot
            # flood the window
            self._tpot_ms.extend([per_ms] * min(st.pending, 64))
        st.t_last = now
        st.pending = 0

    def on_dispatch(self, active=None):
        now = time.perf_counter()
        for st in self._started.values():
            self._flush_pending(st, now)
        if active is not None:
            self.active = int(active)

    def on_spec_round(self, uid, accepted, proposed, committed):
        """One speculative verify round for ``uid``: ``accepted`` of
        ``proposed`` draft tokens survived greedy verification and
        ``committed`` tokens (accepted + bonus) entered the stream.
        Updates the global and per-request-class acceptance EMAs the
        scheduler/router read for fallback and placement."""
        self.spec_rounds += 1
        self.spec_proposed += int(proposed)
        self.spec_accepted += int(accepted)
        self.spec_committed += int(committed)
        frac = accepted / max(1, proposed)
        a = 0.25                          # matches SPEC_EMA_ALPHA
        self._spec_ema = frac if self._spec_ema is None \
            else (1 - a) * self._spec_ema + a * frac
        k = self._klass.get(uid, 0)
        prev = self._spec_class_ema.get(k)
        self._spec_class_ema[k] = frac if prev is None \
            else (1 - a) * prev + a * frac

    def spec_acceptance_ema(self, klass=None):
        """Acceptance-rate EMA in [0, 1] — per request class when
        ``klass`` is given, global otherwise; None before the first
        verify round (spec off, or nothing speculated yet)."""
        if klass is None:
            return self._spec_ema
        return self._spec_class_ema.get(int(klass))

    def on_finish(self, uid):
        st = self._live.pop(uid, None)
        self._started.pop(uid, None)
        self._klass.pop(uid, None)
        if st is not None and st.t_first is not None:
            self._flush_pending(st, time.perf_counter())
        self.completed += 1

    def on_reject(self, uid):
        """A shed/expired/cancelled request leaves the accounting
        entirely: it has no dispatch boundary to amortize against, so
        leaving it in the maps would poison the TTFT/TPOT windows
        (zero/None samples at the next dispatch) and ``completed``
        would count requests that were never served. Percentile windows
        therefore hold ONLY requests that actually produced tokens to
        completion."""
        st = self._live.pop(uid, None)
        self._started.pop(uid, None)
        self._klass.pop(uid, None)
        if st is not None:
            self.rejected += 1

    # --------------------------- disaggregated prefill/decode handoff
    def submit_stamp(self, uid):
        """Original submit time (``time.perf_counter`` domain) of a
        live request — exported with the KV handoff payload so the
        decode side anchors its windows on the ORIGINAL submit, not
        its own admit time. Peek only; the request stays live here
        until :meth:`on_handoff_out`."""
        st = self._live.get(uid)
        return None if st is None else st.t_put

    def klass_of(self, uid):
        """Request class of a live request (0 when unknown) — carried
        across the handoff so per-class windows stay coherent."""
        return self._klass.get(uid, 0)

    def on_handoff_out(self, uid):
        """The request left THIS engine via a prefill->decode handoff:
        forget it WITHOUT counting a rejection — its TTFT sample (the
        first token was produced here) stays in the window, and the
        decode side owns the rest of its accounting."""
        self._live.pop(uid, None)
        self._started.pop(uid, None)
        self._klass.pop(uid, None)
        self.handoffs_out += 1

    def on_handoff_in(self, uid, klass=0, submit_ts=None):
        """Register a handed-off request on the DECODE side, anchored
        at the ORIGINAL submit stamp carried over the wire (decode-side
        admit time would hide the whole prefill+stream latency). The
        request arrives already STARTED — its first token was produced
        by the prefill replica, so no second TTFT sample is recorded
        here; subsequent tokens amortize TPOT from this boundary.

        Clock-domain caveat: the stamp is exact for the in-process
        transport (same ``perf_counter`` domain). Over the DCN
        transport the stamp comes from another host's clock — counters
        stay exact, latency windows are advisory there."""
        now = time.perf_counter()
        st = _ReqTimes(now if submit_ts is None else float(submit_ts))
        st.t_first = st.t_last = now
        self._live[uid] = st
        self._started[uid] = st
        self._klass[uid] = int(klass)
        self.handoffs_in += 1

    def percentiles(self):
        out = {
            "ttft_ms_p50": percentile(self._ttft_ms, 50),
            "ttft_ms_p99": percentile(self._ttft_ms, 99),
            "tpot_ms_p50": percentile(self._tpot_ms, 50),
            "tpot_ms_p99": percentile(self._tpot_ms, 99),
            "completed": self.completed,
            "active": self.active,
        }
        if self.rejected:
            # only present once a cancel/shed happened: router-off
            # engine snapshots stay byte-identical to pre-router runs
            out["rejected"] = self.rejected
        if self.handoffs_in or self.handoffs_out:
            # only present once a handoff touched this engine:
            # colocated snapshots stay byte-identical
            out["handoffs_in"] = self.handoffs_in
            out["handoffs_out"] = self.handoffs_out
        if self._prefix_cache is not None:
            s = self._prefix_cache.stats()
            elapsed = max(1e-9, time.perf_counter() - self._t0)
            out["prefix_hit_rate_pct"] = s["hit_rate_pct"]
            out["cached_tokens_per_sec"] = round(
                s["cached_tokens"] / elapsed, 1)
            out["prefix_evictions"] = s["evicted_blocks"]
            out["cow_copies"] = s["cow_copies"]
        if self.spec_rounds:
            # only present once a verify round ran: the zero-verify-step
            # guard — spec-off (and spec-on-but-idle) windows carry no
            # spec keys at all rather than NaN/zero-division rows
            out["spec_rounds"] = self.spec_rounds
            out["spec_acceptance_pct"] = round(
                100.0 * self.spec_accepted / max(1, self.spec_proposed),
                1)
            out["spec_tokens_per_verify_step"] = round(
                self.spec_committed / self.spec_rounds, 2)
            out["spec_class_acceptance_ema"] = {
                k: round(v, 3)
                for k, v in sorted(self._spec_class_ema.items())}
        return out

    def maybe_emit(self):
        if self.monitor is None \
                or not getattr(self.monitor, "enabled", False) \
                or self.completed - self._emitted_at < self.interval:
            return
        self._emitted_at = self.completed
        p = self.percentiles()
        step = self.completed
        events = [("Serve/Telemetry/completed", p["completed"], step),
                  ("Serve/Telemetry/active", p["active"], step)]
        for tag, key in (
                ("Serve/Telemetry/ttft_ms_p50", "ttft_ms_p50"),
                ("Serve/Telemetry/ttft_ms_p99", "ttft_ms_p99"),
                ("Serve/Telemetry/tpot_ms_p50", "tpot_ms_p50"),
                ("Serve/Telemetry/tpot_ms_p99", "tpot_ms_p99"),
                # prefix-cache effectiveness (only present with an
                # attached PrefixCache — see attach_prefix_cache)
                ("Serve/Telemetry/prefix_hit_rate_pct",
                 "prefix_hit_rate_pct"),
                ("Serve/Telemetry/cached_tokens_per_sec",
                 "cached_tokens_per_sec"),
                ("Serve/Telemetry/prefix_evictions", "prefix_evictions"),
                ("Serve/Telemetry/cow_copies", "cow_copies"),
                # speculative decoding (only present once a verify
                # round ran; spec_class_acceptance_ema is a dict and
                # rides percentiles()/snapshots only, not the scalar
                # event fan-out)
                ("Serve/Telemetry/spec_rounds", "spec_rounds"),
                ("Serve/Telemetry/spec_acceptance_pct",
                 "spec_acceptance_pct"),
                ("Serve/Telemetry/spec_tokens_per_verify_step",
                 "spec_tokens_per_verify_step")):
            if p.get(key) is not None:
                events.append((tag, p[key], step))
        self.monitor.write_events(events)
