"""Replica handle + health state machine for the serving front-end.

Own copy of ``deepspeed_tpu/inference/v2/replica.py``. One
:class:`Replica` wraps one :class:`InferenceEngineV2` in this process
(several replicas may share one card and one model's weights) and owns
the health contract the router dispatches against:

  * state machine ``live -> draining -> dead`` (``live -> dead`` on
    failure). Draining replicas finish their in-flight requests but
    admit nothing new (serving scale-down).
  * heartbeat = recent ``step()`` progress: every completed scheduler
    iteration stamps ``last_progress``; ``max_step_failures``
    CONSECUTIVE injected/IO step failures (the ``serve_step`` fault
    point) mean the heartbeat is broken and the replica declares
    itself dead.
  * ``replica_death`` (fatal blast radius) fires at the top of every
    step — arming it models the replica worker dying mid-decode. The
    failure propagates as :class:`ReplicaDead`; the ROUTER is the
    supervising recovery layer that catches it and replays the
    replica's in-flight requests on a survivor.

The fault points deliberately live HERE, at the replica boundary, not
inside engine_v2: the engine is shared with single-replica serving and
must stay byte-identical with the router off.
"""

import time

import numpy as np

from ...utils import fault_injection
from ...utils.logging import log_dist

LIVE = "live"
DRAINING = "draining"
DEAD = "dead"

# Phase roles for disaggregated serving. "colocated" replicas run
# prefill and decode interleaved through split-fuse (the pre-disagg
# behavior and the default). In an actively disaggregated fleet (the
# router turns it on iff both phase roles are live), "prefill"
# replicas run chunked prefill to the last prompt token, post the
# first generated token, then park the sequence for a KV handoff
# instead of decoding; "decode" replicas take no fresh dispatches and
# admit handed-off sequences directly into their decode batch.
ROLES = ("colocated", "prefill", "decode")


class ReplicaDead(RuntimeError):
    """Terminal replica failure. Raised out of :meth:`Replica.step` —
    the fatal blast-radius contract: nothing below the router may
    swallow it. The router catches it, fails the replica out of the
    rotation, and replays its in-flight requests on a survivor."""

    def __init__(self, name, reason):
        super().__init__(f"replica {name!r} died: {reason}")
        self.name = name
        self.reason = reason


class Replica:
    """Health-tracked handle around one in-process replica engine."""

    def __init__(self, name, engine, max_step_failures=3,
                 role="colocated"):
        if role not in ROLES:
            raise ValueError(
                f"role must be one of {ROLES}, got {role!r}")
        if getattr(engine, "multi_rank", False):
            raise NotImplementedError(
                "a replica whose engine spans ranks (tensor_parallel / "
                "expert_parallel > 1) is not ported yet (ROADMAP Queue 1, "
                "serving: multi-rank replicas)")
        self.name = name
        self.engine = engine
        self.role = role
        # router-driven: the prefill-role park/handoff behavior engages
        # only while the FLEET is actually disaggregated (both phase
        # roles live) — the router re-resolves this every round, so a
        # fleet that loses its last decode replica degrades to
        # colocated behavior instead of deadlocking held sequences
        self._disaggregated = False
        self.state = LIVE
        # True when the terminal state was reached via a clean drain
        # (finished in-flight, nothing replayed) rather than a failure
        self.drained = False
        self.inflight = []            # router uids in dispatch order
        self.steps = 0                # completed scheduler iterations
        self.step_failures = 0        # injected/IO step failures survived
        self._consecutive_failures = 0
        self.max_step_failures = max(1, int(max_step_failures))
        self.last_progress = time.monotonic()

    # -------------------------------------------------------------- state
    @property
    def live(self):
        return self.state == LIVE

    @property
    def draining(self):
        return self.state == DRAINING

    @property
    def dead(self):
        return self.state == DEAD

    @property
    def has_work(self):
        return bool(self.inflight) or self.engine.has_work

    @property
    def slots(self):
        return self.engine.config.max_batch_size

    def heartbeat_age(self, now=None):
        """Seconds since the last completed step() — the router's
        liveness signal (heartbeat = recent step progress)."""
        return (time.monotonic() if now is None else now) \
            - self.last_progress

    def drain(self):
        """Stop admitting; in-flight requests run to completion, then
        the router removes the replica from the rotation."""
        if self.state == LIVE:
            self.state = DRAINING
            log_dist(f"replica {self.name}: draining "
                     f"({len(self.inflight)} in flight)", ranks=[0])

    def mark_dead(self, reason, drained=False):
        self.state = DEAD
        self.drained = drained
        if not drained:
            log_dist(f"replica {self.name}: DEAD ({reason})", ranks=[0])

    # --------------------------------------------------------- dispatching
    def fits(self, prompt_len, max_new_tokens):
        """Whether the request could EVER be served here (context +
        pool capacity), regardless of current load."""
        eng = self.engine
        if prompt_len + max_new_tokens > eng.max_seq_len:
            return False
        mgr = eng.state_mgr
        return mgr.blocks_needed(prompt_len + max_new_tokens) \
            <= mgr.allocator.total_blocks

    def can_accept(self, prompt_len, max_new_tokens, prompt=None):
        """Admission probe the router dispatches against: live, no
        request already parked in the engine's own pending queue (whose
        blocks can_admit cannot see yet), and the state manager has the
        slot + pool capacity to admit NOW."""
        if self.state != LIVE:
            return False
        eng = self.engine
        if eng._pending:
            return False
        if eng.state_mgr.free_slots == 0:
            # cheap probe before can_admit's pool/radix capacity scan
            return False
        if not self.fits(prompt_len, max_new_tokens):
            return False
        return eng.state_mgr.can_admit(prompt_len, max_new_tokens,
                                       prompt=prompt)

    def prefix_score(self, prompt):
        """Longest cached prefix (tokens) this replica's radix tree
        holds for ``prompt`` — the router's prefix-affinity key. Uses
        the PURE ``match()`` probe: no refs, no stats, no LRU touch, so
        affinity probing never skews the cache's hit accounting."""
        pc = self.engine.prefix_cache
        if pc is None:
            return 0
        return int(pc.match(np.asarray(prompt, np.int32)).cached_len)

    @property
    def spec_acceptance(self):
        """Speculative-decoding acceptance EMA of this replica's engine
        (global, [0, 1]) — None when the engine has no draft model, no
        telemetry, or has not run a verify round yet. The router's
        health snapshot surfaces it per replica."""
        tel = getattr(self.engine, "telemetry", None)
        if tel is None:
            return None
        fn = getattr(tel, "spec_acceptance_ema", None)
        return fn() if fn is not None else None

    def submit(self, uid, prompt, max_new_tokens, eos_token_id=-1,
               klass=0):
        """Hand one admitted request to the engine. ``serve_dispatch``
        fires FIRST (retryable): an injected dispatch failure leaves no
        partial state and the router re-queues the request. ``klass``
        rides through to the engine so serving telemetry can key its
        acceptance EMAs by request class."""
        fault_injection.fire("serve_dispatch")
        self.engine.put(prompt, max_new_tokens=max_new_tokens,
                        eos_token_id=eos_token_id, uid=uid, klass=klass)
        if self._disaggregated:
            # prefill role: the sequence prefills here, posts its first
            # token, then waits for the KV handoff instead of decoding
            self.engine.hold_decode(uid)
        self.inflight.append(uid)

    def cancel(self, uid):
        """Withdraw one in-flight request (deadline expiry): the engine
        flushes it through the unref-without-insert path."""
        if uid in self.inflight:
            self.inflight.remove(uid)
            self.engine.cancel(uid)

    # ------------------------------------- disaggregated prefill/decode
    def set_disaggregated(self, on):
        """Router hook, called every round with the fleet-wide verdict.
        Only a prefill-role replica ever engages; flipping OFF releases
        every parked sequence so it resumes decoding HERE (the
        colocated-degradation path when the decode side is gone)."""
        on = bool(on) and self.role == "prefill"
        if self._disaggregated and not on:
            self.engine.release_decode_hold()
        self._disaggregated = on

    def handoff_ready(self):
        """uids parked after completing prefill (first token posted) —
        the router streams these to a decode replica. Empty unless this
        is a prefill replica in an actively disaggregated fleet."""
        if not self._disaggregated or self.dead:
            return []
        eng = self.engine
        ready = []
        for uid in self.inflight:
            if uid not in eng._decode_hold:
                continue    # finished at its first token, or not parked
            seq = eng.state_mgr._seqs.get(uid)
            if seq is not None and seq.generated:
                ready.append(uid)
        return ready

    def export_handoff(self, uid):
        """Serialize ``uid``'s KV blocks + descriptor state to wire
        bytes. The sequence stays owned here until
        :meth:`finish_handoff` — a failed stream retries from unchanged
        state."""
        from . import kv_transfer
        return kv_transfer.export_sequence(self.engine, uid)

    def import_handoff(self, payload):
        """Decode side of the handoff. ``replica_death`` fires first —
        arming it here models the decode replica dying MID-TRANSFER;
        the router observes :class:`ReplicaDead` and re-enqueues the
        request at the front for a colocated / re-prefill replay
        (byte-identical by greedy construction). The retryable
        ``kv_import`` point fires inside the import path BEFORE any
        decode-side mutation. Returns the imported uid; the router owns
        the in-flight bookkeeping."""
        if self.state == DEAD:
            raise ReplicaDead(self.name, "handoff import after death")
        try:
            fault_injection.fire("replica_death")
        except fault_injection.FaultError as e:
            self.mark_dead("injected replica death mid-transfer")
            raise ReplicaDead(self.name, str(e)) from e
        from . import kv_transfer
        return kv_transfer.import_sequence(self.engine, payload)

    def finish_handoff(self, uid):
        """The decode side confirmed the import: release the sequence
        here (prefix insert + pool close, no rejection counted) and
        drop it from this replica's in-flight list."""
        if uid in self.inflight:
            self.inflight.remove(uid)
        self.engine.release_handoff(uid)

    # --------------------------------------------------------------- step
    def step(self):
        """One engine scheduler iteration. Fires ``replica_death``
        (fatal: propagates as :class:`ReplicaDead`) and ``serve_step``
        (retryable: counted; ``max_step_failures`` consecutive failures
        break the heartbeat and the replica dies). Returns the engine's
        (uid, token) pairs."""
        if self.state == DEAD:
            raise ReplicaDead(self.name, "stepped after death")
        try:
            fault_injection.fire("replica_death")
        except fault_injection.FaultError as e:
            self.mark_dead("injected replica death")
            raise ReplicaDead(self.name, str(e)) from e
        # SimulatedKill (kill=True) is deliberately NOT caught: it is a
        # BaseException modeling SIGKILL of the whole front-end process
        # — no layer may convert it into a recoverable event.
        try:
            fault_injection.fire("serve_step")
            if getattr(self.engine, "spec_pending", False):
                # the next step would run a speculative verify dispatch:
                # ``serve_verify`` (retryable) models a failure landing
                # exactly there, while proposals are tentatively
                # appended — the engine's rollback must leave no trace
                # and the failover replay must stay byte-identical
                fault_injection.fire("serve_verify")
            out = self.engine.step()
        except fault_injection.FaultError as e:
            self.step_failures += 1
            self._consecutive_failures += 1
            if self._consecutive_failures >= self.max_step_failures:
                self.mark_dead(
                    f"no step progress after "
                    f"{self._consecutive_failures} consecutive failures")
                raise ReplicaDead(self.name, str(e)) from e
            return []
        self._consecutive_failures = 0
        self.steps += 1
        self.last_progress = time.monotonic()
        return out
