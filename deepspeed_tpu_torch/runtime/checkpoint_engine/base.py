"""Checkpoint engine plugin interface.

Own copy of ``deepspeed_tpu/runtime/checkpoint_engine/base.py``
(reference ``runtime/checkpoint_engine/checkpoint_engine.py:9``, with the
fork's ``wait()/shutdown()`` for async engines; ``save_checkpoint_terminate``
does barrier -> wait -> shutdown -> barrier).

A "state_dict" here is ``(chunks, extra)``: a flat dict of host numpy
arrays plus JSON-able metadata; engines only move bytes. Device->host
staging is the caller's job (runtime/engine.py save_checkpoint copies
every shard to host memory before an engine sees it, so a write running
beside the next training step reads none of the live, in-place updated
state).

Robustness contract (all engines, as the JAX package's):
  * a save that raises has NOT called ``on_durable`` — the 'latest'
    pointer can never name a torn generation;
  * transient write failures are retried with capped exponential
    backoff (``save_retries`` / ``retry_backoff_s`` /
    ``retry_backoff_cap_s`` of CheckpointEngineConfig), then degrade to
    the engine's fallback writer when it has one (native -> the Python
    writer, async with a dead pool -> an in-caller write), counted in
    ``counters["fallbacks"]``;
  * every failed save version surfaces exactly ONE CheckpointSaveError
    from ``wait()``/``commit()`` — failed futures never wedge
    ``_inflight``;
  * ``counters`` records saves/loads/retries/fallbacks/errors under the
    JAX package's names (the hot-tier ones stay 0: M14).
"""

import time

from ...utils import fault_injection
from ...utils.logging import logger


class CheckpointSaveError(RuntimeError):
    """One save version failed durably (retries + fallback exhausted).
    Carries the version and target path so the operator knows exactly
    which generation is NOT on disk."""

    def __init__(self, version, path, cause):
        super().__init__(
            f"checkpoint save (version {version}) to {path} failed "
            f"after retries/fallback: {cause}")
        self.version = version
        self.path = path
        self.cause = cause


def _new_counters():
    return {
        "saves": 0,            # successful engine-level saves
        "loads": 0,
        "retries": 0,          # write attempts that failed and were retried
        "fallbacks": 0,        # saves completed by the degraded writer
        "save_errors": 0,      # versions that failed even after fallback
        "load_fallbacks": 0,   # loads served by an older durable tag
        "gc_removed": 0,       # tags deleted by retention GC
        # hot tier (checkpoint_engine/hot_tier.py)
        "hot_pushes": 0,       # local+peer replications completed
        "hot_push_errors": 0,  # advisory replica-push failures
        "hot_restores": 0,     # loads served from in-memory replicas
        "hot_fallbacks": 0,    # hot tier present but degraded to durable
        "durable_restores": 0,  # loads that DID read persistent storage
        # cross-slice replica tier (slice-aware hot_tier + MiCS
        # zero-replica registration)
        "replica_pushes": 0,     # cross-slice replica/zero-replica pushes
        "replica_restores": 0,   # loads served by the replica tier
        "replica_fallbacks": 0,  # replica tier present but degraded
    }


class CheckpointEngine:
    def __init__(self, config_params=None):
        self.config = config_params
        self.save_retries = int(getattr(config_params, "save_retries", 2))
        self.retry_backoff_s = float(
            getattr(config_params, "retry_backoff_s", 0.05))
        self.retry_backoff_cap_s = float(
            getattr(config_params, "retry_backoff_cap_s", 2.0))
        self.counters = _new_counters()

    def create(self, tag):
        """Log/prepare for a save under ``tag``."""

    def save(self, state_dict, path):
        raise NotImplementedError

    def load(self, path, map_location=None):
        raise NotImplementedError

    def commit(self, tag):
        """Mark ``tag`` durable (reference: nebula/veloc commit).
        Surfaces any already-completed failed save (non-blocking)."""
        return True

    def wait(self, version=None):
        """Block until async work for ``version`` (or all) is durable.
        Fork addition (veloc_checkpoint_engine.py wait). Raises
        CheckpointSaveError once per failed version."""
        return True

    def drain(self, version=None):
        """Like wait(), but never raises for failed saves (they stay
        queued for the next wait()/commit()). Load/recovery paths use
        this: a failed save must not block reading durable data."""
        return self.wait(version)

    def shutdown(self):
        """Drain and stop background machinery (fork addition)."""
        return True

    # ------------------------------------------------------- retry/degrade
    def _write_with_retry(self, attempt, fallback, desc):
        """Run ``attempt()`` with capped exponential backoff on failure;
        after ``save_retries`` failed retries, run ``fallback()`` (the
        degraded writer) when provided. SimulatedKill is never retried —
        it models SIGKILL. Raises the last error when everything fails
        (callers wrap it into CheckpointSaveError with version info)."""
        last = None
        for i in range(self.save_retries + 1):
            try:
                return attempt()
            except fault_injection.SimulatedKill:
                raise
            except Exception as e:  # noqa: BLE001 - any IO failure retries
                last = e
                if i < self.save_retries:
                    self.counters["retries"] += 1
                    delay = min(self.retry_backoff_cap_s,
                                self.retry_backoff_s * (2 ** i))
                    logger.warning(
                        f"checkpoint write to {desc} failed "
                        f"(attempt {i + 1}/{self.save_retries + 1}): {e}; "
                        f"retrying in {delay:.2f}s")
                    time.sleep(delay)
        if fallback is not None:
            try:
                result = fallback()
                self.counters["fallbacks"] += 1
                logger.warning(
                    f"checkpoint write to {desc} degraded to the "
                    f"fallback writer after {self.save_retries + 1} "
                    f"failed attempts ({last})")
                return result
            except fault_injection.SimulatedKill:
                raise
            except Exception as e:  # noqa: BLE001
                last = e
        raise last
