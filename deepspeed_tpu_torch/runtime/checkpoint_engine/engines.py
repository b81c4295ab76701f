"""Checkpoint engine implementations.

Own copy of ``deepspeed_tpu/runtime/checkpoint_engine/engines.py``
(reference engine.py:931-963 selection):
  * SyncCheckpointEngine   — torch_checkpoint_engine.py:12 equivalent.
  * AsyncCheckpointEngine  — async_checkpoint_engine.py:17 equivalent:
    device->host staging happens on the caller (the engine copies every
    shard to host memory first), serialization + file IO on a thread
    pool with a bounded in-flight window; ``wait()`` drains,
    ``shutdown()`` joins.
  * NativeCheckpointEngine — veloc_checkpoint_engine.py:42 equivalent:
    the same pipeline, the file write through the C++ writer pool
    (csrc/ckpt_writer.cpp, built with g++ by op_builder
    ``CkptWriterBuilder``) with pwrite'd chunks.
  * NoneCheckpointEngine   — none_checkpoint_engine.py:12: no-op for
    measuring checkpoint overhead.

Failure semantics (the crash-consistency layer), as the JAX package's:
  * every write is retried with capped exponential backoff
    (base.CheckpointEngine._write_with_retry), then degrades — native
    falls back to the Python writer for that save, async to an in-caller
    synchronous write when its pool is dead; each degrade is counted in
    ``counters["fallbacks"]``;
  * ``on_durable`` only ever fires after the bytes are durable, so a
    failed save can never publish 'latest';
  * a version whose save failed is popped from ``_inflight`` and its
    error raised exactly once, from ``wait()`` or ``commit()`` —
    ``drain()`` (used by load/recovery paths) collects failures without
    raising so durable data stays readable after a failed save.

Unlike the JAX package's native engine, a writer library that fails to
build or load raises from the constructor: the engine never switches to
the Python writer for good behind the caller's back.
"""

import concurrent.futures as futures
import io
import os
import threading

from ...utils import fault_injection
from ...utils.logging import logger
from .base import CheckpointEngine, CheckpointSaveError
from . import serialization as ser


class SyncCheckpointEngine(CheckpointEngine):
    def save(self, state_dict, path, on_durable=None):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tree, extra = state_dict
        try:
            self._write_with_retry(
                lambda: ser.save_file(path, tree, extra_meta=extra),
                None, path)
        except fault_injection.SimulatedKill:
            raise
        except Exception as e:  # noqa: BLE001
            self.counters["save_errors"] += 1
            raise CheckpointSaveError(0, path, e) from e
        self.counters["saves"] += 1
        if on_durable is not None:
            on_durable()

    def load(self, path, map_location=None):
        self.counters["loads"] += 1
        return ser.load_file(path)


class NoneCheckpointEngine(CheckpointEngine):
    def save(self, state_dict, path, on_durable=None):
        return True

    def load(self, path, map_location=None):
        raise RuntimeError("NoneCheckpointEngine cannot load")


class AsyncCheckpointEngine(CheckpointEngine):
    """Thread-pool writer. The caller stages device arrays to host (the
    cheap, bandwidth-bound part — analogous to VELOC's pinned-cache D2H);
    serialization+IO (the slow part) happens off the training thread."""

    def __init__(self, config_params=None, max_workers=None, max_inflight=2):
        super().__init__(config_params)
        workers = max_workers or getattr(config_params, "writer_threads", 2)
        self.max_inflight = getattr(config_params, "max_inflight",
                                    max_inflight)
        self._pool = futures.ThreadPoolExecutor(max_workers=workers)
        self._inflight = {}
        self._failures = {}      # version -> exception, each raised ONCE
        self._lock = threading.Lock()
        self._version = 0

    # --------------------------------------------------------------- write
    def _write_payload(self, path, tree, extra):
        """One write attempt (overridden by the native engine)."""
        ser.save_file(path, tree, extra_meta=extra)

    def _fallback_writer(self, path, tree, extra):
        """-> zero-arg callable performing the degraded write, or None
        when no lower tier exists (the python writer IS the last tier
        for the plain async engine)."""
        return None

    def _run_save(self, version, path, tree, extra, on_durable):
        try:
            self._write_with_retry(
                lambda: self._write_payload(path, tree, extra),
                self._fallback_writer(path, tree, extra), path)
        except fault_injection.SimulatedKill:
            raise
        except Exception as e:  # noqa: BLE001
            self.counters["save_errors"] += 1
            raise CheckpointSaveError(version, path, e) from e
        self.counters["saves"] += 1
        # durability callback runs on the writer thread AFTER the bytes
        # land, so e.g. the 'latest' pointer never names a torn file
        if on_durable is not None:
            on_durable()

    def save(self, state_dict, path, on_durable=None):
        with self._lock:
            self._version += 1
            version = self._version
        self._reap()
        # backpressure: bound staged-copy memory like VELOC's host cache.
        # A failed old save surfaces here (once) rather than wedging the
        # window shut forever.
        while len(self._inflight) >= self.max_inflight:
            self.wait(min(self._inflight))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tree, extra = state_dict
        try:
            fut = self._pool.submit(self._run_save, version, path, tree,
                                    extra, on_durable)
        except RuntimeError as e:
            # writer pool dead (shutdown/interpreter teardown): degrade
            # this save to a synchronous in-caller write instead of
            # losing the generation
            logger.warning(
                f"async checkpoint pool unavailable ({e}); degrading "
                f"save v{version} to a synchronous write")
            self.counters["fallbacks"] += 1
            self._run_save(version, path, tree, extra, on_durable)
            return version
        self._inflight[version] = fut
        return version

    # ------------------------------------------------------------ wait/err
    def _collect(self, version, fut):
        """Record the outcome of a finished future. The version is
        ALREADY popped from _inflight — a failure is queued in _failures
        to be raised exactly once."""
        exc = fut.exception()
        if exc is None:
            return
        if not isinstance(exc, Exception):   # SimulatedKill et al.
            raise exc
        self._failures[version] = exc

    def _reap(self):
        """Non-blocking: fold any finished futures into _failures."""
        for v, fut in list(self._inflight.items()):
            if fut.done():
                self._inflight.pop(v, None)
                self._collect(v, fut)

    def _raise_one_failure(self):
        if not self._failures:
            return
        v = min(self._failures)
        exc = self._failures.pop(v)
        if isinstance(exc, CheckpointSaveError):
            raise exc
        raise CheckpointSaveError(v, "<unknown>", exc) from exc

    def _drain_targets(self, version):
        if version is None:
            return sorted(self._inflight)
        return [version] if version in self._inflight else []

    def wait(self, version=None):
        # pop BEFORE result: one failed save must not raise from every
        # later wait()/load() forever
        for v in self._drain_targets(version):
            fut = self._inflight.pop(v, None)
            if fut is not None:
                fut.exception()   # block until done
                self._collect(v, fut)
        self._raise_one_failure()
        return True

    def drain(self, version=None):
        """wait() without raising: failures stay queued for the next
        wait()/commit(). Recovery paths use this so a failed save can't
        block loading the previous durable generation."""
        for v in self._drain_targets(version):
            fut = self._inflight.pop(v, None)
            if fut is not None:
                fut.exception()
                self._collect(v, fut)
        return True

    def load(self, path, map_location=None):
        self.drain()
        self.counters["loads"] += 1
        return ser.load_file(path)

    def commit(self, tag):
        self._reap()
        self._raise_one_failure()
        return True

    def shutdown(self):
        self.wait()
        self._pool.shutdown(wait=True)
        return True


class NativeCheckpointEngine(AsyncCheckpointEngine):
    """Async engine whose byte-writing goes through the C++ writer pool;
    a save whose native writes fail past the retries degrades to the
    Python writer for that save (counted in ``counters["fallbacks"]``)."""

    def __init__(self, config_params=None, **kw):
        super().__init__(config_params, **kw)
        from ...ops.native import ckpt_writer
        # fsync=True: the tmp's bytes must be durable BEFORE the rename
        # publishes them — otherwise on_durable fires (and retention GC
        # deletes older generations) while the shard is still page
        # cache, and a power loss strands 'latest' on a torn file with
        # the known-good tags already gone
        self._writer = ckpt_writer.Writer(
            threads=getattr(config_params, "writer_threads", 2),
            fsync=True)

    def _write_payload(self, path, tree, extra):
        # serialize to bytes in-thread (CRC manifest included), write via
        # the native pwrite pool to a tmp name, then atomic rename — the
        # C++ path gets the same two-phase durability as the python one
        bio = io.BytesIO()
        ser.save_file(bio, tree, extra_meta=extra)
        tmp = str(path) + ".tmp"
        os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
        try:
            self._writer.write(tmp, bio.getbuffer())
            fault_injection.fire("rename")
            os.replace(tmp, path)
        except Exception:
            # failed attempts must not leak full-size tmp shards (a
            # SimulatedKill/real crash still leaves one, like SIGKILL)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        ser._fsync_dir(os.path.dirname(str(path)))

    def _fallback_writer(self, path, tree, extra):
        # degrade: the plain python writer (its own tmp+fsync+rename)
        return lambda: ser.save_file(path, tree, extra_meta=extra)


ENGINES = {
    "sync": SyncCheckpointEngine,
    "async": AsyncCheckpointEngine,
    "native": NativeCheckpointEngine,
    "none": NoneCheckpointEngine,
    # reference-fork config names (engine.py:931-963 selection) map onto
    # the equivalent engines: torch -> sync; veloc/datastates (C++
    # pinned-cache writer pipelines) -> native; torch_sn_async -> async
    "torch": SyncCheckpointEngine,
    "veloc": NativeCheckpointEngine,
    "datastates": NativeCheckpointEngine,
    "torch_sn_async": AsyncCheckpointEngine,
    "nebula": AsyncCheckpointEngine,   # Azure tiered async -> async
}


def create_checkpoint_engine(cfg):
    """cfg: CheckpointEngineConfig (runtime/config.py)."""
    typ = getattr(cfg, "type", "sync")
    if typ not in ENGINES:
        raise ValueError(f"unknown checkpoint engine '{typ}'; "
                         f"available: {sorted(ENGINES)}")
    return ENGINES[typ](cfg)
