"""Chaos suite for the port's checkpoints: the port's counterparts of
tests/unit/test_chaos_checkpoint.py over deepspeed_tpu_torch's fault
injection, engines, serialization and manager, with every repeated case
a parametrized case.

Invariant, for EVERY engine and EVERY injection point: the save either
completes, or 'latest' keeps naming a fully loadable prior generation — a
fault can cost at most the generation being written, never the run. The
matrix runs at the engine-plugin / manager layer (numpy trees, no
model); the engine-level cases (d2h, reshape, load fallback through
``load_checkpoint``) use a tiny fp32 GPT-2 on the CPU.
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

from deepspeed_tpu_torch.utils import fault_injection
from deepspeed_tpu_torch.runtime.checkpoint_engine import serialization as ser
from deepspeed_tpu_torch.runtime.checkpoint_engine import manager
from deepspeed_tpu_torch.runtime.checkpoint_engine.base import (
    CheckpointSaveError)
from deepspeed_tpu_torch.runtime.checkpoint_engine.engines import (
    ENGINES, AsyncCheckpointEngine, NativeCheckpointEngine,
    NoneCheckpointEngine, SyncCheckpointEngine)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the four distinct engine classes; alias names are covered by the
# ENGINES-wide smoke test at the bottom
ENGINE_NAMES = ["sync", "async", "native", "none"]
POINTS = ["serialize", "write", "rename", "commit"]


@pytest.fixture(autouse=True)
def _reset_faults():
    fault_injection.reset()
    yield
    fault_injection.reset()


def _cfg(**kw):
    base = dict(writer_threads=2, max_inflight=2, save_retries=1,
                retry_backoff_s=0.001, retry_backoff_cap_s=0.002,
                keep_last=0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def _tree(step):
    return {"w": np.full((4, 3), float(step), np.float32),
            "b": {"x": np.arange(5, dtype=np.int64) + step}}


def _save_generation(eng, save_dir, step, keep_last=0):
    """The single-process save protocol of the engine's
    save_checkpoint: chunked shard write -> on_durable publishes 'latest'
    -> retention GC."""
    tag = f"step{step}"
    path = os.path.join(save_dir, tag, "shard-0.npz")
    chunks, index, meta = ser.extract_local_chunks(_tree(step))
    extra = {"index": index, "__tree_meta__": meta,
             "user_extra": {"global_step": step}}

    def on_durable():
        manager.publish_latest(save_dir, tag)
        manager.gc_tags(save_dir, keep_last, counters=eng.counters)

    eng.save((chunks, extra), path, on_durable=on_durable)
    eng.commit(tag)
    return tag


def _load_best(load_dir):
    """The shared load-with-fallback protocol (manager.load_best).
    -> (tag, flat, header) or (None, None, None) when nothing is
    loadable."""
    try:
        return manager.load_best(load_dir)
    except ser.CheckpointCorruptionError:
        return None, None, None


def _assert_loads_step(load_dir, allowed_steps):
    tag, flat, header = _load_best(load_dir)
    assert tag is not None, f"no loadable generation under {load_dir}"
    step = header["extra"]["global_step"]
    assert step in allowed_steps, (tag, step, allowed_steps)
    np.testing.assert_array_equal(flat["w"],
                                  np.full((4, 3), float(step), np.float32))
    np.testing.assert_array_equal(flat["b/x"],
                                  np.arange(5, dtype=np.int64) + step)
    return step


# --------------------------------------------------------------- injector
class TestInjector:
    def test_deterministic_countdown_and_budget(self):
        fault_injection.arm("p", fails=2, skip=1)
        fault_injection.fire("p")                      # skip
        with pytest.raises(fault_injection.FaultError):
            fault_injection.fire("p")
        with pytest.raises(fault_injection.FaultError):
            fault_injection.fire("p")
        fault_injection.fire("p")                      # healed
        assert fault_injection.injector.fired("p") == 4
        assert fault_injection.injector.hits("p") == 2

    def test_kill_is_base_exception(self):
        fault_injection.arm("p", kill=True)
        with pytest.raises(fault_injection.SimulatedKill):
            fault_injection.fire("p")
        assert not isinstance(fault_injection.SimulatedKill("p"),
                              Exception)

    def test_env_arming(self):
        os.environ["DSTPU_FAULT_INJECT"] = "write:2,rename:1:skip=3:kill"
        try:
            inj = fault_injection.FaultInjector()
        finally:
            del os.environ["DSTPU_FAULT_INJECT"]
        assert inj._arms["write"].fails == 2
        assert inj._arms["rename"].skip == 3
        assert inj._arms["rename"].kill is True


# ------------------------------------------------------- the chaos matrix
class TestFaultMatrix:
    """For each engine x injection point: persistent fault (outlives
    retries AND the degraded writer) -> 'latest' still names a loadable
    prior generation; the failed generation never becomes 'latest'."""

    @pytest.mark.parametrize("point", POINTS)
    @pytest.mark.parametrize("name", ENGINE_NAMES)
    def test_fault_never_costs_prior_generation(self, tmp_path, name,
                                                point):
        d = str(tmp_path)
        seed_eng = SyncCheckpointEngine(_cfg())
        _save_generation(seed_eng, d, step=1)
        _assert_loads_step(d, {1})

        eng = ENGINES[name](_cfg())
        fault_injection.arm(point, fails=100)     # persistent
        completed = True
        try:
            _save_generation(eng, d, step=2)
            eng.wait()
        except Exception:  # noqa: BLE001 - surfaced failure is legal
            completed = False
        finally:
            fault_injection.reset()
        if isinstance(eng, NoneCheckpointEngine):
            # no-op engine never writes or publishes: gen 1 must survive
            assert completed
            _assert_loads_step(d, {1})
            return
        if completed:
            step = _assert_loads_step(d, {1, 2})
            # a completed save under a 'commit' fault may legitimately
            # leave latest at gen 1; any other completed point must have
            # published gen 2 durably
            if point != "commit":
                assert step == 2
        else:
            _assert_loads_step(d, {1})
        eng.shutdown()

    @pytest.mark.parametrize("point", ["write", "rename", "commit"])
    @pytest.mark.parametrize("name", ENGINE_NAMES)
    def test_kill_mid_save_keeps_prior_generation(self, tmp_path, name,
                                                  point):
        """SIGKILL model: SimulatedKill (BaseException) aborts the save
        with no retry, no fallback, no cleanup handlers in the write
        path. The previously durable generation must stay intact AND
        remain what 'latest' resolves to."""
        d = str(tmp_path)
        _save_generation(SyncCheckpointEngine(_cfg()), d, step=1)

        eng = ENGINES[name](_cfg())
        fault_injection.arm(point, kill=True)
        try:
            _save_generation(eng, d, step=2)
            eng.wait()
        except BaseException:  # noqa: BLE001 - includes SimulatedKill
            pass
        finally:
            fault_injection.reset()
        _assert_loads_step(d, {1, 2})
        latest = manager.read_latest(d)
        assert latest is not None
        ser.verify_tag(os.path.join(d, latest))
        eng.shutdown()


# ------------------------------------------------------- retry / degrade
class TestRetryDegrade:
    @pytest.mark.parametrize("name", ["sync", "async", "native"])
    def test_transient_write_failure_recovers_via_retry(self, tmp_path,
                                                        name):
        d = str(tmp_path)
        eng = ENGINES[name](_cfg(save_retries=2))
        fault_injection.arm("write", fails=1)     # fail once, then heal
        _save_generation(eng, d, step=3)
        eng.wait()
        assert eng.counters["retries"] >= 1
        assert eng.counters["saves"] == 1
        assert eng.counters["save_errors"] == 0
        assert _assert_loads_step(d, {3}) == 3

    def test_native_degrades_to_python_writer(self, tmp_path):
        d = str(tmp_path)
        eng = NativeCheckpointEngine(_cfg(save_retries=1))

        class DeadWriter:
            def write(self, path, data):
                raise OSError(5, "injected native pool death")

        eng._writer = DeadWriter()
        _save_generation(eng, d, step=4)
        eng.wait()
        assert eng.counters["fallbacks"] == 1
        assert eng.counters["retries"] >= 1
        assert _assert_loads_step(d, {4}) == 4
        eng.shutdown()

    def test_async_dead_pool_degrades_to_sync_write(self, tmp_path):
        d = str(tmp_path)
        eng = AsyncCheckpointEngine(_cfg())
        eng._pool.shutdown(wait=True)             # writer threads dead
        _save_generation(eng, d, step=5)
        assert eng.counters["fallbacks"] == 1
        assert _assert_loads_step(d, {5}) == 5

    def test_failed_save_never_publishes_latest(self, tmp_path):
        d = str(tmp_path)
        _save_generation(SyncCheckpointEngine(_cfg()), d, step=1)
        eng = AsyncCheckpointEngine(_cfg(save_retries=0))
        fault_injection.arm("write", fails=50)
        with pytest.raises(CheckpointSaveError):
            _save_generation(eng, d, step=2)
            eng.wait()
        fault_injection.reset()
        assert manager.read_latest(d) == "step1"
        eng.shutdown()


# ----------------------------------------- inflight bookkeeping (satellite)
class TestFailedSaveBookkeeping:
    def test_wait_raises_exactly_once_then_heals(self, tmp_path):
        """A failed version is popped from _inflight before the error
        re-raises, so ONE failed save raises ONE error — not on every
        later wait()/load() forever."""
        d = str(tmp_path)
        eng = AsyncCheckpointEngine(_cfg(save_retries=0))
        fault_injection.arm("write", fails=50)
        with pytest.raises(CheckpointSaveError) as ei:
            # commit() inside _save_generation surfaces the failure when
            # the writer thread finishes first; wait() surfaces it
            # otherwise — exactly one of them raises
            _save_generation(eng, d, step=1)
            eng.wait()
        assert "version 1" in str(ei.value)
        fault_injection.reset()
        assert eng._inflight == {}
        assert eng.wait() is True                 # no second raise
        assert eng.commit("t") is True
        # and the engine still saves + loads fine afterwards
        _save_generation(eng, d, step=2)
        eng.wait()
        assert _assert_loads_step(d, {2}) == 2
        eng.shutdown()

    def test_load_drains_without_raising(self, tmp_path):
        d = str(tmp_path)
        eng = AsyncCheckpointEngine(_cfg(save_retries=0))
        _save_generation(eng, d, step=1)
        eng.wait()
        fault_injection.arm("write", fails=50)
        surfaced_early = False
        try:
            _save_generation(eng, d, step=2)
        except CheckpointSaveError:      # commit() won the race
            surfaced_early = True
        eng.drain()          # v2 completes (failed) WITHOUT raising
        fault_injection.reset()
        # load() must return the durable generation even though v2 failed
        flat, header = eng.load(os.path.join(d, "step1", "shard-0.npz"))
        assert header["extra"]["user_extra"]["global_step"] == 1
        # ...and the failure still surfaces exactly once, from wait()
        if not surfaced_early:
            with pytest.raises(CheckpointSaveError):
                eng.wait()
        assert eng.wait() is True        # and never again
        eng.shutdown()

    def test_backpressure_window_never_wedges(self, tmp_path):
        """Old bug shape: a failed future stuck in _inflight kept the
        max_inflight window permanently full. After surfacing the
        failure, later saves must proceed."""
        d = str(tmp_path)
        eng = AsyncCheckpointEngine(_cfg(save_retries=0, max_inflight=1))
        fault_injection.arm("write", fails=50)
        raised = 0
        try:
            # commit() inside may already surface the failure when the
            # writer thread loses the race — that's the "exactly once"
            _save_generation(eng, d, step=1)
        except CheckpointSaveError:
            raised += 1
        eng.drain()          # v1 completes (failed) WITHOUT raising
        fault_injection.reset()
        for step in (2, 3, 4):
            try:
                _save_generation(eng, d, step=step)
            except CheckpointSaveError:
                raised += 1
        eng.wait()
        assert raised == 1   # surfaced exactly once, wherever it landed
        assert _assert_loads_step(d, {4}) == 4
        eng.shutdown()


# ------------------------------------------------- integrity & atomicity
class TestIntegrityAtomicity:
    def test_save_file_is_atomic_under_write_fault(self, tmp_path):
        """A crash mid-write must never destroy the previously durable
        shard at the same path."""
        p = str(tmp_path / "x.npz")
        ser.save_file(p, _tree(1), extra_meta={"global_step": 1})
        fault_injection.arm("write", fails=1)
        with pytest.raises(fault_injection.FaultError):
            ser.save_file(p, _tree(2), extra_meta={"global_step": 2})
        fault_injection.reset()
        flat, header = ser.load_file(p)
        assert header["extra"]["global_step"] == 1
        np.testing.assert_array_equal(flat["w"], _tree(1)["w"])

    def test_save_file_is_atomic_under_kill_at_rename(self, tmp_path):
        p = str(tmp_path / "x.npz")
        ser.save_file(p, _tree(1))
        fault_injection.arm("rename", kill=True)
        with pytest.raises(fault_injection.SimulatedKill):
            ser.save_file(p, _tree(2))
        fault_injection.reset()
        flat, _ = ser.load_file(p)
        np.testing.assert_array_equal(flat["w"], _tree(1)["w"])

    def test_crc_detects_bit_corruption(self, tmp_path):
        p = str(tmp_path / "x.npz")
        ser.save_file(p, _tree(7))
        size = os.path.getsize(p)
        with open(p, "r+b") as f:        # flip bytes inside the payload
            f.seek(size // 2)
            chunk = f.read(4)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        with pytest.raises(ser.CheckpointCorruptionError):
            ser.load_file(p)

    def test_truncation_detected(self, tmp_path):
        p = str(tmp_path / "x.npz")
        ser.save_file(p, _tree(7))
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.truncate(size // 2)
        with pytest.raises(ser.CheckpointCorruptionError):
            ser.load_file(p)

    def test_verify_tag_passes_good_and_fails_torn(self, tmp_path):
        tagdir = tmp_path / "t"
        os.makedirs(tagdir)
        ser.save_file(str(tagdir / "state.npz"), _tree(1))
        assert ser.verify_tag(str(tagdir)) is True
        with open(tagdir / "state.npz", "r+b") as f:
            f.truncate(10)
        with pytest.raises(ser.CheckpointCorruptionError):
            ser.verify_tag(str(tagdir))


# ------------------------------------------------------- retention & GC
class TestRetention:
    def test_keep_last_k_durable_tags(self, tmp_path):
        d = str(tmp_path)
        eng = SyncCheckpointEngine(_cfg())
        for step in range(1, 6):
            _save_generation(eng, d, step=step, keep_last=2)
        tags = manager.list_tags(d)
        assert sorted(tags) == ["step4", "step5"]
        assert manager.read_latest(d) == "step5"
        assert eng.counters["gc_removed"] == 3
        assert _assert_loads_step(d, {5}) == 5

    def test_gc_refuses_when_newest_tag_is_torn(self, tmp_path):
        d = str(tmp_path)
        eng = SyncCheckpointEngine(_cfg())
        for step in (1, 2, 3):
            _save_generation(eng, d, step=step)
        # tear the newest generation AFTER it was published
        shard = os.path.join(d, "step3", "shard-0.npz")
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
        removed = manager.gc_tags(d, keep_last=1,
                                  counters=eng.counters)
        assert removed == []                      # nothing deleted
        assert sorted(manager.list_tags(d)) == ["step1", "step2",
                                                "step3"]
        # recovery still has a known-good generation
        assert _assert_loads_step(d, {2}) == 2

    def test_gc_never_deletes_what_latest_names(self, tmp_path):
        d = str(tmp_path)
        eng = SyncCheckpointEngine(_cfg())
        for step in (1, 2, 3):
            _save_generation(eng, d, step=step)
        manager.publish_latest(d, "step1")        # pointer pinned old
        removed = manager.gc_tags(d, keep_last=1)
        assert "step1" not in removed
        assert _assert_loads_step(d, {1}) == 1


# ------------------------------------------------------- load fallback
class TestLoadFallback:
    def test_corrupt_newest_falls_back_to_previous_durable(self,
                                                           tmp_path):
        d = str(tmp_path)
        eng = SyncCheckpointEngine(_cfg())
        _save_generation(eng, d, step=1)
        _save_generation(eng, d, step=2)
        shard = os.path.join(d, "step2", "shard-0.npz")
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) - 64)
        tag, flat, header = _load_best(d)
        assert tag == "step1"
        assert header["extra"]["global_step"] == 1

    def test_missing_latest_pointer_still_recovers(self, tmp_path):
        d = str(tmp_path)
        eng = SyncCheckpointEngine(_cfg())
        _save_generation(eng, d, step=1)
        os.remove(os.path.join(d, "latest"))
        tag, _, header = _load_best(d)
        assert tag == "step1" and header["extra"]["global_step"] == 1


# ------------------------------------------ process-kill (real process)
class TestProcessKill:
    def test_os_level_kill_between_write_and_publish(self, tmp_path):
        """A REAL process death (os._exit, no unwinding) at the commit
        boundary: the shard of gen 2 is durable but 'latest' still names
        gen 1 — recovery loads gen 1; nothing is torn."""
        d = str(tmp_path / "ckpt")
        script = textwrap.dedent(f"""
            import os, sys
            sys.path.insert(0, {ROOT!r})
            os.environ["DSTPU_FAULT_INJECT"] = "commit:1:skip=1"
            import numpy as np
            from deepspeed_tpu_torch.runtime.checkpoint_engine import manager
            from deepspeed_tpu_torch.runtime.checkpoint_engine.engines import (
                SyncCheckpointEngine)

            def save(step):
                tag = f"step{{step}}"
                path = os.path.join({d!r}, tag, "shard-0.npz")
                eng = SyncCheckpointEngine(None)
                eng.save(({{"w": np.full((4, 3), float(step),
                                         np.float32)}},
                          {{"global_step": step}}), path,
                         on_durable=lambda: manager.publish_latest(
                             {d!r}, tag))

            save(1)      # commit fire #1: skipped -> publishes
            try:
                save(2)  # commit fire #2: SimulatedKill
            except BaseException:
                os._exit(137)   # SIGKILL-faithful: no cleanup
            os._exit(0)
        """)
        proc = subprocess.run([sys.executable, "-c", script],
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 137, (proc.stdout, proc.stderr)
        assert manager.read_latest(d) == "step1"
        flat, header = ser.load_file(
            os.path.join(d, "step1", "shard-0.npz"))
        assert header["extra"]["global_step"] == 1
        np.testing.assert_array_equal(
            flat["w"], np.full((4, 3), 1.0, np.float32))
        # gen 2's shard is durable (write finished before the kill) —
        # a later load_candidates pass may use it, and it must verify
        assert ser.verify_tag(os.path.join(d, "step2")) is True


# ------------------------------------------------- ENGINES-wide smoke
@pytest.mark.parametrize("name", sorted(ENGINES))
def test_every_engine_roundtrips_under_one_write_failure(tmp_path, name):
    """Every ENGINES entry (aliases included) completes a save/load
    round-trip with one injected write failure absorbed by the retry
    layer."""
    d = str(tmp_path)
    eng = ENGINES[name](_cfg(save_retries=2))
    fault_injection.arm("write", fails=1)
    _save_generation(eng, d, step=9)
    eng.wait()
    fault_injection.reset()
    if isinstance(eng, NoneCheckpointEngine):
        assert manager.read_latest(d) is None     # writes nothing
        with pytest.raises(RuntimeError):
            eng.load("anything")
        return
    assert eng.counters["save_errors"] == 0
    assert _assert_loads_step(d, {9}) == 9
    eng.shutdown()


# ------------------------------------------------------- engine level
CFG = dict(n_layer=2, n_head=4, d_model=32, max_seq_len=32, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)


def _engine(typ="sync", micro=2, seed=0, **ckpt):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2, GPT2Config
    from deepspeed_tpu_torch.utils import groups
    groups.reset()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2(GPT2Config(**CFG), device="cpu", seed=seed),
        config={"train_micro_batch_size_per_gpu": micro,
                "steps_per_print": 0,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "checkpoint_engine": {"type": typ, "save_retries": 1,
                                      "retry_backoff_s": 0.001, **ckpt}},
        device="cpu")
    return engine


def _step(engine, seed=0, rows=2):
    ids = np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (rows, CFG["max_seq_len"])).astype(np.int32)
    return float(engine.train_batch({"input_ids": ids}))


def _corrupt_chunk(shard):
    """Flip one byte inside the largest chunk's bytes (the zip stays
    readable; only the CRC manifest can tell)."""
    import zipfile
    with zipfile.ZipFile(shard) as z:
        info = max(z.infolist(), key=lambda i: i.file_size)
        with open(shard, "rb") as f:
            f.seek(info.header_offset + 26)
            n, m = np.frombuffer(f.read(4), np.uint16)
        off = info.header_offset + 30 + int(n) + int(m) + info.file_size // 2
    with open(shard, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0x5A]))


@pytest.mark.parametrize("name", ["sync", "async", "native"])
def test_engine_d2h_fault_fails_before_any_write(tmp_path, name):
    """A 'd2h' fault (the host copy of this rank's shards) fails the
    save before a byte is written: 'latest' stays on the prior tag."""
    engine = _engine(name)
    _step(engine)
    engine.save_checkpoint(str(tmp_path))
    engine.checkpoint_engine.wait()
    _step(engine, 1)
    fault_injection.arm("d2h", fails=1)
    with pytest.raises(fault_injection.FaultError):
        engine.save_checkpoint(str(tmp_path))
    assert manager.read_latest(str(tmp_path)) == "global_step1"
    assert manager.list_tags(str(tmp_path)) == ["global_step1"]
    engine.save_checkpoint_terminate()


@pytest.mark.parametrize("name", ["sync", "async", "native"])
def test_engine_corrupt_chunk(tmp_path, name):
    """One byte flipped inside a chunk of the newest tag: loading it by
    explicit tag raises CheckpointCorruptionError; without a tag the
    load falls back to the previous durable generation and counts one
    load fallback."""
    engine = _engine(name)
    _step(engine)
    engine.save_checkpoint(str(tmp_path))
    _step(engine, 1)
    engine.save_checkpoint(str(tmp_path))
    engine.checkpoint_engine.wait()
    assert manager.read_latest(str(tmp_path)) == "global_step2"
    _corrupt_chunk(str(tmp_path / "global_step2" / "shard-0.npz"))
    fresh = _engine(name, seed=3)
    with pytest.raises(ser.CheckpointCorruptionError):
        fresh.load_checkpoint(str(tmp_path), tag="global_step2")
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert path == str(tmp_path / "global_step1")
    assert fresh.global_step == 1
    assert fresh.checkpoint_engine.counters["load_fallbacks"] == 1
    assert fresh.checkpoint_engine.counters["fallbacks"] == 0


def test_engine_all_corrupt_raises(tmp_path):
    engine = _engine()
    _step(engine)
    engine.save_checkpoint(str(tmp_path))
    shard = str(tmp_path / "global_step1" / "shard-0.npz")
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) // 2)
    with pytest.raises(ser.CheckpointCorruptionError):
        _engine(seed=4).load_checkpoint(str(tmp_path))


@pytest.mark.parametrize("kill", [False, True])
def test_engine_reshape_fault_fires_on_a_topology_change(tmp_path, kill):
    """'reshape' fires (and propagates: its blast radius is fatal) when
    the load crosses a topology or stage change, never on a same-shape
    resume."""
    engine = _engine()
    _step(engine)
    engine.save_checkpoint(str(tmp_path))
    fault_injection.arm("reshape", fails=1, kill=kill)
    same = _engine(seed=2)
    same.load_checkpoint(str(tmp_path))          # same topology: no fire
    assert fault_injection.injector.fired("reshape") == 0
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import GPT2, GPT2Config
    from deepspeed_tpu_torch.utils import groups
    groups.reset()
    other, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2(GPT2Config(**CFG), device="cpu"),
        config={"train_micro_batch_size_per_gpu": 2,
                "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
                "zero_optimization": {"stage": 3}}, device="cpu")
    want = (fault_injection.SimulatedKill if kill
            else fault_injection.FaultError)
    with pytest.raises(want):
        other.load_checkpoint(str(tmp_path))
    assert fault_injection.injector.hits("reshape") == 1


def test_engine_keep_last_retains_what_latest_names(tmp_path):
    engine = _engine(keep_last=2)
    for i in range(4):
        _step(engine, i)
        engine.save_checkpoint(str(tmp_path))
    assert sorted(manager.list_tags(str(tmp_path))) == ["global_step3",
                                                        "global_step4"]
    assert manager.read_latest(str(tmp_path)) == "global_step4"
    assert engine.checkpoint_engine.counters["gc_removed"] == 2


@pytest.mark.parametrize("point", fault_injection.PORT_POINTS)
def test_port_points_fired_and_armed(point):
    """Every point the port fires is fired in deepspeed_tpu_torch/ and
    armed by a test of this file (the JAX fault-points lint)."""
    import re
    pkg = os.path.join(ROOT, "deepspeed_tpu_torch")
    fired = False
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    fired |= f'fire("{point}")' in fh.read()
    assert fired, point
    with open(os.path.abspath(__file__)) as fh:
        text = fh.read()
    armed = re.search(rf'arm\(\s*"{point}"', text) or (
        f'"{point}"' in text.split("POINTS = [", 1)[1].split("]", 1)[0])
    assert armed, point
    assert point in fault_injection.KNOWN_POINTS
