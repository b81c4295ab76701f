"""Deterministic fault injection for the checkpoint subsystem.

Own copy of ``deepspeed_tpu/utils/fault_injection.py`` (standard library
only): the same named, counted injection points, the same countdown and
failure budget, ``SimulatedKill`` and the ``DSTPU_FAULT_INJECT`` env
arming, so a chaos test can say "the 2nd byte-write of this save fails"
and get exactly that, every run.

Points the port fires (grep for ``fault_injection.fire``), at the places
the JAX package fires them:

  ==============  =====================================================
  point           fires in
  ==============  =====================================================
  d2h             runtime/engine.py save_checkpoint, before the local
                  shard extraction (the copy of this rank's state to
                  host memory)
  serialize       serialization.save_file, before the tree is encoded
  write           serialization.save_file byte write, and
                  ops/native/ckpt_writer.py Writer.write (C++ path)
  rename          serialization.save_file and the native engine,
                  before the atomic tmp -> final os.replace
  commit          checkpoint_engine/manager.py publish_latest, before
                  the 'latest' pointer is replaced
  reshape         runtime/engine.py load_checkpoint, before the
                  reshape-on-resume path adapts to another topology
  kill            any of the above via ``kill=True``: raises
                  SimulatedKill (BaseException), which NO layer
                  retries, modelling SIGKILL mid-save
  ==============  =====================================================

The serving plane fires SERVING_POINTS at the JAX package's places:

  ===============  ====================================================
  point            fires in
  ===============  ====================================================
  serve_dispatch   inference/v2/replica.py Replica.submit
  serve_step       Replica.step, before the engine's step
  serve_verify     Replica.step when the engine has a speculative
                   verify pending (never in the port yet: it has no
                   speculative decoding)
  replica_death    Replica.step and Replica.import_handoff
  router_overload  inference/v2/router.py, each round's overload check
  kv_stream        inference/v2/kv_transfer.py, each transport send
  kv_import        kv_transfer.import_sequence, before unpacking
  ===============  ====================================================

The hot tier's points (replica_push, replica_fetch, replica_restore,
dcn_partition, host_loss, slice_loss) keep their names and blast radius
here; the module that fires them is not ported yet (ROADMAP Queue 1:
M14 hot tier).

Faults are armed per point with a countdown (skip the first N fires) and
a failure budget (fail the next M fires, then heal): "fail once then
succeed" (retry coverage), "always fail" (degrade coverage) and "die at
the commit boundary" (crash consistency), deterministically.

Arming is process-local via :func:`arm` / :func:`reset`, or via the
``DSTPU_FAULT_INJECT`` env var for subprocess tests:
``DSTPU_FAULT_INJECT="write:2,rename:1:skip=1"`` arms two write failures
and one rename failure after one clean rename.
"""

import os
import threading

# Every named injection point of the JAX package, the same tuple; the
# port fires PORT_POINTS (tests/test_torch_checkpoint_chaos.py checks
# each is fired somewhere in deepspeed_tpu_torch/ and armed by a test).
KNOWN_POINTS = (
    "d2h",
    "serialize",
    "write",
    "rename",
    "commit",
    "replica_push",
    "replica_fetch",
    "replica_restore",
    "dcn_partition",
    "host_loss",
    "slice_loss",
    "reshape",
    "serve_dispatch",
    "serve_step",
    "serve_verify",
    "replica_death",
    "router_overload",
    "kv_stream",
    "kv_import",
)

# The points this package fires (the rest stay defined, unfired).
PORT_POINTS = ("d2h", "serialize", "write", "rename", "commit", "reshape")

# The serving plane's points this package fires (tests/test_torch_router.py
# checks each is fired in deepspeed_tpu_torch/ and armed by a serving test).
SERVING_POINTS = ("serve_dispatch", "serve_step", "serve_verify",
                  "replica_death", "router_overload", "kv_stream",
                  "kv_import")

# Blast-radius class per injection point:
#
#   advisory   the failure is counted/logged and MUST NOT propagate to
#              the save/load caller (a replica push can never cost the
#              durable save; loads degrade down-tier)
#   retryable  the save retry/degrade policy owns the failure — it may
#              surface only as CheckpointSaveError after the budget
#   fatal      the failure propagates (crash-consistency boundaries and
#              process/host/slice-death points; only ``kill`` or a test
#              harness is expected to observe them)
BLAST_RADIUS = {
    "d2h": "fatal",
    "serialize": "retryable",
    "write": "retryable",
    "rename": "retryable",
    "commit": "fatal",
    "replica_push": "advisory",
    "replica_fetch": "advisory",
    "replica_restore": "advisory",
    "dcn_partition": "advisory",
    "host_loss": "fatal",
    "slice_loss": "fatal",
    "reshape": "fatal",
    # serving plane: the router is the recovery layer above the
    # replica, so "retryable" means the ROUTER's re-route/health policy
    # owns the failure (not the checkpoint save policy), and the fatal
    # replica_death propagates out of Replica.step() as ReplicaDead for
    # the router to observe — mirroring how host_loss propagates to the
    # elastic agent. router_overload is advisory: shedding is a typed,
    # counted service decision and must never take a replica down.
    "serve_dispatch": "retryable",
    "serve_step": "retryable",
    "serve_verify": "retryable",
    "replica_death": "fatal",
    "router_overload": "advisory",
    # disaggregated serving handoff: both halves fire BEFORE
    # any state moves — the prefill replica owns the sequence until the
    # decode side confirms the import — so the router's retry-next-round
    # policy owns these failures end to end
    "kv_stream": "retryable",
    "kv_import": "retryable",
}


class FaultError(OSError):
    """The injected failure for retryable points (an IO-shaped error,
    so the production retry path treats it like a real EIO)."""

    def __init__(self, point, fire_index):
        super().__init__(5, f"injected fault at '{point}' "
                            f"(fire #{fire_index})")
        self.point = point
        self.fire_index = fire_index


class SimulatedKill(BaseException):
    """Process death mid-save. Deliberately a BaseException: no retry
    loop, ``except Exception`` recovery path, or engine fallback may
    swallow it — exactly like SIGKILL. Tests catch it at top level and
    then assert on-disk state."""

    def __init__(self, point):
        super().__init__(f"simulated process kill at '{point}'")
        self.point = point


class _Arm:
    __slots__ = ("skip", "fails", "kill")

    def __init__(self, fails, skip=0, kill=False):
        self.fails = int(fails)
        self.skip = int(skip)
        self.kill = bool(kill)


class FaultInjector:
    """Registry of armed faults + a fire log. Thread-safe: writer
    threads in the async engines fire points concurrently."""

    def __init__(self):
        self._lock = threading.Lock()
        self._arms = {}
        self._fired = {}     # point -> total fire() calls (hit or not)
        self._hits = {}      # point -> injected-failure count
        self._load_env()

    # ------------------------------------------------------------- arming
    def arm(self, point, fails=1, skip=0, kill=False):
        """Arm ``point``: after ``skip`` clean passes, the next
        ``fails`` fires raise (FaultError, or SimulatedKill when
        ``kill``), then the point heals."""
        with self._lock:
            self._arms[point] = _Arm(fails, skip=skip, kill=kill)

    def reset(self):
        with self._lock:
            self._arms.clear()
            self._fired.clear()
            self._hits.clear()

    def _load_env(self):
        spec = os.environ.get("DSTPU_FAULT_INJECT", "")
        for part in filter(None, (p.strip() for p in spec.split(","))):
            fields = part.split(":")
            point, fails = fields[0], 1
            skip, kill = 0, False
            if len(fields) > 1 and fields[1]:
                fails = int(fields[1])
            for extra in fields[2:]:
                if extra.startswith("skip="):
                    skip = int(extra[5:])
                elif extra == "kill":
                    kill = True
            self._arms[point] = _Arm(fails, skip=skip, kill=kill)

    # ------------------------------------------------------------- firing
    def fire(self, point):
        """Called at an injection point. No-op (beyond counting) unless
        the point is armed."""
        with self._lock:
            n = self._fired.get(point, 0) + 1
            self._fired[point] = n
            arm = self._arms.get(point)
            if arm is None:
                return
            if arm.skip > 0:
                arm.skip -= 1
                return
            if arm.fails <= 0:
                return
            arm.fails -= 1
            self._hits[point] = self._hits.get(point, 0) + 1
            kill = arm.kill
        if kill:
            raise SimulatedKill(point)
        raise FaultError(point, n)

    # ---------------------------------------------------------- inspection
    def fired(self, point):
        """Total fire() calls seen at ``point`` (hit or clean)."""
        with self._lock:
            return self._fired.get(point, 0)

    def hits(self, point):
        """Injected failures actually raised at ``point``."""
        with self._lock:
            return self._hits.get(point, 0)


# Process-global injector: production code fires against this; tests
# arm/reset it. fire() on an un-armed point is two dict ops under an
# uncontended lock — cheap enough to leave in the hot save path.
injector = FaultInjector()

fire = injector.fire
arm = injector.arm
reset = injector.reset
