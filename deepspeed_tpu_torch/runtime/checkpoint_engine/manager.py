"""Durable-tag bookkeeping shared by the runtime engine and the chaos
tests: atomic 'latest' publication, retention GC, and the ordered list
of generations a loader should try.

Own copy of ``deepspeed_tpu/runtime/checkpoint_engine/manager.py``, the
same directory protocol, so either package reads what the other wrote:

  {save_dir}/{tag}/shard-{p}.npz   durable generations (CRC manifests)
  {save_dir}/latest                atomically-replaced pointer; only
                                   ever names a fully durable tag
  {save_dir}/.latest_seq           the global step 'latest' was saved at

The in-memory hot tier (JAX ``checkpoint_engine/hot_tier.py``) is not
ported (ROADMAP Queue 1, M14): :func:`load_best_tiered` takes
``hot_store=None`` only.
"""

import glob
import os
import re
import shutil
import threading
import time

from ...utils import fault_injection
from ...utils.logging import logger
from . import serialization as ser

# Publication and GC run on async-engine writer threads; two saves can
# reach durability concurrently. This lock serializes the in-process
# latest/GC critical sections so (a) GC never double-counts a tag two
# overlapping runs both saw, and (b) the .latest tmp file is never
# written by two threads at once. Cross-process publication is already
# serialized by the rank-0/barrier protocol in engine.save_checkpoint.
_publish_lock = threading.Lock()


def publish_latest(save_dir, tag, seq=None):
    """Atomically point ``latest`` at ``tag``. Callers must only invoke
    this AFTER every shard of ``tag`` is durable (the on_durable /
    barrier protocol in runtime/engine.py save_checkpoint).

    ``seq``: optional monotonic sequence (the engine passes the global
    step the tag was saved at). With async engines two in-flight saves
    can hit durability out of order; the guard keeps 'latest' from
    regressing to the older generation. Returns False when skipped."""
    os.makedirs(save_dir, exist_ok=True)
    fault_injection.fire("commit")
    with _publish_lock:
        if seq is not None:
            cur = _read_seq(save_dir)
            if cur is not None and cur > seq:
                logger.info(
                    f"not publishing 'latest'={tag!r} (seq {seq}): a "
                    f"newer generation (seq {cur}) is already published")
                return False
        tmp = os.path.join(save_dir, ".latest.tmp")
        with open(tmp, "w") as f:
            f.write(tag)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(save_dir, "latest"))
        if seq is not None:
            tmp2 = os.path.join(save_dir, ".latest_seq.tmp")
            with open(tmp2, "w") as f:
                f.write(str(int(seq)))
            os.replace(tmp2, os.path.join(save_dir, ".latest_seq"))
        ser._fsync_dir(save_dir)
    return True


def _read_seq(save_dir):
    try:
        with open(os.path.join(save_dir, ".latest_seq")) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def read_latest(save_dir):
    """-> tag named by the 'latest' pointer, or None."""
    p = os.path.join(save_dir, "latest")
    try:
        with open(p) as f:
            tag = f.read().strip()
        return tag or None
    except OSError:
        return None


def list_tags(save_dir):
    """Tag directories that contain checkpoint data, newest first
    (mtime order, name as tiebreak)."""
    try:
        names = os.listdir(save_dir)
    except OSError:
        return []
    out = []
    for name in names:
        p = os.path.join(save_dir, name)
        if not os.path.isdir(p):
            continue
        if not (os.path.exists(os.path.join(p, "state.npz"))
                or glob.glob(os.path.join(p, "shard-*.npz"))):
            continue
        try:
            mtime = os.path.getmtime(p)
        except OSError:
            continue   # GC'd by a writer thread between listdir and stat
        out.append((mtime, _step_key(name), name))
    return [name for _, _, name in sorted(out, reverse=True)]


def _step_key(name):
    """mtime tie-break (coarse-granularity filesystems): the trailing
    integer of the tag name, so global_step10 orders after global_step9
    instead of lexicographically before it."""
    m = re.search(r"(\d+)$", name)
    return int(m.group(1)) if m else -1


def load_candidates(load_dir, tag=None):
    """Generations to try loading, best first. An explicit ``tag`` is
    the only candidate (the caller asked for THAT generation — silently
    substituting another would be worse than failing). With no tag: the
    'latest' pointer first, then every other tag newest-first, so a
    corrupt newest generation falls back to the previous durable one."""
    if tag is not None:
        return [tag]
    latest = read_latest(load_dir)
    tags = list_tags(load_dir)
    durable = [latest] if latest else []
    durable.extend(t for t in tags if t != latest)
    return durable


# Errors that mean "this generation is unloadable, try the previous
# durable one" — the ONE definition of the fallback trigger set shared
# by the training engine and the chaos tests.
FALLBACK_ERRORS = (ser.CheckpointCorruptionError, ValueError, OSError)


def load_best(load_dir, tag=None, loader=None, counters=None):
    """Load the best available generation with fallback: try each
    candidate from :func:`load_candidates` with ``loader(tag_dir)``
    (default :func:`serialization.load_state`); a candidate failing with
    one of FALLBACK_ERRORS falls through to the next, bumping
    ``counters['load_fallbacks']``.

    Returns ``(tag, flat, header)``; ``(None, None, None)`` when no
    checkpoint exists at all. Raises CheckpointCorruptionError when
    generations exist but none is loadable — resuming silently from
    scratch would be worse than failing loudly."""
    loader = loader or ser.load_state
    last_err = None
    tried = 0
    candidates = load_candidates(load_dir, tag)
    for i, cand in enumerate(candidates):
        tag_dir = os.path.join(load_dir, cand)
        if not os.path.isdir(tag_dir):
            continue
        tried += 1
        try:
            flat, header = loader(tag_dir)
        except FALLBACK_ERRORS as e:
            last_err = e
            if i + 1 < len(candidates):
                # only a real fallback (another candidate exists) is
                # counted/logged — an explicit corrupt tag with nothing
                # to fall back to must not report a recovery
                if counters is not None:
                    counters["load_fallbacks"] += 1
                logger.warning(
                    f"checkpoint tag {cand!r} failed verification/load "
                    f"({e}); falling back to the previous durable "
                    f"generation")
            continue
        return cand, flat, header
    if tried == 0:
        return None, None, None
    raise ser.CheckpointCorruptionError(
        f"no loadable checkpoint generation under {load_dir} "
        f"(tried {tried} tag(s))") from last_err


def load_best_tiered(load_dir, tag=None, hot_store=None, loader=None,
                     counters=None):
    """The JAX ``load_best_tiered`` with the durable tier only
    (``hot_store`` must be None): :func:`load_best` over the
    :func:`load_candidates` order. -> (tier, tag, flat, header), tier
    'durable' (all None when nothing exists)."""
    if hot_store is not None:
        raise NotImplementedError(
            "the in-memory hot tier is not ported yet (ROADMAP Queue 1, "
            "M14, hot tier)")
    cand, flat, header = load_best(load_dir, tag, loader=loader,
                                   counters=counters)
    if cand is None:
        return None, None, None, None
    if counters is not None:
        counters["durable_restores"] = \
            counters.get("durable_restores", 0) + 1
    return "durable", cand, flat, header


def gc_tags(save_dir, keep_last, counters=None):
    """Retention: delete all but the newest ``keep_last`` durable tags.

    Only runs after the NEWEST tag passes a full integrity verification
    (CRC manifests + chunk coverage) — if the newest generation is torn,
    nothing is deleted, so recovery always has a known-good generation.
    The tag named by 'latest' is never deleted regardless of age.
    Returns the list of removed tags; never raises (GC is advisory —
    a failed cleanup must not fail the save that triggered it)."""
    if not keep_last or keep_last <= 0:
        return []
    try:
        with _publish_lock:
            return _gc_tags_locked(save_dir, keep_last, counters)
    except Exception as e:  # noqa: BLE001 - advisory
        logger.warning(f"checkpoint retention GC failed: {e}")
        return []


def _gc_tags_locked(save_dir, keep_last, counters):
    tags = list_tags(save_dir)
    _sweep_empty_tag_dirs(save_dir, keep=set(tags))
    if len(tags) <= keep_last:
        return []
    try:
        ser.verify_tag(os.path.join(save_dir, tags[0]))
    except Exception as e:  # noqa: BLE001 - verification IS the gate
        logger.warning(
            f"checkpoint retention GC skipped: newest tag "
            f"{tags[0]!r} failed verification ({e}); keeping every "
            f"older generation as recovery candidates")
        return []
    protect = set(tags[:keep_last])
    latest = read_latest(save_dir)
    if latest:
        protect.add(latest)
    removed = []
    for t in tags[keep_last:]:
        if t in protect:
            continue
        shutil.rmtree(os.path.join(save_dir, t), ignore_errors=True)
        removed.append(t)
    if removed:
        logger.info(
            f"checkpoint retention (keep_last={keep_last}): removed "
            f"{len(removed)} old generation(s): {removed}")
        if counters is not None:
            counters["gc_removed"] += len(removed)
    return removed


def _sweep_empty_tag_dirs(save_dir, keep, min_age_s=900):
    """Failed saves leave empty tag directories behind (their tmp shard
    is unlinked on failure); sweep them so intermittent storage failures
    cannot grow an unbounded dir set. Two defenses against racing an
    in-flight save whose tag dir is momentarily empty: os.rmdir refuses
    non-empty dirs (a tag holding a tmp being written survives), and
    only dirs older than ``min_age_s`` are touched (a freshly created
    tag is younger; the write path also re-creates its dir on retry)."""
    try:
        names = os.listdir(save_dir)
    except OSError:
        return
    cutoff = time.time() - min_age_s
    for name in names:
        if name in keep:
            continue
        p = os.path.join(save_dir, name)
        if not os.path.isdir(p):
            continue
        try:
            if os.stat(p).st_mtime > cutoff:
                continue
            os.rmdir(p)
        except OSError:
            pass
