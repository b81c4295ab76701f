"""Persistent winner cache for the measured kernel dispatch.

Own copy of ``deepspeed_tpu/autotuning/kernel_cache.py``, with the same
file format byte for byte, so one file can hold both packages' entries and
a file written by either loads in the other. One entry per
(device_kind, op, shape-bucket, dtype) holds the measured winner's
parameters. ``ops/cuda/_common.dispatch`` consults it when a knob is
"auto"; the models memoise nothing themselves (``kernel_dispatch`` does,
per process).

Entries record the ``device_kind`` they were measured on
(``kernel_dispatch.device_kind``: the card's name, or ``"torch-cpu"`` for
the port on the CPU, a name the JAX package never writes) and ``lookup``
REFUSES an entry measured on another kind: a CPU cache, whose timings order
candidates by the plain versions' cost, must never steer a card, and the
JAX package's entries never steer the port (nor the port's them). A refused
entry is a miss.

File format (versioned, serialized deterministically so that a round trip
is byte-identical):

    {"version": 1,
     "entries": {
       "<device_kind>|<op>|<bucket>|<dtype>": {
         "device_kind": ..., "op": ..., "bucket": ..., "dtype": ...,
         "params": {...}, "measured_ms": ..., "default_ms": ...,
         "candidates": N}}}

Writes are atomic (tmp + fsync + rename): a crash mid-save never corrupts
the previous generation of the file.
"""

import json
import math
import os

from ..utils.logging import logger

CACHE_VERSION = 1

# env override consulted by default_cache_path(); an explicit path (the
# training config's autotune.cache_path, the serving engine's
# autotune_cache) wins over it
CACHE_PATH_ENV = "DSTPU_AUTOTUNE_CACHE"
_DEFAULT_DIRNAME = os.path.join("~", ".cache", "deepspeed_tpu")
_DEFAULT_BASENAME = "kernel_autotune.json"


def default_cache_path():
    """$DSTPU_AUTOTUNE_CACHE if set, else
    ~/.cache/deepspeed_tpu/kernel_autotune.json (the JAX package's file)."""
    env = os.environ.get(CACHE_PATH_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser(_DEFAULT_DIRNAME),
                        _DEFAULT_BASENAME)


def entry_key(device_kind, op, bucket, dtype):
    return f"{device_kind}|{op}|{bucket}|{dtype}"


class KernelCache:
    """In-memory view of one cache file; load and save are explicit."""

    def __init__(self, entries=None):
        self.entries = dict(entries or {})

    @classmethod
    def load(cls, path):
        """Read ``path``; a missing, corrupt or other-version file is an
        EMPTY cache (every lookup then misses): a bad cache degrades to
        the defaults, it never stops a run."""
        try:
            with open(path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            return cls()
        except (OSError, ValueError) as e:
            logger.warning(f"autotune cache {path!r} unreadable "
                           f"({type(e).__name__}: {e}); ignoring it")
            return cls()
        if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
            logger.warning(
                f"autotune cache {path!r} has version "
                f"{raw.get('version') if isinstance(raw, dict) else '?'} "
                f"(want {CACHE_VERSION}); ignoring it")
            return cls()
        entries = raw.get("entries", {})
        if not isinstance(entries, dict):
            return cls()
        return cls(entries)

    def to_json(self):
        """Deterministic serialization (sorted keys, indent 2, a final
        newline): the same entries always give the same bytes."""
        return json.dumps({"version": CACHE_VERSION,
                           "entries": self.entries},
                          indent=2, sort_keys=True) + "\n"

    def save(self, path):
        """Atomic write: tmp + fsync + rename."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def lookup(self, device_kind, op, bucket, dtype):
        """The winner's params for the key, or None. An entry whose recorded
        device_kind is not ``device_kind`` is REFUSED: a plain miss."""
        e = self.entries.get(entry_key(device_kind, op, bucket, dtype))
        if e is None:
            return None
        if e.get("device_kind") != device_kind:
            logger.warning(
                f"autotune cache: refusing entry for op={op!r} "
                f"bucket={bucket!r}: measured on "
                f"{e.get('device_kind')!r}, running on {device_kind!r}")
            return None
        params = e.get("params")
        return dict(params) if isinstance(params, dict) else None

    def put(self, device_kind, op, bucket, dtype, params,
            measured_ms=None, default_ms=None, candidates=None):
        def fin(v):
            # non-finite floats would serialize as the non-standard
            # 'Infinity' / 'NaN' tokens and break strict JSON readers
            return v if v is None or (isinstance(v, (int, float))
                                      and math.isfinite(v)) else None

        self.entries[entry_key(device_kind, op, bucket, dtype)] = {
            "device_kind": device_kind, "op": op, "bucket": bucket,
            "dtype": dtype, "params": dict(params),
            "measured_ms": fin(measured_ms), "default_ms": fin(default_ms),
            "candidates": candidates,
        }

    def __len__(self):
        return len(self.entries)


def seed_entries(rows, path=None):
    """Merge externally measured rows (dicts in cache-entry shape:
    device_kind / op / bucket / dtype / params [+ measured_ms, default_ms,
    candidates]) into the cache file with the same atomic write as
    ``save``; malformed rows are skipped. Returns the number merged."""
    path = path or default_cache_path()
    cache = KernelCache.load(path)
    n = 0
    for r in rows or []:
        if not isinstance(r, dict):
            continue
        try:
            cache.put(str(r["device_kind"]), str(r["op"]),
                      str(r["bucket"]), str(r.get("dtype", "float32")),
                      dict(r.get("params") or {}),
                      measured_ms=r.get("measured_ms"),
                      default_ms=r.get("default_ms"),
                      candidates=r.get("candidates"))
            n += 1
        except (KeyError, TypeError, ValueError):
            continue
    cache.save(path)
    return n
