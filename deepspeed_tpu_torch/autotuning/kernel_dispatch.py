"""Autotune dispatch state: mode + winner cache, consulted where a knob is
"auto".

Own copy of ``deepspeed_tpu/autotuning/kernel_dispatch.py``.
``ops/cuda/_common.dispatch`` routes here. The state is process-global (a
knob resolves the same way in every call of a process) and is configured
by the training engine from the ``autotune`` config block, by the serving
engine from its ``autotune_mode`` / ``autotune_cache`` fields, by
``configure()`` directly, or by env:

  DSTPU_AUTOTUNE        off | cache_only | on_first_use | search
                        (default cache_only: a cache file with winners
                        activates them; no file means the defaults, i.e.
                        what the port runs without a cache)
  DSTPU_AUTOTUNE_CACHE  cache file path (default
                        ~/.cache/deepspeed_tpu/kernel_autotune.json)

Modes:
  off          never consult the cache; every "auto" knob takes its default
  cache_only   use cached winners, NEVER search (a cold key takes the
               defaults)
  on_first_use a cache hit wins; a miss runs a measured search for that
               (op, shape-bucket, dtype) once per process and persists the
               winner (a bucket with one candidate is not searched: its
               defaults, nothing persisted)
  search       re-measure every key once per process even if cached,
               persisting the new winners

Resolution is memoised per process: after the first call in a bucket each
dispatch is a dict lookup.

The device kind of a key is the card's name
(``torch.cuda.get_device_name``) on a CUDA device and ``"torch-cpu"`` on
the CPU, a name the JAX package (whose CPU kind is ``"cpu"``) never
writes: neither package's CPU entries can steer the other's, and no CPU
entry can steer the card.

Where the port departs from the JAX module: a search that fails (a
candidate that does not build or launch, or no candidate passing its
parity check) raises here, where JAX logs it and takes the defaults (an op
with no registry entry takes the defaults in both); and on a card a
winner naming a plain (step-by-step) version where a kernel runs
(``kernel_registry.names_plain``) raises, cached or measured, and is
never applied.
"""

import os

import torch

from ..utils.logging import logger
from .kernel_cache import KernelCache, default_cache_path, entry_key

MODES = ("off", "cache_only", "on_first_use", "search")
MODE_ENV = "DSTPU_AUTOTUNE"

_STATE = {
    "mode": None,          # None -> env/default at use time
    "cache_path": None,    # None -> env/default at use time
    "cache": None,         # lazily loaded KernelCache
    "resolved": {},        # key -> winner params (or None for a miss)
    "reports": {},         # key -> last search report
    "chain_lengths": (8, 24),
    "reps": 3,
    "searching": False,    # re-entrancy guard: a search never searches
    # a multi-rank serving engine's agreement (``set_agreement``): None,
    # or a callable with ``root`` that maps rank 0's winner to every rank;
    # the keys resolved under it have a memo of their own, which every
    # rank fills in the same order (a key this process resolved alone
    # must not skip a collective the other ranks enter)
    "agree": None,
    "agreed": {},
}


def configure(mode=None, cache_path=None, chain_lengths=None, reps=None):
    """Set the process-global autotune state; None keeps env/default
    resolution for that field. Clears the memo and the loaded cache so the
    new settings apply to later calls."""
    if mode is not None:
        if mode not in MODES:
            raise ValueError(
                f"autotune mode must be one of {MODES}, got {mode!r}")
        _STATE["mode"] = mode
    if cache_path is not None:
        _STATE["cache_path"] = cache_path or None
    if chain_lengths is not None:
        k1, k2 = chain_lengths
        _STATE["chain_lengths"] = (int(k1), int(k2))
    if reps is not None:
        _STATE["reps"] = int(reps)
    _STATE["cache"] = None
    _STATE["resolved"] = {}
    _STATE["agreed"] = {}


def configure_from_config(cfg):
    """Training-engine hook: apply the ``autotune`` config block
    (runtime/config.py AutotuneConfig) as the COMPLETE new state; an empty
    field reverts to env/default resolution rather than keeping an earlier
    engine's explicit setting."""
    if cfg.mode and cfg.mode not in MODES:
        raise ValueError(
            f"autotune mode must be one of {MODES}, got {cfg.mode!r}")
    _STATE["mode"] = cfg.mode or None
    _STATE["cache_path"] = cfg.cache_path or None
    _STATE["chain_lengths"] = tuple(int(k) for k in cfg.chain_lengths)
    _STATE["reps"] = int(cfg.reps)
    _STATE["cache"] = None
    _STATE["resolved"] = {}
    _STATE["agreed"] = {}


def configure_serving(mode="", cache_path=""):
    """Serving-engine hook: apply mode + cache path as the COMPLETE new
    state ("" = env/default for that field), keeping the search timing
    knobs. Each engine applies it at construction and before each of its
    programs runs, so engines sharing one model each dispatch under their
    own config. A no-op when that state is already installed: the memo and
    the loaded cache survive, so a search still runs once per process and
    the file is not re-read per call."""
    if mode and mode not in MODES:
        raise ValueError(
            f"autotune mode must be one of {MODES}, got {mode!r}")
    new_mode, new_path = mode or None, cache_path or None
    if _STATE["mode"] == new_mode and _STATE["cache_path"] == new_path:
        return
    _STATE["mode"] = new_mode
    _STATE["cache_path"] = new_path
    _STATE["cache"] = None
    _STATE["resolved"] = {}
    _STATE["agreed"] = {}


def set_agreement(agree):
    """Resolve every new key alike on all ranks of a multi-rank engine:
    ``agree`` has ``root`` (True on the rank that resolves: its cache
    lookup, or its measured search and the file write) and is called with
    that rank's winner (None elsewhere), returning it on every rank. The
    serving engine installs its own before each program runs (None on one
    rank)."""
    _STATE["agree"] = agree


def reset():
    """Back to the pristine env-driven state (tests)."""
    _STATE.update(mode=None, cache_path=None, cache=None, resolved={},
                  reports={}, chain_lengths=(8, 24), reps=3,
                  searching=False, agree=None, agreed={})


def current_mode():
    if _STATE["mode"] is not None:
        return _STATE["mode"]
    env = os.environ.get(MODE_ENV, "cache_only")
    if env not in MODES:
        logger.warning(f"{MODE_ENV}={env!r} is not one of {MODES}; "
                       f"using cache_only")
        return "cache_only"
    return env


def cache_path():
    return _STATE["cache_path"] or default_cache_path()


def reports():
    """The search reports of this process, by cache key."""
    return dict(_STATE["reports"])


def _device(device=None):
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def device_kind(device=None):
    """The kind of the device a call computes on, part of every cache key:
    the card's name on a CUDA device, ``"torch-cpu"`` on the CPU
    (``"torch-<type>"`` on another device type). ``device`` defaults to
    this process's current card, or the CPU without one."""
    dev = _device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(
            dev.index if dev.index is not None
            else torch.cuda.current_device())
    return f"torch-{dev.type}"


def _cache():
    if _STATE["cache"] is None:
        _STATE["cache"] = KernelCache.load(cache_path())
    return _STATE["cache"]


def resolve(op, bucket, dtype, defaults, device=None):
    """The winner's params for (device_kind, op, bucket, dtype) under the
    active mode, merged over ``defaults``; plain ``defaults`` on a miss or
    a refusal. Only keys present in ``defaults`` are returned, so a caller
    tuning a subset of an op's parameters gets exactly its own knobs
    back."""
    mode = current_mode()
    defaults = dict(defaults)
    if mode == "off" or _STATE["searching"]:
        return defaults
    dev = _device(device)
    dk = device_kind(dev)
    key = entry_key(dk, op, bucket, str(dtype))
    agree = _STATE["agree"]
    memo = _STATE["resolved" if agree is None else "agreed"]
    if key in memo:
        winner = memo[key]
    else:
        winner = None
        if agree is None or agree.root:
            if mode != "search":
                winner = _cache().lookup(dk, op, bucket, str(dtype))
            if winner is None and mode in ("on_first_use", "search"):
                winner = _search_and_store(op, bucket, str(dtype),
                                           defaults, dk, key, dev)
        if agree is not None:
            winner = agree(winner)
        if winner is not None and dev.type == "cuda":
            from .kernel_registry import names_plain
            plain = names_plain(op, winner)
            if plain:
                raise ValueError(
                    f"autotune: the winner for {key} names a plain "
                    f"(step-by-step) version ({plain}); on a card the "
                    f"kernels run: remove the entry from {cache_path()!r}")
        memo[key] = winner
    if winner is None:
        return defaults
    return {**defaults,
            **{k: v for k, v in winner.items() if k in defaults}}


def _search_and_store(op, bucket, dtype, defaults, dk, key, device):
    from . import kernel_autotuner, kernel_registry
    if op not in kernel_registry.REGISTRY or len(
            kernel_autotuner.candidates(op, bucket, dtype, defaults)) < 2:
        return None                 # nothing to choose: the defaults
    _STATE["searching"] = True
    try:
        winner, report = kernel_autotuner.search(
            op, bucket, dtype, defaults=defaults,
            chain_lengths=_STATE["chain_lengths"], reps=_STATE["reps"],
            device=device)
    finally:
        _STATE["searching"] = False
    _STATE["reports"][key] = report
    cache = _cache()
    cache.put(dk, op, bucket, dtype, winner,
              measured_ms=report["winner_ms"],
              default_ms=report["default_ms"],
              candidates=len(report["candidates"]))
    try:
        cache.save(cache_path())
    except OSError as e:
        logger.warning(f"autotune cache save to {cache_path()!r} "
                       f"failed: {e} (the winner still applies in this "
                       f"process)")
    return winner

