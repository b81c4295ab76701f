"""Measured kernel-lever search (the dispatch layer's slow path).

Counterpart of ``deepspeed_tpu/autotuning/kernel_autotuner.py``: each
candidate of ``kernel_registry.REGISTRY`` is timed on the device the call
computes on, and the winner is cached per (device_kind, op, shape-bucket,
dtype).

Timing: the candidate's step (forward and backward where the op has one)
is chained, each step's output feeding the next, at two chain lengths
(default 8 and 24); the slope between them is the per-step time, best of
``reps``. The slope cancels the fixed cost of a chain. On a card the chain
is a host loop queued behind a device spin (``torch.cuda._sleep``, as long
as twice the host's queueing of the longer chain): the host queues every
step while the device spins, and CUDA events around the chain see the
steps back to back, not the Python launch path (a K4 call of 0.02 ms is
shorter than its launch). On the CPU, ``time.perf_counter``.

JAX's semantics are kept: candidate 0 is the complete defaults, candidates
are deduplicated, the fastest candidate that passes its parity check wins,
and the report holds every candidate's ms, the winner's and the
defaults'. Where the port departs: every candidate's parity is checked
(the report carries each result), and a candidate that fails to build or
launch raises, as does a search with no candidate passing its parity: a
fault to show, not a timing to route around. JAX's worker thread (a jax
tracing workaround) has no counterpart.
"""

import math
import time

import torch

from ..utils.logging import logger
from . import kernel_registry

# device-spin cycles a millisecond of host queueing (an H100 clocks at up
# to 1.98 GHz; a slower clock only spins longer)
_SPIN_CYCLES_PER_MS = 2_000_000
_SPIN_MIN_MS = 1.0
_SPIN_MAX_MS = 2000.0


def _chain(step_fn, args, k):
    a = args
    for _ in range(k):
        a = step_fn(a)
    return a


def _chain_ms_cuda(step_fn, args, k, spin_ms):
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_ms * _SPIN_CYCLES_PER_MS))
    t0.record()
    _chain(step_fn, args, k)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def _chain_ms_cpu(step_fn, args, k):
    t0 = time.perf_counter()
    _chain(step_fn, args, k)
    return 1e3 * (time.perf_counter() - t0)


def time_step(step_fn, args, chain_lengths=(8, 24), reps=3, device=None):
    """Per-step milliseconds of ``step_fn`` (tuple -> tuple of the same
    structure) on ``device``: the slope between two chain lengths, each the
    best of ``reps``."""
    k1, k2 = chain_lengths
    if not (0 < k1 < k2):
        raise ValueError(f"need 0 < k1 < k2, got {chain_lengths}")
    dev = torch.device(device) if device is not None else args[0].device
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            step_fn(args)                       # build, bind, warm
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            _chain(step_fn, args, k2)
            host_ms = 1e3 * (time.perf_counter() - h0)
            torch.cuda.synchronize()
            spin = min(_SPIN_MAX_MS, max(_SPIN_MIN_MS, 2.0 * host_ms))
            times = [min(_chain_ms_cuda(step_fn, args, k, spin)
                         for _ in range(max(1, reps)))
                     for k in (k1, k2)]
    else:
        step_fn(args)
        times = [min(_chain_ms_cpu(step_fn, args, k)
                     for _ in range(max(1, reps)))
                 for k in (k1, k2)]
    return (times[1] - times[0]) / (k2 - k1)


def candidates(op, bucket, dtype, defaults=None):
    """The deduplicated candidates of (op, bucket, dtype), the complete
    defaults first: the registry's, with ``defaults`` (if given) merged
    over them, so the fallback is measured beside the rest."""
    spec = kernel_registry.REGISTRY.get(op)
    if spec is None:
        raise KeyError(f"no tunable registry entry for op {op!r}")
    b = kernel_registry.parse_bucket(bucket)
    base = spec["defaults"](b)
    cands = [dict(base, **{k: v for k, v in (defaults or {}).items()
                           if k in base})]
    cands.extend(spec["candidates"](b, dtype))
    return kernel_registry._dedup(cands)


def search(op, bucket, dtype, defaults=None, chain_lengths=(8, 24),
           reps=3, device=None):
    """Measure every candidate of (op, bucket, dtype) on ``device`` (default:
    this process's card, or the CPU without one) and check its parity (a
    candidate failing it cannot win); returns ``(winner_params, report)``.
    ``defaults`` as in ``candidates``: ``default_ms`` lands in the cache
    entry."""
    from .kernel_dispatch import _device, device_kind
    spec = kernel_registry.REGISTRY[op]
    dev = _device(device)
    b = kernel_registry.parse_bucket(bucket)
    cands = candidates(op, bucket, dtype, defaults)

    rows = []
    for params in cands:
        # a search may start inside a serving program's inference mode;
        # its steps make tensors of their own and may need autograd
        with torch.inference_mode(False):
            step_fn, args = spec["make_step"](b, dtype, params, dev)
            ms = time_step(step_fn, args, chain_lengths, reps, dev)
        del step_fn, args
        # the two chain lengths are timed apart, so noise can drive the
        # slope of a very cheap step through zero; clamp (the sort below
        # is stable, so among ties the defaults win)
        row = {"params": params, "ms": max(ms, 0.0), "error": None,
               "parity": "ok"}
        try:
            with torch.inference_mode(False):
                spec["parity"](b, dtype, params, dev)
        except AssertionError as e:
            row["parity"] = f"{type(e).__name__}: {e}"[:300]
            row["error"] = "parity"
            logger.warning(f"autotune {op}/{bucket}: candidate {params} "
                           f"failed parity ({e})")
        rows.append(row)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ok = sorted((r for r in rows if r["error"] is None),
                key=lambda r: r["ms"])
    if not ok:
        raise RuntimeError(
            f"autotune search {op}/{bucket}/{dtype}: no candidate passed "
            f"the parity check: {[r['parity'] for r in rows]}")
    winner = ok[0]
    default_ms = rows[0]["ms"]
    report = {"op": op, "bucket": bucket, "dtype": dtype,
              "device_kind": device_kind(dev), "candidates": rows,
              "winner": winner["params"], "winner_ms": winner["ms"],
              "default_ms": default_ms if math.isfinite(default_ms)
              else None}
    logger.info(
        f"autotune {op}/{bucket}/{dtype}: winner {winner['params']} "
        f"({winner['ms']:.4f} ms a step over {len(rows)} candidates; "
        f"defaults {default_ms:.4f} ms)")
    return dict(winner["params"]), report
