"""Shared inference-engine helpers: a rank's slice of a model's weights.

Counterpart of ``deepspeed_tpu/inference/utils.py`` (``shard_params``).
The JAX engine places the whole parameter tree on its mesh under the
model's ``partition_specs`` (quantized first, host-side, when the engine
quantizes); each device then holds its shard of every leaf. The port's
multi-rank engine is one process a rank, so each process keeps its own
shard and drops the rest:

  * a leaf whose spec names mesh axes along a dim keeps this rank's
    ``axis_index``-th equal slice of that dim (``tensor`` on the column
    dim of ``wq`` / ``wk`` / ``wv`` / ``wgate`` / ``wup`` and their biases,
    on the row dim of ``wo`` / ``wdown``; the experts over ``expert``);
    every other leaf stays whole;
  * a quantized leaf is sliced as ``ops/int8_weights.quantized_slice``
    places it (a row shard keeps the global per-channel scale), from the
    whole tree's quantization;
  * a fused leaf (GPT-2's ``wqkv`` (L, D, 3D) / ``bqkv`` (L, 3D): the
    column dim laid out (3, H, hd)) is split per head: the rank keeps its
    H / tp heads of q, of k and of v. The JAX spec names a contiguous
    third of the 3D axis, which under GSPMD is only a placement (XLA
    reshards before the head split); a contiguous slice would hand rank 0
    all of Q and half of K. The per-head slice computes the same function.

A dim that does not divide over its axis raises ``ValueError``, as the
JAX placement does.
"""

import torch.nn as nn

from ..ops.int8_weights import is_quantized, quantized_slice


def _entries(spec, ndim):
    """The spec's axes (or None) for each of ``ndim`` dims."""
    spec = tuple(spec or ())
    return list(spec) + [None] * (ndim - len(spec))


def _narrow(x, d, parts, index, fused, name):
    """Slice ``index`` of ``parts`` along dim ``d`` of a tensor or a
    quantized leaf; with ``fused`` > 1 the dim is ``fused`` equal
    sections and each is sliced so (the per-head split)."""
    n = x.shape[d]
    if n % (parts * fused):
        raise ValueError(
            f"{name}: dim {d} of {n} does not divide over {parts} ranks"
            + (f" ({fused} fused sections)" if fused > 1 else ""))
    if fused == 1:
        if is_quantized(x):
            return quantized_slice(x, d, parts, index)
        size = n // parts
        return x.narrow(d, index * size, size).contiguous()
    size = n // fused // parts

    def cut(t):
        sec = t.unflatten(d, (fused, t.shape[d] // fused))
        return sec.narrow(d + 1, index * size, size).flatten(
            d, d + 1).contiguous()
    if is_quantized(x):
        if d != len(x.shape) - 1:
            raise ValueError(f"{name}: a fused quantized leaf is split on "
                             f"its output dim only")
        return type(x)(cut(x.q), cut(x.scale))
    return cut(x)


def shard_leaf(x, spec, topology, fused=1, name="leaf"):
    """This rank's slice of leaf ``x`` (a tensor or a quantized leaf)
    under ``spec`` (a tuple of axis names, tuples of names or None per
    dim; empty = whole). ``fused``: the sliced dim holds that many fused
    sections, each split per head (GPT-2's ``wqkv`` / ``bqkv``: 3)."""
    for d, axes in enumerate(_entries(spec, len(x.shape))):
        if axes is None:
            continue
        parts = topology.axis_size(axes)
        if parts == 1:
            continue
        x = _narrow(x, d, parts, topology.axis_index(axes), fused, name)
    return x


def shard_model(model, topology):
    """Keep this rank's slice of every block leaf of ``model`` in place
    (its ``partition_specs(topology)``; the top-level leaves are whole in
    every spec), quantized leaves included, and set the
    model's serving topology (``_serving_topology_``: the local head
    counts, the sums over ``tensor``, the experts over ``expert``). The
    model raises first where its heads do not divide over the tensor
    axis, or where it has no multi-rank programs. A no-op on a world of
    one rank, and for a model already sliced to ``topology`` (engines
    that share a model: the self-draft, a second engine)."""
    held = model._serving_topo
    if held is topology:
        return model             # an engine sharing the model sliced it
    if held is not None:
        raise ValueError("the model already holds its slices of another "
                         "topology")
    model._check_serving_topology(topology)
    if topology.world_size == 1:
        return model
    specs = model.partition_specs(topology)
    fused = getattr(model, "_FUSED_SECTIONS", {})
    for key, p in list(model.blocks.named_parameters()):
        leaf = shard_leaf(p.data, specs.get(f"blocks.{key}", ()), topology,
                          fused.get(key, 1), key)
        if leaf is not p.data:     # one leaf at a time: the whole one frees
            model.blocks[key] = nn.Parameter(leaf, requires_grad=False)
    for key, w in list(model.qblocks.items()):
        model.qblocks[key] = shard_leaf(w, specs.get(f"blocks.{key}", ()),
                                        topology, fused.get(key, 1), key)
    model._serving_topology_(topology)
    return model


__all__ = ["shard_leaf", "shard_model"]
