"""ZeRO stages as per-leaf partition plans, and the flat collectives that
move a plan's shards.

Counterpart of ``deepspeed_tpu/runtime/zero/partitioning.py``. The JAX
package states each stage as sharding specs and lets GSPMD place the
collectives; the eager engine runs them itself (``runtime/engine.py``):

  stage 0: params, master and optimizer state whole on every rank; the
           gradients all-reduced.
  stage 1: the fp32 master and the optimizer moments partitioned over the
           partition axes; the gradients all-reduced, each rank updates its
           shard, the parameters re-made whole by an all-gather of the cast
           shards (the step-end all-gather, reference
           stage_1_and_2.py:1815).
  stage 2: + the gradients partitioned: reduce-scattered along the
           partition dim, each rank keeping its shard.
  stage 3: + the working parameters partitioned between steps, gathered
           whole for each micro step's forward and backward and freed after
           it.

A leaf is partitioned along its LAST dim that its base spec leaves free,
divisible by the partition count and at least as large (``lax.scan``
slices the stacked layer dim 0, so the JAX package keeps it whole); a leaf
with no such dim stays replicated. A rank's shard is the
``axis_index(axes)``-th equal slice along that dim.

A spec is a tuple with one entry per dim, as a JAX ``PartitionSpec``: None,
an axis name, or a tuple of axis names (major first). The base specs are
the model's tensor-parallel specs (``GPT2.partition_specs``), where
"tensor" marks a dim that is taken even at one tensor rank, so the port
partitions the same dim as JAX. A plan also holds each leaf's partition as
``(dim or None, axes)``.

MiCS partitions everything over ``INNER_DP_AXES`` (replicated over
``data_outer``); hpZ partitions only the stage-3 parameters over
``INNER_DP_AXES`` while master and moments stay on ``DP_AXES``.
"""

import torch

from ... import comm
from ...utils import groups
from ...utils.groups import DP_AXES, MESH_AXES


def _as_tuple(axes):
    return axes if isinstance(axes, tuple) else (axes,)


def _used_axes(spec):
    used = set()
    for entry in spec:
        if entry is not None:
            used.update(_as_tuple(entry))
    return used


def partition_of(shape, base_spec, axes, topology):
    """``(dim, axes)`` of the partition ``add_partition_axis`` adds, or
    ``(None, axes)`` for a leaf that stays replicated; ``axes`` lose those
    the base spec already uses."""
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))
    used = _used_axes(spec)
    ax = tuple(a for a in _as_tuple(axes) if a not in used)
    count = topology.axis_size(ax) if ax else 1
    if count == 1:
        return None, ax
    for dim in reversed(range(len(shape))):
        if spec[dim] is None and shape[dim] % count == 0 \
                and shape[dim] >= count:
            return dim, ax
    return None, ax


def add_partition_axis(shape, base_spec, axes, topology):
    """``base_spec`` with ``axes`` on the last eligible dim (JAX
    ``add_partition_axis``): a spec tuple of ``len(shape)`` entries."""
    spec = list(base_spec) + [None] * (len(shape) - len(base_spec))
    dim, ax = partition_of(shape, base_spec, axes, topology)
    if dim is not None:
        spec[dim] = ax if len(ax) > 1 else ax[0]
    return tuple(spec)


class ZeroShardingPlan:
    """The partition of every leaf for params, master (and the optimizer
    moments) and grads. ``tp_specs``: name -> base spec (missing names are
    replicated); ``shapes``: name -> shape."""

    def __init__(self, stage, topology, tp_specs, shapes,
                 partition_axes=DP_AXES, param_partition_axes=None):
        self.stage = stage
        self.topology = topology
        self.partition_axes = partition_axes
        self.param_partition_axes = param_partition_axes or partition_axes
        self.tp_specs = {n: tuple(tp_specs.get(n, ())) for n in shapes}
        self.shapes = {n: tuple(s) for n, s in shapes.items()}

        # params partitioned at stage 3, master + moments from stage 1,
        # grads (the master's partition) from stage 2
        self._axes = {"param": self.param_partition_axes,
                      "master": partition_axes, "grad": partition_axes}
        self._on = {"param": stage >= 3, "master": stage >= 1,
                    "grad": stage >= 2}
        self.parts = {
            w: {n: (partition_of(s, self.tp_specs[n], self._axes[w],
                                 topology) if self._on[w] else (None, ()))
                for n, s in self.shapes.items()}
            for w in self._on}

    def specs(self, which):
        """name -> spec tuple of ``which`` ("param", "master", "grad"):
        the base spec where the stage leaves ``which`` whole, as JAX."""
        if not self._on[which]:
            return dict(self.tp_specs)
        return {n: add_partition_axis(s, self.tp_specs[n],
                                      self._axes[which], self.topology)
                for n, s in self.shapes.items()}

    def partitioned(self, which):
        """Names whose ``which`` leaf is partitioned."""
        return [n for n, (dim, _) in self.parts[which].items()
                if dim is not None]

    def describe(self):
        """JSON-able summary (the JAX ``describe``): stage, partition
        axes and group size, the mesh shape and each leaf's master spec,
        keyed by its tree path ("blocks/wqkv")."""
        topo = self.topology
        return {
            "stage": self.stage,
            "partition_axes": list(self.partition_axes),
            "partition_group": topo.axis_size(self.partition_axes),
            "mesh_shape": {a: int(s) for a, s in zip(MESH_AXES,
                                                     topo.shape)},
            "master_specs": {
                n.replace(".", "/"): [list(e) if isinstance(e, tuple) else e
                                      for e in spec]
                for n, spec in self.specs("master").items()},
        }


def reshape_diff(saved_desc, plan):
    """The leaves whose master partition changed between a recorded plan
    description and ``plan`` ('resharded'), those ``plan`` leaves
    replicated at stage >= 1 ('replicated'), and the old / new partition
    group sizes and stages (the JAX ``reshape_diff``)."""
    new_desc = plan.describe()
    old_specs = (saved_desc or {}).get("master_specs", {})
    resharded, replicated = [], []
    for key, new_spec in new_desc["master_specs"].items():
        old_spec = old_specs.get(key)
        if old_spec is not None and old_spec != new_spec:
            resharded.append(key)
        if plan.stage >= 1 and all(e is None for e in new_spec):
            replicated.append(key)
    return {
        "resharded": sorted(resharded),
        "replicated": sorted(replicated),
        "old_partition_group": (saved_desc or {}).get("partition_group"),
        "new_partition_group": new_desc["partition_group"],
        "old_stage": (saved_desc or {}).get("stage"),
        "new_stage": new_desc["stage"],
    }


# ------------------------------------------------------------ shards


def shard(x, dim, axes, topology):
    """This rank's slice of ``x`` along ``dim`` over ``axes`` (a view)."""
    n = topology.axis_size(axes)
    size = x.shape[dim] // n
    return x.narrow(dim, topology.axis_index(axes) * size, size)


def _split_rows(tensors, dims, n):
    """Each tensor with its partition dim moved first, as (n, -1)."""
    return [t.movedim(d, 0).reshape(n, -1) for t, d in zip(tensors, dims)]


def _unsplit(flat_rows, like, dims, n, whole):
    """The inverse of ``_split_rows`` for one (n or 1, -1) piece a leaf:
    ``whole`` gives the full leaf (all n rows), else one shard."""
    out = []
    for piece, t, d in zip(flat_rows, like, dims):
        moved = list(t.movedim(d, 0).shape)
        moved[0] = moved[0] * n if whole else moved[0] // n
        out.append(piece.reshape(moved).movedim(0, d))
    return out


def flat_reduce_scatter(tensors, dims, axes):
    """The sum over ``axes`` of each full tensor (one dtype), this rank's
    shard of each along its dim: one ``reduce_scatter`` of one flat
    buffer."""
    topo = groups.get_topology()
    n = topo.axis_size(axes)
    rows = _split_rows(tensors, dims, n)
    flat = torch.cat(rows, dim=1).reshape(-1)
    out = comm.reduce_scatter(flat, axes)
    pieces = out.split([r.shape[1] for r in rows])
    return _unsplit(pieces, tensors, dims, n, whole=False)


def flat_all_gather(shards, dims, axes):
    """Each leaf made whole from the ranks' shards along its dim: one
    ``all_gather`` of one flat buffer (one dtype)."""
    topo = groups.get_topology()
    n = topo.axis_size(axes)
    flat = torch.cat([s.movedim(d, 0).reshape(-1)
                      for s, d in zip(shards, dims)])
    rows = comm.all_gather(flat, axes).view(n, -1)
    pieces = rows.split([s.numel() for s in shards], dim=1)
    return _unsplit(pieces, shards, dims, n, whole=True)
