"""Parallel topology: the ranks of a ``torch.distributed`` world laid out
on the JAX package's named mesh axes, with one process group per axis.

Counterpart of ``deepspeed_tpu/utils/groups.py`` (``TopologyConfig`` :59,
``ParallelTopology`` :72, ``initialize`` :170, ``get_topology`` / ``reset``
:184-196). Where the JAX package reshapes its devices into a
``jax.sharding.Mesh`` of axes

    pipe, data_outer, data, expert, seq, tensor

(``seq`` and ``tensor`` innermost), this module reshapes the world's ranks
the same way: rank ``r`` sits at ``np.unravel_index(r, shape)``, so the
ranks of one ``seq`` group are consecutive, as the JAX mesh lays out its
devices. An axis (or a tuple of axes, major first, as JAX's collectives
take them) names the process group of the ranks that differ only along
it; a rank's index in that group is its ``axis_index``.

Groups are made on first use of an axis: ``dist.new_group`` is collective
over the whole world, and every rank asks for the same axes in the same
order because every rank runs the same program. A group that spans the
whole world is the default group. Without an initialized world the
topology has one rank and no groups; the comm layer then computes each
collective's one-rank result locally.

This slice runs the ``data``, ``data_outer`` and ``seq`` axes; a
``tensor``, ``pipe`` or ``expert`` axis of more than one rank raises,
naming its ROADMAP item.
"""

from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

MESH_AXES = ("pipe", "data_outer", "data", "expert", "seq", "tensor")

DP_AXES = ("data_outer", "data", "expert")    # non-expert-param DP
INNER_DP_AXES = ("data", "expert")            # intra-slice shard group
EXPERT_DP_AXES = ("data_outer", "data")       # expert-param data parallelism
GRAD_REDUCE_AXES = ("data_outer", "data", "expert", "seq")
BATCH_AXES = ("data_outer", "data", "expert")  # batch dim of the global batch

_TODO = {"tensor_parallel_size": "(ROADMAP Queue 1, M5: tensor parallel)",
         "pipe_parallel_size": "(ROADMAP Queue 1, M13: pipeline)",
         "expert_parallel_size": "(ROADMAP Queue 1, M10: MoE expert "
                                 "parallel)"}


@dataclass(frozen=True)
class TopologyConfig:
    """Sizes for each mesh axis. -1 for data = fill with remaining ranks.
    ``zero_shard_size``: subdivide DP so the inner 'data' axis has this
    size, replicating over 'data_outer'; -1 = all of DP on the inner
    axis."""
    data_parallel_size: int = -1
    tensor_parallel_size: int = 1
    pipe_parallel_size: int = 1
    seq_parallel_size: int = 1
    expert_parallel_size: int = 1
    zero_shard_size: int = -1


def _world():
    """(world size, rank) of the initialized world, else (1, 0)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ParallelTopology:
    """The world's ranks on the mesh axes; answers group-size/rank queries
    and owns the process group of each axis this rank uses."""

    def __init__(self, config: TopologyConfig = None, world_size=None,
                 rank=None):
        config = config or TopologyConfig()
        for name, item in _TODO.items():
            if getattr(config, name) > 1:
                raise NotImplementedError(
                    f"{name}={getattr(config, name)}: the PyTorch port does "
                    f"not carry this axis yet {item}")
        w, r = _world()
        n = w if world_size is None else world_size
        self.rank = r if rank is None else rank
        fixed = config.seq_parallel_size
        dp = config.data_parallel_size
        if dp == -1:
            if n % fixed != 0:
                raise ValueError(
                    f"world size {n} not divisible by tensor*pipe*seq*"
                    f"expert={fixed}")
            dp = n // fixed
        if dp * fixed != n:
            raise ValueError(
                f"data({dp}) * tensor(1) * pipe(1) * "
                f"seq({config.seq_parallel_size}) * expert(1) = "
                f"{dp * fixed} != world size {n}")
        shard = config.zero_shard_size
        if shard in (-1, 0):
            shard = dp
        if dp % shard != 0:
            raise ValueError(
                f"zero_shard_size {shard} does not divide data-parallel "
                f"size {dp}")
        self.config = TopologyConfig(
            data_parallel_size=dp, seq_parallel_size=config.seq_parallel_size,
            zero_shard_size=shard)
        self.shape = (1, dp // shard, shard, 1, config.seq_parallel_size, 1)
        self.ranks = np.arange(n).reshape(self.shape)
        self.coords = dict(zip(MESH_AXES,
                               np.unravel_index(self.rank, self.shape)))
        self._groups = {}

    # --- size getters (reference utils/groups.py:317-560 parity) ---
    @property
    def world_size(self):
        return self.ranks.size

    def axis_size(self, axis):
        return int(np.prod([self.shape[MESH_AXES.index(a)]
                            for a in _axes(axis)]))

    def get_data_parallel_world_size(self):
        """Replicas of a non-expert param: data_outer * data * expert."""
        return self.axis_size(DP_AXES)

    def get_expert_parallel_world_size(self):
        return self.axis_size("expert")

    def get_expert_data_parallel_world_size(self):
        return self.axis_size(EXPERT_DP_AXES)

    def get_zero_shard_group_size(self):
        return self.axis_size(INNER_DP_AXES)

    def get_model_parallel_world_size(self):
        return self.axis_size("tensor")

    def get_sequence_parallel_world_size(self):
        return self.axis_size("seq")

    def get_pipe_parallel_world_size(self):
        return self.axis_size("pipe")

    # --- ranks and groups ---
    def axis_index(self, axis):
        """This rank's index in the group of ``axis`` (a tuple: the
        flattened index, first axis major, as ``lax.axis_index``)."""
        idx = 0
        for a in _axes(axis):
            idx = idx * self.shape[MESH_AXES.index(a)] + int(self.coords[a])
        return idx

    def group_ranks(self, axis):
        """The global ranks of this rank's ``axis`` group, in axis-index
        order."""
        return [int(r) for r in self._rows(axis)[self._row_of(axis)]]

    def _rows(self, axis):
        axes = _axes(axis)
        ids = [MESH_AXES.index(a) for a in axes]
        rest = [i for i in range(len(MESH_AXES)) if i not in ids]
        return self.ranks.transpose(rest + ids).reshape(
            -1, self.axis_size(axes))

    def _row_of(self, axis):
        return int(np.nonzero((self._rows(axis) == self.rank).any(1))[0][0])

    def group(self, axis):
        """The process group of ``axis`` for this rank (None without an
        initialized world). The first call for an axis is collective over
        the whole world (``dist.new_group`` for every group of the
        axis)."""
        axes = _axes(axis)
        if axes not in self._groups:
            if not (dist.is_available() and dist.is_initialized()):
                self._groups[axes] = None
            else:
                rows = self._rows(axes)
                mine = None
                for i, row in enumerate(rows):
                    if len(row) == self.world_size:
                        g = dist.group.WORLD
                    else:
                        g = dist.new_group([int(r) for r in row])
                    if i == self._row_of(axes):
                        mine = g
                self._groups[axes] = mine
        return self._groups[axes]


def _axes(axis):
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in axes:
        if a not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {a!r}; expected one of "
                             f"{MESH_AXES}")
    return axes


_TOPOLOGY = None


def initialize(config: TopologyConfig = None, force=False):
    """Create (or return) the global topology; repeat calls with an
    equivalent (post-resolution) config return the same object."""
    global _TOPOLOGY
    if _TOPOLOGY is None or force:
        _TOPOLOGY = ParallelTopology(config)
    elif config is not None:
        candidate = ParallelTopology(config)
        if candidate.config != _TOPOLOGY.config:
            _TOPOLOGY = candidate
    return _TOPOLOGY


def get_topology():
    global _TOPOLOGY
    if _TOPOLOGY is None:
        _TOPOLOGY = ParallelTopology()
    return _TOPOLOGY


def reset():
    global _TOPOLOGY
    _TOPOLOGY = None
