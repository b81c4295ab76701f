"""The port's comm layer (deepspeed_tpu_torch/comm, utils/groups.py) held
against the JAX package's on CPU: the same program of collectives
(``test_torch_dist_worker.comm_program``) runs in a gloo world of 2 and 4
processes (spawned once each for the file) and inside a JAX ``shard_map``
on the virtual mesh, on the same numpy inputs. A sum of two fp32 terms
is exact in any order, so every result is held bitwise but the sum over
four ranks (``sum_both``), which gloo and XLA add in other orders (at
rtol 1e-6, a few ulps); the comms logger's byte counts are held
exactly. Also the process-ring
byte transports, the topology's rank layout and the device rule."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.comm import get_comms_logger as jlogger
from deepspeed_tpu.runtime.config import CommsLoggerConfig as JLogCfg
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import GPT2, GPT2Config
from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
from deepspeed_tpu_torch.utils import groups
from deepspeed_tpu_torch.utils.device import resolve_device
from test_torch_dist_worker import comm_program, run_world

WORLDS = (2, 4)


def _inputs(world):
    rs = np.random.RandomState(world)
    return {"x": rs.standard_normal((world, 4, 6)).astype(np.float32)}


def jax_program(program, module, x, world):
    """``program(module, block, world)`` in a shard_map over the data axes
    of ``world`` virtual devices (data_outer=2 beyond two); returns
    ({name: (world, ...) per-rank results}, the comms logger's dict)."""
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(
        zero_shard_size=2 if world > 2 else -1),
        devices=jax.devices()[:world])
    spec = P(("data_outer", "data"))

    def body(xb):
        return {k: v[None] for k, v in
                program(module, xb[0], world).items()}

    lg = jlogger()
    lg.reset()
    lg.configure(JLogCfg(enabled=True))
    try:
        fn = shard_map(body, mesh=topo.mesh, in_specs=spec, out_specs=spec,
                       check_vma=False)
        with jax.set_mesh(topo.mesh):
            res = jax.jit(fn)(jnp.asarray(x))
        log = {op: {ax: list(v) for ax, v in axes.items()}
               for op, axes in lg.comms_dict.items()}
    finally:
        lg.configure(JLogCfg(enabled=False))
        lg.reset()
    return {k: np.asarray(v) for k, v in res.items()}, log


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: run_world("comm", w, _inputs(w),
                         tmp_path_factory.mktemp(f"comm{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def jax_results():
    return {w: jax_program(comm_program, jcomm, _inputs(w)["x"], w)
            for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_every_op_matches_jax(worlds, jax_results, world):
    ref, _ = jax_results[world]
    outs = worlds[world]
    assert set(outs[0]["res"]) == set(ref)
    for name, want in ref.items():
        for rank, o in enumerate(outs):
            if name == "sum_both":
                np.testing.assert_allclose(o["res"][name], want[rank],
                                           rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(o["res"][name], want[rank],
                                              err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_comms_logger_bytes_match_jax(worlds, jax_results, world):
    _, ref = jax_results[world]
    for o in worlds[world]:
        assert o["log"] == ref


@pytest.mark.parametrize("world", WORLDS)
def test_byte_transports(worlds, world):
    outs = worlds[world]
    payloads = [bytes([r]) * (3 * r) for r in range(world)]
    for r, o in enumerate(outs):
        assert (o["rank"], o["world"]) == (r, world)
        assert o["ring"] == (payloads[(r - 1) % world], (r - 1) % world)
        s = 2 % world
        assert o["ring2"] == (payloads[(r - s) % world], (r - s) % world)
        assert o["gather"] == payloads


def test_single_process_world():
    """Without a world each collective is its one-rank result and the byte
    transports return None, as in the JAX package alone."""
    from deepspeed_tpu_torch import comm
    groups.reset()
    x = torch.arange(6.0).reshape(2, 3)
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    for out in (comm.all_reduce(x, "data"), comm.all_gather(x, "data"),
                comm.reduce_scatter(x, "seq"), comm.broadcast(x, "seq"),
                comm.all_to_all(x, "seq", 0, 1),
                comm.ppermute(x, "seq", [(0, 0)])):
        assert torch.equal(out, x) and out is not x
    assert comm.ring_exchange_bytes(b"abc") == (None, None)
    assert comm.allgather_bytes(b"abc") is None
    with pytest.raises(comm.comm.CommPayloadError):
        comm.allgather_bytes(b"\0" * (comm.comm.MAX_PAYLOAD_BYTES + 1))


@pytest.mark.parametrize("cfg", [
    dict(), dict(seq_parallel_size=2), dict(seq_parallel_size=4),
    dict(zero_shard_size=2), dict(seq_parallel_size=2, zero_shard_size=2)])
def test_topology_layout_matches_jax_mesh(cfg):
    """Rank r sits where device r sits in the JAX mesh: the same groups,
    sizes and axis indices for every rank of an 8-rank world."""
    j = jgroups.ParallelTopology(jgroups.TopologyConfig(**cfg),
                                 devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(j.mesh.devices)
    for rank in range(8):
        t = groups.ParallelTopology(groups.TopologyConfig(**cfg),
                                    world_size=8, rank=rank)
        assert t.shape == ids.shape
        pos = dict(zip(groups.MESH_AXES,
                       (int(i) for i in np.argwhere(ids == rank)[0])))
        for axis in ("data", "seq", "data_outer", ("data_outer", "data"),
                     groups.GRAD_REDUCE_AXES):
            assert t.axis_size(axis) == int(np.prod(
                [j.axis_size(a) for a in groups._axes(axis)]))
            want = 0
            for a in groups._axes(axis):
                want = want * j.axis_size(a) + pos[a]
            assert t.axis_index(axis) == want
            assert rank in t.group_ranks(axis)
            assert t.group_ranks(axis)[want] == rank
        for getter in ("data", "expert", "expert_data", "model",
                       "sequence", "pipe"):
            name = f"get_{getter}_parallel_world_size"
            assert getattr(t, name)() == getattr(j, name)(), name
        assert (t.get_zero_shard_group_size()
                == j.get_zero_shard_group_size())


def test_unported_axes_raise():
    with pytest.raises(NotImplementedError, match="M13"):
        groups.ParallelTopology(groups.TopologyConfig(pipe_parallel_size=2),
                                world_size=2, rank=0)
    # the tensor axis lays out (serving runs it); training refuses it
    t = groups.ParallelTopology(groups.TopologyConfig(tensor_parallel_size=2),
                                world_size=2, rank=1)
    assert t.shape == (1, 1, 1, 1, 1, 2) and t.axis_index("tensor") == 1
    with pytest.raises(NotImplementedError, match="M5: tensor parallel"):
        DeepSpeedEngine(GPT2(GPT2Config(n_layer=1, n_head=2, d_model=16,
                                        max_seq_len=8, vocab_size=32,
                                        dtype="float32"), device="cpu"),
                        {"train_micro_batch_size_per_gpu": 1,
                         "optimizer": {"type": "AdamW",
                                       "params": {"lr": 1e-3}}},
                        device="cpu", topology=t)
    # the expert axis is ported: ranks (data_outer, expert) as JAX's mesh
    t = groups.ParallelTopology(groups.TopologyConfig(
        expert_parallel_size=2, zero_shard_size=1), world_size=4, rank=3)
    assert t.shape == (1, 2, 1, 2, 1, 1)
    assert t.axis_index("expert") == 1 and t.axis_index("data_outer") == 1
    assert t.get_data_parallel_world_size() == 4
    assert t.get_expert_data_parallel_world_size() == 2
    with pytest.raises(ValueError, match="expert"):
        groups.ParallelTopology(groups.TopologyConfig(
            expert_parallel_size=3), world_size=4, rank=0)
    with pytest.raises(ValueError, match="divisible"):
        groups.ParallelTopology(groups.TopologyConfig(seq_parallel_size=3),
                                world_size=4, rank=0)


def test_resolve_device_takes_the_local_rank(monkeypatch):
    """An explicit device wins; otherwise cuda:$LOCAL_RANK, raising with
    the rank and the card count when that card does not exist (never
    wrapped round the cards)."""
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert resolve_device() == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match=r"LOCAL_RANK=3.*2 card"):
        resolve_device()
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device() == torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_backend_follows_the_device(monkeypatch):
    """init_distributed picks nccl on a card and gloo on the CPU; it runs
    alone (no world) without WORLD_SIZE, and refuses nccl off a card."""
    from deepspeed_tpu_torch.comm import comm
    seen = {}
    monkeypatch.setattr(comm.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(comm.dist, "init_process_group",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(comm.dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    comm.init_distributed(device="cpu", verbose=False)
    assert seen == {}
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    comm.init_distributed(device="cpu", verbose=False)
    assert (seen["backend"], seen["rank"], seen["world_size"]) == \
        ("gloo", 1, 2)
    comm.init_distributed(device="cuda:0", verbose=False)
    assert seen["backend"] == "nccl"
    comm.init_distributed(device="cuda:0", dist_backend="gloo",
                          verbose=False)
    assert seen["backend"] == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        comm.init_distributed(device="cpu", dist_backend="nccl",
                              verbose=False)
    assert os.environ["RANK"] == "1"
