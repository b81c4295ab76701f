"""Expert-parallel training in the port (runtime/engine.py's expert leaves,
runtime/zero/partitioning.py, models/gpt2_moe.py and models/mixtral.py at
``expert_parallel_size`` 2) and LAMB under ZeRO-1 at dp = 2, in gloo
worlds of 2 and 4 CPU processes (spawned once each through the
``moe_ep`` worker suite), held against the JAX engine on the virtual CPU
mesh, fp32:

- GPT2MoE (E = 4, top-2, ragged, ``moe_loss_coeff`` 1 so the aux
  gradient weighs, AdamW with a clip that acts) at ep = 2, ZeRO-1 and
  ZeRO-3, and at data 2 x expert 2, ZeRO-2: 3 ``train_batch`` steps, every
  rank's losses and final master (test_torch_moe_data_parallel.py's
  tolerances), each step's clipped gradients leaf by leaf at a relative
  error norm of 1e-4, and each run against the port at ep = 1 in this
  process with its global gradient norms (rtol 1e-5);
- Mixtral with the staged exchange at data_outer 2 x expert 2 (MiCS
  shard 1, experts over the (data_outer, expert) grid), ZeRO-1, the
  grouped kernels' plain versions in the port and ``lax.ragged_dot`` in
  JAX: losses and master;
- LAMB at ZeRO-1, dp = 2 (GPT-2): its per-leaf norms summed over the
  ranks that hold the master's shards: losses and master against JAX;
- a checkpoint at ep = 2 each way: the JAX engine's tag into the port
  (the next step's loss and master match the JAX engine's) and the port's
  tag (each rank writing its experts) into the JAX engine (its master
  bitwise the port's, the next loss at rtol 2e-5).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as J_TINY
from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import (MIXTRAL_TINY, GPT2MoE,
                                        GPT2MoEConfig,
                                        gpt2_moe_params_from_numpy)
from deepspeed_tpu_torch.utils import groups as tgroups
from test_torch_dist_worker import run_world

MOE = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=16, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False,
           num_experts=4, moe_top_k=2, moe_backend="ragged",
           moe_loss_coeff=1.0)
GPT = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=16, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)
MIX = dict(dtype="float32", remat=False, use_flash_attention=False,
           max_seq_len=16, vocab_size=128, num_experts=4)
MICRO = 2
CLIP = 0.5
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_NORM = 1e-4
CKPT_LOSS_RTOL = 2e-5
CKPT = "ep2_s1"


def _config(stage, dp, ep=2, opt=("AdamW", {"lr": 1e-3, "weight_decay": 0.01,
                                            "eps": 1e-6}), **over):
    cfg = {"train_batch_size": MICRO * dp, "steps_per_print": 0,
           "optimizer": {"type": opt[0], "params": dict(opt[1])},
           "gradient_clipping": CLIP, "zero_optimization": {"stage": stage},
           "expert_parallel_size": ep, "moe": {"grouped_kernel": False}}
    cfg.update(over)
    return cfg


def _batches(rows, seed, vocab=128, n=3):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, vocab, (rows, MOE["max_seq_len"]))
             .astype(np.int32)} for _ in range(n)]


NEXT = _batches(4, seed=99, n=1)[0]


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for k, v in tree["blocks"].items():
        if k == "moe":
            out.update({f"blocks.moe.{m}": a for m, a in v.items()})
        else:
            out[f"blocks.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _mixtral_cfgs():
    over = dict(MIX)
    jcfg = dataclasses.replace(J_TINY, **over)
    port = dataclasses.asdict(dataclasses.replace(MIXTRAL_TINY, **over))
    return jcfg, port


def _runs():
    """name -> (world, kind, port model cfg, port config, JAX model, JAX
    config, JAX topology kwargs, batches)."""
    out = {}
    lamb = _config(1, 2, ep=1, opt=("Lamb", {"lr": 2e-3,
                                             "weight_decay": 0.01}))
    out["lamb_dp2_s1"] = (2, "gpt2", GPT, lamb,
                          lambda: JGPT2(JGPT2Config(**GPT)), lamb, {},
                          _batches(4, seed=20))
    # the checkpointed run last: the process's topology is its own when
    # the checkpoint runs take their next step
    for stage in (3, 1):
        cfg = _config(stage, 2)
        out[f"ep2_s{stage}"] = (2, "gpt2_moe", MOE, cfg,
                                lambda: JGPT2MoE(JGPT2MoEConfig(**MOE)),
                                cfg, dict(expert_parallel_size=2),
                                _batches(4, seed=10 + stage))
    cfg = _config(2, 4)
    out["dp2_ep2_s2"] = (4, "gpt2_moe", MOE, cfg,
                         lambda: JGPT2MoE(JGPT2MoEConfig(**MOE)), cfg,
                         dict(expert_parallel_size=2), _batches(8, seed=30))
    jmix, mix = _mixtral_cfgs()
    staged = dict(zero_optimization={"stage": 1, "mics_shard_size": 1})
    out["mixtral_staged_s1"] = (
        4, "mixtral", mix,
        _config(1, 4, moe={"grouped_kernel": True}, **staged),
        lambda: JMixtral(jmix),
        _config(1, 4, moe={"grouped_kernel": False}, **staged),
        dict(data_parallel_size=2, zero_shard_size=1,
             expert_parallel_size=2), _batches(8, seed=40))
    return out


RUNS = _runs()


def _jax_run(jmodel, config, world, topo, batches, ckpt_dir=None):
    """The JAX engine's losses, master and each step's clipped gradients;
    with ``ckpt_dir`` it then saves a tag and takes NEXT (also returning
    the engine, that loss and master)."""
    jgroups.reset()
    topology = jgroups.initialize(jgroups.TopologyConfig(**topo),
                                  devices=jax.devices()[:world])
    engine, *_ = deepspeed_tpu.initialize(model=jmodel, topology=topology,
                                          config=config)
    master0 = jax.tree.map(np.asarray, engine.state["master"])
    steps, update = [], engine.optimizer.update

    def record(grads, state, master, lr=None):
        jax.debug.callback(lambda g: steps.append(_flat(g)), grads)
        return update(grads, state, master, lr=lr)
    engine.optimizer.update = record
    losses = [float(engine.train_batch(b)) for b in batches]
    jax.effects_barrier()
    engine.optimizer.update = update
    out = dict(master0=master0, losses=losses,
               master=_flat(engine.state["master"]), grads=list(steps))
    if ckpt_dir is not None:
        engine.save_checkpoint(ckpt_dir)
        out.update(engine=engine, next_loss=float(engine.train_batch(NEXT)),
                   next_master=_flat(engine.state["master"]))
    jgroups.reset()
    return out


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("jax_ep_ckpt"))


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port_ep_ckpt"))


@pytest.fixture(scope="module")
def jax_runs(jax_dir):
    return {name: _jax_run(jm(), jcfg, world, topo, b,
                           ckpt_dir=jax_dir if name == CKPT else None)
            for name, (world, _, _, _, jm, jcfg, topo, b) in RUNS.items()}


@pytest.fixture(scope="module")
def worlds(jax_runs, jax_dir, port_dir, tmp_path_factory):
    out = {}
    for world in (2, 4):
        runs = {name: dict(kind=kind, model=m, params=jax_runs[name][
            "master0"], config=cfg, batches=b)
            for name, (w, kind, m, cfg, _, _, _, b) in RUNS.items()
            if w == world}
        inputs = {"fn": {}, "runs": runs}
        if world == 2:
            inputs["ckpt"] = dict(names=[CKPT], dir=port_dir, next=NEXT,
                                  jax_dirs={CKPT: jax_dir})
        out[world] = run_world("moe_ep", world, inputs,
                               tmp_path_factory.mktemp(f"moe_ep_train{world}"))
    return out


def _res(worlds, name):
    return [o["res"][name] for o in worlds[RUNS[name][0]]]


@pytest.mark.parametrize("name", list(RUNS))
def test_train_batch_matches_jax(worlds, jax_runs, name):
    want = jax_runs[name]
    for got in _res(worlds, name):
        np.testing.assert_allclose(np.asarray(got["losses"]), want["losses"],
                                   **LOSS_TOL)
        assert set(got["master"]) == set(want["master"])
        for n, m in got["master"].items():
            np.testing.assert_allclose(m, want["master"][n], err_msg=n,
                                       **MASTER_TOL)


@pytest.mark.parametrize("name", [n for n in RUNS if RUNS[n][1] != "gpt2"])
def test_expert_leaves_are_split(worlds, name):
    """Each rank holds E / ep experts of every expert leaf (the router
    whole); Mixtral's staged exchange splits them over (data_outer,
    expert): E / 4."""
    kind = RUNS[name][1]
    n_shards = 4 if kind == "mixtral" else 2
    for got in _res(worlds, name):
        assert int(got["ep"]) == 2
        leaves = list(got["expert_leaves"])
        if kind == "mixtral":
            assert leaves == ["blocks.moe_w1", "blocks.moe_w2",
                              "blocks.moe_w3"]
        else:
            assert leaves == [f"blocks.moe.{k}" for k in
                              ("bi", "bo", "wi", "wo")]
        for n in leaves:
            assert got["shard_shapes"][n][1] * n_shards == \
                got["master"][n].shape[1], n


@pytest.mark.parametrize("name", [n for n in RUNS if RUNS[n][1] == "gpt2_moe"])
def test_clipped_grads_match_jax(worlds, jax_runs, name):
    want = jax_runs[name]["grads"]
    for got in _res(worlds, name):
        assert len(got["grads"]) == len(want) == 3
        for step, (g, w) in enumerate(zip(got["grads"], want)):
            assert set(g) == set(w)
            for n, x in g.items():
                err = np.linalg.norm(x - w[n]) / np.linalg.norm(w[n])
                assert err <= GRAD_REL_NORM, (name, step, n, err)


@pytest.mark.parametrize("name", [n for n in RUNS if RUNS[n][1] == "gpt2_moe"])
def test_equals_ep1(worlds, jax_runs, name):
    """The same run with one process (micro batch dp times larger, every
    expert local): the losses and each step's global gradient norm."""
    _, _, _, cfg, _, _, _, batches = RUNS[name]
    tgroups.reset()
    model = GPT2MoE(GPT2MoEConfig(**MOE), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(
        jax_runs[name]["master0"], "cpu", torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={**cfg, "expert_parallel_size": 1}, device="cpu")
    assert engine.dp == 1 and engine.model._moe_ep == 1
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(b)))
        norms.append(engine.get_global_grad_norm())
    tgroups.reset()
    for got in _res(worlds, name):
        np.testing.assert_allclose(np.asarray(got["losses"]), losses,
                                   **LOSS_TOL)
        np.testing.assert_allclose(np.asarray(got["grad_norms"]), norms,
                                   rtol=1e-5)


def _ckpt(worlds):
    return [o["res"]["ckpt"][CKPT] for o in worlds[2]]


def test_ckpt_ep2_writes_whole_leaves(worlds, port_dir):
    """Two shard files; each rank reloads its own tag bitwise."""
    tag_dir = os.path.join(port_dir, CKPT, "global_step3")
    assert sorted(os.listdir(tag_dir)) == ["shard-0.npz", "shard-1.npz"]
    for got in _ckpt(worlds):
        assert got["state_bitwise"]
        assert (got["global_step"], got["micro_steps"]) == (3, 3)


def test_ckpt_port_ep2_tag_loads_into_jax(worlds, jax_runs, port_dir):
    engine = jax_runs[CKPT]["engine"]
    got = _ckpt(worlds)[0]
    jgroups.reset()
    engine.load_checkpoint(os.path.join(port_dir, CKPT))
    master = _flat(engine.state["master"])
    for n, m in got["master"].items():
        assert np.array_equal(master[n], m), n
    loss = float(engine.train_batch(NEXT))
    np.testing.assert_allclose(loss, float(got["next_loss"]),
                               rtol=CKPT_LOSS_RTOL)


def test_ckpt_jax_ep2_tag_loads_into_port(worlds, jax_runs):
    want = jax_runs[CKPT]
    for got in _ckpt(worlds):
        np.testing.assert_allclose(float(got["from_jax_loss"]),
                                   want["next_loss"], rtol=CKPT_LOSS_RTOL)
        for n, m in got["from_jax_master"].items():
            np.testing.assert_allclose(m, want["next_master"][n], err_msg=n,
                                       **MASTER_TOL)
