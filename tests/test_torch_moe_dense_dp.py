"""The GShard capacity MoE backend at dp = 2 in the port held against the
JAX package's global-batch gating, in one gloo world of 2 processes
(spawned once), fp32. In JAX the gate sees GSPMD's global (S, E) logits;
each port rank routes its own rows with the engine's batch axes:

- the gates: each rank's rows of a global logits matrix routed with the
  axes give, put together, JAX's routing of the whole matrix: C from the
  global token count, each token's queue position counted over the
  global batch rank-major (top-2's second queue after every rank's first
  choices), the dispatch mask and ``exp_counts`` exactly, ``combine`` and
  ``l_aux`` (the same on both ranks) at 1e-6, the noise the rank's rows
  of the global draw; the gradient of ``l_aux`` with respect to a rank's
  logits is the JAX gradient's rows for that rank times the rank count
  (each rank's loss reads the global term and the engine averages the
  ranks' gradients);
- 3 ``train_batch`` steps of a tiny dense GPT2MoE (top-1 with RSample
  and top-2 with second-expert sampling, capacity factor 0.5 so tokens
  drop, ``moe_loss_coeff`` 1) from the JAX engine's initial master
  against the JAX engine on a 2-device CPU mesh: losses at rtol 1e-4,
  master at rtol 1e-4 / atol 1e-5 (test_torch_moe_data_parallel.py's
  tolerances), the key words bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.moe import sharded_moe as J
from deepspeed_tpu.utils import groups as jgroups
from test_torch_dist_worker import run_world
from test_torch_moe_dense import dense_combine
from test_torch_moe_data_parallel import _flat

WORLD = 2
MICRO = 2
CFG = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=16, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False,
           num_experts=4, moe_backend="dense", capacity_factor=0.5,
           min_capacity=1, moe_loss_coeff=1.0)
RUNS = {"top1_rsample": dict(noisy_gate_policy="RSample"),
        "top2_sampling": dict(moe_top_k=2)}
GATES = {
    "top1": dict(k=1, cf=1.0, mc=1, policy=None, seed=0),
    "top1_drops_rsample": dict(k=1, cf=0.5, mc=1, policy="RSample", seed=1),
    "top1_jitter": dict(k=1, cf=1.25, mc=4, policy="Jitter", seed=2),
    "top2": dict(k=2, cf=0.5, mc=1, sampling=False, seed=3),
    "top2_sampling": dict(k=2, cf=1.0, mc=4, sampling=True, seed=4),
}


def _gate_inputs():
    rs = np.random.RandomState(5)
    return {name: dict(g, logits=(2 * rs.standard_normal((2 * 24, 4)))
                       .astype(np.float32)) for name, g in GATES.items()}


def _config(stage):
    return {"train_batch_size": MICRO * WORLD, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}},
            "gradient_clipping": 0.5, "zero_optimization": {"stage": stage}}


def _batches(seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (MICRO * WORLD, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(3)]


def _run(name):
    stage = 2 if name == "top1_rsample" else 0
    return dict(model={**CFG, **RUNS[name]}, config=_config(stage),
                batches=_batches(len(name)))


@pytest.fixture(scope="module")
def master0():
    return {name: jax.tree.map(np.asarray, JGPT2MoE(JGPT2MoEConfig(
        **{**CFG, **over})).init(jax.random.key(0)))
        for name, over in RUNS.items()}


@pytest.fixture(scope="module")
def world(master0, tmp_path_factory):
    runs = {name: dict(_run(name), params=master0[name]) for name in RUNS}
    return run_world("moe_dense_dp", WORLD,
                     {"gates": _gate_inputs(), "runs": runs},
                     tmp_path_factory.mktemp("moe_dense_dp"))


@pytest.mark.parametrize("name", list(GATES))
def test_gates_route_the_global_batch(world, name):
    g = _gate_inputs()[name]
    logits = jnp.asarray(g["logits"])
    key = jax.random.key(g["seed"])
    if g["k"] == 1:
        def fn(x):
            return J.top1gating(x, g["cf"], g["mc"], g["policy"], key)
    else:
        def fn(x):
            return J.top2gating(x, g["cf"], g["mc"], key, True,
                                g["sampling"])
    jl, jc, jd, je = fn(logits)
    jgrad = np.asarray(jax.grad(lambda x: fn(x)[0])(logits))
    outs = [o["res"]["gates"][name] for o in world]
    whole = type("G", (), {})()
    whole.capacity = outs[0]["capacity"]
    for f in ("experts", "locations", "weights"):
        setattr(whole, f, torch.from_numpy(np.concatenate(
            [o[f] for o in outs])))
    assert all(o["capacity"] == jc.shape[2] for o in outs)
    comb = dense_combine(whole, 4)
    np.testing.assert_array_equal(comb > 0, np.asarray(jd))
    np.testing.assert_allclose(comb, np.asarray(jc), rtol=1e-6, atol=1e-7)
    S = 24
    for r, o in enumerate(outs):
        np.testing.assert_allclose(float(o["l_aux"]), float(jl), rtol=1e-6)
        np.testing.assert_array_equal(o["exp_counts"], np.asarray(je))
        np.testing.assert_allclose(o["l_aux_grad"],
                                   WORLD * jgrad[r * S:(r + 1) * S],
                                   rtol=1e-5, atol=1e-7)
    if g["cf"] <= 0.5:
        assert (comb > 0).sum() < g["k"] * 2 * S        # tokens dropped


def _jax_run(name):
    run = _run(name)
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(),
                              devices=jax.devices()[:WORLD])
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2MoE(JGPT2MoEConfig(**run["model"])), topology=topo,
        config=run["config"])
    losses = [float(engine.train_batch(b)) for b in run["batches"]]
    key = np.asarray(jax.random.key_data(engine.state["rng"]))
    jgroups.reset()
    return losses, _flat(engine.state["master"]), key


@pytest.mark.parametrize("name", list(RUNS))
def test_train_batch_matches_jax(world, name):
    jlosses, jmaster, jkey = _jax_run(name)
    for o in world:
        got = o["res"]["runs"][name]
        assert got["dp"] == WORLD
        np.testing.assert_allclose(np.asarray(got["losses"]), jlosses,
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(got["rng_data"], jkey)
        for n, m in got["master"].items():
            np.testing.assert_allclose(m, jmaster[n], err_msg=n, rtol=1e-4,
                                       atol=1e-5)
