"""GPT2MoE at dp > 1 in the port (moe/sharded_moe.py ``topk_routing`` with
the engine's data-parallel axes, runtime/engine.py) held against the JAX
engine on the virtual CPU mesh, in gloo worlds of 2 and 4 processes
(spawned once each), fp32:

- the aux loss of a rank's rows with the engine's axes is the JAX aux of
  the global batch (the JAX loss runs over the batch sharded on the data
  axes, so its routing means are global), at rtol 1e-5; the control, each
  rank's own aux, misses it by more than that at dp = 2;
- 3 ``train_batch`` steps of a tiny GPT2MoE (E = 4, top-2, ragged, a
  ``moe_loss_coeff`` of 1 so the aux gradient weighs, AdamW with a clip
  that acts every step) from the JAX engine's initial master, ZeRO 0-3 at
  dp = 2 and 4: every rank's losses and final master at
  test_torch_zero.py's tolerances, each step's clipped gradients leaf by
  leaf at a relative error norm of 1e-4 (a backward that did not sum the
  aux statistics' cotangent over the ranks leaves the router's gradient
  off by far more), and each run against the port at dp = 1 with its
  global gradient norms at rtol 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import (GPT2MoE, GPT2MoEConfig,
                                        gpt2_moe_params_from_numpy)
from deepspeed_tpu_torch.utils import groups as tgroups
from test_torch_dist_worker import run_world

CFG = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=16, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False,
           num_experts=4, moe_top_k=2, moe_backend="ragged",
           moe_loss_coeff=1.0)
MICRO = 2
CLIP = 0.5
AUX_TOL = dict(rtol=1e-5, atol=0)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_REL_NORM = 1e-4
RUNS = [(dp, stage) for dp in (2, 4) for stage in (0, 1, 2, 3)]


def _name(dp, stage):
    return f"dp{dp}_s{stage}"


def _config(stage, dp):
    return {"train_batch_size": MICRO * dp, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}},
            "gradient_clipping": CLIP, "zero_optimization": {"stage": stage},
            "moe": {"grouped_kernel": False}}


def _batches(rows, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (rows, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(3)]


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for k, v in tree["blocks"].items():
        if k == "moe":
            out.update({f"blocks.moe.{m}": a for m, a in v.items()})
        else:
            out[f"blocks.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_run(config, n, batches):
    """The JAX engine's losses, final master and each step's clipped
    gradients (what its optimizer is given)."""
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(),
                              devices=jax.devices()[:n])
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2MoE(JGPT2MoEConfig(**CFG)), topology=topo, config=config)
    steps, update = [], engine.optimizer.update

    def record(grads, state, master, lr=None):
        jax.debug.callback(lambda g: steps.append(_flat(g)), grads)
        return update(grads, state, master, lr=lr)
    engine.optimizer.update = record
    losses = [float(engine.train_batch(b)) for b in batches]
    jax.effects_barrier()
    jgroups.reset()
    return losses, _flat(engine.state["master"]), list(steps)


@pytest.fixture(scope="module")
def master0():
    return jax.tree.map(np.asarray, JGPT2MoE(JGPT2MoEConfig(**CFG)).init(
        jax.random.key(0)))


@pytest.fixture(scope="module")
def runs():
    return {_name(dp, stage): (_config(stage, dp), dp,
                               _batches(MICRO * dp, seed=10 * dp + stage))
            for dp, stage in RUNS}


@pytest.fixture(scope="module")
def jax_runs(runs):
    return {name: _jax_run(cfg, dp, b) for name, (cfg, dp, b) in runs.items()}


def _aux_ids(dp):
    return np.random.RandomState(7 + dp).randint(
        0, CFG["vocab_size"], (MICRO * dp, CFG["max_seq_len"])).astype(
            np.int32)


@pytest.fixture(scope="module")
def worlds(runs, master0, tmp_path_factory):
    out = {}
    for world in (2, 4):
        mine = {name: dict(model=CFG, params=master0, config=cfg, batches=b)
                for name, (cfg, dp, b) in runs.items() if dp == world}
        aux = dict(model=CFG, params=master0, config=_config(0, world),
                   ids=_aux_ids(world))
        out[world] = run_world("moe_dp", world, {"runs": mine, "aux": aux},
                               tmp_path_factory.mktemp(f"moe_dp{world}"))
    return out


@pytest.mark.parametrize("dp", [2, 4])
def test_aux_loss_is_the_global_batch_s(worlds, master0, dp):
    jmodel = JGPT2MoE(JGPT2MoEConfig(**CFG))
    _, jaux = jmodel.apply_with_aux(master0, jnp.asarray(_aux_ids(dp)))
    local = []
    for o in worlds[dp]:
        res = o["res"]
        assert tuple(res["aux_axes"]) == ("data",)
        np.testing.assert_allclose(res["aux_global"], float(jaux), **AUX_TOL)
        local.append(float(res["aux_local"]))
    if dp == 2:       # the control: each rank's own aux is not the JAX aux
        for a in local:
            assert abs(a - float(jaux)) > AUX_TOL["rtol"] * abs(float(jaux))


@pytest.mark.parametrize("dp,stage", RUNS)
def test_train_batch_matches_jax(worlds, jax_runs, dp, stage):
    jlosses, jmaster, _ = jax_runs[_name(dp, stage)]
    for o in worlds[dp]:
        got = o["res"][_name(dp, stage)]
        assert got["dp"] == dp
        np.testing.assert_allclose(np.asarray(got["losses"]), jlosses,
                                   **LOSS_TOL)
        assert set(got["master"]) == set(jmaster)
        for n, m in got["master"].items():
            np.testing.assert_allclose(m, jmaster[n], err_msg=n,
                                       **MASTER_TOL)


@pytest.mark.parametrize("dp,stage", RUNS)
def test_clipped_grads_match_jax(worlds, jax_runs, dp, stage):
    want = jax_runs[_name(dp, stage)][2]
    for o in worlds[dp]:
        got = o["res"][_name(dp, stage)]["grads"]
        assert len(got) == len(want) == 3
        for step, (g, w) in enumerate(zip(got, want)):
            assert set(g) == set(w)
            for n, x in g.items():
                err = np.linalg.norm(x - w[n]) / np.linalg.norm(w[n])
                assert err <= GRAD_REL_NORM, (dp, stage, step, n, err)


@pytest.mark.parametrize("dp,stage", RUNS)
def test_equals_dp1(worlds, runs, master0, dp, stage):
    """The same run at one data-parallel rank in this process (micro
    batch dp times larger): losses, master and every step's gradient
    norm."""
    cfg, _, batches = runs[_name(dp, stage)]
    tgroups.reset()
    model = GPT2MoE(GPT2MoEConfig(**CFG), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(master0, "cpu",
                                                     torch.float32))
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu")
    assert engine.dp == 1 and engine.model._moe_dp_axes is None
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(b)))
        norms.append(engine.get_global_grad_norm())
    master = {k: m.numpy() for k, m in engine.gathered_master().items()}
    tgroups.reset()
    for o in worlds[dp]:
        got = o["res"][_name(dp, stage)]
        np.testing.assert_allclose(np.asarray(got["losses"]), losses,
                                   **LOSS_TOL)
        np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-5)
        for n, m in got["master"].items():
            np.testing.assert_allclose(m, master[n], err_msg=n, **MASTER_TOL)
