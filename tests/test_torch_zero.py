"""ZeRO stages 0-3 at dp > 1 in the port (runtime/zero/partitioning.py,
runtime/engine.py) held against the JAX package on CPU, in gloo worlds of
2 and 4 processes (spawned once each):

- the port's ``add_partition_axis`` / ``ZeroShardingPlan`` give the JAX
  specs for params, master and grads on the GPT-2 shapes (including
  ``bqkv``, which falls back to replicated over 4 ranks), and the same
  ``describe()`` and ``reshape_diff``;
- 3 ``train_batch`` steps of a tiny fp32 GPT-2 (AdamW, weight decay,
  a global-norm clip that acts every step) from the JAX engine's initial master: at dp = 2 for stages
  0-3 x gas 1 and 2; at dp = 4 for stages 2 and 3 with
  ``mics_shard_size=2`` and with ``hpz_partition_size=2``; at dp 2 x seq 2
  at stage 2 (ring attention). Every rank's losses and the gathered fp32
  master against the JAX engine on the virtual CPU mesh at the tolerances
  of test_torch_engine.py (losses rtol 1e-4, master rtol 1e-4 / atol
  1e-5);
- each run at dp = 2 and 4 against the same port at dp = 1 (the ZeRO
  stage-parity test of tests/unit/test_engine.py), with each step's
  global gradient norm, and the master and stage-3 parameters held as
  shards;
- checkpoints at dp = 2 (ZeRO 0-3, after the gas-1 runs): two shard
  files a tag; a fresh dp = 2 engine loads it bitwise and resumes bitwise; the
  port at dp = 1 loads it (gas 1 -> 2 keeps the global batch, micro_steps
  realigned, the gathered master bitwise) and its next step matches dp =
  2's; the JAX engine on the 2-device mesh loads the port's tag and the
  port loads the JAX engine's, each next step within rtol 2e-5 of the
  other side's (the master within a relative error norm of 1e-4)."""

import os

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.runtime.zero import partitioning as jpart
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_numpy
from deepspeed_tpu_torch.runtime.checkpoint_engine import serialization as tser
from deepspeed_tpu_torch.utils import prng as tprng
from deepspeed_tpu_torch.runtime.zero import partitioning as tpart
from deepspeed_tpu_torch.utils import groups as tgroups
from test_torch_dist_worker import run_world

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-5)
# each step's clipped gradient leaf against JAX's by relative error norm:
# fp32 sums in another order (the flat reduce-scatter, the ring's blockwise
# softmax) and masters a few ulps apart after a step; 1e-4 is the gradient
# tolerance of test_torch_gpt2_training.py
GRAD_REL_NORM = 1e-4
# Adam eps of the dp 2 x seq 2 run. At the default 1e-8, blocks.wup[1, 9,
# 4] has a first-step gradient of 2.4e-9 (1e-6 of the leaf's largest) that
# the two reduction orders give 7 % apart (2.37e-9 vs 2.57e-9; the leaf
# agrees to a relative error norm of 3e-7): Adam's first update there,
# lr g / (|g| + eps), then differs by 1.26e-5, over MASTER_TOL's atol. At
# 1e-6 the same noise moves it by 2e-7 (test_torch_gpt2_moe_training.py
# runs its engine at 1e-6 for the same reason).
SEQ2_EPS = 1e-6
CFG = dict(n_layer=2, n_head=4, d_model=32, max_seq_len=32, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)
RING = dict(CFG, attention_backend="ring")
MICRO = 2
CLIP = 0.5       # under the tiny model's gradient norm (~1): every step clips
DP2 = [(stage, gas) for stage in (0, 1, 2, 3) for gas in (1, 2)]
CKPT = [f"s{stage}_gas1" for stage in range(4)]   # checkpointed at dp = 2
NEXT = {"input_ids": np.random.RandomState(99).randint(
    0, 128, (MICRO * 2, 32)).astype(np.int32)}
CKPT_LOSS_RTOL = 2e-5
CKPT_MASTER_REL_NORM = 1e-4
DP4 = {"s2_mics": (2, {"mics_shard_size": 2}),
       "s2_hpz": (2, {"hpz_partition_size": 2}),
       "s3_mics": (3, {"mics_shard_size": 2}),
       "s3_hpz": (3, {"hpz_partition_size": 2})}


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _config(stage, gas, dp, **over):
    zero = {"stage": stage, **over.pop("zero", {})}
    return {"train_batch_size": MICRO * gas * dp,
            "gradient_accumulation_steps": gas, "steps_per_print": 0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": CLIP, "zero_optimization": zero, **over}


def _batches(n_rows, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (n_rows, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(3)]


def _jtopology(n, **kw):
    jgroups.reset()
    return jgroups.initialize(jgroups.TopologyConfig(**kw),
                              devices=jax.devices()[:n])


def _jax_run(model_cfg, config, n, batches, ckpt_dir=None, **topo):
    """The JAX engine's losses, final master and each step's clipped
    gradients (what its optimizer is given, read by a debug callback
    traced into the step). With ``ckpt_dir`` it then saves a tag there
    and takes the NEXT batch: also returns the engine, that step's loss
    and master."""
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2(JGPT2Config(**model_cfg)), topology=_jtopology(n, **topo),
        config=config)
    steps, update = [], engine.optimizer.update

    def record(grads, state, master, lr=None):
        jax.debug.callback(lambda g: steps.append(_flat(g)), grads)
        return update(grads, state, master, lr=lr)
    engine.optimizer.update = record
    losses = [float(engine.train_batch(b)) for b in batches]
    jax.effects_barrier()
    out = (losses, _flat(engine.state["master"]), list(steps))
    if ckpt_dir is None:
        return out
    engine.optimizer.update = update
    engine.save_checkpoint(ckpt_dir)
    loss = float(engine.train_batch(NEXT))
    return out + (engine, loss, _flat(engine.state["master"]))


def _shard_size(zero):
    return zero.get("mics_shard_size", zero.get("hpz_partition_size", -1))


@pytest.fixture(scope="module")
def runs():
    """name -> (model cfg, port config, JAX mesh size and topology kwargs,
    batches) of every run."""
    out = {}
    for stage, gas in DP2:
        out[f"s{stage}_gas{gas}"] = (
            CFG, _config(stage, gas, 2), (2, {}),
            _batches(MICRO * gas * 2, seed=10 * stage + gas))
    for name, (stage, zero) in DP4.items():
        out[name] = (CFG, _config(stage, 1, 4, zero=zero),
                     (4, {"zero_shard_size": _shard_size(zero)}),
                     _batches(MICRO * 4, seed=50 + stage))
    seq2 = _config(2, 1, 2, sequence_parallel_size=2,
                   sequence={"block_kernel": False})
    seq2["optimizer"]["params"]["eps"] = SEQ2_EPS
    out["s2_seq2"] = (RING, seq2, (4, {"seq_parallel_size": 2}),
                      _batches(MICRO * 2, seed=70))
    return out


@pytest.fixture(scope="module")
def master0():
    return jax.tree.map(np.asarray, JGPT2(JGPT2Config(**CFG)).init(
        jax.random.key(0)))


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    return {name: str(tmp_path_factory.mktemp(f"jax_{name}"))
            for name in CKPT}


@pytest.fixture(scope="module")
def jax_runs(runs, jax_dirs):
    return {name: _jax_run(m, cfg, n, b, ckpt_dir=jax_dirs.get(name),
                           **topo)
            for name, (m, cfg, (n, topo), b) in runs.items()}


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port_ckpt"))


@pytest.fixture(scope="module")
def worlds(runs, master0, jax_runs, jax_dirs, port_dir, tmp_path_factory):
    """world size -> every rank's results of the runs of that world (at
    world 2 also the checkpoint runs: the JAX tags are saved first)."""
    out = {}
    for world in (2, 4):
        mine = {name: dict(model=m, params=master0, config=cfg, batches=b)
                for name, (m, cfg, (n, _), b) in runs.items() if n == world}
        inputs = {"runs": mine}
        if world == 2:
            inputs["ckpt"] = dict(names=CKPT, dir=port_dir, next=NEXT,
                                  jax_dirs=jax_dirs)
        out[world] = run_world("zero", world, inputs,
                               tmp_path_factory.mktemp(f"zero{world}"))
    return out


def _results(worlds, runs, name):
    return [o["res"][name] for o in worlds[runs[name][2][0]]]


def _check(got, jlosses, jmaster):
    np.testing.assert_allclose(np.asarray(got["losses"]), jlosses,
                               **LOSS_TOL)
    assert set(got["master"]) == set(jmaster)
    for n, m in got["master"].items():
        np.testing.assert_allclose(m, jmaster[n], err_msg=n, **MASTER_TOL)


# ------------------------------------------------------------------- plans


def _shapes():
    tree = jax.eval_shape(JGPT2(JGPT2Config(**CFG)).init, jax.random.key(0))
    out = {k: v.shape for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v.shape for k, v in tree["blocks"].items()})
    return out


def _jax_plan(stage, n, zero):
    mics = zero.get("mics_shard_size", -1) not in (-1, 0)
    hpz = zero.get("hpz_partition_size", 1) > 1
    topo = _jtopology(n, zero_shard_size=_shard_size(zero))
    model = JGPT2(JGPT2Config(**CFG))
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        model.init, jax.random.key(0)))
    return jpart.ZeroShardingPlan(
        stage, topo.mesh, model.partition_specs(topo), shapes,
        partition_axes=jgroups.INNER_DP_AXES if mics else jgroups.DP_AXES,
        param_partition_axes=jgroups.INNER_DP_AXES if hpz else None)


def _port_plan(stage, n, zero):
    mics = zero.get("mics_shard_size", -1) not in (-1, 0)
    hpz = zero.get("hpz_partition_size", 1) > 1
    topo = tgroups.ParallelTopology(
        tgroups.TopologyConfig(zero_shard_size=_shard_size(zero)),
        world_size=n, rank=0)
    model = GPT2(GPT2Config(**CFG), device="cpu")
    return tpart.ZeroShardingPlan(
        stage, topo, model.partition_specs(), _shapes(),
        partition_axes=tgroups.INNER_DP_AXES if mics else tgroups.DP_AXES,
        param_partition_axes=tgroups.INNER_DP_AXES if hpz else None)


PLANS = [(stage, 2, {}) for stage in (0, 1, 2, 3)] + [
    (1, 4, {}), (3, 4, {}), (2, 4, {"mics_shard_size": 2}),
    (3, 4, {"hpz_partition_size": 2})]


@pytest.mark.parametrize("stage,n,zero", PLANS)
def test_plan_specs_match_jax(stage, n, zero):
    jplan, plan = _jax_plan(stage, n, zero), _port_plan(stage, n, zero)
    for which, jspecs in (("param", jplan.param_specs),
                          ("master", jplan.master_specs),
                          ("grad", jplan.grad_specs)):
        want = {k: tuple(v) for k, v in jspecs.items() if k != "blocks"}
        want.update({f"blocks.{k}": tuple(v)
                     for k, v in jspecs["blocks"].items()})
        assert plan.specs(which) == want, which
    if n == 4 and stage >= 1 and not zero:
        # bqkv (L=2, 3D): dim 0 is too short for 4 ranks, its last dim is
        # "tensor", so it stays replicated
        assert plan.parts["master"]["blocks.bqkv"][0] is None
        assert "blocks.bqkv" not in plan.partitioned("master")


@pytest.mark.parametrize("stage,n,zero", [(2, 2, {}),
                                          (3, 4, {"mics_shard_size": 2})])
def test_describe_matches_jax(stage, n, zero):
    assert _port_plan(stage, n, zero).describe() == \
        _jax_plan(stage, n, zero).describe()


def test_reshape_diff_matches_jax():
    saved = _jax_plan(2, 2, {}).describe()
    assert tpart.reshape_diff(saved, _port_plan(2, 4, {})) == \
        jpart.reshape_diff(saved, _jax_plan(2, 4, {}))


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("stage,gas", DP2)
def test_train_batch_dp2_matches_jax(worlds, runs, jax_runs, stage, gas):
    name = f"s{stage}_gas{gas}"
    for got in _results(worlds, runs, name):
        assert got["dp"] == 2
        _check(got, *jax_runs[name][:2])


@pytest.mark.parametrize("name", list(DP4))
def test_train_batch_dp4_mics_hpz_matches_jax(worlds, runs, jax_runs, name):
    for got in _results(worlds, runs, name):
        assert got["dp"] == 4
        _check(got, *jax_runs[name][:2])


def test_train_batch_dp2_seq2_matches_jax(worlds, runs, jax_runs):
    for got in _results(worlds, runs, "s2_seq2"):
        assert got["dp"] == 2
        _check(got, *jax_runs["s2_seq2"][:2])


@pytest.mark.parametrize("name", [f"s{s}_gas{g}" for s, g in DP2]
                         + list(DP4) + ["s2_seq2"])
def test_clipped_grads_match_jax(worlds, runs, jax_runs, name):
    """Every step's clipped gradients (the global-norm clip's coefficient
    included) on every rank against the JAX engine's, leaf by leaf."""
    want = jax_runs[name][2]
    for got in _results(worlds, runs, name):
        assert len(got["grads"]) == len(want) == 3
        for step, (g, w) in enumerate(zip(got["grads"], want)):
            assert set(g) == set(w)
            for n, x in g.items():
                err = np.linalg.norm(x - w[n]) / np.linalg.norm(w[n])
                assert err <= GRAD_REL_NORM, (name, step, n, err)


@pytest.mark.parametrize("name", [f"s{s}_gas{g}" for s, g in DP2]
                         + list(DP4))
def test_equals_dp1(worlds, runs, master0, name):
    """The same run at one data-parallel rank, in this process: losses,
    master and every step's global gradient norm (which counts each
    partitioned leaf's shards and each replicated leaf once, as at dp =
    1)."""
    model_cfg, cfg, (n, _), batches = runs[name]
    tgroups.reset()
    model = GPT2(GPT2Config(**model_cfg), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(master0, "cpu",
                                                 torch.float32))
    # the same global batch: at dp = 1 the micro batch is n times dp's;
    # MiCS / hpZ shard sizes do not divide one rank
    cfg = dict(cfg, zero_optimization={
        "stage": cfg["zero_optimization"]["stage"]})
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, device="cpu")
    assert engine.dp == 1
    assert engine.config.train_micro_batch_size_per_gpu == n * MICRO
    losses, norms = [], []
    for b in batches:
        losses.append(float(engine.train_batch(b)))
        norms.append(engine.get_global_grad_norm())
    master = {k: m.numpy() for k, m in engine.gathered_master().items()}
    tgroups.reset()
    for got in _results(worlds, runs, name):
        _check(got, losses, master)
        np.testing.assert_allclose(got["grad_norms"], norms, rtol=1e-5)


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_state_is_partitioned(worlds, runs, stage):
    """Every rank holds half of each partitioned master leaf at dp = 2 and,
    at stage 3, its parameters as shards; no shard at stage < 3."""
    plan = _port_plan(stage, 2, {})
    shapes = _shapes()
    for got in _results(worlds, runs, f"s{stage}_gas1"):
        for n, (dim, _) in plan.parts["master"].items():
            want = list(shapes[n])
            if dim is not None:
                want[dim] //= 2
            assert got["shard_shapes"][n] == tuple(want), n
        assert sorted(got["param_shards"]) == sorted(
            plan.partitioned("param"))
        assert bool(got["param_shards"]) == (stage == 3)


# ------------------------------------------------------------ checkpoints


def _ckpt(worlds, name):
    return [o["res"]["ckpt"][name] for o in worlds[2]]


def _rel_norm(got, want):
    num = sum(float(np.square(got[n] - want[n]).sum()) for n in want)
    den = sum(float(np.square(want[n]).sum()) for n in want)
    return (num / den) ** 0.5


@pytest.mark.parametrize("name", CKPT)
def test_ckpt_dp2_writes_two_shard_files(worlds, runs, port_dir, name):
    """Each rank writes its shard file; together they reassemble the
    gathered master of the run bitwise."""
    d = os.path.join(port_dir, name)
    assert sorted(os.listdir(os.path.join(d, "global_step3"))) == [
        "shard-0.npz", "shard-1.npz"]
    assert open(os.path.join(d, "latest")).read() == "global_step3"
    assert tser.verify_tag(os.path.join(d, "global_step3"))
    flat, header = tser.load_sharded(os.path.join(d, "global_step3"))
    assert header["extra"]["nprocs"] == 2
    assert header["extra"]["topology"]["dp"] == 2
    master = _results(worlds, runs, name)[0]["master"]
    for n, m in master.items():
        assert np.array_equal(flat[f"master/{n.replace('.', '/')}"], m), n


@pytest.mark.parametrize("name", CKPT)
def test_ckpt_dp2_reloads_bitwise(worlds, name):
    """A fresh dp = 2 engine loads each rank's shards bitwise and its
    next step is the uninterrupted run's, bitwise."""
    for got in _ckpt(worlds, name):
        assert got["state_bitwise"]
        assert got["global_step"] == 3 and got["micro_steps"] == 3
        assert got["client"] == {"run": name}
        assert float(got["resumed_loss"]) == float(got["next_loss"])


@pytest.mark.parametrize("name", CKPT)
def test_ckpt_dp2_loads_at_dp1(worlds, runs, master0, port_dir, name):
    """The dp = 2 tag at dp = 1 (ZeRO-2 config, micro 2): gas 1 -> 2 keeps
    the global batch of 4, micro_steps realign to global_step * gas, the
    RNG words fold for the new world, the master is the gathered dp = 2
    master bitwise, and the next step matches dp = 2's."""
    tgroups.reset()
    model = GPT2(GPT2Config(**CFG), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(master0, "cpu",
                                                 torch.float32))
    cfg = {k: v for k, v in runs[name][1].items()
           if k != "train_batch_size"}
    cfg.update(train_micro_batch_size_per_gpu=MICRO,
               zero_optimization={"stage": 2})
    engine, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                device="cpu")
    assert engine.config.gradient_accumulation_steps == 1
    engine.load_checkpoint(os.path.join(port_dir, name))
    tgroups.reset()
    assert engine.config.gradient_accumulation_steps == 2
    assert engine.config.train_batch_size == MICRO * 2
    assert engine.global_step == 3 and engine.micro_steps == 6
    assert np.array_equal(engine.rng_data, tprng.fold_in(
        tprng.key_data(1), 1 * 1000003 + 1))
    want = _ckpt(worlds, name)[0]
    for n, m in engine.state["master"].items():
        assert np.array_equal(m.numpy(), want["master"][n]), n
    loss = float(engine.train_batch(NEXT))
    np.testing.assert_allclose(loss, float(want["next_loss"]), **LOSS_TOL)


@pytest.mark.parametrize("name", CKPT)
def test_ckpt_port_dp2_tag_loads_into_jax(worlds, jax_runs, port_dir, name):
    """The port's dp = 2 tag (two shard files) into the JAX engine on the
    2-device mesh: its master is the port's bitwise, and its next step
    matches the port's (rtol 2e-5)."""
    engine = jax_runs[name][3]
    got = _ckpt(worlds, name)[0]
    engine.load_checkpoint(os.path.join(port_dir, name))
    master = _flat(engine.state["master"])
    for n, m in got["master"].items():
        assert np.array_equal(master[n], m), n
    loss = float(engine.train_batch(NEXT))
    np.testing.assert_allclose(loss, float(got["next_loss"]),
                               rtol=CKPT_LOSS_RTOL)


@pytest.mark.parametrize("name", CKPT)
def test_ckpt_jax_dp2_tag_loads_into_port(worlds, jax_runs, name):
    """The JAX engine's tag of the same run into the port at dp = 2: the
    next step's loss and master match the JAX engine's next step."""
    jloss, jmaster = jax_runs[name][4], jax_runs[name][5]
    for got in _ckpt(worlds, name):
        np.testing.assert_allclose(float(got["from_jax_loss"]), jloss,
                                   rtol=CKPT_LOSS_RTOL)
        assert _rel_norm(got["from_jax_master"], jmaster) \
            <= CKPT_MASTER_REL_NORM
