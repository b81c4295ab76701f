"""The rest of the port's M4 (deepspeed_tpu_torch/runtime/lr_schedules.py,
ops/optimizers.py's LAMB / Lion / Adagrad / SGD, fp16 training through
runtime/engine.py) held against the JAX package on CPU:

- each schedule's lr over a sweep of steps at rtol 1e-6 (both compute in
  float32), and ``state_dict`` round trips;
- three updates of each optimizer at 1e-6, LAMB also with its leaves
  walked in many ``UPDATE_SLICE`` slices (its norms are the whole leaf's);
- ``initialize`` -> ``train_batch`` with a ``scheduler`` block and with an
  ``lr_scheduler`` object, and one engine per optimizer, against the JAX
  engine on one device (losses rtol 1e-4, master rtol 1e-4 / atol 1e-5 as
  test_torch_engine.py's); the schedule's state crossing the packages
  through a checkpoint;
- three fp16 ``train_batch`` steps from ``initial_scale_power`` 20 with a
  hysteresis of 2: the first two overflow, the first is skipped on the
  hysteresis, the second also halves the scale, the third (at 2^19)
  steps; the same skips, overflow flags and scale path as the JAX engine,
  and the same losses (fp16 on both sides: rtol 1e-3).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_numpy
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.utils import groups as tgroups

CFG = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=32, vocab_size=256,
           remat=False, dtype="float32", use_flash_attention=False)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-5)
# fp16 batch rows: the largest gradient element (a bias's, summed over the
# tokens) times 2^19 is 37k-44k on these batches (JAX, fp32), so 2^20
# overflows fp16 (65504) by at least 1.14x and 2^19 stays 1.5x under it:
# no step sits near the threshold, where the two packages' fp16
# reductions could round to different sides
FP16_ROWS = 24

SCHEDULES = {
    "warmup_log": ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=3e-3,
                                    warmup_num_steps=7)),
    "warmup_linear": ("WarmupLR", dict(warmup_max_lr=1e-3,
                                       warmup_num_steps=5,
                                       warmup_type="linear")),
    "warmup_decay": ("WarmupDecayLR", dict(total_num_steps=20,
                                           warmup_min_lr=1e-5,
                                           warmup_max_lr=3e-3,
                                           warmup_num_steps=6)),
    "warmup_cosine": ("WarmupCosineLR", dict(total_num_steps=20,
                                             warmup_min_ratio=0.1,
                                             warmup_num_steps=4, lr=2e-3)),
    "one_cycle_decay": ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                                         cycle_first_step_size=5,
                                         cycle_second_step_size=4,
                                         decay_step_size=3,
                                         decay_lr_rate=0.1)),
    "one_cycle": ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                                   cycle_first_step_size=5)),
    "range_staircase": ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                                            lr_range_test_step_size=3,
                                            lr_range_test_step_rate=2.0,
                                            lr_range_test_staircase=True)),
    "range": ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                                  lr_range_test_step_size=3)),
}


@pytest.mark.parametrize("case", list(SCHEDULES))
def test_schedule_matches_jax(case):
    name, params = SCHEDULES[case]
    j, t = jsched.build_scheduler(name, params), tsched.build_scheduler(
        name, params)
    steps = np.arange(40)
    want = np.array([float(j(s)) for s in steps], np.float32)
    got = np.array([float(t(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert t(3).dtype == torch.float32
    # the object surface: step / get_lr / state_dict round trip
    for _ in range(9):
        j.step()
        t.step()
    assert t.get_lr()[0] == pytest.approx(j.get_lr()[0], rel=1e-6)
    sd = t.state_dict()
    assert sd == j.state_dict() == {"last_batch_iteration": 8}
    fresh = tsched.build_scheduler(name, params)
    fresh.load_state_dict(sd)
    assert fresh.get_lr() == t.get_lr()
    fresh.step(20)
    assert fresh.last_batch_iteration == 20


def test_build_scheduler_rejects_unknown():
    with pytest.raises(ValueError, match="unknown scheduler"):
        tsched.build_scheduler("Linear", {})
    assert set(tsched.SCHEDULES) == set(jsched.SCHEDULES)


OPTIMIZERS = {
    "lamb": ("FusedLamb", dict(lr=1e-2, weight_decay=0.1)),
    "lamb_clip": ("FusedLamb", dict(lr=1e-3, max_coeff=0.5,
                                    min_coeff=0.4)),
    "lion": ("FusedLion", dict(lr=1e-3, weight_decay=0.1)),
    "adagrad": ("FusedAdagrad", dict(lr=1e-2, weight_decay=0.05)),
    "sgd": ("SGD", dict(lr=1e-2)),
    "sgd_momentum": ("SGD", dict(lr=1e-2, momentum=0.9, weight_decay=0.01)),
}


@pytest.mark.parametrize("sliced", [False, True])
@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizer_matches_jax(case, sliced, monkeypatch):
    """Three updates from the same leaves and gradients (a zero leaf
    included: LAMB's trust ratio is then 1); with ``sliced`` the port walks
    every leaf in 4-element slices."""
    if sliced:
        monkeypatch.setattr(topt, "UPDATE_SLICE", 4)
    cls, kw = OPTIMIZERS[case]
    rs = np.random.RandomState(0)
    shapes = {"a": (3, 5), "b": (7,), "z": (2, 3)}
    params = {k: rs.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    params["z"][:] = 0
    j, t = getattr(jopt, cls)(**kw), getattr(topt, cls)(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = j.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = t.init(tp)
    for step in range(3):
        g = {k: rs.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js = j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                          lr=jnp.float32(kw["lr"] * (1 + step)))
        t.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                 lr=torch.tensor(kw["lr"] * (1 + step)))
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert set(ts) == set(js)
    for key in ts:
        if isinstance(ts[key], dict):
            for k in shapes:
                np.testing.assert_allclose(
                    ts[key][k].numpy(), np.asarray(js[key][k]), rtol=1e-6,
                    atol=1e-6, err_msg=f"{key}.{k}")
        else:
            assert int(ts[key]) == int(js[key]) == 3


def test_build_optimizer_matches_jax():
    for name in ("Lamb", "FusedLamb", "Lion", "fusedlion", "Adagrad", "SGD",
                 "AdamW"):
        assert type(topt.build_optimizer(name, {})).__name__ == \
            type(jopt.build_optimizer(name, {})).__name__
    opt = topt.build_optimizer("sgd", {"lr": 0.5, "momentum": 0.9})
    assert (opt.lr, opt.momentum) == (0.5, 0.9)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("rmsprop", {})


# ----------------------------------------------------------- the engines


def _config(opt=("AdamW", {"lr": 1e-3, "weight_decay": 0.01}), **over):
    cfg = {"train_batch_size": 8, "steps_per_print": 0,
           "optimizer": {"type": opt[0], "params": dict(opt[1])},
           "gradient_clipping": 1.0}
    cfg.update(over)
    return cfg


def _batches(n, seed, rows=8):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (rows, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(n)]


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def _jax_engine(config, model_cfg=CFG, lr_scheduler=None):
    """The JAX engine on one device (so fp16 gradients are formed as the
    port's single process forms them)."""
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(),
                              devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2(JGPT2Config(**model_cfg)), topology=topo, config=config,
        lr_scheduler=lr_scheduler)
    return engine


def _port_engine(config, master0, model_cfg=CFG, lr_scheduler=None):
    tgroups.reset()
    dtype = getattr(torch, model_cfg["dtype"])
    model = GPT2(GPT2Config(**model_cfg), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(master0, "cpu", dtype))
    engine, _, _, sched = deepspeed_tpu_torch.initialize(
        model=model, config=config, lr_scheduler=lr_scheduler, device="cpu")
    assert sched is engine.lr_scheduler
    return engine


def _run_both(config, batches, model_cfg=CFG, jsched_obj=None,
              tsched_obj=None):
    jeng = _jax_engine(config, model_cfg, jsched_obj)
    master0 = jax.tree.map(lambda x: np.asarray(x, np.float32),
                           jeng.state["master"])
    teng = _port_engine(config, master0, model_cfg, tsched_obj)
    out = {"jax": [], "port": []}
    for b in batches:
        for key, eng in (("jax", jeng), ("port", teng)):
            lr = eng.get_lr()[0]
            loss = float(eng.train_batch(b))
            scale = float(eng.state["scale"]["scale"])
            out[key].append((loss, lr, scale))
    return jeng, teng, out


def _check(jeng, teng, out, sign_step=None):
    """Losses, lrs and master (``_hold_master``) against the JAX
    engine's."""
    jl, tl = np.array(out["jax"]), np.array(out["port"])
    np.testing.assert_allclose(tl[:, 0], jl[:, 0], **LOSS_TOL)
    np.testing.assert_allclose(tl[:, 1], jl[:, 1], rtol=1e-6)
    _hold_master(teng, _flat(jeng.state["master"]), MASTER_TOL, sign_step,
                 len(tl))


def _hold_master(teng, jm, tol, sign_step=None, steps=1):
    """The port's master against the JAX engine's ``jm`` at ``tol``.
    ``sign_step``: the most an element moves in a step whose update is
    (nearly) the sign of its gradient (Lion; Adagrad's and Adam's first
    steps): an element whose gradient is fp32 noise (the key bias, to
    which the softmax is invariant, and a few others) then moves by up to
    that much either way on either side, so every element is held to twice
    that a step, and at most 1% of those outside the key bias may miss
    ``tol``."""
    D = CFG["d_model"]
    for n, m in teng.state["master"].items():
        got, want = m.numpy(), jm[n]
        if sign_step is None:
            np.testing.assert_allclose(got, want, err_msg=n, **tol)
            continue
        diff = np.abs(got - want)
        off = diff > tol["atol"] + tol["rtol"] * np.abs(want)
        assert diff.max() <= 2 * sign_step * steps, n
        if n == "blocks.bqkv":
            off[:, D:2 * D] = False
        assert off.mean() <= 0.01, (n, off.mean())


WARMUP_DECAY = {"type": "WarmupDecayLR", "params": {
    "total_num_steps": 6, "warmup_min_lr": 1e-4, "warmup_max_lr": 3e-3,
    "warmup_num_steps": 2}}


def test_scheduler_block_trains_like_jax(tmp_path):
    """A WarmupDecayLR block: each step's lr (get_lr before the step), the
    losses and the master; then the schedule's state through a port
    checkpoint into the JAX engine and a JAX checkpoint into the port."""
    cfg = _config(scheduler=WARMUP_DECAY)
    jeng, teng, out = _run_both(cfg, _batches(3, seed=1))
    _check(jeng, teng, out)
    assert teng.lr_scheduler.last_batch_iteration == 2
    lrs = [r[1] for r in out["port"]]
    assert lrs[0] < lrs[1] < lrs[2]               # the warmup
    assert float(teng.lr_scheduler(5)) < lrs[2]   # the decay
    teng.save_checkpoint(str(tmp_path / "port"))
    jeng.save_checkpoint(str(tmp_path / "jax"))
    j2 = _jax_engine(cfg)
    j2.load_checkpoint(str(tmp_path / "port"))
    assert j2.lr_scheduler.state_dict() == teng.lr_scheduler.state_dict()
    t2 = _port_engine(cfg, jax.tree.map(np.asarray, jeng.state["master"]))
    assert t2.lr_scheduler.last_batch_iteration == -1
    t2.load_checkpoint(str(tmp_path / "jax"))
    assert t2.lr_scheduler.state_dict() == jeng.lr_scheduler.state_dict()
    assert t2.get_lr()[0] == pytest.approx(jeng.get_lr()[0], rel=1e-6)
    t3 = _port_engine(cfg, jax.tree.map(np.asarray, jeng.state["master"]))
    t3.load_checkpoint(str(tmp_path / "jax"), load_lr_scheduler_states=False)
    assert t3.lr_scheduler.last_batch_iteration == -1
    assert os.path.exists(tmp_path / "port" / "latest")


def test_scheduler_object_trains_like_jax():
    """An lr_scheduler object passed to initialize wins over the config's
    optimizer lr, as in JAX."""
    params = dict(total_num_steps=10, warmup_min_ratio=0.2,
                  warmup_num_steps=2, lr=2e-3)
    jeng, teng, out = _run_both(
        _config(), _batches(3, seed=2),
        jsched_obj=jsched.WarmupCosineLR(**params),
        tsched_obj=tsched.WarmupCosineLR(**params))
    _check(jeng, teng, out)
    assert teng.last_metrics["lr"].dtype == torch.float32


@pytest.mark.parametrize("opt", [
    ("Lamb", {"lr": 2e-3, "weight_decay": 0.01}),
    ("Lion", {"lr": 1e-4, "weight_decay": 0.01}),
    ("Adagrad", {"lr": 1e-2}),
    ("SGD", {"lr": 0.1, "momentum": 0.9}),
], ids=lambda o: o[0])
def test_optimizer_engines_train_like_jax(opt):
    jeng, teng, out = _run_both(_config(opt=opt), _batches(2, seed=3))
    sign = opt[0] in ("Lion", "Adagrad")
    _check(jeng, teng, out, sign_step=opt[1]["lr"] if sign else None)


def test_fp16_overflow_steps_match_jax():
    """fp16 from 2^20 with hysteresis 2: overflow (skipped, scale kept),
    overflow (skipped, scale halved), a step at 2^19; the port's skips,
    overflow flags and scale path are the JAX engine's, the losses match
    and the master is the JAX engine's after the one real update."""
    cfg = _config(train_batch_size=FP16_ROWS,
                  fp16={"enabled": True, "initial_scale_power": 20,
                        "hysteresis": 2, "loss_scale_window": 100})
    fp16 = dict(CFG, dtype="float16")
    jeng = _jax_engine(cfg, fp16)
    master0 = jax.tree.map(lambda x: np.asarray(x, np.float32),
                           jeng.state["master"])
    teng = _port_engine(cfg, master0, fp16)
    assert teng.state["params"]["wte"].dtype == torch.float16
    got = {"jax": [], "port": []}
    for b in _batches(3, seed=4, rows=FP16_ROWS):
        for key, eng in (("jax", jeng), ("port", teng)):
            scale = float(eng.state["scale"]["scale"])
            loss = float(eng.train_batch(b))
            skipped = (int(eng.state["skipped"]) if key == "jax"
                       else eng.skipped_steps)
            got[key].append((scale, skipped, loss))
    assert [g[:2] for g in got["port"]] == [g[:2] for g in got["jax"]] == [
        (2.0 ** 20, 1), (2.0 ** 20, 2), (2.0 ** 19, 2)]
    assert teng.last_metrics["loss_scale"] == 2.0 ** 19
    assert not teng.last_metrics["overflow"]
    assert float(teng.state["scale"]["scale"]) == \
        float(jeng.state["scale"]["scale"])
    for key in ("good_steps", "hysteresis"):
        assert int(teng.state["scale"][key]) == \
            int(jeng.state["scale"][key]), key
    np.testing.assert_allclose([g[2] for g in got["port"]],
                               [g[2] for g in got["jax"]], rtol=1e-3)
    # one AdamW update, whose first step is the sign of the gradient
    _hold_master(teng, _flat(jeng.state["master"]),
                 dict(rtol=1e-3, atol=1e-4), sign_step=1e-3)
