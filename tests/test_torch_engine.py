"""The port's training runtime (deepspeed_tpu_torch: runtime/config.py,
runtime/engine.py, ops/optimizers.py, runtime/fp16/loss_scaler.py and
``initialize``) held against the JAX package's on CPU.

The JAX engine runs on the tests' 8-device CPU mesh (dp=8), so both sides
are given the same train_batch_size: the JAX global micro-batch of 8 rows
is the port's micro-batch. Tolerances: losses at rtol=1e-4 and the final
fp32 master at rtol=1e-4, atol=1e-5 (three AdamW steps whose sums run in
another order; Adam normalises each element's step, so an element whose
gradient sits at the fp32 noise floor can move by a sizeable part of
lr=1e-3 either way, hence the atol of 1% of one step); the optimizer and
the loss scaler alone at 1e-6."""

import dataclasses

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
from deepspeed_tpu.runtime import config as jconfig
from deepspeed_tpu.runtime.fp16 import loss_scaler as jscaler
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_numpy
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as tscaler

CFG = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=32, vocab_size=256,
           remat=False, dtype="float32", use_flash_attention=False)


def _bench_config(stage=2):
    """benchmarks/bench_engine.py:185-206 at its defaults (350M, micro 24)."""
    return {
        "train_micro_batch_size_per_gpu": 24,
        "gradient_accumulation_steps": 1,
        "steps_per_print": 0,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 2e-4, "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "bf16": {"enabled": True},
        "zero_optimization": {"stage": stage},
    }


def _engine_config(stage=0, micro=8, gas=1, **over):
    """tests/unit/test_engine.py's _config, with AdamW and weight decay."""
    cfg = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "steps_per_print": 0,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": stage},
    }
    cfg.update(over)
    return cfg


def _fields(c):
    return dict(
        triad=(c.train_batch_size, c.train_micro_batch_size_per_gpu,
               c.gradient_accumulation_steps),
        steps_per_print=c.steps_per_print, clip=c.gradient_clipping,
        fp16=dataclasses.asdict(c.fp16), bf16=dataclasses.asdict(c.bf16),
        zero=dataclasses.asdict(c.zero),
        optimizer=c.optimizer and (c.optimizer.type, c.optimizer.params),
        grad_accum_dtype=c.grad_accum_dtype)


@pytest.mark.parametrize("raw", [
    _bench_config(), _bench_config(stage=3), _engine_config(),
    _engine_config(stage=2, gas=2), _engine_config(bf16={"enabled": True}),
    {"train_batch_size": 32, "gradient_accumulation_steps": 4,
     "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
     "data_types": {"grad_accum_dtype": "bf16"}},
    {"train_batch_size": 16, "train_micro_batch_size_per_gpu": 4},
], ids=["bench", "bench_zero3", "engine", "engine_gas2", "engine_bf16",
        "train_and_gas", "train_and_micro"])
def test_config_resolves_like_jax(raw):
    j = jconfig.DeepSpeedConfig(raw, dp_world_size=1)
    t = tconfig.DeepSpeedConfig(raw, dp_world_size=1)
    assert _fields(t) == _fields(j)
    assert str(t.precision_dtype) == f"torch.{jnp.dtype(j.precision_dtype)}"


def test_config_errors_and_warnings_like_jax(monkeypatch):
    for bad in ({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4,
                 "gradient_accumulation_steps": 2},
                {"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4},
                {"gradient_accumulation_steps": 2},
                {"train_micro_batch_size_per_gpu": 0},
                {"train_micro_batch_size_per_gpu": 2,
                 "zero_optimization": {"stage": 5}}):
        with pytest.raises(jconfig.DeepSpeedConfigError):
            jconfig.DeepSpeedConfig(bad)
        with pytest.raises(tconfig.DeepSpeedConfigError):
            tconfig.DeepSpeedConfig(bad)
    seen = []
    monkeypatch.setattr(tconfig.logger, "warning", seen.append)
    tconfig.DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                             "zero_optimization": {"stage": 1, "bogus": 1}})
    assert len(seen) == 1 and "bogus" in seen[0]


@pytest.mark.parametrize("over", [
    {"zero_optimization": {"stage": 2, "offload_optimizer": {"device": "cpu"}}},
    {"pipeline": {"stages": 2}}, {"tensorboard": {"enabled": True}},
    {"parallelism": "auto"},
    {"moe": {"grouped_kernel": True}, "tensor_parallel": {"size": 2}},
    {"comm_overlap": {"enabled": True}}, {"quantize": {"int8_matmul": True}},
    {"telemetry": {"enabled": True}},
    {"scheduler": {"type": "WarmupLR"}, "wandb": {"enabled": True}},
    {"fp16": {"enabled": True}, "csv_monitor": {"enabled": True}},
    {"tensor_parallel": {"size": 2}},
    {"curriculum_learning": {"enabled": True}},
    {"data_efficiency": {"enabled": True, "data_routing": {
        "random_ltd": {"enabled": True}}}},
])
def test_unported_blocks_raise(over):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tconfig.DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2, **over})


def _jax_engine(stage, micro, gas, steps, batches):
    groups.reset()
    engine, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2(JGPT2Config(**CFG)),
        config=_engine_config(stage=stage, micro=micro, gas=gas))
    master0 = jax.tree.map(np.asarray, engine.state["master"])
    losses = [float(engine.train_batch(b)) for b in batches[:steps]]
    return master0, losses, engine


def _port_engine(master0, stage, micro, gas, batches, dtype=torch.float32,
                 **over):
    model = GPT2(GPT2Config(**{**CFG, "dtype": str(dtype).split(".")[-1]}),
                 device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(master0, "cpu", dtype))
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, config=_engine_config(stage=stage, micro=micro, gas=gas,
                                           **over), device="cpu")
    assert opt is engine.optimizer and loader is None and sched is None
    losses = [float(engine.train_batch(b)) for b in batches]
    return losses, engine


def _batches(n, bsz, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (bsz, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(n)]


@pytest.mark.parametrize("gas", [1, 2])
def test_train_batch_matches_jax_engine(gas):
    """3 AdamW steps with clipping from the JAX engine's initial master:
    the same losses and the same final master."""
    batches = _batches(3, 8 * gas, seed=gas)
    master0, jlosses, jeng = _jax_engine(0, 1, gas, 3, batches)
    assert jeng.config.train_batch_size == 8 * gas
    losses, eng = _port_engine(master0, 0, 8, gas, batches)
    assert eng.config.train_batch_size == 8 * gas
    assert eng.global_step == 3 and eng.micro_steps == 3 * gas
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-6)
    jm = jeng.state["master"]
    jmaster = {k: v for k, v in jm.items() if k != "blocks"}
    jmaster.update({f"blocks.{k}": v for k, v in jm["blocks"].items()})
    for name, m in eng.state["master"].items():
        np.testing.assert_allclose(m.numpy(), np.asarray(jmaster[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    assert int(eng.state["opt"]["step"]) == int(jeng.state["opt"]["step"])


def test_zero_stages_identical_and_bf16_master():
    batches = _batches(3, 8, seed=7)
    model = GPT2(GPT2Config(**CFG), device="cpu", seed=3)
    master0 = {n: p.detach().numpy().copy()
               for n, p in model.named_parameters()}
    tree = {k: v for k, v in master0.items() if not k.startswith("blocks.")}
    tree["blocks"] = {k[7:]: v for k, v in master0.items()
                      if k.startswith("blocks.")}
    l0, e0 = _port_engine(tree, 0, 8, 1, batches)
    l2, e2 = _port_engine(tree, 2, 8, 1, batches)
    assert l0 == l2
    for n in e0.state["master"]:
        assert torch.equal(e0.state["master"][n], e2.state["master"][n])
    _, eb = _port_engine(tree, 2, 8, 1, batches[:1], dtype=torch.bfloat16,
                         bf16={"enabled": True})
    assert eb.state["master"]["wte"].dtype == torch.float32
    assert eb.state["params"]["wte"].dtype == torch.bfloat16
    assert eb.state["params"]["wte"] is eb.model.wte


def test_engine_guards():
    model = GPT2(GPT2Config(**CFG), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        deepspeed_tpu_torch.initialize(
            model=model, config=_engine_config(bf16={"enabled": True}),
            device="cpu")
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_engine_config(), device="cpu")
    with pytest.raises(ValueError, match="train_batch_size"):
        eng.train_batch(_batches(1, 4)[0])
    with pytest.raises(NotImplementedError, match="ROADMAP.*M14, hot tier"):
        deepspeed_tpu_torch.initialize(
            model=model, config=_engine_config(
                checkpoint_engine={"hot_tier": True}), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        deepspeed_tpu_torch.initialize(model=model, config=_engine_config(),
                                       training_data=[1], device="cpu")
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("Lambda", {})


@pytest.mark.parametrize("kw", [
    dict(lr=1e-2, weight_decay=0.1),
    dict(lr=1e-2, weight_decay=0.1, adam_w_mode=False),
    dict(lr=1e-3, moments_dtype="bfloat16", bias_correction=False),
])
def test_fused_adam_matches_jax(kw):
    rs = np.random.RandomState(0)
    shapes = {"a": (3, 5), "b": (7,)}
    params = {k: rs.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    j = jopt.FusedAdam(**kw)
    t = topt.FusedAdam(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = j.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = t.init(tp)
    for step in range(3):
        g = {k: rs.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, js = j.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        t.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts["m"][k].float().numpy(),
                                   np.asarray(js["m"][k], np.float32),
                                   rtol=1e-6, atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_loss_scalers_match_jax():
    cfg = jconfig.FP16Config(enabled=True, hysteresis=2, loss_scale_window=3)
    tcfg = tconfig.FP16Config(**dataclasses.asdict(cfg))
    js = jscaler.create_loss_scaler(cfg, jnp.float16)
    ts = tscaler.create_loss_scaler(tcfg, torch.float16)
    assert ts.dynamic and js.dynamic
    jst, tst = js.init_state(), ts.init_state()
    for overflow in (False, True, False, True, True, False, False, False,
                     False):
        jst = js.update(jst, jnp.asarray(overflow))
        tst = ts.update(tst, overflow)
        for key in jst:
            assert float(tst[key]) == float(jst[key]), key
    assert not tscaler.create_loss_scaler(tcfg, torch.bfloat16).dynamic
    assert float(tscaler.create_loss_scaler(None).init_state()["scale"]) == 1
    g = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    assert not bool(tscaler.grads_finite(g))
    assert bool(tscaler.grads_finite(g[:1]))
