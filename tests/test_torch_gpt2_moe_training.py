"""The port's GPT2MoE training (deepspeed_tpu_torch/models/gpt2_moe.py over
moe/, ops/cuda/grouped_matmul.py and the engine's ``moe`` block) held
against the JAX package's on CPU: the same weights (a JAX ``GPT2MoE.init``
carried over by ``gpt2_moe_params_from_numpy``) and batch give the same
loss and every gradient, with the JAX grouped kernels in Pallas interpret
mode (``moe_grouped_kernel=True``) and through ``lax.ragged_dot`` (False);
three ``train_batch`` steps match the JAX engine. fp32 on both sides.

Tolerances: loss 2e-5 and gradients 1e-4 (test_torch_gpt2_training.py's);
the remat policies change only what is recomputed, so the port's agree
with its own no-remat values to 1e-6; engine losses and final master at
rtol 1e-4 with atol 1e-5 on the master (test_torch_engine.py's note). The
engine runs Adam with eps 1e-6: at the default 1e-8 an element whose
gradient sits at the fp32 noise floor (~1e-8, reached by a few of the
experts' ~0.5 M weights) takes a step of any size up to lr from rounding
noise alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import (GPT2MoE, GPT2MoEConfig,
                                        gpt2_moe_params_from_numpy)
from deepspeed_tpu_torch.moe import sharded_moe as moe
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.engine import _jax_order

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(n_layer=2, n_head=2, d_model=128, max_seq_len=32, vocab_size=256,
            dtype="float32", remat=False, use_flash_attention=False,
            num_experts=4, moe_top_k=2, moe_backend="ragged")


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for k, v in tree["blocks"].items():
        if k == "moe":
            out.update({f"blocks.moe.{m}": a for m, a in v.items()})
        else:
            out[f"blocks.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _ids(cfg, seed, rows=2):
    return np.random.RandomState(seed).randint(
        0, cfg["vocab_size"], (rows, cfg["max_seq_len"])).astype(np.int32)


def _port(over, params):
    model = GPT2MoE(GPT2MoEConfig(**{**BASE, **over}), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(params, "cpu",
                                                     torch.float32))
    return model


def _port_loss_grads(model, ids):
    model.zero_grad(set_to_none=True)
    loss = model.loss({"input_ids": ids})
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("grouped_kernel", [True, False],
                         ids=["pallas_interpret", "ragged_dot"])
def test_loss_and_every_grad_match_jax(grouped_kernel):
    """The port (remat off, nothing_saveable, and save_flash with the flash
    path) against jax.value_and_grad(GPT2MoE.loss); the aux loss and its
    coefficient ride in the loss."""
    over = dict(moe_grouped_kernel=grouped_kernel)
    jmodel = JGPT2MoE(JGPT2MoEConfig(**{**BASE, **over}))
    params = jmodel.init(jax.random.key(0))
    ids = _ids(BASE, 10)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    jgrads = _flat(jgrads)
    params = jax.tree.map(np.asarray, params)
    _, jaux = jmodel.apply_with_aux(params, jnp.asarray(ids))
    model = _port(over, params)
    with torch.no_grad():
        _, aux = model.hidden_with_aux(torch.from_numpy(ids))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    loss, grads = _port_loss_grads(model, ids)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)
    for policy in ("nothing_saveable", "save_flash"):
        m = _port(dict(over, remat=True, remat_policy=policy,
                       use_flash_attention=policy == "save_flash"), params)
        l2, g2 = _port_loss_grads(m, ids)
        tol = dict(rtol=1e-6, atol=1e-6) if policy != "save_flash" \
            else GRAD_TOL
        np.testing.assert_allclose(l2, loss, **tol)
        for name, g in g2.items():
            np.testing.assert_allclose(g, grads[name], err_msg=f"{policy} "
                                       f"{name}", **tol)


def test_chunked_fused_head_and_loss_coefficient():
    """The bench head (loss_chunk with the fused CE kernel's plain version)
    under save_flash against JAX's, and moe_loss_coeff scaling the aux."""
    over = dict(loss_chunk=12, fused_loss=True, fused_loss_kernel=True,
                moe_grouped_kernel=False, moe_loss_coeff=0.5)
    jmodel = JGPT2MoE(JGPT2MoEConfig(**{**BASE, **over}))
    params = jmodel.init(jax.random.key(3))
    ids = _ids(BASE, 11)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    jgrads = _flat(jgrads)
    model = _port(dict(over, remat=True, remat_policy="save_flash",
                       use_flash_attention=True),
                  jax.tree.map(np.asarray, params))
    loss, grads = _port_loss_grads(model, ids)
    np.testing.assert_allclose(loss, float(jloss), **LOSS_TOL)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)


def test_config_params_and_order_mirror_jax():
    """GPT2MoEConfig's fields and num_params are JAX's; the port's
    parameters have the JAX tree's names, shapes and dtypes (the router in
    fp32), and the engine sums them in JAX's leaf order."""
    import dataclasses
    jcfg, tcfg = JGPT2MoEConfig(), GPT2MoEConfig()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    cfg = {**BASE, "n_layer": 3}
    assert GPT2MoEConfig(**cfg).num_params() == \
        JGPT2MoEConfig(**cfg).num_params()
    jtree = JGPT2MoE(JGPT2MoEConfig(**cfg)).init(jax.random.key(1))
    model = GPT2MoE(GPT2MoEConfig(**cfg), device="cpu")
    flat = _flat(jtree)
    named = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in named.items()} == \
        {n: a.shape for n, a in flat.items()}
    assert named["blocks.moe.gate_w"].dtype == torch.float32
    assert sum(p.numel() for p in named.values()) == \
        GPT2MoEConfig(**cfg).num_params()
    jkeys = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert _jax_order(named) == jkeys


def _engine_config(micro, gas, grouped_kernel):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 2},
            "moe": {"grouped_kernel": grouped_kernel}}


@pytest.mark.parametrize("gas", [1, 2])
def test_train_batch_matches_jax_engine(gas):
    """3 AdamW steps of GPT2MoE with a ``moe`` block from the JAX engine's
    initial master (the JAX engine on the 8-device CPU mesh: its global
    micro-batch of 8 rows is the port's micro-batch)."""
    rs = np.random.RandomState(gas)
    batches = [{"input_ids": rs.randint(0, 256, (8 * gas, 32))
                .astype(np.int32)} for _ in range(3)]
    groups.reset()
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2MoE(JGPT2MoEConfig(**BASE)),
        config=_engine_config(1, gas, False))
    master0 = jax.tree.map(np.asarray, jeng.state["master"])
    jlosses = [float(jeng.train_batch(b)) for b in batches]
    model = GPT2MoE(GPT2MoEConfig(**BASE), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(master0, "cpu",
                                                     torch.float32))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_engine_config(8, gas, False), device="cpu")
    assert eng.model._moe_cfg.grouped_kernel is False
    losses = [float(eng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-6)
    jmaster = _flat(jeng.state["master"])
    for name, m in eng.state["master"].items():
        np.testing.assert_allclose(m.numpy(), jmaster[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_bf16_engine_casts_the_router_like_jax():
    """As JAX's engine (engine.py:468-474): every parameter, the fp32
    router included, is cast to bf16 and the master is taken from those."""
    model = GPT2MoE(GPT2MoEConfig(**{**BASE, "dtype": "bfloat16"}),
                    device="cpu", seed=2)
    gate = model.blocks.moe.gate_w.detach().clone()
    assert gate.dtype == torch.float32
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}})
    assert torch.equal(eng.state["master"]["blocks.moe.gate_w"],
                       gate.to(torch.bfloat16).float())
    assert eng.state["params"]["blocks.moe.gate_w"].dtype == torch.bfloat16
    loss = float(eng.train_batch({"input_ids": _ids(BASE, 5)}))
    assert np.isfinite(loss)


@pytest.mark.parametrize("model_knob,block,want", [
    (True, "auto", "kernel"), (False, "auto", "ragged"),
    (True, False, "ragged"), (False, True, "kernel"), ("auto", None, "kernel"),
])
def test_engine_moe_block_overrides_the_model_knob(model_knob, block, want,
                                                   monkeypatch):
    """An explicit (non-"auto") engine ``moe.grouped_kernel`` overrides the
    model's ``moe_grouped_kernel``; "auto" or no block keeps it
    (gpt2_moe.py:95-106)."""
    seen = []
    real = moe.resolve_grouped_params
    monkeypatch.setattr(moe, "resolve_grouped_params",
                        lambda knob: seen.append(real(knob)["backend"])
                        or real(knob))
    model = GPT2MoE(GPT2MoEConfig(**{**BASE, "moe_grouped_kernel":
                                     model_knob}), device="cpu")
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    if block is not None:
        config["moe"] = {"grouped_kernel": block}
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                             device="cpu")
    eng.train_batch({"input_ids": _ids(BASE, 6)})
    assert seen and set(seen) == {want}, seen


def test_unported_moe_paths_raise():
    """moe_backend='dense' (GShard capacity), an expert-parallel config, a
    quantized expert leaf and ragged noisy gating raise; the moe block is
    validated as JAX's."""
    with pytest.raises(NotImplementedError, match="GShard capacity"):
        GPT2MoE(GPT2MoEConfig(**{**BASE, "moe_backend": "dense"}),
                device="cpu")
    with pytest.raises(NotImplementedError, match="GShard capacity"):
        GPT2MoE(GPT2MoEConfig(n_layer=1, d_model=64, n_head=2,
                              max_seq_len=16, vocab_size=64), device="cpu")
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        GPT2MoE(GPT2MoEConfig(**{**BASE, "noisy_gate_policy": "Jitter"}),
                device="cpu")
    model = GPT2MoE(GPT2MoEConfig(**BASE), device="cpu")
    with pytest.raises(NotImplementedError, match="expert parallel"):
        deepspeed_tpu_torch.initialize(
            model=model, device="cpu",
            config={"train_batch_size": 2, "expert_parallel_size": 2,
                    "optimizer": {"type": "AdamW", "params": {}}})

    class Quantized(np.ndarray):
        scale = None

    tree = {k: v.detach().numpy() for k, v in model.named_parameters()
            if not k.startswith("blocks.")}
    tree["blocks"] = {"moe": {"wi": np.zeros((2, 4, 128, 512), np.int8)
                              .view(Quantized)}}
    with pytest.raises(NotImplementedError, match="K9"):
        gpt2_moe_params_from_numpy(tree, "cpu", torch.float32)
    for bad in ({"grouped_kernel": "yes"}, {"hierarchical_a2a": "yes"},
                {"dcn_quantize": "x"}):
        with pytest.raises(tconfig.DeepSpeedConfigError):
            tconfig.DeepSpeedConfig({"train_batch_size": 2, "moe": bad})
    cfg = tconfig.DeepSpeedConfig({"train_batch_size": 2, "moe": {
        "grouped_kernel": True, "hierarchical_a2a": False,
        "dcn_quantize": "auto"}})
    assert (cfg.moe.grouped_kernel, cfg.moe.hierarchical_a2a,
            cfg.moe.dcn_quantize) == (True, False, "auto")
