"""The port's Mixtral training (deepspeed_tpu_torch/models/mixtral.py:
Llama's ``apply`` / ``loss`` with ``_mlp`` under autograd, the router's
gradient through ``route_top_k``'s renormalised weights, the experts'
through ``grouped_swiglu``'s backward; ``partition_specs``; the engine;
checkpoints) held against the JAX package on CPU, fp32 on both sides. The
JAX side takes its own CPU paths (dense attention, ``lax.ragged_dot``
experts, no remat); the port runs its grouped kernels' plain versions (the
K8 chain it launches on the card: ``grouped_swiglu`` forward and backward)
and the ragged math, flash and dense attention, remat on and off, on
``MIXTRAL_TINY`` and on a GQA case with one KV head and a sliding window
under T. Tolerances as test_torch_llama_training.py's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

import deepspeed_tpu_torch
from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as J_TINY
from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu.runtime.zero import partitioning as jpart
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import (MIXTRAL_TINY, Mixtral,
                                        mixtral_params_from_numpy)
from deepspeed_tpu_torch.models import mixtral as tmixtral
from deepspeed_tpu_torch.runtime.zero import partitioning as tpart
from deepspeed_tpu_torch.utils import groups as tgroups
from test_torch_llama_training import (CASES, MASTER_TOL, VARIANTS, _ids,
                                       check_loss_and_grads,
                                       check_train_batch,
                                       check_tree_mirrors_jax)

KERNELS = ({"grouped_kernel": True}, {"grouped_kernel": False})


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_grad_match_jax(case):
    """Every (flash, remat) variant with the grouped kernels' plain
    versions and with the ragged math, against the JAX loss's gradients
    (the router's included)."""
    check_loss_and_grads(JMixtral, Mixtral, J_TINY, MIXTRAL_TINY,
                         mixtral_params_from_numpy, CASES[case], VARIANTS,
                         _ids(MIXTRAL_TINY.vocab_size, 1), knobs=KERNELS)


def test_fused_head_with_the_grouped_kernels_matches_jax():
    check_loss_and_grads(JMixtral, Mixtral, J_TINY, MIXTRAL_TINY,
                         mixtral_params_from_numpy,
                         dict(loss_chunk=12, fused_loss=True), [(True, True)],
                         _ids(MIXTRAL_TINY.vocab_size, 2), knobs=KERNELS[:1])


def test_config_params_specs_and_zero_plan_mirror_jax():
    """The tree, num_params, flops_per_token and specs as JAX's; the ZeRO
    plan the engine builds from those specs at dp = 2, stages 1-3, gives
    JAX's params / master / grads specs (the experts' "expert" dim taken,
    the partition on the next eligible dim)."""
    model = check_tree_mirrors_jax(JMixtral, Mixtral, J_TINY, MIXTRAL_TINY)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    jm = JMixtral(dataclasses.replace(J_TINY, dtype="float32"))
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        jm.init, jax.random.key(0)))
    for stage in (1, 2, 3):
        jgroups.reset()
        jtopo = jgroups.initialize(jgroups.TopologyConfig(),
                                   devices=jax.devices()[:2])
        jplan = jpart.ZeroShardingPlan(stage, jtopo.mesh,
                                       jm.partition_specs(jtopo), jshapes)
        topo = tgroups.ParallelTopology(tgroups.TopologyConfig(),
                                        world_size=2, rank=0)
        plan = tpart.ZeroShardingPlan(stage, topo, model.partition_specs(),
                                      shapes)
        for which, jspecs in (("param", jplan.param_specs),
                              ("master", jplan.master_specs),
                              ("grad", jplan.grad_specs)):
            want = {k: tuple(v) for k, v in jspecs.items() if k != "blocks"}
            want.update({f"blocks.{k}": tuple(v)
                         for k, v in jspecs["blocks"].items()})
            assert plan.specs(which) == want, (stage, which)
        assert plan.parts["master"]["blocks.moe_w1"][0] is not None
    jgroups.reset()


@pytest.mark.parametrize("gas", [1, 2])
def test_train_batch_and_checkpoints_match_jax_engine(gas, tmp_path):
    """The JAX engine with ``moe.grouped_kernel`` False (ragged_dot) and
    the port with its grouped kernels (the model knob True under the same
    engine block would be overridden, so the port's block says True)."""
    over = dict(dtype="float32", remat=False, use_flash_attention=False,
                **CASES["gqa_window"])
    jmodel = JMixtral(dataclasses.replace(J_TINY, **over))
    port_over = dict(over, use_flash_attention=True, remat=True)
    eng, _, master, jmaster = check_train_batch(
        jmodel, lambda: Mixtral(dataclasses.replace(MIXTRAL_TINY,
                                                    **port_over),
                                device="cpu"),
        mixtral_params_from_numpy, gas, tmp_path,
        grouped_kernel=(False, True))
    assert eng.model._grouped_knob() is True
    for n, m in master.items():
        np.testing.assert_allclose(m, jmaster[n], err_msg=n, **MASTER_TOL)


def test_bf16_engine_casts_the_router_like_jax():
    """As JAX's engine (engine.py:468-474): the fp32 router is cast to
    bf16 with the rest and the master taken from those; the loss falls."""
    model = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="bfloat16"),
                    device="cpu", seed=2)
    gate = model.blocks.moe_gate.detach().clone()
    assert gate.dtype == torch.float32
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    assert torch.equal(eng.state["master"]["blocks.moe_gate"],
                       gate.to(torch.bfloat16).float())
    assert eng.state["params"]["blocks.moe_gate"].dtype == torch.bfloat16
    batch = {"input_ids": _ids(MIXTRAL_TINY.vocab_size, 5)}
    losses = [float(eng.train_batch(batch)) for _ in range(4)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]


@pytest.mark.parametrize("model_knob,block,want", [
    (True, "auto", "kernel"), (False, "auto", "ragged"),
    (True, False, "ragged"), (False, True, "kernel"), ("auto", None, "kernel"),
])
def test_engine_moe_block_overrides_the_model_knob(model_knob, block, want,
                                                   monkeypatch):
    """An explicit (non-"auto") engine ``moe.grouped_kernel`` overrides the
    model's ``grouped_kernel``; "auto" or no block keeps it."""
    seen = []
    real = tmixtral.resolve_grouped_params
    monkeypatch.setattr(tmixtral, "resolve_grouped_params",
                        lambda knob, *a: seen.append(real(knob, *a)["backend"])
                        or real(knob, *a))
    model = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"),
                    device="cpu")
    model.grouped_kernel = model_knob
    config = {"train_batch_size": 2,
              "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
    if block is not None:
        config["moe"] = {"grouped_kernel": block}
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=config,
                                             device="cpu")
    eng.train_batch({"input_ids": _ids(MIXTRAL_TINY.vocab_size, 6)})
    assert seen and set(seen) == {want}, seen
