"""The port's GPT-2 training model (deepspeed_tpu_torch/models/gpt2.py) held
against the JAX package's: the same weights (a JAX init carried over by
``gpt2_params_from_numpy``) and the same batch give the same loss and
every parameter gradient, in fp32 on CPU, with the JAX flash and fused CE
kernels in interpret mode and the port's kernels in their plain versions.

Tolerances: loss at rtol=atol=2e-5 and gradients at 1e-4 (test_gpt2.py's
fp32 chunked-loss tolerances, :125-134, :183); the remat policies change
only what is recomputed, so their values agree to 1e-6."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu_torch.models import GPT2, GPT2Config, gpt2_params_from_numpy

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=64, vocab_size=200,
            dtype="float32", remat=False)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_case(over, seed=0):
    cfg = JGPT2Config(**{**BASE, **over})
    model = JGPT2(cfg)
    params = model.init(jax.random.key(seed))
    ids = np.random.RandomState(seed + 10).randint(
        0, cfg.vocab_size, (3, cfg.max_seq_len)).astype(np.int32)
    loss, grads = jax.value_and_grad(
        lambda p: model.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    return jax.tree.map(np.asarray, params), ids, float(loss), _flat(grads)


def _port(over, params):
    model = GPT2(GPT2Config(**{**BASE, **over}), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(params, "cpu",
                                                 torch.float32))
    return model


def _port_loss_grads(model, ids):
    model.zero_grad(set_to_none=True)
    loss = model.loss({"input_ids": ids})
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


@pytest.mark.parametrize("over", [
    dict(use_flash_attention=False),
    dict(use_flash_attention=True),
    dict(use_flash_attention=True, loss_chunk=24, fused_loss=True,
         fused_loss_kernel=True),
], ids=["dense", "flash", "flash_fused_ce_kernel"])
def test_loss_and_every_grad_match_jax(over):
    params, ids, jloss, jgrads = _jax_case(over)
    model = _port(over, params)
    assert model.flash_on == bool(over["use_flash_attention"])
    loss, grads = _port_loss_grads(model, ids)
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)


def test_remat_policies_give_equal_values():
    """remat off, nothing_saveable (whole-block recompute) and save_flash
    (saved o/lse, the flash forward never re-run) agree, and save_flash
    runs no flash forward in backward."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    over = dict(use_flash_attention=True, loss_chunk=24, fused_loss=True)
    params, ids, jloss, _ = _jax_case(over, seed=1)
    ref_loss, ref_grads = _port_loss_grads(_port(over, params), ids)
    np.testing.assert_allclose(ref_loss, jloss, **LOSS_TOL)
    calls = {"fwd": 0}
    real = fa.flash_forward_reference

    def counted(*a, **kw):
        calls["fwd"] += 1
        return real(*a, **kw)

    for policy in ("nothing_saveable", "save_flash"):
        model = _port(dict(over, remat=True, remat_policy=policy), params)
        calls["fwd"] = 0
        fa.flash_forward_reference = counted
        try:
            loss, grads = _port_loss_grads(model, ids)
        finally:
            fa.flash_forward_reference = real
        # one forward per layer, plus one re-run per layer when the whole
        # block is recomputed
        assert calls["fwd"] == BASE["n_layer"] * (
            2 if policy == "nothing_saveable" else 1), (policy, calls)
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6, atol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g, ref_grads[name], rtol=1e-6,
                                       atol=1e-6, err_msg=f"{policy} {name}")


def test_chunked_loss_and_logits_match_jax():
    over = dict(use_flash_attention=False, loss_chunk=24)
    params, ids, jloss, jgrads = _jax_case(over, seed=2)
    model = _port(over, params)
    loss, grads = _port_loss_grads(model, ids)
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    np.testing.assert_allclose(grads["wte"], jgrads["wte"], **GRAD_TOL)
    jmodel = JGPT2(JGPT2Config(**{**BASE, **over}))
    jl = np.asarray(jmodel.apply(jax.tree.map(jnp.asarray, params),
                                 jnp.asarray(ids)))
    with torch.no_grad():
        tl = model.logits(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)


def test_config_and_presets_mirror_jax():
    from deepspeed_tpu.models import PRESETS as JP
    from deepspeed_tpu_torch.models import GPT2_PRESETS as TP
    assert set(TP) == set(JP)
    for name in JP:
        assert dataclasses.asdict(TP[name]) == dataclasses.asdict(JP[name])
        assert TP[name].num_params() == JP[name].num_params()
        assert TP[name].flops_per_token() == JP[name].flops_per_token()


def test_unported_knobs_raise():
    # per-layer windows are ported (test_torch_gpt_neo_training.py)
    for over in (dict(dropout=0.1),
                 dict(remat=True, remat_policy="save_attn"),
                 dict(remat=True, remat_policy="save_mid")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GPT2(GPT2Config(**{**BASE, **over}), device="cpu")
    model = GPT2(GPT2Config(**BASE), device="cpu")
    ids = torch.zeros(1, 8, dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.loss({"input_ids": ids}, ltd_keep=4)
    with pytest.raises(ValueError):
        GPT2(GPT2Config(**{**BASE, "remat": True, "remat_policy": "x"}),
             device="cpu")
