"""GPT-2 with the kernel knobs on: ``fused_layernorm`` (K13) and
``mlp_kernel`` / ``mlp_kernel_fuse_dw`` (K6), the port's model held
against the JAX package's on CPU. The same weights (a JAX init carried
over by ``gpt2_params_from_numpy``) and batch give the same loss and every
gradient, fp32, with the JAX Pallas kernels in interpret mode and the
port's kernels in their plain versions. ``"auto"`` resolves as the JAX
package does on a winner-cache miss: the plain path. Also a GPT2MoE with
``fused_layernorm=True``, and three ``train_batch`` steps with the knobs
on against the same port model with them off.

Tolerances: loss at rtol=atol=2e-5 and gradients at 1e-4
(test_torch_gpt2_training.py's, from test_gpt2.py's fp32 chunked-loss
tolerances); engine losses at rtol 1e-5 and final weights at rtol 1e-4,
atol 1e-5 (the knobs change only the order of fp32 sums). The engine runs
Adam with eps 1e-6, as test_torch_gpt2_moe_training.py does: at the
default 1e-8 an element whose gradient sits at the fp32 noise floor takes
a step of any size up to lr from rounding noise alone."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu_torch.models import (GPT2, GPT2Config, GPT2MoE,
                                        GPT2MoEConfig,
                                        gpt2_moe_params_from_numpy,
                                        gpt2_params_from_numpy)
from deepspeed_tpu_torch.ops.cuda import layernorm as tln
from deepspeed_tpu_torch.ops.cuda import mlp_matmul as tmm

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# D = 128: the fused norms need D % 128 == 0
BASE = dict(n_layer=2, n_head=2, d_model=128, max_seq_len=128,
            vocab_size=200, dtype="float32", remat=False,
            use_flash_attention=False)
SAVE_FLASH = dict(remat=True, remat_policy="save_flash",
                  use_flash_attention=True, loss_chunk=48, fused_loss=True,
                  fused_loss_kernel=True)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for k, v in tree["blocks"].items():
        if isinstance(v, dict):
            out.update({f"blocks.{k}.{m}": a for m, a in v.items()})
        else:
            out[f"blocks.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _ids(seed, rows=2):
    return np.random.RandomState(seed).randint(
        0, BASE["vocab_size"], (rows, BASE["max_seq_len"])).astype(np.int32)


def _jax_case(jcls, jcfg_cls, over, seed):
    model = jcls(jcfg_cls(**{**BASE, **over}))
    params = model.init(jax.random.key(seed))
    ids = _ids(seed + 10)
    loss, grads = jax.value_and_grad(
        lambda p: model.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    return jax.tree.map(np.asarray, params), ids, float(loss), _flat(grads)


def _port_loss_grads(model, ids):
    model.zero_grad(set_to_none=True)
    loss = model.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


def _counted(monkeypatch):
    """Count the plain versions standing in for the kernels on CPU: the
    knobs must reach them exactly when on."""
    calls = {"ln_fwd": 0, "ln_bwd": 0, "mm": 0, "dw": 0}

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def counted(*a, **k):
            calls[key] += 1
            return real(*a, **k)
        monkeypatch.setattr(mod, name, counted)

    wrap(tln, "layernorm_bwd_reference", "ln_bwd")
    wrap(tmm, "mm_reference", "mm")
    wrap(tmm, "dw_reference", "dw")
    real_fwd = tln._fwd

    def fwd(*a, **k):
        calls["ln_fwd"] += 1
        return real_fwd(*a, **k)
    monkeypatch.setattr(tln, "_fwd", fwd)
    return calls


def _hold(over, seed, monkeypatch):
    params, ids, jloss, jgrads = _jax_case(JGPT2, JGPT2Config, over, seed)
    model = GPT2(GPT2Config(**{**BASE, **over}), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(params, "cpu",
                                                 torch.float32))
    calls = _counted(monkeypatch)
    loss, grads = _port_loss_grads(model, ids)
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)
    return calls


@pytest.mark.parametrize("ln", [True, "bwd", "auto"])
def test_fused_layernorm_matches_jax(ln, monkeypatch):
    calls = _hold(dict(fused_layernorm=ln), 0, monkeypatch)
    L = BASE["n_layer"]
    # ln1 + ln2 a layer and lnf: forwards through the kernel's plain
    # version only when True, backwards when True or "bwd"
    assert calls["ln_fwd"] == (2 * L + 1 if ln is True else 0)
    assert calls["ln_bwd"] == (2 * L + 1 if ln in (True, "bwd") else 0)
    assert calls["mm"] == calls["dw"] == 0


@pytest.mark.parametrize("fuse_dw", [True, False], ids=["fuse_dw", "xla_dw"])
@pytest.mark.parametrize("mode", [True, "down", "both", "auto"])
def test_mlp_kernel_matches_jax(mode, fuse_dw, monkeypatch):
    calls = _hold(dict(mlp_kernel=mode, mlp_kernel_fuse_dw=fuse_dw), 1,
                  monkeypatch)
    L = BASE["n_layer"]
    on = mode != "auto"
    kernels = 2 if mode == "both" else 1      # products through K6 a layer
    # forward + dx per product; dW through the fused kernel or the plain
    # einsum (the same plain function on CPU)
    assert calls["mm"] == (2 * kernels * L if on else 0)
    assert calls["dw"] == (kernels * L if on else 0)
    assert calls["ln_fwd"] == calls["ln_bwd"] == 0


@pytest.mark.parametrize("remat", [
    dict(remat=True, remat_policy="nothing_saveable"), SAVE_FLASH],
    ids=["nothing_saveable", "save_flash"])
def test_all_knobs_match_jax(remat, monkeypatch):
    """Both knobs on, the whole block recomputed (nothing_saveable), or
    under save_flash with the flash kernels and the fused CE kernel (lnf
    through K13 inside the grad-in-forward head)."""
    over = dict(fused_layernorm=True, mlp_kernel="both",
                mlp_kernel_fuse_dw=True, **remat)
    calls = _hold(over, 2, monkeypatch)
    L = BASE["n_layer"]
    chunks = -(-(BASE["max_seq_len"] - 1) // 48) if "loss_chunk" in remat \
        else 1
    # forward, recompute in backward, dx: 6 products a layer; 2 dW
    assert calls["mm"] == 6 * L and calls["dw"] == 2 * L
    assert calls["ln_fwd"] == 4 * L + chunks
    assert calls["ln_bwd"] == 2 * L + chunks


def test_gpt2moe_fused_layernorm_matches_jax(monkeypatch):
    over = dict(num_experts=4, moe_top_k=2, moe_backend="ragged",
                moe_grouped_kernel=False, fused_layernorm=True)
    params, ids, jloss, jgrads = _jax_case(JGPT2MoE, JGPT2MoEConfig, over, 3)
    model = GPT2MoE(GPT2MoEConfig(**{**BASE, **over}), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(params, "cpu",
                                                     torch.float32))
    calls = _counted(monkeypatch)
    loss, grads = _port_loss_grads(model, ids)
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)
    assert calls["ln_fwd"] == calls["ln_bwd"] == 2 * BASE["n_layer"] + 1


def test_train_batch_knobs_on_equal_off():
    """Three steps through initialize -> train_batch: the knobs on (K13 and
    K6's plain versions) give the losses and final weights of the same
    model with them off."""
    cfg = dict(BASE, **SAVE_FLASH)
    config = {"train_batch_size": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-3, "weight_decay": 0.01,
                                         "eps": 1e-6}}}
    ids = _ids(7)
    out = {}
    for on in (True, False):
        knobs = dict(fused_layernorm=on, mlp_kernel="both" if on else False)
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=GPT2(GPT2Config(**cfg, **knobs), device="cpu", seed=5),
            config=config, device="cpu")
        losses = [float(engine.train_batch({"input_ids": ids}))
                  for _ in range(3)]
        out[on] = (losses, {n: p.detach().clone() for n, p in
                            engine.model.named_parameters()})
    (l_on, p_on), (l_off, p_off) = out[True], out[False]
    assert l_on[-1] < l_on[0]
    np.testing.assert_allclose(l_on, l_off, rtol=1e-5)
    for name, p in p_off.items():
        np.testing.assert_allclose(p_on[name].numpy(), p.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
