"""GPT-Neo training in the port (models/gpt2.py with ``scale_attn=False``
and per-layer ``attn_layer_windows``) held against the JAX package on CPU,
fp32: the loss and every gradient against ``jax.value_and_grad`` of the
JAX model's loss (2e-5 / 1e-4, test_torch_gpt2_training.py's) with a
window that cuts (16 of 64 positions) and an odd vocabulary (GPT-Neo's
50257 is odd): dense, with ``use_flash_attention`` on (the windows force
the dense path, as in JAX), under remat (whole-block and ``save_flash``),
with the fused CE head (K3's plain version), and seq-sharded at seq = 2
over Ulysses (a gloo world of 2) against the JAX model on a seq = 2 mesh.
Ring attention raises for windows and for unscaled scores, as in JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models.gpt_neo import GPTNeo as JGPTNeo
from deepspeed_tpu.models.gpt_neo import GPTNeoConfig as JGPTNeoConfig
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import (GPTNeo, GPTNeoConfig,
                                        gpt2_params_from_numpy)
from test_torch_dist_worker import run_world
from test_torch_gpt2_paged import randomize

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=64, vocab_size=201,
            dtype="float32", remat=False, attn_layer_windows=(0, 16))


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def case():
    """(randomized params as numpy, ids (2, 64), JAX loss, JAX grads) of
    the dense JAX model."""
    model = JGPTNeo(JGPTNeoConfig(**BASE))
    params = randomize(jax.tree.map(np.asarray,
                                    model.init(jax.random.key(0))))
    ids = np.random.RandomState(10).randint(
        0, BASE["vocab_size"], (2, BASE["max_seq_len"])).astype(np.int32)
    loss, grads = jax.value_and_grad(lambda p: model.loss(
        p, {"input_ids": jnp.asarray(ids)}))(
            jax.tree.map(jnp.asarray, params))
    return params, ids, float(loss), _flat(grads)


def _port(params, **over):
    model = GPTNeo(GPTNeoConfig(**{**BASE, **over}), device="cpu")
    model.load_state_dict(gpt2_params_from_numpy(params, "cpu",
                                                 torch.float32))
    return model


def _check(loss, grads, jloss, jgrads):
    np.testing.assert_allclose(loss, jloss, **LOSS_TOL)
    assert set(grads) == set(jgrads)
    for n, g in grads.items():
        np.testing.assert_allclose(g, jgrads[n], err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("over", [
    dict(use_flash_attention=False),
    dict(use_flash_attention=True),
    dict(use_flash_attention=True, remat=True),
    dict(use_flash_attention=True, remat=True, remat_policy="save_flash",
         loss_chunk=24, fused_loss=True, fused_loss_kernel=True),
], ids=["dense", "flash_on", "remat", "save_flash_fused_ce_kernel"])
def test_loss_and_every_grad_match_jax(case, over):
    params, ids, jloss, jgrads = case
    model = _port(params, **over)
    loss = model.loss({"input_ids": torch.from_numpy(ids)})
    loss.backward()
    _check(float(loss.detach()),
           {n: p.grad.numpy() for n, p in model.named_parameters()},
           jloss, jgrads)


def test_ulysses_seq2_matches_jax(case, tmp_path):
    """Each rank's share of the seq-sharded loss's gradients, summed over
    the two ranks of a gloo world, against the JAX model's seq-sharded
    loss on a seq = 2 mesh (Ulysses: heads onto the seq axis, the window
    in the dense mask over the gathered sequence)."""
    params, ids, _, _ = case
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(seq_parallel_size=2),
                              devices=jax.devices()[:2])
    model = JGPTNeo(JGPTNeoConfig(**BASE))
    with jax.set_mesh(topo.mesh):
        jloss, jgrads = jax.jit(jax.value_and_grad(lambda p: model.loss(
            p, {"input_ids": jnp.asarray(ids)}, seq_sharded=True)))(
                jax.tree.map(jnp.asarray, params))
    jgrads = _flat(jgrads)
    # the worker builds a GPT2 from its config: GPT-Neo's is GPT2Config
    # with the family's scale_attn=False
    neo = dict(BASE, scale_attn=False)
    outs = run_world("gpt2", 2, dict(params=params, ids=ids,
                                     models={"neo": neo}, sequence={},
                                     moe_dp=False), tmp_path)
    for o in outs:
        np.testing.assert_allclose(o["res"]["neo"]["loss"], float(jloss),
                                   **LOSS_TOL)
    got = {n: sum(o["res"]["neo"]["grads"][n] for o in outs)
           for n in jgrads}
    _check(float(outs[0]["res"]["neo"]["loss"]), got, float(jloss), jgrads)


@pytest.mark.parametrize("over", [dict(), dict(attn_layer_windows=(),
                                               scale_attn=False)],
                         ids=["windows", "unscaled"])
def test_ring_attention_raises(case, over):
    """Ring attention takes neither per-layer windows nor unscaled scores
    (the JAX ``block_attn`` raises the same)."""
    model = _port(case[0], attention_backend="ring", **over)
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="ring attention supports neither"):
        model._attn(q, q, q, seq_sharded=True, window=model._window(1))
