"""The seven Llama-family models of the port (Bloom, Falcon, GPT-NeoX,
GPT-J, InternLM, Phi, Qwen: deepspeed_tpu_torch/models/{bloom,...}.py on
the knobs of models/llama.py) held against the JAX package on CPU at their
``*_TINY`` presets, fp32 on both sides.

Every bias, LayerNorm shift and scale and embedding-norm leaf is set to
random values from a numpy seed on both sides before a comparison (the
init's zeros and ones would hide a bias wired wrong). Held: the leaf tree,
``partition_specs``, ``num_params`` and ``flops_per_token`` (every preset's
too); the loss and every gradient against ``jax.value_and_grad`` of the JAX
model's dense loss (2e-5 / 1e-4, test_torch_llama_training.py's), the port
with flash (the K1 / K2 plain versions, ALiBi in them for Bloom) and dense
attention, remat on. The paged programs are in
test_torch_family_paged.py, the engines in test_torch_family_engines.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu.models as jmodels
import deepspeed_tpu_torch.models as tmodels
from deepspeed_tpu_torch.models import llama_params_from_numpy
from test_torch_llama_training import (GRAD_TOL, LOSS_TOL, _flat, _ids,
                                       check_tree_mirrors_jax)

# family: (class name, module of its TINY preset, TINY name)
FAMILIES = {
    "bloom": ("Bloom", "bloom", "BLOOM_TINY"),
    "falcon": ("Falcon", "falcon", "FALCON_TINY"),
    "gpt_neox": ("GPTNeoX", "gpt_neox", "GPTNEOX_TINY"),
    "gptj": ("GPTJ", "gptj", "GPTJ_TINY"),
    "internlm": ("InternLM", "internlm", "INTERNLM_TINY"),
    "phi": ("Phi", "phi", "PHI_TINY"),
    "qwen": ("Qwen", "qwen", "QWEN_TINY"),
}
# the leaves a fresh init sets to zero or one
SCALES = ("rms1", "rms2", "norm_f", "embed_ln_s")
SHIFTS = ("b1", "b2", "norm_f_b", "embed_ln_b", "bq", "bk", "bv", "bo",
          "bup", "bdown", "bgate", "lm_head_b")
T = 32


def family(name):
    """(JAX class, port class, JAX TINY config, port TINY config)."""
    cls, mod, tiny = FAMILIES[name]
    jmod = __import__(f"deepspeed_tpu.models.{mod}", fromlist=[tiny])
    tmod = __import__(f"deepspeed_tpu_torch.models.{mod}", fromlist=[tiny])
    return (getattr(jmodels, cls), getattr(tmodels, cls),
            getattr(jmod, tiny), getattr(tmod, tiny))


def randomize(tree, seed=0, keep=np.asarray):
    """The tree with every scale at 1 + 0.1 N(0, 1) and every shift / bias
    at 0.1 N(0, 1) (a numpy seed, in the tree's leaf order, from the
    leaves' shapes alone, so a traced tree takes it too); the other leaves
    through ``keep``."""
    rs = np.random.RandomState(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in SCALES:
                out[k] = (1 + 0.1 * rs.standard_normal(v.shape)).astype(
                    np.float32)
            elif k in SHIFTS:
                out[k] = (0.1 * rs.standard_normal(v.shape)).astype(
                    np.float32)
            else:
                out[k] = keep(v)
        return out
    return walk(tree)


def pair(name, **over):
    """The same fp32 family model in both packages: the JAX model, its
    randomized tree (jnp), the port's model loaded from it, and the port
    config."""
    jcls, tcls, jtiny, ttiny = family(name)
    over = dict(dtype="float32", **over)
    jm = jcls(dataclasses.replace(jtiny, **over))
    tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    params = jax.tree.map(jnp.asarray, tree)
    tcfg = dataclasses.replace(ttiny, **over)
    pm = tcls(tcfg, device="cpu", dtype=torch.float32)
    pm.load_state_dict(llama_params_from_numpy(tree, "cpu", torch.float32))
    return jm, params, pm, tree


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tree_specs_and_counts_mirror_jax(name):
    """Leaf names, shapes and order, partition_specs, num_params (the
    biases and norm shifts counted) and flops_per_token are the JAX
    model's; the randomized tree loads with no renaming."""
    jcls, tcls, jtiny, ttiny = family(name)
    check_tree_mirrors_jax(jcls, tcls, jtiny, ttiny)
    key = FAMILIES[name][2].replace("_TINY", "_PRESETS")
    jpresets = getattr(jmodels, key)
    tpresets = getattr(tmodels, key)
    assert set(tpresets) == set(jpresets)
    for preset, cfg in jpresets.items():
        tcfg = tpresets[preset]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg), preset
        assert tcfg.num_params() == cfg.num_params(), preset
        assert tcfg.flops_per_token() == cfg.flops_per_token(), preset
    jm, params, pm, tree = pair(name)
    sd = pm.state_dict()
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(sd[k].numpy(), v)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_loss_and_every_grad_match_jax(name):
    """The port's loss and gradients, flash (the K1 / K2 plain versions,
    with the ALiBi slopes for Bloom) and dense, remat on, against
    jax.value_and_grad of the JAX model's dense loss without remat."""
    jm, params, _, tree = pair(name, remat=False,
                               use_flash_attention=False)
    ids = _ids(jm.config.vocab_size, 1, t=T)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    jgrads = _flat(jgrads)
    state = llama_params_from_numpy(tree, "cpu", torch.float32)
    _, tcls, _, ttiny = family(name)
    for flash in (True, False):
        model = tcls(dataclasses.replace(ttiny, dtype="float32", remat=True,
                                         use_flash_attention=flash),
                     device="cpu")
        model.load_state_dict(state)
        loss = model.loss({"input_ids": ids})
        loss.backward()
        tag = f"{name} flash={flash}"
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   err_msg=tag, **LOSS_TOL)
        grads = {n: p.grad.numpy() for n, p in model.named_parameters()}
        assert set(grads) == set(jgrads)
        for n, g in grads.items():
            np.testing.assert_allclose(g, jgrads[n], err_msg=f"{tag} {n}",
                                       **GRAD_TOL)
