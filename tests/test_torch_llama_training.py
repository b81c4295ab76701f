"""The port's Llama training (deepspeed_tpu_torch/models/llama.py: ``apply``,
``loss``, ``partition_specs``, ``flops_per_token``; the engine's
``initialize`` -> ``train_batch``; checkpoints) held against the JAX
package on CPU, fp32 on both sides. The JAX side takes its own CPU paths
(dense attention, no remat); the port runs with the flash kernels' plain
versions (the K1 forward / K2 backward it launches on the card) and with
dense attention, remat on and off, on ``LLAMA_TINY`` and on a GQA case
with one KV head and a sliding window under T.

Tolerances: loss 2e-5 and gradients 1e-4 (test_torch_gpt2_training.py's);
engine losses and final master at rtol 1e-4 with atol 1e-5 on the master
(test_torch_engine.py's, Adam eps 1e-6 as test_torch_gpt2_moe_training.py
explains); a checkpoint's next loss at rtol 2e-5 and its loaded state
bitwise (test_torch_checkpoint.py's)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.runtime.checkpoint_engine import serialization as jser
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import (LLAMA_TINY, Llama,
                                        llama_params_from_numpy)
from deepspeed_tpu_torch.runtime.engine import _jax_order
from deepspeed_tpu_torch.utils import groups as tgroups

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
MASTER_TOL = dict(rtol=1e-4, atol=1e-5)
CKPT_LOSS_RTOL = 2e-5
T = 32
CASES = {"tiny": {}, "gqa_window": dict(n_kv_heads=1, sliding_window=12)}
VARIANTS = [(flash, remat) for flash in (True, False)
            for remat in (False, True)]


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _ids(vocab, seed, rows=2, t=T):
    return np.random.RandomState(seed).randint(0, vocab, (rows, t)).astype(
        np.int32)


def _jax_loss_grads(jmodel, params, ids):
    loss, grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(ids)}))(params)
    return float(loss), _flat(grads)


def _port_loss_grads(model, ids):
    model.zero_grad(set_to_none=True)
    loss = model.loss({"input_ids": ids})
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


def _check_grads(grads, jgrads, tag):
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=f"{tag} {name}",
                                   **GRAD_TOL)


def check_loss_and_grads(jcls, tcls, jbase, tbase, convert, over, variants,
                         ids, knobs=({},)):
    """The port (each variant of ``variants`` (flash, remat) under each
    model-attribute set of ``knobs``) against jax.value_and_grad of the
    JAX model's loss with dense attention and no remat."""
    jmodel = jcls(dataclasses.replace(jbase, dtype="float32", remat=False,
                                      use_flash_attention=False, **over))
    params = jmodel.init(jax.random.key(0))
    jloss, jgrads = _jax_loss_grads(jmodel, params, ids)
    state = convert(jax.tree.map(np.asarray, params), "cpu", torch.float32)
    for flash, remat in variants:
        cfg = dataclasses.replace(tbase, dtype="float32", remat=remat,
                                  use_flash_attention=flash, **over)
        for knob in knobs:
            model = tcls(cfg, device="cpu")
            model.load_state_dict(state)
            for k, v in knob.items():
                setattr(model, k, v)
            loss, grads = _port_loss_grads(model, ids)
            tag = f"flash={flash} remat={remat} {knob}"
            np.testing.assert_allclose(loss, jloss, err_msg=tag, **LOSS_TOL)
            _check_grads(grads, jgrads, tag)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_grad_match_jax(case):
    check_loss_and_grads(JLlama, Llama, J_TINY, LLAMA_TINY,
                         llama_params_from_numpy, CASES[case], VARIANTS,
                         _ids(LLAMA_TINY.vocab_size, 1))


@pytest.mark.parametrize("fused", [False, True], ids=["chunked", "fused"])
def test_chunked_and_fused_heads_match_jax(fused):
    """``loss_chunk`` < T - 1 takes the chunked head, recomputed in
    backward, or the fused one (gradients in the forward); the fused case
    ties the embeddings, so its head parameters are norm_f and wte."""
    over = dict(loss_chunk=12, fused_loss=fused, tie_embeddings=fused,
                sliding_window=12)
    check_loss_and_grads(JLlama, Llama, J_TINY, LLAMA_TINY,
                         llama_params_from_numpy, over, [(True, True)],
                         _ids(LLAMA_TINY.vocab_size, 2))


def check_tree_mirrors_jax(jcls, tcls, jbase, tbase, over=None):
    """Names, shapes, leaf order, num_params, flops_per_token and the
    partition specs of the port's model are the JAX model's; its
    parameters train."""
    over = dict(over or {}, dtype="float32")
    jm = jcls(dataclasses.replace(jbase, **over))
    jtree = jm.init(jax.random.key(1))
    tcfg = dataclasses.replace(tbase, **over)
    model = tcls(tcfg, device="cpu")
    named = dict(model.named_parameters())
    flat = _flat(jtree)
    assert {n: tuple(p.shape) for n, p in named.items()} == \
        {n: a.shape for n, a in flat.items()}
    assert all(p.requires_grad for p in named.values())
    assert sum(p.numel() for p in named.values()) == tcfg.num_params() == \
        jm.config.num_params()
    assert tcfg.flops_per_token() == jm.config.flops_per_token()
    jkeys = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    assert _jax_order(named) == jkeys
    jspecs = _flat(jax.tree.map(tuple, jm.partition_specs(),
                                is_leaf=lambda x: isinstance(
                                    x, jax.sharding.PartitionSpec)))
    assert model.partition_specs() == {k: tuple(v)
                                       for k, v in jspecs.items()}
    return model


@pytest.mark.parametrize("tied", [False, True])
def test_config_params_and_specs_mirror_jax(tied):
    check_tree_mirrors_jax(JLlama, Llama, J_TINY, LLAMA_TINY,
                           dict(tie_embeddings=tied))


def test_serving_programs_run_without_autograd():
    """The paged programs run under inference_mode: with trainable
    parameters their logits and the pools they write carry no graph."""
    model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                  device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    cache = model.init_paged_cache(4, 8)
    ids = torch.from_numpy(_ids(LLAMA_TINY.vocab_size, 3, rows=1, t=8))
    blocks = torch.ones(8, dtype=torch.int32)
    logits, cache = model.apply_paged_prefill(
        ids, cache, blocks, torch.arange(8), 8)
    assert not logits.requires_grad and logits.is_inference()
    assert not any(p.requires_grad for p in cache["k"] + cache["v"])
    assert float(cache["k"][0][1].abs().sum()) > 0


def test_unported_training_paths_raise():
    """remat policies other than nothing_saveable raise M3 (JAX's Llama
    takes any jax.checkpoint_policies name), seq_sharded raises M12, a
    quantized model does not train."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32", remat=True,
                              remat_policy="save_flash")
    ids = {"input_ids": _ids(LLAMA_TINY.vocab_size, 4)}
    with pytest.raises(NotImplementedError, match="M3"):
        Llama(cfg, device="cpu").loss(ids)
    model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="M12"):
        model.loss(ids, seq_sharded=True)
    big = dataclasses.replace(LLAMA_TINY, dtype="float32", d_model=256,
                              vocab_size=64)
    with pytest.raises(NotImplementedError, match="serves only"):
        Llama(big, device="cpu", quantize="int8").loss(ids)
    # nn.Module.apply still applies a function to every submodule
    seen = []
    model.apply(seen.append)
    assert seen[-1] is model and len(seen) == 2


# ------------------------------------------------------------------ engine


def engine_config(micro, gas, grouped_kernel=None):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas, "steps_per_print": 0,
           "optimizer": {"type": "AdamW", "params": {
               "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": 2}}
    if grouped_kernel is not None:
        cfg["moe"] = {"grouped_kernel": grouped_kernel}
    return cfg


def _batches(vocab, rows, seed, n=3):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, vocab, (rows, T)).astype(np.int32)}
            for _ in range(n)]


def check_train_batch(jmodel, tmodel_fn, convert, gas, tmp_path,
                      grouped_kernel=(None, None)):
    """3 AdamW steps (ZeRO-2, clip 1.0) of the port from the JAX engine's
    initial master against the JAX engine on the 8-device CPU mesh (its
    global micro-batch of 8 rows is the port's micro-batch), both fp32;
    then a checkpoint each way: the JAX tag into a fresh port engine
    (loaded state bitwise, next loss at rtol 2e-5) and the port's tag
    into the JAX engine (its master bitwise the port's, next loss).
    ``grouped_kernel``: the JAX and the port configs' ``moe`` block
    knobs (None: no block)."""
    jknob, knob = grouped_kernel
    vocab = jmodel.config.vocab_size
    batches = _batches(vocab, 8 * gas, seed=gas)
    nxt = _batches(vocab, 8 * gas, seed=10 + gas, n=1)[0]
    jgroups.reset()
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, config=engine_config(1, gas, jknob))
    master0 = jax.tree.map(np.asarray, jeng.state["master"])
    jlosses = [float(jeng.train_batch(b)) for b in batches]
    jmaster = _flat(jax.tree.map(np.asarray, jeng.state["master"]))
    jdir = str(tmp_path / "jax")
    jeng.save_checkpoint(jdir)
    saved = {k: np.asarray(v) for k, v in jser.load_sharded(
        os.path.join(jdir, "global_step3"))[0].items()}
    jnext = float(jeng.train_batch(nxt))

    def port():
        tgroups.reset()
        model = tmodel_fn()
        model.load_state_dict(convert(master0, "cpu", torch.float32))
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, config=engine_config(8, gas, knob),
            device="cpu")
        return eng

    eng = port()
    losses = [float(eng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(losses, jlosses, **ENGINE_LOSS_TOL)
    master3 = {n: m.numpy().copy() for n, m in eng.state["master"].items()}

    # the JAX tag into a fresh port engine: its state bitwise, the next
    # step the JAX engine's
    e2 = port()
    e2.load_checkpoint(jdir)
    for n, m in e2.state["master"].items():
        assert np.array_equal(m.numpy(), saved[
            f"master/{n.replace('.', '/')}"]), n
    for k in ("m", "v"):
        for n, x in e2.state["opt"][k].items():
            assert np.array_equal(x.numpy(), saved[
                f"opt/{k}/{n.replace('.', '/')}"]), (k, n)
    np.testing.assert_allclose(float(e2.train_batch(nxt)), jnext,
                               rtol=CKPT_LOSS_RTOL)
    # the port's tag (after its 3 steps) into the JAX engine
    pdir = str(tmp_path / "port")
    eng.save_checkpoint(pdir)
    pnext = float(eng.train_batch(nxt))
    jeng.load_checkpoint(pdir)
    loaded = _flat(jax.tree.map(np.asarray, jeng.state["master"]))
    for n, m in master3.items():
        assert np.array_equal(loaded[n], m), n
    np.testing.assert_allclose(float(jeng.train_batch(nxt)), pnext,
                               rtol=CKPT_LOSS_RTOL)
    tgroups.reset()
    return eng, losses, master3, jmaster


@pytest.mark.parametrize("gas", [1, 2])
def test_train_batch_and_checkpoints_match_jax_engine(gas, tmp_path):
    over = dict(dtype="float32", remat=False, use_flash_attention=False,
                **CASES["gqa_window"])
    jmodel = JLlama(dataclasses.replace(J_TINY, **over))
    _, _, master, jmaster = check_train_batch(
        jmodel, lambda: Llama(dataclasses.replace(
            LLAMA_TINY, **dict(over, use_flash_attention=True, remat=True)),
            device="cpu"),
        llama_params_from_numpy, gas, tmp_path)
    for n, m in master.items():
        np.testing.assert_allclose(m, jmaster[n], err_msg=n, **MASTER_TOL)


def test_engine_casts_every_parameter_like_jax():
    """bf16 engine: every parameter cast to bf16 and the master taken
    from those (JAX engine.py:468-474); the loss is finite and falls."""
    model = Llama(dataclasses.replace(LLAMA_TINY, dtype="bfloat16"),
                  device="cpu", seed=3)
    wq = model.blocks.wq.detach().clone()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2, "bf16": {"enabled": True},
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-2}}})
    assert torch.equal(eng.state["master"]["blocks.wq"], wq.float())
    batch = {"input_ids": _ids(LLAMA_TINY.vocab_size, 5)}
    losses = [float(eng.train_batch(batch)) for _ in range(4)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
