"""The port's GShard capacity MoE backend (deepspeed_tpu_torch/moe/
sharded_moe.py ``_capacity``, ``_gumbel``, ``top1gating``, ``top2gating``,
``TopKGate``, ``moe_layer``; ``MoE(backend="dense")``; GPT2MoE at its
default ``moe_backend``) held against the JAX package's on CPU, fp32 on
both sides:

- the gates on random logits: C, the dispatch mask, each token's queue
  position and ``exp_counts`` exactly; ``combine`` (built from the port's
  compact routing) and ``l_aux`` at 1e-6; top-1 and top-2, with and
  without drops, ``min_capacity``, RSample / Jitter noise and top-2
  second-expert sampling from the same key;
- ``moe_layer``'s output and every gradient at 2e-5 / 1e-4;
- GPT2MoE's loss and every gradient against ``jax.value_and_grad`` at
  2e-5 / 1e-4 (remat policies against the port's own at 1e-6), with and
  without noise, from the same key; ``train=True`` without a key raises
  where the model draws noise, as in JAX; without drops the dense
  backend's loss and gradients are the ragged backend's;
- three ``train_batch`` steps against the JAX engine (losses at 1e-4,
  master at rtol 1e-4 / atol 1e-5; Adam eps 1e-6 as in
  test_torch_gpt2_moe_training.py) with a noisy gate, gas 1 and 2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.moe import sharded_moe as J
from deepspeed_tpu.moe.layer import MoE as JMoE
from deepspeed_tpu.utils import groups
from deepspeed_tpu_torch.models import (GPT2MoE, GPT2MoEConfig,
                                        gpt2_moe_params_from_numpy)
from deepspeed_tpu_torch.moe import MoE
from deepspeed_tpu_torch.moe import sharded_moe as T
from deepspeed_tpu_torch.utils import prng

COMBINE_TOL = dict(rtol=1e-6, atol=1e-7)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=32, vocab_size=256,
            dtype="float32", remat=False, use_flash_attention=False,
            num_experts=4)


def dense_combine(g, E):
    """The JAX (S, E, C) ``combine`` of a port ``Gating``."""
    S, k = g.experts.shape
    comb = torch.zeros(S, E, g.capacity)
    for s in range(S):
        for j in range(k):
            if g.weights[s, j] > 0:
                comb[s, g.experts[s, j], g.locations[s, j]] += g.weights[s, j]
    return comb.numpy()


def _logits(S, E, seed):
    return (2 * np.random.RandomState(seed).standard_normal((S, E))).astype(
        np.float32)


def _check_gating(g, jout, E):
    jl, jc, jd, je = (np.asarray(a) for a in jout)
    assert g.capacity == jc.shape[2]
    comb = dense_combine(g, E)
    np.testing.assert_array_equal(comb > 0, jd)
    # each dispatched choice's queue position is JAX's slot
    s, e, c = np.nonzero(jd)
    got = {(a, b): int(loc) for a, row_e, row_l, row_w in zip(
        range(len(g.experts)), g.experts.tolist(), g.locations.tolist(),
        g.weights.tolist()) for b, loc, w in zip(row_e, row_l, row_w)
        if w > 0}
    assert got == {(a, b): int(x) for a, b, x in zip(s, e, c)}
    np.testing.assert_array_equal(g.exp_counts.numpy(), je)
    np.testing.assert_allclose(comb, jc, **COMBINE_TOL)
    np.testing.assert_allclose(float(g.l_aux), float(jl), **COMBINE_TOL)
    return int(jd.sum())


@pytest.mark.parametrize("S,E", [(16, 4), (37, 8), (64, 4)])
def test_capacity_matches_jax(S, E):
    for cf in (0.25, 0.5, 1.0, 1.25, 2.0, 2.5):
        for mc in (0, 1, 4, 40):
            assert T._capacity(S, E, cf, mc) == J._capacity(S, E, cf, mc)


GATE_CASES = [(cf, mc, drop) for cf, mc, drop in
              ((1.0, 4, True), (0.5, 1, True), (1.25, 4, False),
               (2.0, 0, True), (0.25, 20, True))]


@pytest.mark.parametrize("policy", [None, "RSample", "Jitter"])
@pytest.mark.parametrize("cf,mc,drop", GATE_CASES)
@pytest.mark.parametrize("S,E", [(16, 4), (37, 8)])
def test_top1gating_matches_jax(S, E, cf, mc, drop, policy):
    logits = _logits(S, E, S + E)
    for seed in (0, 5):
        jout = J.top1gating(jnp.asarray(logits), cf, mc, policy,
                            jax.random.key(seed), drop)
        g = T.top1gating(torch.from_numpy(logits), cf, mc, policy,
                         prng.key_data(seed), drop)
        sent = _check_gating(g, jout, E)
        if drop and cf <= 0.5 and mc <= 1:
            assert sent < S        # this case drops tokens


@pytest.mark.parametrize("sampling", [False, True])
@pytest.mark.parametrize("cf,mc,drop", GATE_CASES)
@pytest.mark.parametrize("S,E", [(16, 4), (37, 8)])
def test_top2gating_matches_jax(S, E, cf, mc, drop, sampling):
    logits = _logits(S, E, 2 * S + E)
    for seed in (1, 9):
        jout = J.top2gating(jnp.asarray(logits), cf, mc,
                            jax.random.key(seed), drop, sampling)
        g = T.top2gating(torch.from_numpy(logits), cf, mc,
                         prng.key_data(seed), drop, sampling)
        sent = _check_gating(g, jout, E)
        if drop and cf <= 0.5 and mc <= 1:
            assert sent < 2 * S


def test_gumbel_and_noise_need_a_key():
    """_gumbel draws JAX's uniform bitwise (its logs within an ulp); the
    noisy gates refuse to run without a key, as JAX's do."""
    u = prng.uniform(prng.key_data(3), (8, 4), 1e-20, 1.0 - 1e-20)
    ju = jax.random.uniform(jax.random.key(3), (8, 4), jnp.float32, 1e-20,
                            1.0 - 1e-20)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_allclose(
        T._gumbel(prng.key_data(3), (8, 4)).numpy(),
        np.asarray(J._gumbel(jax.random.key(3), (8, 4))), rtol=1e-6,
        atol=1e-6)
    logits = torch.zeros(4, 4)
    for policy in ("RSample", "Jitter"):
        with pytest.raises(ValueError, match=f"{policy} noisy gating needs"):
            T.top1gating(logits, noisy_gate_policy=policy)
    with pytest.raises(ValueError, match="2nd-expert sampling needs"):
        T.top2gating(logits)


@pytest.mark.parametrize("k", [1, 2])
def test_topkgate_train_and_eval(k):
    """TopKGate: the training capacity factor and noise when train, the
    eval factor and no noise (nor second-expert sampling) otherwise."""
    logits = _logits(24, 4, 3)
    jg = J.TopKGate(k, 0.5, 2.0, 1, "RSample" if k == 1 else None, True,
                    True)
    tg = T.TopKGate(k, 0.5, 2.0, 1, "RSample" if k == 1 else None, True,
                    True)
    for train in (True, False):
        jout = jg(jnp.asarray(logits), rng=jax.random.key(2), train=train)
        g = tg(torch.from_numpy(logits), rng=prng.key_data(2), train=train)
        _check_gating(g, jout, 4)
    with pytest.raises(ValueError, match="top-1 and top-2"):
        T.TopKGate(3)


LAYER_CASES = [(1, 1.0, True, None), (1, 0.25, True, "RSample"),
               (1, 0.5, True, "Jitter"), (2, 0.5, True, None),
               (2, 1.0, False, None), (2, 2.0, True, None)]


@pytest.mark.parametrize("k,cf,drop,policy", LAYER_CASES)
def test_moe_layer_output_and_grads_match_jax(k, cf, drop, policy):
    """moe_layer through the gate (top-2 samples its second expert from
    the key), output and the gradients of sum(y * w) + l_aux."""
    rs = np.random.RandomState(k * 10 + int(cf * 4))
    M, Fd, E = 16, 32, 4
    args = [rs.standard_normal((2, 9, M)), rs.standard_normal((M, E)),
            0.3 * rs.standard_normal((E, M, Fd)),
            0.1 * rs.standard_normal((E, Fd)),
            0.3 * rs.standard_normal((E, Fd, M)),
            0.1 * rs.standard_normal((E, M))]
    args = [a.astype(np.float32) for a in args]
    wts = np.cos(np.arange(2 * 9 * M)).reshape(2, 9, M).astype(np.float32)
    jg = J.TopKGate(k, cf, cf, 1, policy, drop, True)
    tg = T.TopKGate(k, cf, cf, 1, policy, drop, True)

    def jf(*a):
        y, l_aux, _ = J.moe_layer(*a, jg, rng=jax.random.key(5), train=True)
        return jnp.sum(y * wts) + l_aux, y
    (jv, jy), jgrads = jax.value_and_grad(
        jf, argnums=tuple(range(6)), has_aux=True)(*map(jnp.asarray, args))
    ta = [torch.from_numpy(a).requires_grad_() for a in args]
    y, l_aux, counts = T.moe_layer(*ta, tg, rng=prng.key_data(5), train=True)
    (torch.sum(y * torch.from_numpy(wts)) + l_aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **OUT_TOL)
    assert counts.sum() == 18 * k
    for i, (a, jgr) in enumerate(zip(ta, jgrads)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgr),
                                   err_msg=str(i), **GRAD_TOL)


def test_moe_module_dense_matches_jax():
    """MoE(backend="dense").apply with rng / train against the JAX MoE on
    the same parameters: train (capacity factor 0.5, RSample) and eval
    (2.0, no noise) outputs and aux."""
    kw = dict(hidden_size=16, ffn_hidden_size=32, num_experts=4, k=1,
              capacity_factor=0.5, eval_capacity_factor=2.0, min_capacity=1,
              noisy_gate_policy="RSample", backend="dense")
    jm = JMoE(dtype=jnp.float32, **kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    params = {k: (v + 0.1 if k in ("bi", "bo") else v)
              for k, v in params.items()}
    tm = MoE(dtype=torch.float32, **kw)
    x = np.random.RandomState(0).standard_normal((3, 7, 16)).astype(
        np.float32)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    for train in (True, False):
        jy, jaux, jc = jm.apply(params, jnp.asarray(x), rng=jax.random.key(4),
                                train=train)
        y, aux, c = tm.apply(tp, torch.from_numpy(x), rng=prng.key_data(4),
                             train=train)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **OUT_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    for k, v in tree["blocks"].items():
        if k == "moe":
            out.update({f"blocks.moe.{m}": a for m, a in v.items()})
        else:
            out[f"blocks.{k}"] = v
    return {k: np.asarray(v) for k, v in out.items()}


def _ids(rows, seed):
    return np.random.RandomState(seed).randint(
        0, BASE["vocab_size"], (rows, BASE["max_seq_len"])).astype(np.int32)


def _port(over, params):
    model = GPT2MoE(GPT2MoEConfig(**{**BASE, **over}), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(params, "cpu",
                                                     torch.float32))
    return model


def _port_loss_grads(model, ids, rng):
    model.zero_grad(set_to_none=True)
    loss = model.loss({"input_ids": ids}, rng=rng)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy()
                                  for n, p in model.named_parameters()}


MODEL_CASES = {
    "default": {},
    "top1_drops_rsample": dict(capacity_factor=0.5, min_capacity=1,
                               noisy_gate_policy="RSample"),
    "top1_jitter": dict(noisy_gate_policy="Jitter"),
    "top2_sampling": dict(moe_top_k=2, capacity_factor=0.5),
}


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_loss_and_every_grad_match_jax(case):
    """GPT2MoE (dense) against jax.value_and_grad(GPT2MoE.loss) with the
    same key; the remat policies recompute the same noise (the port's own
    values at 1e-6; save_flash at the gradient tolerance)."""
    over = dict(MODEL_CASES[case], moe_backend="dense")
    jmodel = JGPT2MoE(JGPT2MoEConfig(**{**BASE, **over}))
    params = jmodel.init(jax.random.key(0))
    ids = _ids(2, 10)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(ids)},
                              rng=jax.random.key(7)))(params)
    jgrads = _flat(jgrads)
    params = jax.tree.map(np.asarray, params)
    model = _port(over, params)
    assert model._requires_train_rng() == jmodel._requires_train_rng()
    key = prng.key_data(7)
    loss, grads = _port_loss_grads(model, ids, key)
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-5, atol=2e-5)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], err_msg=name, **GRAD_TOL)
    for policy in ("nothing_saveable", "save_flash"):
        m = _port(dict(over, remat=True, remat_policy=policy,
                       use_flash_attention=policy == "save_flash"), params)
        l2, g2 = _port_loss_grads(m, ids, key)
        tol = dict(rtol=1e-6, atol=1e-6) if policy != "save_flash" \
            else GRAD_TOL
        np.testing.assert_allclose(l2, loss, **tol)
        for name, g in g2.items():
            np.testing.assert_allclose(g, grads[name],
                                       err_msg=f"{policy} {name}", **tol)


def test_train_requires_a_key_where_the_model_draws_noise():
    """As JAX's ``embed`` (gpt2.py:489-495): a noisy gate or top-2
    sampling with train=True and no key raises; eval does not."""
    for over in (dict(noisy_gate_policy="RSample"), dict(moe_top_k=2)):
        cfg = {**BASE, **over, "moe_backend": "dense"}
        model = GPT2MoE(GPT2MoEConfig(**cfg), device="cpu")
        jmodel = JGPT2MoE(JGPT2MoEConfig(**cfg))
        assert model._requires_train_rng() and jmodel._requires_train_rng()
        with pytest.raises(ValueError, match="train=True requires rng="):
            model.loss({"input_ids": _ids(1, 0)})
        with torch.no_grad():
            assert torch.isfinite(model.loss({"input_ids": _ids(1, 0)},
                                             train=False))
    model = GPT2MoE(GPT2MoEConfig(**{**BASE, "moe_backend": "dense"}),
                    device="cpu")
    assert not model._requires_train_rng()


@pytest.mark.parametrize("k", [1, 2])
def test_dense_without_drops_is_the_ragged_backend(k):
    """``moe_drop_tokens=False`` (C = S): the dense backend's loss and
    gradients equal the ragged backend's (JAX's
    test_dropless_vs_dense_dispatch_no_drops), relative error norm 1e-5."""
    over = dict(moe_top_k=k, moe_drop_tokens=False)
    params = jax.tree.map(np.asarray, JGPT2MoE(JGPT2MoEConfig(
        **{**BASE, **over})).init(jax.random.key(2)))
    ids = _ids(2, 3)
    out = {}
    for backend in ("dense", "ragged"):
        m = _port(dict(over, moe_backend=backend,
                       moe_grouped_kernel=False), params)
        if backend == "dense":
            m.moe.gate.top2_2nd_expert_sampling = False
        out[backend] = _port_loss_grads(m, ids, None)
    (ld, gd), (lr, gr) = out["dense"], out["ragged"]
    np.testing.assert_allclose(ld, lr, rtol=1e-6)
    for n, g in gd.items():
        err = np.linalg.norm(g - gr[n]) / np.linalg.norm(gr[n])
        assert err <= 1e-5, (n, err)


def _engine_config(micro, gas):
    return {"train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {
                "lr": 1e-3, "weight_decay": 0.01, "eps": 1e-6}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 2}}


@pytest.mark.parametrize("gas", [1, 2])
def test_train_batch_matches_jax_engine(gas):
    """3 AdamW steps of a noisy dense GPT2MoE (top-1, RSample, capacity
    factor 0.5: tokens drop) from the JAX engine's initial master, each
    micro step's key the JAX engine's (the JAX engine on the 8-device CPU
    mesh: its global micro-batch of 8 rows is the port's micro-batch, so
    both gates see the same tokens); the key words after the steps are
    the JAX engine's, bitwise."""
    cfg = dict(BASE, moe_backend="dense", capacity_factor=0.5,
               min_capacity=1, noisy_gate_policy="RSample")
    rs = np.random.RandomState(gas)
    batches = [{"input_ids": rs.randint(0, 256, (8 * gas, 32))
                .astype(np.int32)} for _ in range(3)]
    groups.reset()
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=JGPT2MoE(JGPT2MoEConfig(**cfg)), config=_engine_config(1, gas))
    master0 = jax.tree.map(np.asarray, jeng.state["master"])
    jlosses = [float(jeng.train_batch(b)) for b in batches]
    model = GPT2MoE(GPT2MoEConfig(**cfg), device="cpu")
    model.load_state_dict(gpt2_moe_params_from_numpy(master0, "cpu",
                                                     torch.float32))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_engine_config(8, gas), device="cpu")
    losses = [float(eng.train_batch(b)) for b in batches]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-6)
    jmaster = _flat(jeng.state["master"])
    for name, m in eng.state["master"].items():
        np.testing.assert_allclose(m.numpy(), jmaster[name], rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(
        eng.rng_data, np.asarray(jax.random.key_data(jeng.state["rng"])))
