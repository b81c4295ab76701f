"""GPT-2 sequence-parallel training in the port (models/gpt2.py
``loss(seq_sharded=True)``, runtime/engine.py at seq > 1) held against the
JAX package on CPU, in gloo worlds of seq = 2 and 4 processes (spawned
once each):

- the loss and every parameter gradient (each rank's share, summed over
  the ranks) of a tiny GPT-2 seq-sharded with ``attention_backend="ring"``
  (K10 / K2 steps in their plain versions, with and without whole-block
  remat) and with dense attention (Ulysses), against the JAX model's
  seq-sharded loss on a seq = 2 / 4 mesh (einsum ring steps), at the fp32
  tolerances of test_torch_gpt2_training.py: loss 2e-5, gradients 1e-4;
- 3 ``train_batch`` steps at seq = 2 (ZeRO-2, AdamW with clipping, gas 1
  and 2) from the JAX engine's initial master against the JAX engine on a
  seq_parallel_size=2 topology: the losses and the final fp32 master at
  rtol 1e-4 (atol 1e-6 / 1e-5, as test_torch_engine.py);
- GPT2MoE over a data-parallel world (dp > 1) raises, naming ROADMAP
  item S9 (rest)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepspeed_tpu
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.runtime.config import SequenceConfig as JSequenceConfig
from deepspeed_tpu.utils import groups as jgroups
from test_torch_dist_worker import run_world

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CFG = dict(n_layer=2, n_head=4, d_model=32, max_seq_len=32, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)
MODELS = {"ring": dict(CFG, attention_backend="ring"),
          "ring_remat": dict(CFG, attention_backend="ring", remat=True),
          "dense": dict(CFG)}
SEQ = (2, 4)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _engine_config(gas, **over):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas, "steps_per_print": 0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": 2},
            "sequence": {"block_kernel": False}, **over}


def _topology(sp):
    jgroups.reset()
    return jgroups.initialize(jgroups.TopologyConfig(seq_parallel_size=sp),
                              devices=jax.devices()[:sp])


def _batches(gas, seed):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (2 * gas, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(3)]


def _jax_engine(gas):
    topo = _topology(2)
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2(JGPT2Config(**MODELS["ring"])), topology=topo,
        config=_engine_config(gas))
    master0 = jax.tree.map(np.asarray, engine.state["master"])
    batches = _batches(gas, seed=gas)
    losses = [float(engine.train_batch(b)) for b in batches]
    return master0, batches, losses, _flat(engine.state["master"])


@pytest.fixture(scope="module")
def case():
    params = jax.tree.map(np.asarray,
                          JGPT2(JGPT2Config(**CFG)).init(jax.random.key(0)))
    ids = np.random.RandomState(5).randint(
        0, CFG["vocab_size"], (2, CFG["max_seq_len"])).astype(np.int32)
    return params, ids


@pytest.fixture(scope="module")
def jax_engines():
    return {gas: _jax_engine(gas) for gas in (1, 2)}


@pytest.fixture(scope="module")
def worlds(case, jax_engines, tmp_path_factory):
    params, ids = case
    out = {}
    for sp in SEQ:
        engines = {}
        if sp == 2:
            for gas, (master0, batches, _, _) in jax_engines.items():
                engines[f"gas{gas}"] = dict(
                    model=MODELS["ring"], params=master0, batches=batches,
                    config=_engine_config(gas, sequence_parallel_size=2))
        out[sp] = run_world(
            "gpt2", sp, dict(params=params, ids=ids, models=MODELS,
                             sequence={"block_kernel": True},
                             engines=engines),
            tmp_path_factory.mktemp(f"gpt2sp{sp}"))
    return out


def _jax_loss_grads(name, sp, params, ids):
    model = JGPT2(JGPT2Config(**{k: v for k, v in MODELS[name].items()}))
    model._sequence_cfg = JSequenceConfig(block_kernel=False)
    topo = _topology(sp)
    with jax.set_mesh(topo.mesh):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: model.loss(
            p, {"input_ids": jnp.asarray(ids)}, seq_sharded=True)))(
                jax.tree.map(jnp.asarray, params))
    return float(loss), _flat(grads)


@pytest.mark.parametrize("sp", SEQ)
@pytest.mark.parametrize("name", list(MODELS))
def test_seq_sharded_loss_and_every_grad_match_jax(worlds, case, sp, name):
    params, ids = case
    jloss, jgrads = _jax_loss_grads(name, sp, params, ids)
    outs = [o["res"][name] for o in worlds[sp]]
    for o in outs:                    # the global loss on every rank
        np.testing.assert_allclose(o["loss"], jloss, **LOSS_TOL)
    assert set(outs[0]["grads"]) == set(jgrads)
    for n, want in jgrads.items():
        got = sum(o["grads"][n] for o in outs)
        np.testing.assert_allclose(got, want, err_msg=n, **GRAD_TOL)


@pytest.mark.parametrize("gas", [1, 2])
def test_train_batch_matches_jax_engine_at_seq2(worlds, jax_engines, gas):
    _, _, jlosses, jmaster = jax_engines[gas]
    for o in worlds[2]:
        run = o["res"][f"gas{gas}"]
        np.testing.assert_allclose(np.asarray(run["losses"]), jlosses,
                                   rtol=1e-4, atol=1e-6)
        for n, m in run["master"].items():
            np.testing.assert_allclose(m, jmaster[n], rtol=1e-4, atol=1e-5,
                                       err_msg=n)


@pytest.mark.parametrize("sp", SEQ)
def test_data_parallel_world_raises(worlds, sp):
    """GPT2MoE over a data-parallel world of ``sp`` ranks raises, naming
    its ROADMAP item (GPT-2 itself trains there: test_torch_zero.py)."""
    for o in worlds[sp]:
        assert "S9 (rest): GPT2MoE at dp > 1" in o["res"]["dp_error"]
