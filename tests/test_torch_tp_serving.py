"""The port's v2 engine at ``tensor_parallel`` = 2 (a gloo world of two
CPU processes, ``test_torch_dist_worker.py``'s ``serve`` suite), held
against the JAX InferenceEngineV2 on a two-device CPU mesh (its dense
programs), fp32 on both sides: the greedy streams of a GQA Llama (KV heads
2, bucketed prefill and split-fuse), Qwen (the q / k / v biases slice with
their columns), GPT-NeoX (parallel block, the row-parallel biases added
once after the sum) and Bloom (ALiBi: each rank's heads take the global
heads' slopes, the decode through K4's plain version with the head
offset); both ranks' streams identical, a sampled run (temperature 0.8,
top-k 20) included; each rank holds half the heads and FFN columns and
pools of its KV heads. One JAX engine a case, each on a fresh tree from
the same numpy weights (``randomize``: the biases and norms random too);
the world is started once for the file."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.llama import LLAMA_TINY as J_LLAMA_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import LLAMA_TINY
from test_torch_dist_worker import run_world
from test_torch_families import family, randomize

NEW = 6
BASE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
            max_batch_size=4, decode_steps_per_dispatch=4)
JAX_BASE = dict(BASE, paged_kernel=False, prefix_cache=False,
                telemetry=False)
_rs = np.random.RandomState(0)
PROMPTS = [_rs.randint(0, 512, (n,)).astype(np.int32) for n in (5, 37, 20)]


def jax_streams(jm, tree, conf, prompts=PROMPTS, new=NEW, tp=1, ep=1,
                waves=None):
    """The JAX engine's streams on a ``tp * ep``-device mesh, from a
    fresh parameter tree (its quantization consumes the one it gets)."""
    jgroups.reset()
    topo = jgroups.initialize(
        jgroups.TopologyConfig(tensor_parallel_size=tp,
                               expert_parallel_size=ep),
        devices=jax.devices()[:tp * ep], force=True)
    eng = JEngine(jm, params=jax.tree.map(jnp.asarray, tree), topology=topo,
                  config=dict(JAX_BASE, tensor_parallel=tp,
                              expert_parallel=ep, **conf))
    out = []
    for wave in waves or [range(len(prompts))]:
        out.extend(np.asarray(t).tolist() for t in eng.generate_all(
            [prompts[i] for i in wave], max_new_tokens=new))
    jgroups.reset()
    return out


def spec(cls, cfg, conv, tree):
    """A model of the worker's ``serve`` suite."""
    return {"cls": cls, "cfg": dataclasses.asdict(cfg), "conv": conv,
            "tree": tree}


def run(model, conf, prompts=PROMPTS, new=NEW, waves=None, **extra):
    return {**model, "conf": dict(BASE, **conf), "prompts": prompts,
            "new": new, "waves": waves or [list(range(len(prompts)))],
            **extra}


def _llama(d_model=128, seed=0, **over):
    """(JAX model, randomized numpy tree, port spec) of the tiny GQA
    Llama."""
    over = dict(dtype="float32", d_model=d_model, **over)
    jm = JLlama(dataclasses.replace(J_LLAMA_TINY, **over))
    tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))))
    return jm, tree, spec("Llama", dataclasses.replace(LLAMA_TINY, **over),
                          "llama", tree)


def _family(name):
    jcls, tcls, jtiny, ttiny = family(name)
    jm = jcls(dataclasses.replace(jtiny, dtype="float32"))
    tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
    return jm, tree, spec(tcls.__name__,
                          dataclasses.replace(ttiny, dtype="float32"),
                          "llama", tree)


CASES = {
    # name: (model, engine conf)
    "llama": (_llama, dict(splitfuse_tokens=0)),
    "llama_splitfuse": (_llama, dict(splitfuse_tokens=16)),
    "qwen": (lambda: _family("qwen"), dict(splitfuse_tokens=16)),
    "gpt_neox": (lambda: _family("gpt_neox"), dict(splitfuse_tokens=0)),
    "bloom": (lambda: _family("bloom"), dict(splitfuse_tokens=16)),
}
_MODELS = {}


def _model(name):
    if name not in _MODELS:
        _MODELS[name] = CASES[name][0]()
    return _MODELS[name]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    runs = {name: run(_model(name)[2], dict(conf, tensor_parallel=2))
            for name, (_, conf) in CASES.items()}
    runs["sampled"] = run(_model("llama")[2],
                          dict(splitfuse_tokens=16, tensor_parallel=2,
                               temperature=0.8, top_k=20),
                          seed_by_rank=True)
    return [o["res"] for o in run_world(
        "serve", 2, {"runs": runs}, tmp_path_factory.mktemp("tp_serve"))]


@pytest.mark.parametrize("name", list(CASES))
def test_tp2_streams_match_jax_mesh(world, name):
    """Both ranks' greedy streams equal the JAX engine's at
    tensor_parallel = 2; prefill / chunk and decode forwards ran."""
    jm, tree, _ = _model(name)
    want = jax_streams(jm, tree, CASES[name][1], tp=2)
    for r in (0, 1):
        assert world[r][name]["streams"] == want, r
    fc = world[0][name]["forward_counts"]
    assert fc["decode"] > 0
    assert fc["chunk" if CASES[name][1]["splitfuse_tokens"] else
              "prefill"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_heads(world, name):
    """A rank holds H / 2 query heads, KVH / 2 KV heads and F / 2 FFN
    columns (wo / wdown: the rows), its pools (NB, KVH / 2, BS, hd); the
    norms and embeddings whole."""
    jm = _model(name)[0]
    cfg = jm.config
    hd = cfg.d_model // cfg.n_head
    for r in (0, 1):
        res = world[r][name]
        assert res["multi_rank"] and res["tp"] == 2 and res["tp_index"] == r
        sh = res["shapes"]
        L, D = cfg.n_layer, cfg.d_model
        assert sh["wq"] == (L, D, D // 2)
        assert sh["wk"] == (L, D, cfg.n_kv_heads * hd // 2)
        assert sh["wo"] == (L, D // 2, D)
        assert sh["wup"][-1] * 2 == sh["wdown"][1] * 2 == \
            jm.config.ffn_dim
        assert sh["rms1"] == (L, D)
        assert res["pool"][1] == cfg.n_kv_heads // 2
        assert res["pool"][3] == hd


def test_sampled_streams_identical_on_every_rank(world):
    """Temperature 0.8, top-k 20: rank 0's sampled tokens are every
    rank's (broadcast), so the streams agree though each rank's sampler
    has its own seed."""
    a, b = world[0]["sampled"]["streams"], world[1]["sampled"]["streams"]
    assert a == b
    greedy = world[0]["llama_splitfuse"]["streams"]
    assert a != greedy


def test_agreement_counts_what_rank_0_replaced(world):
    """``agreement()``: rank 0's broadcast replaces none of rank 0's own
    picks; in the greedy runs none of rank 1's either (the replicated
    logits give one argmax), in the sampled run some of rank 1's (its
    sampler has its own seed)."""
    for name, res in world[0].items():
        a = res["agreement"]
        assert a["picks"] > 0 and a["overridden"] == 0, (name, a)
    for name, res in world[1].items():
        a = res["agreement"]
        assert a["picks"] == world[0][name]["agreement"]["picks"], name
        if name == "sampled":
            assert 0 < a["overridden"] < a["picks"], a
        else:
            assert a["overridden"] == 0, (name, a)
