"""The port's v2 engine at ``tensor_parallel`` = 2 (one gloo world of two
CPU processes, the worker's ``serve`` suite) under ``weight_quant`` and
with its serving features, fp32:

  * int8 and int4 at d 256, F 512 (every block projection passes the
    2^16-element ``min_size``): each rank quantizes the whole tree, then
    keeps its slice (a row-parallel ``wo`` / ``wdown`` shard with the
    global scale), the FFN through K7's plain version; the greedy streams
    equal the JAX engine's on a two-device mesh;
  * within the port: the prefix cache on (a second wave sharing the
    first's prefixes) == off, draft speculation (a one-layer draft sliced
    over the same topology, and the model as its own draft) == plain
    decode, KV host offload (each rank's pool of its own heads) ==
    resident, and the plain tp = 2 streams equal the JAX engine's."""

import dataclasses

import numpy as np
import pytest

import jax

from deepspeed_tpu.models.llama import LLAMA_TINY as J_LLAMA_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch.models import LLAMA_TINY
from test_torch_dist_worker import run_world
from test_torch_families import randomize
from test_torch_tp_serving import jax_streams, run, spec

_rs = np.random.RandomState(2)
PROMPTS = [_rs.randint(0, 512, (n,)).astype(np.int32) for n in (5, 37, 61)]
# a second wave: the first wave's prefixes (whole blocks and a partial
# tail) with new tails
PROMPTS += [np.concatenate([PROMPTS[2][:44], _rs.randint(0, 512, (9,))]),
            np.concatenate([PROMPTS[1][:20], _rs.randint(0, 512, (13,))])]
PROMPTS = [p.astype(np.int32) for p in PROMPTS]
WAVES = [[0, 1, 2], [3, 4]]
QUANT = dict(d_model=256, d_ff=512)


def _llama(n_layer=2, seed=0, **over):
    over = dict(dtype="float32", n_layer=n_layer, **over)
    jm = JLlama(dataclasses.replace(J_LLAMA_TINY, **over))
    tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(seed))))
    return jm, tree, spec("Llama", dataclasses.replace(LLAMA_TINY, **over),
                          "llama", tree)


_MODELS = {"plain": _llama(), "quant": _llama(**QUANT),
           "draft": _llama(n_layer=1, seed=3)}
TP = dict(tensor_parallel=2, splitfuse_tokens=16)
RUNS = {
    "plain": ("plain", dict(TP), {}),
    "int8": ("quant", dict(TP, weight_quant="int8"), {}),
    "int4": ("quant", dict(TP, weight_quant="int4"), {}),
    "prefix": ("plain", dict(TP, prefix_cache=True), {}),
    "draft": ("plain", dict(TP, spec_k=3), {"draft": "draft"}),
    "self_draft": ("plain", dict(TP, spec_k=2), {"draft": "self"}),
    "offload": ("plain", dict(TP, kv_host_offload=True,
                              device_kv_blocks=10), {}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    runs = {}
    for name, (model, conf, extra) in RUNS.items():
        extra = dict(extra)
        if extra.get("draft") == "draft":
            extra["draft"] = _MODELS["draft"][2]
        runs[name] = run(_MODELS[model][2], conf, prompts=PROMPTS,
                         waves=WAVES, **extra)
    return [o["res"] for o in run_world(
        "serve", 2, {"runs": runs}, tmp_path_factory.mktemp("tp_feat"))]


@pytest.mark.parametrize("name", ["plain", "int8", "int4"])
def test_streams_match_jax_mesh(world, name):
    """plain / int8 / int4 at tp = 2: both ranks' greedy streams equal the
    JAX engine's on a two-device mesh (quantized from the same float
    tree)."""
    model, conf, _ = RUNS[name]
    jm, tree, _ = _MODELS[model]
    conf = {k: v for k, v in conf.items() if k != "tensor_parallel"}
    want = jax_streams(jm, tree, conf, prompts=PROMPTS, waves=WAVES, tp=2)
    for r in (0, 1):
        assert world[r][name]["streams"] == want, r


@pytest.mark.parametrize("bits", ["int8", "int4"])
def test_quantized_slices_are_the_ranks(world, bits):
    """Every block projection quantized, each rank's slice (logical
    shapes): the column leaves' F / 2 columns, wdown's F / 2 rows, wo's
    D / 2 rows."""
    D, Fd = QUANT["d_model"], QUANT["d_ff"]
    for r in (0, 1):
        sh = world[r][bits]["shapes"]
        assert sh["wgate"] == sh["wup"] == (2, D, Fd // 2)
        assert sh["wdown"] == (2, Fd // 2, D)
        assert sh["wo"] == (2, D // 2, D)


@pytest.mark.parametrize("name", ["prefix", "draft", "self_draft",
                                  "offload"])
def test_feature_streams_equal_plain(world, name):
    """Each feature at tp = 2 serves the plain tp = 2 streams on both
    ranks, and did its work: prefix hits (a partial-tail copy included),
    verify forwards, blocks through the host pool."""
    want = world[0]["plain"]["streams"]
    for r in (0, 1):
        res = world[r][name]
        assert res["streams"] == want, r
        if name == "prefix":
            assert res["prefix"]["hits"] >= 2, res["prefix"]
            assert res["prefix"]["cow_copies"] >= 1, res["prefix"]
        elif name == "offload":
            assert res["offload"][0] > 0 and res["offload"][1] > 0
            assert res["pool"][0] == 10 and res["pool"][1] == 1
        else:
            assert res["forward_counts"]["verify"] > 0
            assert res["draft_forward_counts"]["decode"] > 0
