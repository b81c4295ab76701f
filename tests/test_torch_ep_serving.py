"""Mixtral through the port's v2 engine at ``expert_parallel`` > 1 (gloo
worlds of two and four CPU processes, the worker's ``serve`` suite), held
against the JAX InferenceEngineV2 on a CPU mesh of the same shape, fp32,
at the JAX tests' config (tests/unit/test_inference_v2.py
``test_ep_*``: d 64, 4 experts, top-2): ep = 2 with bucketed prefill and
with split-fuse, ep = 2 x tp = 2 in a world of four. Every rank holds the
same tokens; each takes its share of the flattened rows (padded to the
expert shards: three decode slots make an odd row count), exchanges them
to the ranks of their experts, and gathers the rows back; under tp = 2
the experts' F / 2 columns are summed over ``tensor``. A rank holds E / ep
experts; every rank's streams are the same."""

import numpy as np
import pytest

import jax

from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu.models.mixtral import MixtralConfig as JMixtralConfig
from deepspeed_tpu_torch.models import MixtralConfig
from test_torch_dist_worker import run_world
from test_torch_families import randomize
from test_torch_tp_serving import jax_streams, run, spec

CFG = dict(n_layer=2, n_head=4, n_kv_heads=2, d_model=64, max_seq_len=128,
           vocab_size=512, remat=False, num_experts=4, moe_top_k=2,
           dtype="float32")
_rs = np.random.RandomState(5)
PROMPTS = [_rs.randint(0, 500, (n,)).astype(np.int32) for n in (9, 20, 13)]
EP = dict(max_batch_size=3, kv_block_size=16)
CASES = {
    # name: (tp, ep, engine conf)
    "ep2": (1, 2, dict(EP, splitfuse_tokens=0)),
    "ep2_splitfuse": (1, 2, dict(EP, splitfuse_tokens=16)),
    "ep2_tp2": (2, 2, dict(EP, splitfuse_tokens=16)),
}


def _mixtral():
    jm = JMixtral(JMixtralConfig(**CFG))
    tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(5))))
    return jm, tree, spec("Mixtral", MixtralConfig(**CFG), "mixtral", tree)


_MODEL = _mixtral()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in (2, 4):
        runs = {name: run(_MODEL[2], dict(conf, tensor_parallel=tp,
                                          expert_parallel=ep),
                          prompts=PROMPTS, new=5)
                for name, (tp, ep, conf) in CASES.items() if tp * ep == world}
        out[world] = [o["res"] for o in run_world(
            "serve", world, {"runs": runs},
            tmp_path_factory.mktemp(f"ep_{world}"))]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_ep_streams_match_jax_mesh(worlds, name):
    """Every rank's greedy streams equal the JAX engine's on a mesh of
    expert x tensor devices."""
    tp, ep, conf = CASES[name]
    jm, tree, _ = _MODEL
    want = jax_streams(jm, tree, conf, prompts=PROMPTS, new=5, tp=tp, ep=ep)
    for r in range(tp * ep):
        assert worlds[tp * ep][r][name]["streams"] == want, r


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_experts(worlds, name):
    """moe_w1 / moe_w3 (L, E / ep, D, F / tp), moe_w2 (L, E / ep, F / tp,
    D), the router whole; the KV pools of KVH / tp heads."""
    tp, ep, _ = CASES[name]
    cfg = MixtralConfig(**CFG)
    L, E, D, Fd = cfg.n_layer, cfg.num_experts, cfg.d_model, cfg.ffn_dim
    for r in range(tp * ep):
        res = worlds[tp * ep][r][name]
        assert res["ep"] == ep and res["tp"] == tp
        sh = res["shapes"]
        assert sh["moe_w1"] == sh["moe_w3"] == (L, E // ep, D, Fd // tp)
        assert sh["moe_w2"] == (L, E // ep, Fd // tp, D)
        assert sh["moe_gate"] == (L, D, E)
        assert res["pool"][1] == cfg.n_kv_heads // tp

