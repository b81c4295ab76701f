"""The GPT-2 family through the port's v2 engine at ``tensor_parallel`` > 1
(gloo worlds of two and four CPU processes, the worker's ``serve`` suite),
held against the JAX InferenceEngineV2 on a CPU mesh of the same size, fp32
on both sides (the weights randomized as in test_torch_gpt2_paged.py):
GPT-2 and OPT at tp = 2, GPT-2 at tp = 4 (the JAX
``test_tp_paged_matches_single`` config), GPT-Neo (per-layer windows) at
tp = 2. A rank holds its H / tp heads of q, of k and of v of the fused
``wqkv`` (a per-head split, not a contiguous third of the 3D axis), F / tp
MLP columns, and pools of its heads; every rank's streams are the same."""

import dataclasses

import numpy as np
import pytest

from test_torch_dist_worker import run_world
from test_torch_gpt2_paged import pair
from test_torch_tp_serving import jax_streams, run

_rs = np.random.RandomState(1)
PROMPTS = [_rs.randint(0, 512, (n,)).astype(np.int32) for n in (7, 37, 75)]
CASES = {
    # name: (family, tp, engine conf)
    "gpt2": ("gpt2", 2, dict(splitfuse_tokens=16)),
    "opt": ("opt", 2, dict(splitfuse_tokens=0)),
    "gpt_neo": ("gpt_neo", 2, dict(splitfuse_tokens=16)),
    "gpt2_tp4": ("gpt2", 4, dict(splitfuse_tokens=0)),
}
_PAIRS = {}


def _pair(fam):
    if fam not in _PAIRS:
        _PAIRS[fam] = pair(fam)
    return _PAIRS[fam]


def _spec(fam):
    jm, _, pm, tree = _pair(fam)
    return {"cls": type(pm).__name__,
            "cfg": dataclasses.asdict(pm.config), "conv": "gpt2",
            "tree": tree}


def _world(tmp_path_factory, tp):
    runs = {name: run(_spec(fam), dict(conf, tensor_parallel=tp),
                      prompts=PROMPTS)
            for name, (fam, t, conf) in CASES.items() if t == tp}
    return [o["res"] for o in run_world(
        "serve", tp, {"runs": runs}, tmp_path_factory.mktemp(f"gpt2_{tp}"))]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {tp: _world(tmp_path_factory, tp) for tp in (2, 4)}


@pytest.mark.parametrize("name", list(CASES))
def test_tp_streams_match_jax_mesh(worlds, name):
    """Every rank's greedy streams equal the JAX engine's on a mesh of
    the same tensor-parallel size."""
    fam, tp, conf = CASES[name]
    jm, _, _, tree = _pair(fam)
    want = jax_streams(jm, tree, conf, prompts=PROMPTS, tp=tp)
    for r in range(tp):
        assert worlds[tp][r][name]["streams"] == want, r


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_heads(worlds, name):
    """wqkv (L, D, 3D / tp) and bqkv, wo's rows, wup's columns, pools of
    H / tp heads."""
    fam, tp, _ = CASES[name]
    cfg = _pair(fam)[2].config
    L, D, H = cfg.n_layer, cfg.d_model, cfg.n_head
    for r in range(tp):
        res = worlds[tp][r][name]
        assert res["tp"] == tp and res["tp_index"] == r
        sh = res["shapes"]
        assert sh["wqkv"] == (L, D, 3 * D // tp)
        assert sh["bqkv"] == (L, 3 * D // tp)
        assert sh["wo"] == (L, D // tp, D) and sh["bo"] == (L, D)
        assert sh["wup"] == (L, D, cfg.d_ff // tp)
        assert sh["wdown"] == (L, cfg.d_ff // tp, D)
        assert res["pool"][1] == H // tp

