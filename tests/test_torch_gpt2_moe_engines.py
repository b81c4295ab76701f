"""GPT2MoE through the port's v2 serving engine held against the JAX
InferenceEngineV2 on CPU, fp32 on both sides, the weights of
test_torch_gpt2_moe_paged.py's ``moe_pair``: greedy streams (split-fuse
chunks of 16, 4-step decode dispatches, both waves of
test_torch_gpt2_engines.py's prompts) equal the JAX engine's for the
dense backend (top-1 and top-2), the ragged backend, ``weight_quant``
int8 and int4, and a dense gate whose capacity drops tokens: the drops
are counted, and that stream differs from the dropless backend's. A gate
sees every row a program passes, the prompt bucket's pads and the idle
decode slots included, so equal streams also show that the port's
engine hands the programs JAX's batch shapes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu_torch import InferenceEngineV2
from deepspeed_tpu_torch.models import GPT2MoE, gpt2_moe_params_from_numpy
from test_torch_gpt2_engines import BASE, JAX_BASE, PROMPTS, WAVE2
from test_torch_gpt2_moe_paged import TINY, moe_pair

NEW = 6
_STREAMS = {}


def _jax_streams(case, **quant):
    key = ("streams", case, tuple(sorted(quant.items())))
    if key not in _STREAMS:
        jm, _, _, tree = moe_pair(case)
        jeng = JEngine(jm, params=jax.tree.map(jnp.asarray, tree),
                       config=dict(JAX_BASE, **quant))
        _STREAMS[key] = [np.asarray(w) for w in jeng.generate_all(
            PROMPTS + WAVE2, max_new_tokens=NEW)]
    return _STREAMS[key]


class CountingGate:
    """A gate that counts the choices it drops (weight 0)."""

    def __init__(self, gate):
        self.gate = gate
        self.dropped = 0
        self.calls = 0

    def __call__(self, *args, **kwargs):
        g = self.gate(*args, **kwargs)
        self.dropped += int((g.weights == 0).sum())
        self.calls += 1
        return g


STREAM_CASES = [("dense", {}), ("dense_top2", {}), ("dense_drops", {}),
                ("ragged", {}), ("ragged", dict(weight_quant="int8")),
                ("ragged", dict(weight_quant="int4")),
                ("dense", dict(weight_quant="int4"))]


@pytest.mark.parametrize(
    "case,quant", STREAM_CASES,
    ids=[c + "".join(f"-{v}" for v in q.values()) for c, q in STREAM_CASES])
def test_engine_greedy_streams_match_jax(case, quant):
    """Split-fuse chunks of 16 and 4-step decode dispatches: the streams of
    both waves equal the JAX engine's, each engine quantizing the same
    float weights itself."""
    want = _jax_streams(case, **quant)
    pm = GPT2MoE(moe_pair(case)[2].config, device="cpu",
                 dtype=torch.float32)
    pm.load_state_dict(gpt2_moe_params_from_numpy(
        moe_pair(case)[3], "cpu", torch.float32))
    counting = None
    if pm.moe.gate is not None:
        counting = pm.moe.gate = CountingGate(pm.moe.gate)
    eng = InferenceEngineV2(pm, dict(BASE, splitfuse_tokens=16, **quant),
                            device="cpu")
    got = eng.generate_all(PROMPTS + WAVE2, max_new_tokens=NEW)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)
    fc = eng.forward_counts
    assert fc["chunk"] > 0 and fc["decode"] > 0
    if quant:
        assert pm.weight_quant == quant["weight_quant"]
        assert {"moe.wi", "moe.wo"} <= set(pm.qblocks)
    if counting is not None:
        assert counting.calls == TINY["n_layer"] * sum(fc.values())
    if case == "dense_drops":
        assert counting.dropped > 0
        ragged = _jax_streams("ragged_top1")
        assert any(not np.array_equal(np.asarray(a), b)
                   for a, b in zip(got, ragged))

