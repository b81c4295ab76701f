"""The Llama-family models through the port's engines, held against the JAX
engines on CPU, fp32 on both sides (the randomized biases and norms of
test_torch_families.py): the v2 serving engine's greedy streams for Bloom
(ALiBi: dense prefill / chunk, K4 with the slopes) and Falcon (multi-query,
parallel block) identical to the JAX InferenceEngineV2's (its dense
programs; Bloom split-fuse, Falcon bucketed prefill); an int8 ``weight_quant`` stream of GPT-J (the non-gated FFN with
its biases through K7's plain version); and 3 ``train_batch`` steps of
Bloom at ZeRO-2 against the JAX engine (test_torch_llama_training.py's
``check_train_batch``)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu_torch import InferenceEngineV2
from deepspeed_tpu_torch.models import llama_params_from_numpy
from test_torch_families import family, pair, randomize
from test_torch_llama_training import check_train_batch


def _streams(name, quant=None, splitfuse=16, **over):
    jm, params, pm, _ = pair(name, **over)
    rs = np.random.RandomState(0)
    V = jm.config.vocab_size
    prompts = [rs.randint(0, V, (n,)).astype(np.int32) for n in (5, 37)]
    base = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
                max_batch_size=4, splitfuse_tokens=splitfuse,
                **(quant or {}))
    jeng = JEngine(jm, params=params,
                   config=dict(base, paged_kernel=False, prefix_cache=False,
                               telemetry=False))
    want = jeng.generate_all(prompts, max_new_tokens=4)
    peng = InferenceEngineV2(pm, dict(base, paged_kernel=True), device="cpu")
    got = peng.generate_all(prompts, max_new_tokens=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    return peng


@pytest.mark.parametrize("name,splitfuse", [("bloom", 16), ("falcon", 0)])
def test_engine_greedy_streams_match_jax(name, splitfuse):
    peng = _streams(name, splitfuse=splitfuse)
    assert peng.forward_counts["decode"] > 0
    assert peng.forward_counts["chunk" if splitfuse else "prefill"] > 0


def test_int8_weight_quant_stream_matches_jax():
    """GPT-J at d_model 256 (its projections pass min_size) under
    weight_quant int8: the non-gated FFN through K7 with its biases, the
    attention weights dequantized a layer at a time, the stream the JAX
    engine's."""
    peng = _streams("gptj", quant=dict(weight_quant="int8"), d_model=256)
    model = peng.model
    assert model.weight_quant == "int8" and model._weight_quant_fused
    assert {"wup", "wdown", "wq", "wo"} <= set(model.qblocks)


def test_bloom_train_batch_matches_jax_engine(tmp_path):
    """3 AdamW steps of Bloom at ZeRO-2 (the biases, LayerNorm shifts and
    embedding norm partitioned with the rest) from the JAX engine's initial
    master, randomized, against the JAX engine on the 8-device CPU mesh;
    then the checkpoint round trip both ways."""
    jcls, tcls, jtiny, ttiny = family("bloom")
    over = dict(dtype="float32", remat=False, use_flash_attention=False)
    jmodel = jcls(dataclasses.replace(jtiny, **over))
    init = jmodel.init

    def randomized_init(rng):        # traced by the JAX engine
        return jax.tree.map(jnp.asarray, randomize(init(rng),
                                                   keep=lambda v: v))
    jmodel.init = randomized_init
    check_train_batch(
        jmodel, lambda: tcls(dataclasses.replace(ttiny, dtype="float32",
                                                 remat=True),
                             device="cpu"),
        llama_params_from_numpy, 1, tmp_path)
