"""Quantized Mixtral serving held against the JAX engine on CPU, fp32:
identical greedy streams at ``weight_quant`` int8 and int4 (one at
``d_model=256``, where the attention weights are quantized too) and at
``quantize_weights=True``; the experts go through K9's plain versions on
the fused path and the router stays fp32. The JAX engine's expert FFN runs
``grouped_swiglu_wq`` (Pallas in interpret mode) inside every program.
Also the router's dtype under the unquantized and quantized engines."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as J_TINY
from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu_torch import InferenceEngineV2, Mixtral
from deepspeed_tpu_torch.models import MIXTRAL_TINY, mixtral_params_from_numpy
from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm

from test_torch_quantized_serving import engine_streams


@pytest.mark.parametrize("quant,d_model", [
    (dict(weight_quant="int8"), 128),
    (dict(weight_quant="int4"), 256),
    (dict(quantize_weights=True), 128),
])
def test_mixtral_engine_greedy_streams_match_jax(quant, d_model):
    jm = JMixtral(dataclasses.replace(J_TINY, dtype="float32",
                                      d_model=d_model))
    params = jm.init(jax.random.key(0))
    pm = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32",
                                     d_model=d_model), device="cpu")
    pm.load_state_dict(mixtral_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    got, want, peng = engine_streams(jm, params, pm, quant)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    model = peng.model
    assert {"moe_w1", "moe_w3", "moe_w2"} <= set(model.qblocks)
    assert ({"wq", "wk", "wv", "wo"} <= set(model.qblocks)) == \
        (d_model == 256)
    assert model.blocks["moe_gate"].dtype == torch.float32
    assert model._weight_quant_fused == ("weight_quant" in quant)
    assert gm.LAUNCHES["grouped_swiglu_up_wq"] == 0   # CPU: plain versions


def test_router_dtype_under_both_engines():
    """Unquantized, a bf16 engine rounds the router to bf16 (the JAX
    shard_params quirk, kept); quantized, the router stays fp32 as the JAX
    cast_unquantized keeps it, and the codes and scales keep their types."""
    cfg = dataclasses.replace(MIXTRAL_TINY, dtype="float32")
    plain = InferenceEngineV2(Mixtral(cfg, device="cpu"),
                              dict(dtype="bfloat16", kv_block_size=8),
                              device="cpu")
    assert plain.model.blocks["moe_gate"].dtype == torch.bfloat16
    for quant in (dict(weight_quant="int8"), dict(quantize_weights=True)):
        eng = InferenceEngineV2(Mixtral(cfg, device="cpu"),
                                dict(dtype="bfloat16", kv_block_size=8,
                                     max_batch_size=2, **quant),
                                device="cpu")
        m = eng.model
        assert m.blocks["moe_gate"].dtype == torch.float32
        assert m.wte.dtype == torch.bfloat16
        assert m.blocks["rms1"].dtype == torch.bfloat16
        w = m.qblocks["moe_w1"]
        assert w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
        assert len(eng.generate_all([np.arange(7)], max_new_tokens=3)[0]) \
            == 3
    jm = JMixtral(dataclasses.replace(J_TINY, dtype="float32"))
    jeng = JEngine(jm, config=dict(dtype="bfloat16", kv_block_size=8,
                                   weight_quant="int8", prefix_cache=False,
                                   telemetry=False))
    assert str(jeng.params["blocks"]["moe_gate"].dtype) == "float32"
    assert str(jeng.params["wte"].dtype) == "bfloat16"


def test_converted_router_stays_fp32_bitwise():
    """A bf16 JAX Mixtral converted at torch.bfloat16 keeps the fp32 router
    leaf bit for bit (JAX Mixtral.init keeps it fp32), through the model's
    state and through a weight_quant engine, which routes on it as the JAX
    quantized engine does; the other leaves take the target dtype."""
    jm = JMixtral(J_TINY)
    assert J_TINY.dtype == "bfloat16"
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    jgate = tree["blocks"]["moe_gate"]
    assert jgate.dtype == np.float32
    state = mixtral_params_from_numpy(tree, "cpu", torch.bfloat16)
    assert state["blocks.moe_gate"].dtype == torch.float32
    assert state["blocks.moe_w1"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["blocks.moe_gate"].numpy(), jgate)
    pm = Mixtral(MIXTRAL_TINY, device="cpu")
    pm.load_state_dict(state)
    np.testing.assert_array_equal(pm.blocks["moe_gate"].detach().numpy(),
                                  jgate)
    eng = InferenceEngineV2(pm, dict(dtype="bfloat16", kv_block_size=8,
                                     max_batch_size=2, weight_quant="int8"),
                            device="cpu")
    gate = eng.model.blocks["moe_gate"]
    assert gate.dtype == torch.float32
    np.testing.assert_array_equal(gate.detach().numpy(), jgate)
    assert len(eng.generate_all([np.arange(7)], max_new_tokens=2)[0]) == 2
