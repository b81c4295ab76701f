"""Weight-only quantized serving (``weight_quant``, ``quantize_weights``)
held against the JAX package on CPU, fp32: the Llama and Mixtral ``_mlp``
per layer on quantized weights (the JAX fused path: ``wq_matmul`` and
``grouped_swiglu_wq`` in interpret mode; the port: the K7 / K9 plain
versions, and the ragged parity path), the three paged programs (logits
and pools within 1e-4), identical greedy streams from the JAX and the
port engines for Llama at ``weight_quant`` int8 and int4 and at
``quantize_weights=True`` (``d_model=256``: the attention weights are
quantized too), and the engine's quantization modes. The Mixtral engine
streams and the router's dtype are in ``test_torch_quantized_mixtral.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as JM_TINY
from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu.ops import int8_weights as jiw
from deepspeed_tpu.runtime.config import MoEConfig
from deepspeed_tpu_torch import InferenceEngineV2, Llama, Mixtral
from deepspeed_tpu_torch.models import (LLAMA_TINY, MIXTRAL_TINY,
                                        llama_params_from_numpy,
                                        mixtral_params_from_numpy)
from deepspeed_tpu_torch.ops import int8_weights as iw

TOL = dict(rtol=1e-4, atol=1e-4)
NB, BS = 12, 8
BITS = {"int8": 8, "int4": 4}


def _pair(mixtral, mode, **over):
    """The same fp32 model in both packages (weights from a JAX seed), both
    quantized in ``mode`` on the fused path: (JAX model, quantized JAX
    params, port model)."""
    if mixtral:
        jm = JMixtral(dataclasses.replace(JM_TINY, dtype="float32", **over))
        jm._moe_cfg = MoEConfig(grouped_kernel=True)
        pm = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32",
                                         **over), device="cpu")
        conv = mixtral_params_from_numpy
    else:
        jm = JLlama(dataclasses.replace(J_TINY, dtype="float32", **over))
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32", **over),
                   device="cpu")
        conv = llama_params_from_numpy
    jm._paged_kernel = True           # Pallas kernels, interpret mode
    jm._paged_block_c = 8
    jm._weight_quant_fused = mode
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    pm.load_state_dict(conv(tree, "cpu", torch.float32))
    pm.quantize_(mode)
    pm._weight_quant_fused = True
    qparams = jax.tree.map(jnp.asarray,
                           jiw.quantize_tree(tree, bits=BITS[mode]))
    return jm, qparams, pm


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_llama_mlp_matches_jax(mode, gated):
    """K7 on the gated SwiGLU and the plain-gelu FFN, every layer."""
    jm, qp, pm = _pair(False, mode, mlp_gated=gated)
    assert iw.is_quantized(pm._w("wup", 0))
    x = np.random.RandomState(1).standard_normal((2, 13, 128)).astype(
        np.float32)
    for i in range(LLAMA_TINY.n_layer):
        want = jm._mlp(jnp.asarray(x), jm._layer_slice(qp, i))
        got = pm._mlp(torch.from_numpy(x), i)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_mixtral_mlp_matches_jax(mode, grouped):
    """K9 per layer: the JAX ``grouped_swiglu_wq`` (interpret) against the
    port's plain K9 products, and against the port's ragged parity path
    (each expert dequantized, the JAX fallback math)."""
    jm, qp, pm = _pair(True, mode)
    pm.grouped_kernel = grouped
    x = np.random.RandomState(2).standard_normal((2, 13, 128)).astype(
        np.float32)
    for i in range(MIXTRAL_TINY.n_layer):
        want = jm._mlp(jnp.asarray(x), jm._layer_slice(qp, i))
        got = pm._mlp(torch.from_numpy(x), i)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)


def _assert_pools(jc, pc):
    for name in ("k", "v"):
        for a, b in zip(jc[name], pc[name]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("mixtral,mode", [(False, "int4"), (True, "int8")])
def test_paged_programs_match_jax(mixtral, mode):
    """prefill (13 tokens) -> chunk (5 more, mid-block) -> decode (one live
    slot, one inactive) on quantized weights: logits and every pool."""
    jm, qp, pm = _pair(mixtral, mode)
    jc = jm.init_paged_cache(NB, BS, dtype=jnp.float32)
    pc = pm.init_paged_cache(NB, BS)
    rs = np.random.RandomState(1)
    prompt = rs.randint(0, 512, (18,)).astype(np.int32)
    blocks = np.array([3, 7, 5], np.int32)
    T, Tp = 13, 16
    ids = np.zeros((1, Tp), np.int32)
    ids[0, :T] = prompt[:T]
    tb = np.zeros((Tp,), np.int32)
    to = np.zeros((Tp,), np.int32)
    tb[:T] = blocks[np.arange(T) // BS]
    to[:T] = np.arange(T) % BS
    jl, jc = jm.apply_paged_prefill(qp, jnp.asarray(ids), jc,
                                    jnp.asarray(tb), jnp.asarray(to),
                                    jnp.int32(T))
    pl_, pc = pm.apply_paged_prefill(torch.from_numpy(ids), pc,
                                     torch.from_numpy(tb),
                                     torch.from_numpy(to), T)
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jc, pc)

    C, start, tl = 8, 13, 5
    ids = np.zeros((1, C), np.int32)
    ids[0, :tl] = prompt[start:start + tl]
    tb = np.zeros((C,), np.int32)
    to = np.zeros((C,), np.int32)
    pos = start + np.arange(tl)
    tb[:tl] = blocks[pos // BS]
    to[:tl] = pos % BS
    table = np.zeros((4,), np.int32)
    table[:3] = blocks
    jl, jc = jm.apply_paged_chunk(
        qp, jnp.asarray(ids), jc, jnp.asarray(tb), jnp.asarray(to),
        jnp.int32(start), jnp.int32(tl), jnp.asarray(table))
    pl_, pc = pm.apply_paged_chunk(
        torch.from_numpy(ids), pc, torch.from_numpy(tb),
        torch.from_numpy(to), start, tl, torch.from_numpy(table))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)
    _assert_pools(jc, pc)

    tokens = np.array([int(np.argmax(np.asarray(jl)[0])), 0], np.int32)
    lengths = np.array([18, 0], np.int32)
    tables = np.zeros((2, 4), np.int32)
    tables[0] = table
    jl, jc = jm.apply_paged_decode(qp, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jc,
                                   jnp.asarray(tables))
    pl_, pc = pm.apply_paged_decode(torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), pc,
                                    torch.from_numpy(tables))
    np.testing.assert_allclose(pl_[0].numpy(), np.asarray(jl)[0], **TOL)
    _assert_pools(jc, pc)


def engine_streams(jm, tree, pm, quant, d_steps=2):
    """Greedy streams of the JAX and the port engines (split-fuse chunks of
    16 over 8-token blocks) on the same float weights, each engine
    quantizing them itself: (port streams, JAX streams, port engine)."""
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 16, 37)]
    base = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
                max_batch_size=4, splitfuse_tokens=16,
                decode_steps_per_dispatch=d_steps, **quant)
    jeng = JEngine(jm, params=tree,
                   config=dict(base, paged_kernel=True, paged_block_c=8,
                               prefix_cache=False, telemetry=False))
    want = jeng.generate_all(prompts, max_new_tokens=6)
    peng = InferenceEngineV2(pm, base, device="cpu")
    got = peng.generate_all(prompts, max_new_tokens=6)
    return got, [np.asarray(w) for w in want], peng


@pytest.mark.parametrize("quant,d_model", [
    (dict(weight_quant="int8"), 128),
    (dict(weight_quant="int4"), 128),
    (dict(quantize_weights=True), 256),
])
def test_llama_engine_greedy_streams_match_jax(quant, d_model):
    jm = JLlama(dataclasses.replace(J_TINY, dtype="float32",
                                    d_model=d_model))
    params = jm.init(jax.random.key(0))
    pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32",
                                   d_model=d_model), device="cpu")
    pm.load_state_dict(llama_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    got, want, peng = engine_streams(jm, params, pm, quant)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    model = peng.model
    assert model.weight_quant == quant.get("weight_quant", "int8")
    assert model._weight_quant_fused == ("weight_quant" in quant)
    quantized = set(model.qblocks)
    assert {"wup", "wgate", "wdown"} <= quantized
    assert ({"wq", "wk", "wv", "wo"} <= quantized) == (d_model == 256)


def test_engine_quantization_modes():
    """weight_quant wins over quantize_weights; "auto" resolves off; a model
    built quantized serves in its own mode and raises in another; a bad
    weight_quant value raises as in JAX."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32", d_model=256)
    base = dict(dtype="float32", kv_block_size=8, max_batch_size=2)
    eng = InferenceEngineV2(Llama(cfg, device="cpu"),
                            dict(base, weight_quant="int4",
                                 quantize_weights=True), device="cpu")
    assert eng.model.weight_quant == "int4"
    assert eng.model._weight_quant_fused
    eng = InferenceEngineV2(Llama(cfg, device="cpu"),
                            dict(base, weight_quant="auto"), device="cpu")
    assert eng.model.weight_quant is None and not eng.model.qblocks
    built = Llama(cfg, device="cpu", quantize="int4", seed=2)
    codes = built.qblocks["wup"].q
    eng = InferenceEngineV2(built, dict(base, weight_quant="int4"),
                            device="cpu")
    assert eng.model.qblocks["wup"].q is codes      # served as built
    for quant in (dict(weight_quant="int8"), dict(quantize_weights=True),
                  {}):
        with pytest.raises(ValueError, match="quantized as 'int4'"):
            InferenceEngineV2(Llama(cfg, device="cpu", quantize="int4"),
                              dict(base, **quant), device="cpu")
    for bad in (True, "int2"):
        with pytest.raises(ValueError, match="weight_quant"):
            InferenceEngineV2(Llama(cfg, device="cpu"),
                              dict(base, weight_quant=bad), device="cpu")
