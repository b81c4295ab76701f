"""The GPT-2 family (GPT-2, OPT, GPT-Neo) through the port's v2 serving
engine, held against the JAX InferenceEngineV2 on CPU, fp32 on both sides,
the weights randomized as in test_torch_gpt2_paged.py: greedy streams
identical to the JAX engine's (its dense programs, split-fuse chunks of
16) for bucketed prefill and split-fuse, the prefix cache on (GPT-2, a
second wave sharing the first's prefixes), a GPT-2 draft model, KV host
offload, ``weight_quant`` int8 / int4 and ``quantize_weights``; one DSKV
handoff each way between the packages, with the layout guard refusing a
GPT-2 payload into a Llama cache on both sides; ``prefix_cache=True`` on
GPT-Neo raising as in JAX; GPT2MoE served. The prompts (5, 37 and 75
tokens) run past GPT-Neo's window-64 layer. One JAX engine a family and
mode is built once and shared."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import kv_transfer as jkv
from deepspeed_tpu.models.llama import LLAMA_TINY as J_LLAMA_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch import InferenceEngineV2
from deepspeed_tpu_torch.inference.v2 import kv_transfer
from deepspeed_tpu_torch.inference.v2.kv_transfer import KVWireError
from deepspeed_tpu_torch.models import (GPT2, GPT2_TINY, LLAMA_TINY,
                                        GPT2MoE, GPT2MoEConfig, Llama)
from test_torch_gpt2_paged import pair

NEW = 6
BASE = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
            max_batch_size=4, decode_steps_per_dispatch=4)
JAX_BASE = dict(BASE, splitfuse_tokens=16, paged_kernel=False,
                prefix_cache=False, telemetry=False)
_rs = np.random.RandomState(0)
PROMPTS = [_rs.randint(0, 512, (n,)).astype(np.int32) for n in (5, 37, 75)]
# a second wave: the first wave's prefixes (whole blocks and a partial
# tail) with new tails
WAVE2 = [np.concatenate([PROMPTS[2][:52], _rs.randint(0, 512, (9,))]),
         np.concatenate([PROMPTS[1][:20], _rs.randint(0, 512, (30,))])]
WAVE2 = [p.astype(np.int32) for p in WAVE2]

_CACHE = {}


def _pair(name):
    if name not in _CACHE:
        _CACHE[name] = pair(name)
    return _CACHE[name]


def _jax(name, **quant):
    """(JAX engine, its greedy streams of PROMPTS + WAVE2), built once."""
    key = (name, tuple(sorted(quant.items())))
    if key not in _CACHE:
        jm, _, _, tree = _pair(name)
        # a tree of its own: the JAX engine's quantization consumes it
        jeng = JEngine(jm, params=jax.tree.map(jnp.asarray, tree),
                       config=dict(JAX_BASE, **quant))
        want = [np.asarray(w) for w in jeng.generate_all(
            PROMPTS + WAVE2, max_new_tokens=NEW)]
        _CACHE[key] = (jeng, want)
    return _CACHE[key]


def _port(name, **kw):
    return InferenceEngineV2(_pair(name)[2], dict(BASE, **kw), device="cpu")


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("splitfuse", [0, 16])
@pytest.mark.parametrize("name", ["gpt2", "opt", "gpt_neo"])
def test_engine_greedy_streams_match_jax(name, splitfuse):
    """Bucketed prefill (0) and split-fuse (16): the streams of both waves
    equal the JAX engine's; prefill / chunk and decode forwards ran."""
    _, want = _jax(name)
    eng = _port(name, splitfuse_tokens=splitfuse)
    _same(eng.generate_all(PROMPTS + WAVE2, max_new_tokens=NEW), want)
    fc = eng.forward_counts
    assert fc["decode"] > 0 and fc["chunk" if splitfuse else "prefill"] > 0
    assert eng.prefix_cache is None


def test_prefix_cache_streams_match_jax():
    """GPT-2 with the prefix cache: the second wave hits the first wave's
    blocks (a whole-block hit and a partial-tail copy-on-write) and every
    stream is still the JAX engine's."""
    _, want = _jax("gpt2")
    eng = _port("gpt2", splitfuse_tokens=16, prefix_cache=True)
    _same(eng.generate_all(PROMPTS, max_new_tokens=NEW), want[:3])
    _same(eng.generate_all(WAVE2, max_new_tokens=NEW), want[3:])
    stats = eng.prefix_cache.stats()
    assert stats["hits"] >= 2 and stats["cow_copies"] >= 1, stats


def test_draft_model_streams_match_jax():
    """A one-layer GPT-2 draft over the same vocabulary: the target
    verifies its proposals through ``apply_paged_verify`` and the greedy
    streams are the JAX engine's (plain decode)."""
    _, want = _jax("gpt2")
    draft = GPT2(dataclasses.replace(GPT2_TINY, dtype="float32", n_layer=1),
                 device="cpu", seed=3)
    eng = InferenceEngineV2(_pair("gpt2")[2],
                            dict(BASE, splitfuse_tokens=16, spec_k=3),
                            device="cpu", draft_model=draft)
    _same(eng.generate_all(PROMPTS + WAVE2, max_new_tokens=NEW), want)
    assert eng.forward_counts["verify"] > 0
    assert eng.draft_forward_counts["decode"] > 0


@pytest.mark.parametrize("name", ["gpt2", "gpt_neo"])
def test_kv_offload_streams_match_jax(name):
    """KV host offload with a device pool of 13 blocks (one 81-token
    sequence and scratch): the pool's block is the model's (H, BS, hd),
    blocks move both ways, the streams are the JAX engine's."""
    _, want = _jax(name)
    eng = _port(name, splitfuse_tokens=16, kv_host_offload=True,
                device_kv_blocks=13)
    cfg = eng.model.config
    assert eng.kv_pool._blk_shape == (cfg.n_head, 8, cfg.d_head)
    _same(eng.generate_all(PROMPTS + WAVE2, max_new_tokens=NEW), want)
    assert eng.kv_pool.swapped_in > 0 and eng.kv_pool.swapped_out > 0


@pytest.mark.parametrize("quant", [dict(weight_quant="int8"),
                                   dict(weight_quant="int4"),
                                   dict(quantize_weights=True)],
                         ids=["int8", "int4", "quantize_weights"])
def test_quantized_streams_match_jax(quant):
    """GPT-2 quantized by each engine from the same float weights: the
    fused path keeps ``wup`` / ``wdown`` quantized into K7 (the JAX
    ``wq_matmul`` in interpret mode, the port's plain version) and
    dequantizes ``wqkv`` a layer at a time; ``quantize_weights``
    dequantizes all three."""
    _, want = _jax("gpt2", **quant)
    model = pair("gpt2")[2]
    eng = InferenceEngineV2(model, dict(BASE, splitfuse_tokens=16, **quant),
                            device="cpu")
    assert set(model.qblocks) == {"wqkv", "wup", "wdown"}
    assert model._weight_quant_fused == ("weight_quant" in quant)
    _same(eng.generate_all(PROMPTS + WAVE2, max_new_tokens=NEW), want)


def _prefill_until_first_token(eng, prompt, uid):
    uid = eng.put(prompt, max_new_tokens=NEW, uid=uid)
    eng.hold_decode(uid)
    for _ in range(64):
        eng.step()
        seq = eng.state_mgr._seqs.get(uid)
        if seq is not None and seq.generated:
            return uid
    raise AssertionError("prefill never posted a first token")


def _decode_to_end(eng, uid):
    for _ in range(256):
        if eng.is_done(uid):
            return np.asarray(eng.get(uid))
        eng.step()
    raise AssertionError("decode never finished")


def test_kv_handoff_both_ways_and_layout_guard():
    """A port prefill hands its GPT-2 KV to the JAX engine, which decodes;
    a JAX prefill hands off to the port; both streams are one engine's.
    A GPT-2 payload into a Llama (GQA) cache raises in both packages."""
    jeng, want = _jax("gpt2")
    port = _port("gpt2", splitfuse_tokens=16)
    uid = _prefill_until_first_token(port, PROMPTS[2], 8001)
    payload = kv_transfer.export_sequence(port, uid)
    assert jkv.import_sequence(jeng, payload) == uid
    port.release_handoff(uid)
    np.testing.assert_array_equal(_decode_to_end(jeng, uid), want[2])

    uid = _prefill_until_first_token(jeng, PROMPTS[1], 8002)
    back = jkv.export_sequence(jeng, uid)
    assert kv_transfer.import_sequence(port, back) == uid
    jeng.release_handoff(uid)
    np.testing.assert_array_equal(_decode_to_end(port, uid), want[1])

    llama = InferenceEngineV2(
        Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
              device="cpu"), dict(BASE), device="cpu")
    with pytest.raises(KVWireError, match="layout mismatch"):
        kv_transfer.import_sequence(llama, payload)
    jm = JLlama(dataclasses.replace(J_LLAMA_TINY, dtype="float32"))
    jllama = JEngine(jm, params=jm.init(jax.random.key(0)),
                     config=dict(JAX_BASE))
    with pytest.raises(jkv.KVWireError, match="layout mismatch"):
        jkv.import_sequence(jllama, payload)


def test_prefix_cache_on_windowed_model_raises_as_jax():
    """GPT-Neo (per-layer windows): prefix_cache=True raises in both
    packages with the same message; "auto" resolves off."""
    jm, params, pm, _ = _pair("gpt_neo")
    with pytest.raises(ValueError, match="sliding-window model") as jerr:
        JEngine(jm, params=params, config=dict(JAX_BASE, prefix_cache=True))
    with pytest.raises(ValueError, match="sliding-window model") as perr:
        _port("gpt_neo", prefix_cache=True)
    assert str(perr.value) == str(jerr.value)
    assert _port("gpt_neo", prefix_cache="auto").prefix_cache is None


def test_gpt2_moe_is_refused():
    """GPT2MoE, which the engine refused before its paged programs were
    ported, now serves with both MoE backends (its streams are held to
    the JAX engine's in test_torch_gpt2_moe_engines.py): every request
    completes and prefill and decode forwards ran."""
    for backend in ("ragged", "dense"):
        cfg = GPT2MoEConfig(n_layer=1, n_head=2, d_model=32, max_seq_len=32,
                            vocab_size=64, num_experts=2, dtype="float32",
                            moe_backend=backend)
        eng = InferenceEngineV2(GPT2MoE(cfg, device="cpu"), dict(BASE),
                                device="cpu")
        outs = eng.generate_all([p[:5] % 64 for p in PROMPTS],
                                max_new_tokens=3)
        assert [len(o) for o in outs] == [3, 3, 3]
        assert eng.forward_counts["prefill"] > 0
        assert eng.forward_counts["decode"] > 0
