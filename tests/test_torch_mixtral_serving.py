"""The port's Mixtral serving slice held against the JAX package on CPU:
the parameter count and conversion, ``_mlp`` per layer against the JAX
``Mixtral._mlp`` with its grouped Pallas kernels (interpret mode) and with
``lax.ragged_dot``, the paged prefill/chunk/decode programs (logits and
pools, fp32, within 1e-4) and the v2 engine's greedy streams (identical to
the JAX InferenceEngineV2 with its paged Pallas kernels forced on,
split-fuse on and off)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.mixtral import MIXTRAL_8X7B as J_8X7B
from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as J_TINY
from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu.runtime.config import MoEConfig
from deepspeed_tpu_torch import InferenceEngineV2, Mixtral
from deepspeed_tpu_torch.models import (MIXTRAL_8X7B, MIXTRAL_TINY,
                                        mixtral_params_from_numpy)

TOL = dict(rtol=1e-4, atol=1e-4)
NB, BS = 12, 8


def _pair(grouped=True, **over):
    """The same fp32 Mixtral in both packages (weights from a JAX seed);
    the JAX model's grouped FFN is the Pallas kernel (interpret mode) when
    ``grouped``, else ``lax.ragged_dot``."""
    jcfg = dataclasses.replace(J_TINY, dtype="float32", **over)
    pcfg = dataclasses.replace(MIXTRAL_TINY, dtype="float32", **over)
    jm = JMixtral(jcfg)
    jm._paged_kernel = True           # Pallas kernels, interpret mode
    jm._paged_block_c = 8
    jm._moe_cfg = MoEConfig(grouped_kernel=grouped)
    params = jm.init(jax.random.key(0))
    pm = Mixtral(pcfg, device="cpu", dtype=torch.float32)
    pm.load_state_dict(mixtral_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    pm.grouped_kernel = grouped
    return jm, params, pm


def test_param_count():
    pm = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"),
                 device="cpu")
    assert MIXTRAL_TINY.num_params() == J_TINY.num_params()
    assert sum(p.numel() for p in pm.parameters()) == \
        MIXTRAL_TINY.num_params()
    assert MIXTRAL_8X7B.num_params() == J_8X7B.num_params()
    # the router stays fp32 at init, as in the JAX init
    assert pm.blocks["moe_gate"].dtype == torch.float32


class TestConvert:
    def test_round_trip(self):
        jm, params, pm = _pair()
        tree = jax.tree.map(np.asarray, params)
        sd = pm.state_dict()
        assert set(sd) == {"wte", "norm_f", "lm_head"} | {
            f"blocks.{k}" for k in tree["blocks"]}
        assert not {"blocks.wgate", "blocks.wup", "blocks.wdown"} & set(sd)
        for k in ("wte", "norm_f", "lm_head"):
            np.testing.assert_array_equal(sd[k].numpy(), tree[k])
        for k, v in tree["blocks"].items():
            assert sd[f"blocks.{k}"].shape == v.shape
            np.testing.assert_array_equal(sd[f"blocks.{k}"].numpy(), v)

    def test_unported_leaves_raise(self):
        tree = {"wte": np.zeros((4, 2)), "blocks": {"wgate": np.zeros((1,))}}
        with pytest.raises(NotImplementedError):
            mixtral_params_from_numpy(tree, "cpu", torch.float32)

        class Int8Weight:             # an int8 expert leaf (q + scale)
            q = np.zeros((1, 2, 2, 2), np.int8)
            scale = np.ones((1, 2, 1, 2), np.float32)

        class Quantized(Int8Weight):  # an unknown quantized node
            pass

        tree = {"wte": np.zeros((4, 2)), "blocks": {"moe_w1": Quantized()}}
        with pytest.raises(NotImplementedError, match="K9"):
            mixtral_params_from_numpy(tree, "cpu", torch.float32)
        # the JAX node carries across quantized (weight_quant, K9)
        tree["blocks"]["moe_w1"] = Int8Weight()
        w = mixtral_params_from_numpy(tree, "cpu", torch.float32)[
            "blocks.moe_w1"]
        assert w.q.dtype == torch.int8 and w.scale.dtype == torch.float32

    def test_unported_knobs_raise(self):
        for over in (dict(alibi=True), dict(norm_type="ln"),
                     dict(qkv_bias=True)):
            with pytest.raises(NotImplementedError):
                Mixtral(dataclasses.replace(MIXTRAL_TINY, **over),
                        device="cpu")
        with pytest.raises(ValueError, match="SwiGLU"):
            Mixtral(dataclasses.replace(MIXTRAL_TINY, mlp_gated=False),
                    device="cpu")
        with pytest.raises(ValueError, match="moe_top_k"):
            Mixtral(dataclasses.replace(MIXTRAL_TINY, moe_top_k=5),
                    device="cpu")
        pm = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"),
                     device="cpu")
        pm.grouped_kernel = "yes"
        with pytest.raises(ValueError, match="grouped_kernel"):
            pm._mlp(torch.zeros(1, 3, 128), 0)


@pytest.mark.parametrize("grouped", [True, False])
def test_mlp_matches_jax(grouped):
    """Each layer's MoE FFN on the same activations: routing, the sort,
    the grouped SwiGLU (JAX: Pallas interpret or ragged_dot; the port:
    the kernel's plain version or the ragged math) and the combine."""
    jm, params, pm = _pair(grouped=grouped)
    x = np.random.RandomState(1).standard_normal((2, 13, 128)).astype(
        np.float32)
    for i in range(MIXTRAL_TINY.n_layer):
        layer = jax.tree.map(lambda a: a[i], params["blocks"])
        want = np.asarray(jm._mlp(jnp.asarray(x), layer))
        got = pm._mlp(torch.from_numpy(x), i).detach().numpy()
        np.testing.assert_allclose(got, want, **TOL)


def _assert_pools(jc, pc):
    for name in ("k", "v"):
        for a, b in zip(jc[name], pc[name]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_paged_programs_match_jax():
    """prefill (13 tokens) -> chunk (5 more, mid-block) -> decode (one
    live slot, one inactive): logits and every pool agree."""
    jm, params, pm = _pair()
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
    jl, jc = jm.apply_paged_prefill(params, jnp.asarray(ids), jc,
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
        params, jnp.asarray(ids), jc, jnp.asarray(tb), jnp.asarray(to),
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
    jl, jc = jm.apply_paged_decode(params, jnp.asarray(tokens),
                                   jnp.asarray(lengths), jc,
                                   jnp.asarray(tables))
    pl_, pc = pm.apply_paged_decode(torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), pc,
                                    torch.from_numpy(tables))
    np.testing.assert_allclose(pl_[0].numpy(), np.asarray(jl)[0], **TOL)
    _assert_pools(jc, pc)


@pytest.mark.parametrize("splitfuse", [16, 0])
def test_engine_greedy_streams_match_jax(splitfuse):
    """Split-fuse on (chunks of 16 over 8-token blocks) and off (bucketed
    prefill): the port's engine on CPU (the kernels' plain versions) and
    the JAX engine with its paged Pallas kernels forced on give identical
    greedy streams. The JAX expert FFN runs ``lax.ragged_dot`` here (its
    grouped Pallas kernels in interpret mode are held per layer and per
    program above; inside every jitted engine program they would triple
    this test's time)."""
    jm, params, pm = _pair(grouped=False)
    pm.grouped_kernel = "auto"
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 16, 37)]
    base = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
                max_batch_size=4, splitfuse_tokens=splitfuse)
    jeng = JEngine(jm, params=params,
                   config=dict(base, paged_kernel=True, paged_block_c=8,
                               prefix_cache=False, telemetry=False))
    want = jeng.generate_all(prompts, max_new_tokens=6)
    peng = InferenceEngineV2(pm, dict(base, paged_kernel=True), device="cpu")
    got = peng.generate_all(prompts, max_new_tokens=6)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    n_chunks = sum(-(-len(p) // 16) for p in prompts) if splitfuse else 0
    assert peng.forward_counts["chunk"] == n_chunks
    assert peng.forward_counts["prefill"] == (0 if splitfuse else 3)


def test_engine_casts_the_router_like_the_jax_engine():
    """The engine casts every floating parameter to its dtype, the router
    included (the JAX engine's shard_params does the same); routing then
    multiplies the cast router in fp32."""
    pm = Mixtral(MIXTRAL_TINY, device="cpu")
    assert pm.blocks["moe_gate"].dtype == torch.float32
    eng = InferenceEngineV2(pm, dict(dtype="bfloat16", kv_block_size=8,
                                     max_batch_size=2), device="cpu")
    assert eng.model.blocks["moe_gate"].dtype == torch.bfloat16
    out = eng.generate_all([np.arange(7)], max_new_tokens=3)
    assert len(out[0]) == 3
