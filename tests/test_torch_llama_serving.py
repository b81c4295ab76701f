"""The port's Llama serving slice held against the JAX package on CPU:
parameter conversion, the paged prefill/chunk/decode programs (logits and
pools, fp32, within 1e-4), the v2 engine's greedy streams (identical to
the JAX InferenceEngineV2 with its Pallas paged kernels forced on, in
interpret mode), the decode write past a sequence's table, and the
sampler's own properties."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu_torch import InferenceEngineV2, Llama
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
NB, BS = 12, 8


def _pair(**over):
    """The same fp32 Llama in both packages (weights from a JAX seed)."""
    jcfg = dataclasses.replace(J_TINY, dtype="float32", **over)
    pcfg = dataclasses.replace(LLAMA_TINY, dtype="float32", **over)
    jm = JLlama(jcfg)
    jm._paged_kernel = True           # Pallas kernels, interpret mode
    jm._paged_block_c = 8
    params = jm.init(jax.random.key(0))
    pm = Llama(pcfg, device="cpu", dtype=torch.float32)
    pm.load_state_dict(llama_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    return jm, params, pm


def _caches(jm, pm):
    return (jm.init_paged_cache(NB, BS, dtype=jnp.float32),
            pm.init_paged_cache(NB, BS))


def _assert_pools(jc, pc):
    for name in ("k", "v"):
        for a, b in zip(jc[name], pc[name]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


class TestConvert:
    def test_round_trip(self):
        jm, params, pm = _pair()
        tree = jax.tree.map(np.asarray, params)
        sd = pm.state_dict()
        assert set(sd) == {"wte", "norm_f", "lm_head"} | {
            f"blocks.{k}" for k in tree["blocks"]}
        for k in ("wte", "norm_f", "lm_head"):
            np.testing.assert_array_equal(sd[k].numpy(), tree[k])
        for k, v in tree["blocks"].items():
            np.testing.assert_array_equal(sd[f"blocks.{k}"].numpy(), v)

    def test_unported_leaves_raise(self):
        tree = {"wte": np.zeros((4, 2)), "blocks": {"bq": np.zeros((1, 2))}}
        with pytest.raises(NotImplementedError):
            llama_params_from_numpy(tree, "cpu", torch.float32)

    def test_unported_knobs_raise(self):
        for over in (dict(alibi=True), dict(norm_type="ln"),
                     dict(parallel_block=True), dict(qkv_bias=True),
                     dict(embed_norm=True), dict(rotary_pct=0.5)):
            with pytest.raises(NotImplementedError):
                Llama(dataclasses.replace(LLAMA_TINY, **over), device="cpu")


@pytest.mark.parametrize("window", [0, 8])
def test_paged_programs_match_jax(window):
    """prefill (13 tokens) -> chunk (5 more, mid-block) -> decode (one
    live slot, one inactive): logits and every pool agree."""
    jm, params, pm = _pair(sliding_window=window)
    jc, pc = _caches(jm, pm)
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


def test_decode_write_past_table_goes_to_scratch():
    """A slot whose position is past its table (a sequence that finished
    mid-dispatch near max_seq_len keeps decoding) writes its K/V to
    scratch block 0: no other block changes, the logits stay finite and
    agree with JAX (which drops the out-of-range write)."""
    jm, params, pm = _pair()
    jc, pc = _caches(jm, pm)
    rs = np.random.RandomState(2)
    for name in ("k", "v"):
        for i in range(len(pc[name])):
            arr = rs.standard_normal(pc[name][i].shape).astype(np.float32)
            pc[name][i].copy_(torch.from_numpy(arr))
            jc[name][i] = jnp.asarray(arr)
    MB = 4
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lengths = np.array([MB * BS, MB * BS + 3], np.int32)   # past the table
    tokens = np.array([7, 9], np.int32)
    before = [t.clone() for t in pc["k"]]
    pl_, pc = pm.apply_paged_decode(torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), pc,
                                    torch.from_numpy(tables))
    for b, a in zip(before, pc["k"]):
        torch.testing.assert_close(a[1:], b[1:], rtol=0, atol=0)
        assert not torch.equal(a[0], b[0])
    assert torch.isfinite(pl_).all()
    jl, _ = jm.apply_paged_decode(params, jnp.asarray(tokens),
                                  jnp.asarray(lengths), jc,
                                  jnp.asarray(tables))
    np.testing.assert_allclose(pl_.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("splitfuse,window", [(16, 0), (0, 0), (16, 8)])
def test_engine_greedy_streams_match_jax(splitfuse, window):
    """Split-fuse on (chunks of 16 over 8-token blocks) and off
    (bucketed prefill), and a sliding window: the port's engine on CPU and
    the JAX engine with its Pallas kernels forced on give identical greedy
    streams."""
    jm, params, pm = _pair(sliding_window=window)
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


def test_engine_eos_matches_jax():
    """A request stops at its EOS token in both engines, identically."""
    jm, params, pm = _pair()
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32) for n in (9, 21)]
    base = dict(dtype="float32", kv_block_size=8, max_batch_size=4,
                splitfuse_tokens=16)
    free = InferenceEngineV2(pm, dict(base), device="cpu").generate_all(
        prompts, max_new_tokens=8)
    eos = int(free[0][2])
    got = InferenceEngineV2(pm, dict(base), device="cpu").generate_all(
        prompts, max_new_tokens=8, eos_token_id=eos)
    jeng = JEngine(jm, params=params,
                   config=dict(base, paged_kernel=True, paged_block_c=8,
                               prefix_cache=False, telemetry=False))
    want = jeng.generate_all(prompts, max_new_tokens=8, eos_token_id=eos)
    assert got[0][-1] == eos and len(got[0]) <= 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_engine_cancel_and_pool_accounting():
    """cancel() drops a queued request and flushes an in-flight one; every
    KV block returns to the pool once the engine drains."""
    pcfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    eng = InferenceEngineV2(Llama(pcfg, device="cpu"),
                            dict(dtype="float32", kv_block_size=8,
                                 max_batch_size=2, splitfuse_tokens=8),
                            device="cpu")
    total = eng.state_mgr.allocator.total_blocks
    uids = [eng.put(np.arange(n) + 1, 6) for n in (5, 12, 7)]
    eng.step()                                  # admits two, queues one
    assert not eng.is_done(uids[1])
    assert len(eng.get(uids[2], flush=False)) == 0
    assert eng.cancel(uids[2]) and eng.cancel(uids[1])
    assert not eng.cancel(12345)
    with pytest.raises(KeyError):
        eng.is_done(uids[1])
    while eng.has_work:
        eng.step()
    assert len(eng.get(uids[0])) == 6
    assert eng.state_mgr.allocator.free_blocks == total
    assert eng.state_mgr.n_active == 0


class TestSampler:
    sample = staticmethod(InferenceEngineV2._sample_per_slot)

    def _logits(self, B=4, V=64, seed=0):
        rs = np.random.RandomState(seed)
        return torch.from_numpy(rs.standard_normal((B, V)).astype(np.float32))

    def _gen(self, seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return g

    def test_top_k_one_is_greedy(self):
        x = self._logits()
        temps = torch.full((4,), 0.8)
        out = self.sample(x, self._gen(0), temps,
                          torch.ones(4, dtype=torch.int32))
        torch.testing.assert_close(out, x.argmax(-1).to(torch.int32))

    def test_samples_stay_in_top_k(self):
        x = self._logits(V=256)
        k = torch.tensor([1, 5, 40, 3], dtype=torch.int32)
        top = [set(x[i].topk(int(k[i])).indices.tolist()) for i in range(4)]
        g = self._gen(1)
        seen = [set() for _ in range(4)]
        for _ in range(50):
            out = self.sample(x, g, torch.full((4,), 1.5), k)
            for i in range(4):
                assert int(out[i]) in top[i]
                seen[i].add(int(out[i]))
        assert len(seen[2]) > 1            # it does sample

    def test_greedy_rows_and_ties(self):
        x = torch.zeros(2, 8)
        x[:, 3] = 1.0
        x[:, 6] = 1.0                       # tie: the first index wins
        out = self.sample(x, self._gen(0), torch.tensor([0.0, 0.0]),
                          torch.zeros(2, dtype=torch.int32))
        assert out.tolist() == [3, 3]

    def test_same_seed_same_stream(self):
        x = self._logits(V=128)
        temps = torch.full((4,), 1.0)
        k = torch.zeros(4, dtype=torch.int32)
        a = [self.sample(x, g, temps, k) for g in [self._gen(5)] * 6]
        b = [self.sample(x, g, temps, k) for g in [self._gen(5)] * 6]
        for u, v in zip(a, b):
            torch.testing.assert_close(u, v)

    def test_engine_sampled_streams_repeat_with_seed(self):
        pcfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
        prompts = [np.arange(5) + 3, np.arange(11) + 7]

        def run(seed):
            eng = InferenceEngineV2(
                Llama(pcfg, device="cpu"),
                dict(dtype="float32", kv_block_size=8, max_batch_size=2,
                     splitfuse_tokens=8, temperature=0.8, top_k=40,
                     seed=seed), device="cpu")
            return eng.generate_all(prompts, max_new_tokens=5)

        for a, b in zip(run(3), run(3)):
            np.testing.assert_array_equal(a, b)
