"""A rank's slice of a model for multi-rank serving
(``deepspeed_tpu_torch/inference/utils.py``), held against the JAX
package's placement: each leaf put on a CPU mesh under the JAX model's
``partition_specs`` (quantized leaves under ``quantized_shardings``), the
device of rank r's shard read back; the port's ``shard_leaf`` on rank r
must give the same array, bitwise. GPT-2's fused ``wqkv`` / ``bqkv`` are
split per head instead (the JAX placement's contiguous third hands rank 0
all of q). Also: K4's plain version with a head offset (a tensor-parallel
Bloom rank's heads) against the whole-head rows, the ``tensor`` axis of
``utils/groups.py`` against the JAX mesh, and the refusals (heads or
experts that do not divide, int4 rows, GPT2MoE, a multi-rank replica, a
tensor-parallel engine without a world)."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.models.bloom import BLOOM_TINY as J_BLOOM_TINY
from deepspeed_tpu.models.bloom import Bloom as JBloom
from deepspeed_tpu.models.gpt2 import GPT2 as JGPT2
from deepspeed_tpu.models.gpt2 import GPT2_TINY as J_GPT2_TINY
from deepspeed_tpu.models.llama import LLAMA_TINY as J_LLAMA_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as J_MIXTRAL_TINY
from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
from deepspeed_tpu.models.qwen import QWEN_TINY as J_QWEN_TINY
from deepspeed_tpu.models.qwen import Qwen as JQwen
from deepspeed_tpu.ops import int8_weights as jq
from deepspeed_tpu.ops.pallas import paged_attention as jpa
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch import InferenceEngineV2, Replica
from deepspeed_tpu_torch.inference.utils import shard_leaf, shard_model
from deepspeed_tpu_torch.models import (BLOOM_PRESETS, FALCON_PRESETS, GPT2,
                                        GPT2_TINY, LLAMA_TINY, MIXTRAL_TINY,
                                        QWEN_PRESETS, Bloom, Falcon, GPT2MoE,
                                        GPT2MoEConfig, Llama, Mixtral, Qwen)
from deepspeed_tpu_torch.ops import int8_weights as tq
from deepspeed_tpu_torch.ops.cuda import paged_attention as tpa
from deepspeed_tpu_torch.utils import groups
from test_torch_families import randomize
from test_torch_gpt2_paged import randomize as gpt2_randomize


def _topo(world, rank, **cfg):
    return groups.ParallelTopology(groups.TopologyConfig(**cfg),
                                   world_size=world, rank=rank)


def _jmesh(n, **cfg):
    return jgroups.ParallelTopology(jgroups.TopologyConfig(**cfg),
                                    devices=jax.devices()[:n]).mesh


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not isinstance(v, P):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _jax_shard(x, spec, mesh, rank):
    """Rank ``rank``'s shard of ``x`` as the JAX placement lays it."""
    a = jax.device_put(x, NamedSharding(mesh, spec))
    dev = mesh.devices.reshape(-1)[rank]
    return next(np.asarray(s.data) for s in a.addressable_shards
                if s.device == dev)


MODELS = {
    "llama": (JLlama, J_LLAMA_TINY, Llama, LLAMA_TINY),
    "qwen": (JQwen, J_QWEN_TINY, Qwen, QWEN_PRESETS["tiny"]),
    "bloom": (JBloom, J_BLOOM_TINY, Bloom, BLOOM_PRESETS["tiny"]),
    "mixtral": (JMixtral, J_MIXTRAL_TINY, Mixtral, MIXTRAL_TINY),
}
TP2, TP4 = dict(tensor_parallel_size=2), dict(tensor_parallel_size=4)
EP2 = dict(expert_parallel_size=2)
SLICES = [("llama", TP2), ("qwen", TP2), ("bloom", TP2), ("bloom", TP4),
          ("mixtral", TP2), ("mixtral", EP2),
          ("mixtral", dict(TP2, **EP2))]


@pytest.mark.parametrize("name,cfg", SLICES,
                         ids=[f"{n}-" + "-".join(f"{k[0]}{v}" for k, v in
                                                 c.items())
                              for n, c in SLICES])
def test_float_slices_equal_jax_placement(name, cfg):
    """Every leaf (biases and norms random): the port's slice on rank r
    (the port's specs) equals the JAX shard on device r (the JAX specs),
    bitwise."""
    jcls, jcfg, tcls, tcfg = MODELS[name]
    n = int(np.prod(list(cfg.values())))
    jm = jcls(dataclasses.replace(jcfg, dtype="float32"))
    tree = _flat(randomize(jax.tree.map(np.asarray,
                                        jm.init(jax.random.key(0)))))
    mesh = _jmesh(n, **cfg)
    jspecs = _flat(jm.partition_specs(jgroups.ParallelTopology(
        jgroups.TopologyConfig(**cfg), devices=jax.devices()[:n])))
    tm = tcls(dataclasses.replace(tcfg, dtype="float32"), device="cpu")
    tspecs = tm.partition_specs(_topo(n, 0, **cfg))
    assert set(tspecs) == set(jspecs)
    for r in range(n):
        topo = _topo(n, r, **cfg)
        for k, x in tree.items():
            want = _jax_shard(x, jspecs[k], mesh, r)
            got = shard_leaf(torch.from_numpy(np.array(x)), tspecs[k], topo,
                             name=k)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)


@pytest.mark.parametrize("tp", [2, 4])
def test_gpt2_fused_qkv_split_per_head(tp):
    """wqkv (L, D, 3D) and bqkv (L, 3D): rank r keeps heads r H / tp ...
    of q, of k and of v; the other leaves are the JAX placement's."""
    jm = JGPT2(dataclasses.replace(J_GPT2_TINY, dtype="float32"))
    tree = _flat(gpt2_randomize(jax.tree.map(np.asarray,
                                             jm.init(jax.random.key(0)))))
    cfg = dict(tensor_parallel_size=tp)
    mesh = _jmesh(tp, **cfg)
    jspecs = _flat(jm.partition_specs(None))
    tm = GPT2(dataclasses.replace(GPT2_TINY, dtype="float32"), device="cpu")
    tspecs = tm.partition_specs()
    H, hd = J_GPT2_TINY.n_head, J_GPT2_TINY.d_model // J_GPT2_TINY.n_head
    for r in range(tp):
        topo = _topo(tp, r, **cfg)
        for k, x in tree.items():
            leaf = k.rsplit(".", 1)[-1]
            got = shard_leaf(torch.from_numpy(np.array(x)), tspecs[k], topo,
                             tm._FUSED_SECTIONS.get(leaf, 1), k).numpy()
            if leaf in ("wqkv", "bqkv"):
                heads = x.reshape(*x.shape[:-1], 3, H, hd)
                want = heads[..., r * H // tp:(r + 1) * H // tp, :].reshape(
                    *x.shape[:-1], -1)
                np.testing.assert_array_equal(got, want, err_msg=k)
                if r == 0:       # the JAX placement's third is not it
                    assert not np.array_equal(
                        got, _jax_shard(x, jspecs[k], mesh, r))
            else:
                np.testing.assert_array_equal(
                    got, _jax_shard(x, jspecs[k], mesh, r), err_msg=k)


@pytest.mark.parametrize("bits,tp", [(8, 2), (4, 2), (8, 4), (4, 4)])
def test_quantized_slices_equal_jax_placement(bits, tp):
    """A Llama at d 256, F 512 quantized whole (the JAX ``quantize_tree``
    and the port's ``quantize_tensor``, bitwise the same), then sliced:
    codes and scales on rank r equal the JAX ``quantized_shardings``
    placement on device r (a row-parallel shard keeps the global scale),
    and are the whole quantization sliced."""
    over = dict(dtype="float32", d_model=256, d_ff=512)
    jm = JLlama(dataclasses.replace(J_LLAMA_TINY, **over))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    qtree = jq.quantize_tree(params, bits=bits)
    cfg = dict(tensor_parallel_size=tp)
    mesh = _jmesh(tp, **cfg)
    jspecs = jm.partition_specs(None)
    shards = jq.quantized_shardings(jspecs, qtree, mesh)
    tm = Llama(dataclasses.replace(LLAMA_TINY, **over), device="cpu")
    tspecs = tm.partition_specs()
    quantized = [k for k, v in qtree["blocks"].items() if jq._is_q(v)]
    assert {"wq", "wk", "wv", "wo", "wgate", "wup", "wdown"} <= \
        set(quantized)
    for k in quantized:
        jw = qtree["blocks"][k]
        tw = tq.quantize_tensor(torch.from_numpy(np.array(params["blocks"][k])),
                               bits)
        assert np.array_equal(tw.q.numpy(), np.asarray(jw.q))
        for r in range(tp):
            got = shard_leaf(tw, tspecs[f"blocks.{k}"], _topo(tp, r, **cfg),
                             name=k)
            sh = shards["blocks"][k]
            for part in ("q", "scale"):
                want = _jax_shard(np.asarray(getattr(jw, part)),
                                  getattr(sh, part).spec, mesh, r)
                np.testing.assert_array_equal(
                    getattr(got, part).numpy(), want, err_msg=(k, part))
            assert type(got) is type(tw)


def test_int4_row_slice_needs_even_rows():
    """int4 packs two rows a byte: a row slice of an odd row count
    raises, as does a dim that does not divide."""
    w = tq.quantize_leaf(torch.randn(4, 6, 8), bits=4)
    assert isinstance(w, tq.Int4Weight)
    with pytest.raises(ValueError, match="even"):
        tq.quantized_slice(w, 1, 2, 0)            # 3 rows a slice
    with pytest.raises(ValueError, match="divide"):
        tq.quantized_slice(w, 2, 3, 0)
    half = tq.quantized_slice(w, 2, 2, 1)
    assert torch.equal(half.codes(), w.codes()[..., 4:])


def test_heads_and_experts_must_divide():
    """Falcon-7b's single KV head at tp = 2, Qwen's 2 KV heads at tp = 4,
    3 experts over ep = 2: ValueError, as the JAX placement refuses."""
    falcon = Falcon(dataclasses.replace(FALCON_PRESETS["tiny"],
                                        dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="n_kv_heads=1"):
        shard_model(falcon, _topo(2, 0, tensor_parallel_size=2))
    qwen = Qwen(dataclasses.replace(QWEN_PRESETS["tiny"], dtype="float32"),
                device="cpu")
    with pytest.raises(ValueError, match="n_kv_heads=2"):
        shard_model(qwen, _topo(4, 0, tensor_parallel_size=4))
    mix = Mixtral(dataclasses.replace(MIXTRAL_TINY, num_experts=3,
                                      dtype="float32"), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        shard_model(mix, _topo(2, 0, expert_parallel_size=2))


def test_gpt2moe_and_replicas_refuse_multi_rank():
    """GPT2MoE on a multi-rank world and a replica around a multi-rank
    engine raise, naming their ROADMAP items."""
    gm = GPT2MoE(GPT2MoEConfig(n_layer=1, n_head=2, d_model=32,
                               max_seq_len=32, vocab_size=64, num_experts=2,
                               dtype="float32"), device="cpu")
    with pytest.raises(NotImplementedError, match="GPT2MoE across ranks"):
        shard_model(gm, _topo(2, 0, tensor_parallel_size=2))
    with pytest.raises(NotImplementedError, match="multi-rank replicas"):
        Replica("r0", types.SimpleNamespace(multi_rank=True))


def test_tensor_parallel_engine_needs_a_world():
    """tensor_parallel = 2 in a process that joined no world: the
    topology cannot lay out two ranks; a non-positive size is refused."""
    model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                  device="cpu")
    groups.reset()
    with pytest.raises(ValueError, match="world size 1"):
        InferenceEngineV2(model, dict(dtype="float32", tensor_parallel=2),
                          device="cpu")
    groups.reset()
    with pytest.raises(ValueError, match="expert_parallel"):
        InferenceEngineV2(model, dict(dtype="float32", expert_parallel=0),
                          device="cpu")


@pytest.mark.parametrize("H,tp", [(12, 2), (12, 4), (8, 2), (6, 3)])
def test_k4_plain_head_offset_equals_whole_heads(H, tp):
    """K4's plain versions (the dense gather and the split arithmetic) on
    rank r's heads with ``alibi_offset`` = r H / tp and ``alibi_heads`` =
    H equal the whole-head call's rows (12 heads: the power-of-two count
    8 and the interleaved rest); the whole call equals the JAX kernel in
    interpret mode; slopes of another head range raise."""
    rs = np.random.RandomState(H + tp)
    B, KVH, d, NB, BS, MB = 3, H, 32, 9, 8, 4
    q = torch.from_numpy(rs.standard_normal((B, H, d)).astype(np.float32))
    k = torch.from_numpy(rs.standard_normal((NB, KVH, BS, d))
                         .astype(np.float32))
    v = torch.from_numpy(rs.standard_normal((NB, KVH, BS, d))
                         .astype(np.float32))
    tables = torch.from_numpy(rs.randint(1, NB, (B, MB)).astype(np.int32))
    lengths = torch.tensor([5, 17, 30], dtype=torch.int32)
    slopes = tpa.alibi_slopes(H)
    whole = tpa.paged_decode_attention(q, k, v, tables, lengths,
                                       alibi_slopes=slopes)
    jw = np.asarray(jpa.paged_decode_attention(
        *(jax.numpy.asarray(t.numpy()) for t in (q, k, v, tables, lengths)),
        alibi_slopes=slopes, interpret=True))
    np.testing.assert_allclose(whole.numpy(), jw, rtol=1e-5, atol=1e-5)
    Hl = H // tp
    for r in range(tp):
        hs = slice(r * Hl, (r + 1) * Hl)
        kw = dict(alibi_slopes=slopes[hs], alibi_offset=r * Hl,
                  alibi_heads=H)
        part = tpa.paged_decode_attention(
            q[:, hs].contiguous(), k[:, hs].contiguous(),
            v[:, hs].contiguous(), tables, lengths, **kw)
        np.testing.assert_allclose(part.numpy(), whole[:, hs].numpy(),
                                   rtol=1e-6, atol=1e-6)
        split = tpa.paged_decode_split_reference(
            q[:, hs].contiguous(), k[:, hs].contiguous(),
            v[:, hs].contiguous(), tables, lengths, splits=(2, 2), **kw)
        np.testing.assert_allclose(split.numpy(), whole[:, hs].numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError):
        tpa.paged_decode_attention(
            q[:, :Hl].contiguous(), k[:, :Hl].contiguous(),
            v[:, :Hl].contiguous(), tables, lengths,
            alibi_slopes=tpa.alibi_slopes(Hl), alibi_offset=Hl,
            alibi_heads=H)
    with pytest.raises(ValueError, match="heads"):
        tpa.paged_decode_attention(
            q, k, v, tables, lengths, alibi_slopes=slopes, alibi_offset=1,
            alibi_heads=H)


@pytest.mark.parametrize("cfg", [
    dict(tensor_parallel_size=2), dict(tensor_parallel_size=4),
    dict(tensor_parallel_size=8),
    dict(tensor_parallel_size=2, expert_parallel_size=2),
    dict(tensor_parallel_size=2, seq_parallel_size=2),
    dict(tensor_parallel_size=2, zero_shard_size=2)])
def test_tensor_axis_layout_matches_jax_mesh(cfg):
    """Rank r sits where device r sits in the JAX mesh (``tensor``
    innermost): the same shape, axis sizes and indices for every rank of
    an 8-rank world, the tensor group consecutive ranks."""
    jt = jgroups.ParallelTopology(jgroups.TopologyConfig(**cfg),
                                  devices=jax.devices()[:8])
    ids = np.vectorize(lambda dv: dv.id)(jt.mesh.devices)
    for rank in range(8):
        t = _topo(8, rank, **cfg)
        assert t.shape == ids.shape
        pos = dict(zip(groups.MESH_AXES,
                       (int(i) for i in np.argwhere(ids == rank)[0])))
        for axis in groups.MESH_AXES:
            assert t.axis_size(axis) == jt.axis_size(axis)
            assert t.axis_index(axis) == pos[axis]
        assert t.get_model_parallel_world_size() == \
            jt.get_model_parallel_world_size()
        tp = cfg["tensor_parallel_size"]
        assert t.group_ranks("tensor") == list(
            range(rank // tp * tp, rank // tp * tp + tp))
