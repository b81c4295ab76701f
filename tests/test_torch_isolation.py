"""The port stands alone: no module of deepspeed_tpu_torch (nor
chip_smoke.py) imports jax or the JAX package, the port imports and
serves with both made unimportable, and its entry points refuse to fall
back to the CPU on their own. Also the op builder's hygiene: a stable
content hash and output path, and a clear error (never a stub library)
without nvcc or on a failed build."""

import dataclasses
import os
import re
import subprocess
import sys
import types

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import (GPT2, GPT2Config, GPT2MoE, GPT2MoEConfig,
                                 InferenceEngineV2, Llama, Mixtral)
from deepspeed_tpu_torch.models import LLAMA_TINY, MIXTRAL_TINY
from deepspeed_tpu_torch.op_builder import builder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "deepspeed_tpu_torch")

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|deepspeed_tpu)\b(?!_)"
    r"|from\s+(jax|jaxlib|deepspeed_tpu)\b(?!_))", re.M)


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_static_scan_no_jax_imports():
    srcs = _port_sources()
    assert len(srcs) > 10
    # the seven Llama-family modules and the two GPT-2 families are scanned
    # with the rest
    for fam in ("bloom", "falcon", "gpt_neox", "gptj", "internlm", "phi",
                "qwen", "opt", "gpt_neo"):
        assert os.path.join(PKG, "models", f"{fam}.py") in srcs, fam
    # so are the autotune winner cache and the dispatch layer
    for mod in ("__init__", "kernel_cache", "kernel_dispatch",
                "kernel_autotuner", "kernel_registry"):
        assert os.path.join(PKG, "autotuning", f"{mod}.py") in srcs, mod
    assert os.path.join(PKG, "ops", "cuda", "_common.py") in srcs
    bad = []
    for path in srcs:
        with open(path) as f:
            text = f.read()
        bad += [f"{path}: {m.group(0).strip()}"
                for m in _FORBIDDEN.finditer(text)]
        bad += [f"{path}: deepspeed_tpu. reference"
                for _ in re.finditer(r"\bdeepspeed_tpu\.", text)]
    assert not bad, bad


_BLOCKED_RUN = r"""
import os, sys, importlib.abc
ROOTS = ("jax", "jaxlib", "deepspeed_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in ROOTS:
        del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ROOTS:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import dataclasses
import numpy as np
import torch
from deepspeed_tpu_torch import (GPT2, GPT2Config, GPT2MoE, GPT2MoEConfig,
                                 InferenceEngineV2, Llama, Mixtral,
                                 initialize)
from deepspeed_tpu_torch.models import LLAMA_TINY, MIXTRAL_TINY
for model in (Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                    device="cpu"),
              Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"),
                      device="cpu")):
    for quant in ({}, dict(weight_quant="int4"),
                  dict(quantize_weights=True)):
        eng = InferenceEngineV2(model, dict(dtype="float32", kv_block_size=8,
                                            max_batch_size=2,
                                            splitfuse_tokens=8, **quant),
                                device="cpu")
        out = eng.generate_all([np.arange(5), np.arange(12)],
                               max_new_tokens=3)
        assert [len(o) for o in out] == [3, 3]
        model = type(model)(model.config, device="cpu")
import deepspeed_tpu_torch as dst
for fam, preset in (("Bloom", "BLOOM_PRESETS"), ("Falcon", "FALCON_PRESETS"),
                    ("GPTNeoX", "GPTNEOX_PRESETS"), ("GPTJ", "GPTJ_PRESETS"),
                    ("InternLM", "INTERNLM_PRESETS"), ("Phi", "PHI_PRESETS"),
                    ("Qwen", "QWEN_PRESETS")):
    cfg = dataclasses.replace(getattr(dst, preset)["tiny"], dtype="float32")
    fmodel = getattr(dst, fam)(cfg, device="cpu")
    loss = fmodel.loss({"input_ids": np.arange(16)[None] % 512})
    loss.backward()
    assert np.isfinite(float(loss))
    out = InferenceEngineV2(fmodel, dict(dtype="float32", kv_block_size=8,
                                         max_batch_size=2,
                                         splitfuse_tokens=8),
                            device="cpu").generate_all([np.arange(9)],
                                                       max_new_tokens=2)
    assert [len(o) for o in out] == [2], fam
for fam, preset in (("GPT2", "GPT2_PRESETS"), ("OPT", "OPT_PRESETS"),
                    ("GPTNeo", "GPTNEO_PRESETS")):
    cfg = dataclasses.replace(getattr(dst, preset)["tiny"], dtype="float32")
    for quant in ({}, dict(weight_quant="int4")):
        fmodel = getattr(dst, fam)(cfg, device="cpu")
        out = InferenceEngineV2(fmodel, dict(dtype="float32", kv_block_size=8,
                                             max_batch_size=2,
                                             splitfuse_tokens=8, **quant),
                                device="cpu").generate_all(
                                    [np.arange(9), np.arange(70)],
                                    max_new_tokens=2)
        assert [len(o) for o in out] == [2, 2], fam
gcfg = GPT2Config(n_layer=2, n_head=2, d_model=64, max_seq_len=32,
                  vocab_size=128, dtype="float32", use_flash_attention=True,
                  remat=True, remat_policy="save_flash", loss_chunk=8,
                  fused_loss=True, fused_loss_kernel=True)
trainer, *_ = initialize(model=GPT2(gcfg, device="cpu"), device="cpu",
                         config={"train_batch_size": 2, "optimizer": {
                             "type": "AdamW", "params": {"lr": 1e-3}}})
ids = np.random.RandomState(0).randint(0, 128, (2, 32))
losses = [float(trainer.train_batch({"input_ids": ids})) for _ in range(2)]
assert losses[1] < losses[0], losses
kcfg = GPT2Config(**{**gcfg.__dict__, "d_model": 128,
                      "fused_layernorm": True, "mlp_kernel": "both"})
trainer, *_ = initialize(model=GPT2(kcfg, device="cpu"), device="cpu",
                         config={"train_batch_size": 2, "optimizer": {
                             "type": "AdamW", "params": {"lr": 1e-3}}})
losses = [float(trainer.train_batch({"input_ids": ids})) for _ in range(2)]
assert losses[1] < losses[0], losses
mcfg = GPT2MoEConfig(**{**gcfg.__dict__, "num_experts": 4, "moe_top_k": 2,
                        "moe_backend": "ragged"})
trainer, *_ = initialize(model=GPT2MoE(mcfg, device="cpu"), device="cpu",
                         config={"train_batch_size": 2, "optimizer": {
                             "type": "AdamW", "params": {"lr": 1e-3}},
                             "moe": {"grouped_kernel": True}})
losses = [float(trainer.train_batch({"input_ids": ids})) for _ in range(2)]
assert losses[1] < losses[0], losses
qcfg = GPT2Config(**{**gcfg.__dict__, "flash_bwd_qmajor": True})
trainer, *_ = initialize(model=GPT2(qcfg, device="cpu"), device="cpu",
                         config={"train_batch_size": 2, "optimizer": {
                             "type": "AdamW", "params": {"lr": 1e-3}}})
losses = [float(trainer.train_batch({"input_ids": ids})) for _ in range(2)]
assert losses[1] < losses[0], losses
from deepspeed_tpu_torch.ops.sparse_attention import (
    BigBirdSparsityConfig, SparseSelfAttention)
op = SparseSelfAttention(BigBirdSparsityConfig(num_heads=2, block=16))
q = torch.randn(1, 64, 2, 32, requires_grad=True)
out = op(q, q, q)
out.square().sum().backward()
assert out.shape == q.shape and torch.isfinite(q.grad).all()
import json, tempfile
from deepspeed_tpu_torch.autotuning import (kernel_autotuner,
                                            kernel_dispatch, kernel_registry)
from deepspeed_tpu_torch.ops.cuda import _common
path = os.path.join(tempfile.mkdtemp(), "winners.json")
kernel_dispatch.configure(mode="on_first_use", cache_path=path,
                          chain_lengths=(1, 2), reps=1)
win = _common.dispatch("layernorm", _common.ln_bucket(16, 128), "float32",
                       kernel_registry.LN_DEFAULTS, device="cpu")
assert set(win) == {"variant"}, win
assert "torch-cpu|layernorm|R16,D128|float32" in json.load(open(path))[
    "entries"]
kernel_dispatch.reset()
assert not any(n.split(".")[0] in ROOTS for n in sys.modules)
print("ISOLATED_OK")
"""


def _child_env():
    """The child's environment: the repo on the path, and one intra-op
    thread (the tiny shapes gain nothing from a pool, and a pool a core in
    the child beside every test worker's oversubscribes the host)."""
    return dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def test_port_runs_with_jax_unimportable():
    env = _child_env()
    res = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED_OK" in res.stdout


def test_quantized_weights_off_the_cpu_take_the_kernel(monkeypatch,
                                                      tmp_path):
    """A tensor off the CPU with quantized weights goes to the K7 / K9
    kernels and never to their plain versions: here, with no nvcc, the
    build raises."""
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.ops import int8_weights as iw
    from deepspeed_tpu_torch.ops.cuda import grouped_matmul as gm
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    monkeypatch.setattr(builder, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(builder, "find_nvcc", lambda: None)
    monkeypatch.setattr(mm, "_builder", None)
    monkeypatch.setattr(gm, "_builder", None)

    def plain(*a, **k):
        raise AssertionError("a tensor off the CPU took a plain version")

    monkeypatch.setattr(mm, "_plain_rows", plain)
    for name in ("grouped_matmul_wq_reference",
                 "grouped_swiglu_up_wq_reference"):
        monkeypatch.setattr(gm, name, plain)
    x = torch.ones(6, 32, device="meta")
    w = iw.quantize_leaf(torch.ones(32, 64, device="meta"), 4)
    ws = [iw.quantize_leaf(torch.ones(s, device="meta"), 8)
          for s in ((2, 32, 64), (2, 32, 64), (2, 64, 32))]
    gs = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mm.wq_matmul(x, w)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gm.grouped_swiglu_wq(x, *ws, gs)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        sharded_moe._grouped_swiglu_ffn(x, *ws, gs, {"backend": "kernel"})
    assert os.listdir(tmp_path) == []


def test_training_kernels_off_the_cpu_take_the_kernel(monkeypatch,
                                                     tmp_path):
    """A tensor off the CPU goes to the K13 LayerNorm and K6 projection
    kernels, forward and backward, and never to their plain versions:
    here, with no nvcc, each build raises."""
    from deepspeed_tpu_torch.ops.cuda import layernorm as ln
    from deepspeed_tpu_torch.ops.cuda import mlp_matmul as mm
    monkeypatch.setattr(builder, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(builder, "find_nvcc", lambda: None)
    monkeypatch.setattr(mm, "_builder", None)
    monkeypatch.setattr(ln, "_builder", None)

    def plain(*a, **k):
        raise AssertionError("a tensor off the CPU took a plain version")

    for mod, names in ((ln, ("layernorm_reference",
                             "layernorm_bwd_reference")),
                       (mm, ("mm_reference", "dw_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    x = torch.ones(2, 8, 128, device="meta")
    s = torch.ones(128, device="meta")
    w = torch.ones(128, 64, device="meta")
    for call in (lambda: ln.fused_layernorm(x, s, s),
                 lambda: ln._bwd(x[0], s, x[0], 1e-5),
                 lambda: mm.mlp_matmul(x, w),
                 lambda: mm.mlp_matmul(x.transpose(1, 2), w, x_t=True,
                                       out_t=True),
                 lambda: mm._dw(x, x, False, False, torch.float32)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert os.listdir(tmp_path) == []


def test_attention_kernels_off_the_cpu_take_the_kernel(monkeypatch,
                                                      tmp_path):
    """A tensor off the CPU goes to the query-major flash backward and the
    K11 block-sparse kernels and never to their plain versions: here, with
    no nvcc, each build raises."""
    from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    monkeypatch.setattr(builder, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(builder, "find_nvcc", lambda: None)
    monkeypatch.setattr(fa, "_builder", None)
    monkeypatch.setattr(bsa, "_builder", None)

    def plain(*a, **k):
        raise AssertionError("a tensor off the CPU took a plain version")

    for mod, names in ((fa, ("flash_bwd_qmajor_reference",
                             "flash_backward_reference")),
                       (bsa, ("bsa_forward_reference", "bsa_dq_reference",
                              "bsa_dkv_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, plain)
    x = torch.ones(2, 4, 64, 32, device="meta")
    lse = torch.ones(2, 4, 64, device="meta")
    f = torch.ones(8, 64, 32, device="meta")
    lists = bsa.lists_on(bsa.layout_lists(torch.ones(4, 4, 4).bool().numpy(),
                                          True, 4, 4), "meta")
    for call in (lambda: fa.flash_backward_qmajor(x, x, x, x, lse, x),
                 lambda: bsa.bsa_forward(f, f, f, lists, 16, True),
                 lambda: bsa.bsa_backward(f, f, f, f, lse.view(8, 64), f,
                                          lists, 16, True)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert os.listdir(tmp_path) == []


def test_ring_and_quantize_kernels_off_the_cpu_take_the_kernel(
        monkeypatch, tmp_path):
    """A tensor off the CPU goes to K10 (flash_block_fwd, through the ring)
    and the K12 quantize / dequantize kernels, and never to their plain
    versions: here, with no nvcc, each build raises."""
    from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
    from deepspeed_tpu_torch.ops.cuda import quantization as qz
    from deepspeed_tpu_torch.sequence import ring_attention
    from deepspeed_tpu_torch.utils import groups
    monkeypatch.setattr(builder, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(builder, "find_nvcc", lambda: None)
    monkeypatch.setattr(fa, "_builder", None)
    monkeypatch.setattr(qz, "_builder", None)

    def plain(*a, **k):
        raise AssertionError("a tensor off the CPU took a plain version")

    monkeypatch.setattr(fa, "flash_block_fwd_reference", plain)
    monkeypatch.setattr(qz, "quantize_rows_reference", plain)
    monkeypatch.setattr(qz, "dequantize_rows_reference", plain)
    groups.reset()
    x = torch.ones(2, 64, 4, 32, device="meta")
    f = torch.ones(8, 64, 32, device="meta")
    q8 = torch.ones(2, 2048, dtype=torch.int8, device="meta")
    s = torch.ones(2, 1, device="meta")
    for call in (lambda: ring_attention(x, x, x, "seq"),
                 lambda: fa.flash_block_fwd(
                     f, f, f, fa.flash_block_state(8, 64, 32, "meta")),
                 lambda: qz.quantize_blockwise(x),
                 lambda: qz.dequantize_rows(q8, s, 2, 2048, torch.float32,
                                            sum_rows=True)):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            call()
    assert os.listdir(tmp_path) == []


_BLOCKED_SEQ_RUN = _BLOCKED_RUN.split("import dataclasses")[0] + r"""
import torch
from deepspeed_tpu_torch import comm, initialize
from deepspeed_tpu_torch.comm import quantized
from deepspeed_tpu_torch.models import GPT2, GPT2Config
from deepspeed_tpu_torch.ops.cuda import quantization
from deepspeed_tpu_torch.sequence import (DistributedAttention,
                                          ring_attention, ulysses_attention)
from deepspeed_tpu_torch.utils import groups
comm.init_distributed(device="cpu")
x = torch.randn(2, 16, 4, 8)
o = ring_attention(x, x, x, "seq")
assert torch.allclose(o, ulysses_attention(x, x, x), atol=1e-5)
q = quantized.quantized_all_gather(x, "data")
assert q.shape == (1,) + x.shape
cfg = GPT2Config(n_layer=2, n_head=2, d_model=64, max_seq_len=32,
                 vocab_size=128, dtype="float32", attention_backend="ring")
trainer, *_ = initialize(model=GPT2(cfg, device="cpu"), device="cpu",
                         config={"train_batch_size": 2, "optimizer": {
                             "type": "AdamW", "params": {"lr": 1e-3}}})
import numpy as np
ids = np.random.RandomState(0).randint(0, 128, (2, 32))
losses = [float(trainer.train_batch({"input_ids": ids})) for _ in range(2)]
assert losses[1] < losses[0], losses
assert groups.get_topology().world_size == 1
assert not any(n.split(".")[0] in ROOTS for n in sys.modules)
print("ISOLATED_OK")
"""


def test_comm_and_sequence_run_with_jax_unimportable():
    """comm/, sequence/, utils/groups.py and ops/cuda/quantization.py
    import and run (ring and Ulysses at one rank, a quantized gather, an
    engine with attention_backend="ring") with the JAX package blocked;
    the static scan above covers their sources."""
    assert {os.path.join(PKG, f) for f in (
        "comm/comm.py", "comm/quantized.py", "comm/logging.py",
        "sequence/ring.py", "sequence/layer.py", "utils/groups.py",
        "ops/cuda/quantization.py")} <= set(_port_sources())
    env = _child_env()
    env.pop("WORLD_SIZE", None)
    res = subprocess.run([sys.executable, "-c", _BLOCKED_SEQ_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED_OK" in res.stdout


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"))
    model = Llama(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(model, dict(dtype="float32", kv_block_size=8))


_TRAIN_CFG = dict(n_layer=2, n_head=2, d_model=64, max_seq_len=32,
                  vocab_size=128, dtype="float32")
_TRAIN_CONFIG = {"train_batch_size": 2,
                 "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}


def test_training_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GPT2Config(**_TRAIN_CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2MoE(GPT2MoEConfig(**_TRAIN_CFG, moe_backend="ragged"))
    model = GPT2(cfg, device="cpu")
    assert not model.flash_on          # "auto": the kernels only on a card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config=_TRAIN_CONFIG)


def test_training_rejects_unported_config():
    model = GPT2(GPT2Config(**_TRAIN_CFG), device="cpu")
    for over in ({"pipeline": {"stages": 2}}, {"tensor_parallel": {"size": 2}},
                 {"zero_optimization": {"offload_param": {"device": "nvme"}}},
                 {"quantize": {"int8_matmul": True}},
                 {"comm_overlap": {"enabled": True}}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            deepspeed_tpu_torch.initialize(
                model=model, config={**_TRAIN_CONFIG, **over}, device="cpu")


def test_engine_rejects_unported_config(tmp_path):
    model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                  device="cpu")
    # tensor / expert parallel are ported: a process that joined no world
    # cannot lay out their two ranks; a replica around a multi-rank engine
    # is not ported (its ROADMAP item)
    from deepspeed_tpu_torch import Replica
    from deepspeed_tpu_torch.utils import groups
    for over in (dict(tensor_parallel=2), dict(expert_parallel=2)):
        groups.reset()
        with pytest.raises(ValueError, match="world size 1"):
            InferenceEngineV2(model, dict(dtype="float32", **over),
                              device="cpu")
    groups.reset()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Replica("r0", types.SimpleNamespace(multi_rank=True))
    # the autotune winner cache's fields are ported: accepted
    from deepspeed_tpu_torch.autotuning import kernel_dispatch
    try:
        for over in (dict(paged_block_c=16), dict(autotune_mode="off"),
                     dict(autotune_cache=str(tmp_path / "winners.json"))):
            InferenceEngineV2(model, dict(dtype="float32", **over),
                              device="cpu")
    finally:
        kernel_dispatch.reset()
    # serving telemetry and its monitor are ported: accepted
    eng = InferenceEngineV2(model, dict(dtype="float32", telemetry=True),
                            device="cpu", monitor=object())
    assert eng.telemetry is not None
    with pytest.raises(ValueError):
        InferenceEngineV2(model, dict(paged_kernel="yes"), device="cpu")


class TestOpBuilder:
    @pytest.mark.parametrize("cls,name", [
        (builder.FlashAttentionBuilder, "flash_attention"),
        (builder.FusedCEBuilder, "fused_ce"),
        (builder.GroupedMatmulBuilder, "grouped_matmul"),
        (builder.MlpMatmulBuilder, "mlp_matmul"),
        (builder.LayerNormBuilder, "layernorm"),
        (builder.BlockSparseAttentionBuilder, "block_sparse_attention"),
        (builder.QuantizationBuilder, "quantization")])
    def test_training_builders(self, cls, name):
        b = cls()
        assert b.so_path() == os.path.join(
            ROOT, "build", "deepspeed_tpu_torch",
            f"{name}-{b.build_hash()}.so")
        assert all(os.path.exists(s) for s in b.absolute_sources())
        assert all(os.path.exists(os.path.join(builder.CSRC, d))
                   for d in b.DEPENDS)

    def test_build_all_waits_for_every_build(self, monkeypatch, tmp_path):
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\nfor a; do out=$a; done\n"
                        "case $* in *fused_ce*) exit 3;; esac\n"
                        "touch $out\n")
        fake.chmod(0o755)
        monkeypatch.setattr(builder, "BUILD_DIR", str(tmp_path / "out"))
        monkeypatch.setattr(builder, "find_nvcc", lambda: str(fake))
        bs = [builder.FlashAttentionBuilder(), builder.FusedCEBuilder(),
              builder.PagedAttentionBuilder()]
        with pytest.raises(RuntimeError, match="fused_ce"):
            builder.build_all(bs)
        built = sorted(os.listdir(tmp_path / "out"))
        assert [f.split("-")[0] for f in built] == ["flash_attention",
                                                    "paged_attention"]

    def test_stable_hash_and_path(self, monkeypatch):
        a = builder.PagedAttentionBuilder()
        b = builder.PagedAttentionBuilder()
        assert a.build_hash() == b.build_hash()
        assert re.fullmatch(r"[0-9a-f]{16}", a.build_hash())
        h = a.build_hash()
        assert a.so_path() == os.path.join(
            ROOT, "build", "deepspeed_tpu_torch", f"paged_attention-{h}.so")
        monkeypatch.setattr(builder, "NVCC_FLAGS",
                            builder.NVCC_FLAGS + ["-lineinfo"])
        assert builder.PagedAttentionBuilder().build_hash() != h

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(builder, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(builder, "find_nvcc", lambda: None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            builder.PagedAttentionBuilder().load()
        assert os.listdir(tmp_path) == []

    def test_failed_build_raises(self, monkeypatch, tmp_path):
        fake = tmp_path / "nvcc"
        fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 2\n")
        fake.chmod(0o755)
        out = tmp_path / "out"
        monkeypatch.setattr(builder, "BUILD_DIR", str(out))
        monkeypatch.setattr(builder, "find_nvcc", lambda: str(fake))
        with pytest.raises(RuntimeError, match="nvcc failed"):
            builder.PagedAttentionBuilder().load()
        assert not any(f.endswith(".so") for f in os.listdir(out))
