"""The port's autotune winner cache (``deepspeed_tpu_torch/autotuning/``,
``ops/cuda/_common.py``) on the CPU, held against the JAX package's
``autotuning`` modules and ``tests/unit/test_autotune.py``'s classes:

  * the registry: JAX's ops but the deferred ones and those nothing would
    read, deduplicated candidates with the defaults first and no plain
    version where a kernel runs, ``parse_bucket`` round trips, every
    searched op's ``make_step`` runs and every candidate passes its parity
    check;
  * the cache: byte-identical round trips, files crossing between the two
    packages, missing and corrupt files read as empty, another device
    kind refused;
  * dispatch: JAX's modes and memo, a bucket with one candidate never
    searched, the failed search that raises (the port's divergence), a
    plain winner refused on a card;
  * the buckets, equal to JAX's strings; the shared-parameter resolvers
    (prefix cache, speculation, the paged kernels' mode) reading one
    seeded file as JAX's do; the engines' autotune fields and the training
    ``autotune`` block setting the process state completely;
  * a tiny fp32 Llama engine with a seeded ``prefix_cache`` winner giving
    the JAX engine's greedy streams and tree counters from the same file.

Every test runs on a private cache file with both packages' dispatch state
reset (the state is process-global)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from deepspeed_tpu.autotuning import KernelCache as JKernelCache
from deepspeed_tpu.autotuning import kernel_dispatch as j_dispatch
from deepspeed_tpu.autotuning import kernel_registry as j_registry
from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import prefix_cache as j_prefix
from deepspeed_tpu.inference.v2 import speculative as j_spec
from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.ops.pallas import _common as j_common
from deepspeed_tpu.ops.pallas import paged_attention as j_paged
import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2, GPT2Config, InferenceEngineV2, Llama
from deepspeed_tpu_torch.autotuning import (KernelCache, kernel_autotuner,
                                            kernel_dispatch, kernel_registry,
                                            seed_entries)
from deepspeed_tpu_torch.autotuning.kernel_cache import entry_key
from deepspeed_tpu_torch.inference.v2.prefix_cache import resolve_prefix_cache
from deepspeed_tpu_torch.inference.v2.speculative import resolve_spec
from deepspeed_tpu_torch.models import LLAMA_TINY, llama_params_from_numpy
from deepspeed_tpu_torch.ops.cuda import _common
from deepspeed_tpu_torch.ops.cuda import paged_attention as pa
from deepspeed_tpu_torch.runtime.config import DeepSpeedConfigError

H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _pristine(tmp_path, monkeypatch):
    """A private cache path and reset dispatch state in both packages."""
    monkeypatch.setenv("DSTPU_AUTOTUNE_CACHE",
                       str(tmp_path / "kernel_autotune.json"))
    monkeypatch.delenv("DSTPU_AUTOTUNE", raising=False)
    kernel_dispatch.reset()
    j_dispatch.reset()
    yield
    kernel_dispatch.reset()
    j_dispatch.reset()


def _path():
    return os.environ["DSTPU_AUTOTUNE_CACHE"]


# a tiny bucket per op (several tests build real steps from them)
_BUCKETS = {
    "flash_attention": "T32,d16,c1,q1",
    "mlp_matmul": "T16,D128,F256",
    "layernorm": "R64,D128",
    "moe_grouped_mm": "S32,E4,M32,F64",
    "paged_decode": "B2,MB4,BS16,kh2,g2,d16",
    "paged_chunk": "C8,MB4,BS16,kh2,g2,d16",
    "prefix_cache": "B4,NB16,BS16",
    "spec_decode": "B4,NB16,BS16",
}
# the ops with more than one candidate (the rest are never searched)
_SEARCHED = sorted(op for op in _BUCKETS
                   if kernel_registry.REGISTRY[op]["make_step"])
# JAX ops this slice leaves to later items (ROADMAP Queue 1: the collective
# ops with M5 / M14, pipe_microbatch with M13, the int8 compute with M11)
_DEFERRED = {"mlp_int8", "moe_grouped_int8", "pipe_microbatch",
             "comm_bucket", "grad_staging", "a2a_staging", "dcn_quantize",
             "ring_rotate", "scan_unroll", "hot_replicas"}
# JAX ops no call of the port would read: K3 and K10 take no lever, and
# kv_handoff's one reader is the planner (M14)
_NO_READER = {"fused_ce", "ring_block", "kv_handoff"}


# --------------------------------------------------------------- registry


class TestRegistry:
    def test_ops_are_jax_ops_but_the_deferred(self):
        assert set(kernel_registry.REGISTRY) == \
            set(j_registry.REGISTRY) - _DEFERRED - _NO_READER
        assert set(_BUCKETS) == set(kernel_registry.REGISTRY)
        assert _SEARCHED == ["flash_attention", "layernorm", "mlp_matmul",
                             "paged_chunk", "paged_decode"]

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("op", sorted(_BUCKETS))
    def test_candidates_deduped_defaults_first_no_plain(self, op, dtype):
        spec = kernel_registry.REGISTRY[op]
        b = kernel_registry.parse_bucket(_BUCKETS[op])
        cands = spec["candidates"](b, dtype)
        assert cands and cands[0] == spec["defaults"](b)
        assert kernel_registry._dedup(cands) == cands
        assert all(kernel_registry.names_plain(op, c) is None for c in cands)

    def test_levers_per_design(self):
        """K5's sm90 buckets search its key-walk splits, the SIMT / fp32
        ones its query tile; K4 its split size, one candidate per distinct
        split; K2-qmajor only on qkv_t; K13 only where D % 128 == 0."""
        sm90 = kernel_registry.parse_bucket("C256,MB64,BS64,kh32,g1,d128")
        cands = kernel_registry._pgc_candidates(sm90, "bfloat16")
        assert [c["splits"] for c in cands] == ["rule", 1, 2, 4, 8]
        assert {c["block_c"] for c in cands} == {pa.PAGED_CHUNK_BLOCK_C}
        cands = kernel_registry._pgc_candidates(sm90, "float32")
        assert [c["block_c"] for c in cands] == [64, 16, 32, 128]
        assert {c["splits"] for c in cands} == {"rule"}
        dec = kernel_registry.parse_bucket("B8,MB64,BS64,kh32,g1,d128")
        assert [c["split_positions"] for c in
                kernel_registry._pgd_candidates(dec, "bfloat16")] == \
            [512, 256, 1024, 0]
        small = kernel_registry.parse_bucket("B8,MB4,BS64,kh32,g1,d128")
        assert [c["split_positions"] for c in
                kernel_registry._pgd_candidates(small, "bfloat16")] == [512]
        fl = kernel_registry.REGISTRY["flash_attention"]["candidates"]
        assert fl({"T": 1024, "d": 64, "c": 1, "q": 1}, "bfloat16") == [
            {"bwd_qmajor": False}, {"bwd_qmajor": True}]
        assert fl({"T": 1024, "d": 64, "c": 1, "q": 0}, "bfloat16") == [
            {"bwd_qmajor": False}]
        assert fl({"T": 1024, "d": 64, "c": 1, "q": 1}, "float16") == [
            {"bwd_qmajor": False}]
        ln = kernel_registry.REGISTRY["layernorm"]["candidates"]
        assert len(ln({"R": 64, "D": 128}, "bfloat16")) == 3
        assert ln({"R": 64, "D": 96}, "bfloat16") == [{"variant": "plain"}]

    @pytest.mark.parametrize("op", sorted(_BUCKETS))
    def test_parse_bucket_roundtrip(self, op):
        b = kernel_registry.parse_bucket(_BUCKETS[op])
        assert ",".join(f"{k}{v}" for k, v in b.items()) == _BUCKETS[op]
        assert b == j_registry.parse_bucket(_BUCKETS[op])

    @pytest.mark.parametrize("op", _SEARCHED)
    def test_make_step_runs_and_candidates_pass_parity(self, op):
        """One chained step of every candidate on the CPU keeps its
        carry's shapes, and every candidate holds against the plain
        version."""
        spec = kernel_registry.REGISTRY[op]
        b = kernel_registry.parse_bucket(_BUCKETS[op])
        dev = torch.device("cpu")
        for params in spec["candidates"](b, "float32"):
            step, args = spec["make_step"](b, "float32", params, dev)
            out = step(args)
            assert [tuple(t.shape) for t in out] == \
                [tuple(t.shape) for t in args]
            assert all(torch.isfinite(t.float()).all() for t in out
                       if t.is_floating_point())
            spec["parity"](b, "float32", params, dev)

    def test_parity_catches_a_wrong_candidate(self, monkeypatch):
        """The control: a paged decode that drops its last cache block
        fails the parity check."""
        real = pa.paged_decode_attention

        def short(q, kc, vc, tables, lengths, **kw):
            return real(q, kc, vc, tables[:, :-1].contiguous(),
                        torch.clamp(lengths, max=(tables.shape[1] - 1)
                                    * kc.shape[2] - 1), **kw)

        monkeypatch.setattr(pa, "paged_decode_attention", short)
        b = kernel_registry.parse_bucket(_BUCKETS["paged_decode"])
        with pytest.raises(AssertionError, match="paged_decode"):
            kernel_registry._pgd_parity(b, "float32",
                                        dict(pa.PAGED_DECODE_DEFAULTS),
                                        torch.device("cpu"))


# ------------------------------------------------------------------ cache


def _entries(c, dk):
    c.put(dk, "layernorm", "R256,D128", "float32", {"variant": "fused"},
          measured_ms=0.5, default_ms=0.75, candidates=3)
    c.put(dk, "paged_decode", "B8,MB64,BS64,kh32,g1,d128", "bfloat16",
          {"mode": "kernel", "split_positions": 1024}, measured_ms=0.02,
          default_ms=float("inf"), candidates=4)
    return c


class TestCache:
    def test_roundtrip_is_byte_identical(self, tmp_path):
        p = str(tmp_path / "c.json")
        c = _entries(KernelCache(), "torch-cpu")
        c.save(p)
        raw = open(p).read()
        assert raw == c.to_json()
        again = KernelCache.load(p)
        assert again.to_json() == raw
        again.save(p)
        assert open(p).read() == raw
        assert json.loads(raw)["version"] == 1
        # non-finite timings are stored as null (strict JSON)
        assert "Infinity" not in raw
        assert not os.path.exists(p + ".tmp")

    def test_files_cross_between_the_packages(self, tmp_path):
        p = str(tmp_path / "jax.json")
        jc = _entries(JKernelCache(), "cpu")
        jc.save(p)
        assert KernelCache.load(p).to_json() == jc.to_json()
        q = str(tmp_path / "port.json")
        c = _entries(KernelCache(), "torch-cpu")
        c.save(q)
        assert JKernelCache.load(q).to_json() == c.to_json() == \
            open(q).read()
        # one file holds both packages' entries, each steering its own
        both = KernelCache.load(p)
        both.entries.update(KernelCache.load(q).entries)
        both.save(p)
        assert JKernelCache.load(p).lookup(
            "cpu", "layernorm", "R256,D128", "float32") == \
            KernelCache.load(p).lookup(
                "torch-cpu", "layernorm", "R256,D128", "float32") == \
            {"variant": "fused"}

    def test_missing_and_corrupt_files_are_empty(self, tmp_path):
        assert len(KernelCache.load(str(tmp_path / "none.json"))) == 0
        bad = tmp_path / "bad.json"
        bad.write_text("{not json")
        assert len(KernelCache.load(str(bad))) == 0
        other = tmp_path / "v2.json"
        other.write_text(json.dumps({"version": 2, "entries": {"a": {}}}))
        assert len(KernelCache.load(str(other))) == 0

    def test_device_kind_mismatch_refused(self):
        c = KernelCache()
        c.put(H100, "layernorm", "R256,D128", "float32",
              {"variant": "fused"})
        # an entry filed under one key but measured elsewhere is refused
        c.entries[entry_key("torch-cpu", "layernorm", "R256,D128",
                            "float32")] = dict(
            c.entries[entry_key(H100, "layernorm", "R256,D128",
                                "float32")])
        assert c.lookup("torch-cpu", "layernorm", "R256,D128",
                        "float32") is None
        assert c.lookup(H100, "layernorm", "R256,D128", "float32") == \
            {"variant": "fused"}
        # the JAX package's CPU kind never steers the port's
        c.put("cpu", "mlp_matmul", "T16,D128,F256", "float32",
              {"mode": "both", "fuse_dw": True})
        assert c.lookup(kernel_dispatch.device_kind("cpu"), "mlp_matmul",
                        "T16,D128,F256", "float32") is None
        assert kernel_dispatch.device_kind("cpu") == "torch-cpu" != \
            j_dispatch.device_kind()

    def test_seed_entries_merges_and_skips_malformed(self):
        n = seed_entries([
            {"device_kind": "torch-cpu", "op": "layernorm",
             "bucket": "R64,D128", "dtype": "float32",
             "params": {"variant": "bwd"}, "measured_ms": 0.1},
            {"op": "layernorm"}, "junk"])
        assert n == 1
        assert KernelCache.load(_path()).lookup(
            "torch-cpu", "layernorm", "R64,D128", "float32") == \
            {"variant": "bwd"}


# --------------------------------------------------------------- dispatch


def _seed(op, bucket, dtype, params, dk="torch-cpu"):
    c = KernelCache.load(_path())
    c.put(dk, op, bucket, dtype, params)
    c.save(_path())


def _fake_search(calls, winner):
    def search(op, bucket, dtype, defaults=None, **kw):
        calls.append((op, bucket))
        return dict(winner), {
            "op": op, "bucket": bucket, "dtype": dtype,
            "candidates": [{"params": winner, "ms": 1.0, "error": None,
                            "parity": "ok"}],
            "winner": winner, "winner_ms": 1.0, "default_ms": 2.0}
    return search


class TestDispatch:
    def test_fallback_to_defaults_on_miss(self):
        d = {"variant": "plain"}
        got = _common.dispatch("layernorm", "R256,D128", "float32", d,
                               device="cpu")
        assert got == d and got is not d

    def test_off_mode_ignores_cache(self):
        _seed("layernorm", "R256,D128", "float32", {"variant": "fused"})
        kernel_dispatch.configure(mode="off")
        assert _common.dispatch("layernorm", "R256,D128", "float32",
                                {"variant": "plain"}, device="cpu") == \
            {"variant": "plain"}

    def test_cache_only_never_triggers_search(self, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("search invoked under cache_only")

        monkeypatch.setattr(kernel_autotuner, "search", boom)
        kernel_dispatch.configure(mode="cache_only")
        d = dict(kernel_registry.FLASH_DEFAULTS)
        assert _common.dispatch("flash_attention", "T128,d64,c1,q1",
                                "bfloat16", d, device="cpu") == d

    def test_cached_winner_wins_and_memoizes(self, monkeypatch):
        _seed("layernorm", "R256,D128", "float32", {"variant": "fused"})
        kernel_dispatch.configure(mode="cache_only")
        d = {"variant": "plain"}
        got = _common.dispatch("layernorm", "R256,D128", "float32", d,
                               device="cpu")
        assert got == {"variant": "fused"}
        monkeypatch.setattr(KernelCache, "load", classmethod(
            lambda cls, p: (_ for _ in ()).throw(AssertionError("re-read"))))
        assert _common.dispatch("layernorm", "R256,D128", "float32", d,
                                device="cpu") == got

    def test_winner_filtered_to_callers_keys(self):
        _seed("mlp_matmul", "T16,D128,F256", "float32",
              {"mode": "both", "fuse_dw": False})
        assert _common.dispatch("mlp_matmul", "T16,D128,F256", "float32",
                                {"fuse_dw": True}, device="cpu") == \
            {"fuse_dw": False}

    def test_on_first_use_searches_once_and_persists(self, monkeypatch):
        calls = []
        monkeypatch.setattr(kernel_autotuner, "search", _fake_search(
            calls, {"variant": "bwd"}))
        kernel_dispatch.configure(mode="on_first_use")
        d = {"variant": "plain"}
        for _ in range(2):
            assert _common.dispatch("layernorm", "R256,D128", "float32", d,
                                    device="cpu") == {"variant": "bwd"}
        assert calls == [("layernorm", "R256,D128")]
        e = KernelCache.load(_path()).entries[entry_key(
            "torch-cpu", "layernorm", "R256,D128", "float32")]
        assert (e["params"], e["measured_ms"], e["default_ms"],
                e["candidates"]) == ({"variant": "bwd"}, 1.0, 2.0, 1)

    def test_search_mode_remeasures_cached_keys(self, monkeypatch):
        _seed("layernorm", "R256,D128", "float32", {"variant": "fused"})
        calls = []
        monkeypatch.setattr(kernel_autotuner, "search", _fake_search(
            calls, {"variant": "bwd"}))
        kernel_dispatch.configure(mode="search")
        assert _common.dispatch("layernorm", "R256,D128", "float32",
                                {"variant": "plain"}, device="cpu") == \
            {"variant": "bwd"}
        assert calls == [("layernorm", "R256,D128")]
        assert KernelCache.load(_path()).lookup(
            "torch-cpu", "layernorm", "R256,D128", "float32") == \
            {"variant": "bwd"}

    def test_failed_search_raises(self, monkeypatch):
        """The port's divergence: JAX takes the defaults after a failed
        search (kernel_dispatch.py:183-191); the port raises, and so does
        a search whose candidates all fail parity."""
        def broken(*a, **k):
            raise RuntimeError("the candidate did not launch")

        real = kernel_autotuner.search
        kernel_dispatch.configure(mode="on_first_use")
        monkeypatch.setattr(kernel_autotuner, "search", broken)
        with pytest.raises(RuntimeError, match="did not launch"):
            _common.dispatch("layernorm", "R256,D128", "float32",
                             {"variant": "plain"}, device="cpu")
        from deepspeed_tpu.autotuning import kernel_autotuner as j_tuner
        monkeypatch.setattr(j_tuner, "search", broken)
        j_dispatch.configure(mode="on_first_use")
        assert j_dispatch.resolve("fused_ce", "N128,D128,V384", "float32",
                                  {"block_m": 512, "block_n": 512}) == \
            {"block_m": 512, "block_n": 512}
        monkeypatch.setattr(kernel_autotuner, "search", real)
        kernel_dispatch.configure(mode="on_first_use", chain_lengths=(1, 2),
                                  reps=1)

        def wrong(b, dtype, params, device):
            raise AssertionError("wrong numbers")

        monkeypatch.setitem(kernel_registry.REGISTRY["layernorm"], "parity",
                            wrong)
        with pytest.raises(RuntimeError, match="no candidate passed"):
            _common.dispatch("layernorm", "R64,D128", "float32",
                             {"variant": "plain"}, device="cpu")

    @pytest.mark.parametrize("mode", ["on_first_use", "search"])
    def test_one_candidate_is_never_searched(self, monkeypatch, mode):
        """A bucket with one candidate resolves to its defaults in the
        search modes without a search or an entry; a cached winner still
        applies where the mode reads the cache."""
        def boom(*a, **k):
            raise AssertionError("a one-candidate bucket was searched")

        monkeypatch.setattr(kernel_autotuner, "search", boom)
        kernel_dispatch.configure(mode=mode)
        single = [("prefix_cache", "B4,NB64,BS8"),
                  ("spec_decode", "B4,NB64,BS8"),
                  ("moe_grouped_mm", "S32,E4,M32,F64"),
                  ("layernorm", "R64,D96"),
                  ("flash_attention", "T32,d16,c1,q0")]
        for op, bucket in single:
            spec = kernel_registry.REGISTRY[op]
            d = spec["defaults"](kernel_registry.parse_bucket(bucket))
            assert len(kernel_autotuner.candidates(op, bucket, "float32",
                                                   d)) == 1
            assert _common.dispatch(op, bucket, "float32", d,
                                    device="cpu") == d
        assert not kernel_dispatch.reports()
        assert len(KernelCache.load(_path())) == 0
        winner = {"enabled": 1, "min_match_blocks": 2,
                  "evict_watermark_pct": 25}
        _seed("prefix_cache", "B8,NB64,BS8", "float32", winner)
        kernel_dispatch.configure(mode=mode)
        got = _common.dispatch("prefix_cache", "B8,NB64,BS8", "float32",
                               kernel_registry.PREFIX_CACHE_DEFAULTS,
                               device="cpu")
        assert got == (winner if mode == "on_first_use" else
                       kernel_registry.PREFIX_CACHE_DEFAULTS)

    def test_unknown_op_falls_back(self):
        kernel_dispatch.configure(mode="on_first_use")
        assert _common.dispatch("not_a_kernel", "X1", "float32", {"a": 1},
                                device="cpu") == {"a": 1}

    def test_plain_winner_refused_on_a_card(self, monkeypatch):
        """A card's entry naming a plain version (paged decode ``dense``,
        the MoE ``ragged`` backend) raises, never applied; on the CPU the
        same entry resolves as JAX's would."""
        monkeypatch.setattr(kernel_dispatch, "device_kind",
                            lambda device=None: H100 if torch.device(
                                device).type == "cuda" else "torch-cpu")
        bucket = "B8,MB64,BS64,kh32,g1,d128"
        for dk in (H100, "torch-cpu"):
            _seed("paged_decode", bucket, "bfloat16",
                  {"mode": "dense", "split_positions": 512}, dk=dk)
        kernel_dispatch.configure(mode="cache_only")
        with pytest.raises(ValueError, match="plain"):
            pa.resolve_paged_decode("auto", 8, 64, 64, 32, 1, 128,
                                    torch.bfloat16,
                                    device=torch.device("cuda", 0))
        assert pa.resolve_paged_decode("auto", 8, 64, 64, 32, 1, 128,
                                       torch.bfloat16, device="cpu") is False
        _seed("moe_grouped_mm", "S16,E8,M4096,F14336", "bfloat16",
              {"backend": "ragged"}, dk=H100)
        from deepspeed_tpu_torch.moe import sharded_moe
        kernel_dispatch.configure(mode="cache_only")
        with pytest.raises(ValueError, match="backend='ragged'"):
            sharded_moe.resolve_grouped_params(
                "auto", 16, 8, 4096, 14336, torch.bfloat16,
                torch.device("cuda", 0))

    def test_real_search_on_the_cpu(self):
        """A measured search under on_first_use: every candidate timed
        and parity-checked, the winner persisted with its timings, then
        served from the file under cache_only."""
        kernel_dispatch.configure(mode="on_first_use", chain_lengths=(1, 2),
                                  reps=1)
        got = _common.dispatch("layernorm", "R64,D128", "float32",
                               kernel_registry.LN_DEFAULTS, device="cpu")
        (key, rep), = kernel_dispatch.reports().items()
        assert key == entry_key("torch-cpu", "layernorm", "R64,D128",
                                "float32")
        assert [r["params"] for r in rep["candidates"]] == [
            {"variant": "plain"}, {"variant": "fused"}, {"variant": "bwd"}]
        assert all(r["parity"] == "ok" and r["ms"] >= 0
                   for r in rep["candidates"])
        assert rep["winner"] == got and rep["default_ms"] == \
            rep["candidates"][0]["ms"]
        e = KernelCache.load(_path()).entries[key]
        assert e["params"] == got and e["candidates"] == 3
        kernel_dispatch.configure(mode="cache_only")
        assert _common.dispatch("layernorm", "R64,D128", "float32",
                                kernel_registry.LN_DEFAULTS,
                                device="cpu") == got


# ---------------------------------------------------------------- buckets


_SHAPES = [(1, 1, 1, 1, 1, 1), (3, 7, 16, 2, 4, 64), (8, 64, 64, 32, 1, 128),
           (100, 1000, 128, 8, 4, 96), (1024, 33, 8, 71, 1, 256),
           (5, 65, 32, 1, 71, 80)]


class TestBuckets:
    @pytest.mark.parametrize("s", _SHAPES)
    def test_bucket_strings_equal_jax(self, s):
        a, b, c, d, e, f = s
        pairs = [
            (_common.pow2_bucket(a * b), j_common.pow2_bucket(a * b)),
            (_common.flash_bucket(b, f, a % 2, c % 2),
             j_common.flash_bucket(b, f, a % 2, c % 2)),
            (_common.mlp_bucket(b, c, f), j_common.mlp_bucket(b, c, f)),
            (_common.ln_bucket(a * b, f), j_common.ln_bucket(a * b, f)),
            (_common.moe_grouped_bucket(a * 2, d, c, f),
             j_common.moe_grouped_bucket(a * 2, d, c, f)),
            (_common.paged_decode_bucket(a, b, c, d, e, f),
             j_common.paged_decode_bucket(a, b, c, d, e, f)),
            (_common.paged_chunk_bucket(a, b, c, d, e, f),
             j_common.paged_chunk_bucket(a, b, c, d, e, f)),
            (_common.prefix_cache_bucket(a, b, c),
             j_prefix.prefix_cache_bucket(a, b, c)),
            (_common.spec_bucket(a, b, c), j_spec.spec_bucket(a, b, c))]
        for mine, theirs in pairs:
            assert mine == theirs

    def test_dtype_names(self):
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            name = _common.dtype_name(dt)
            assert name == j_common.dtype_name(name) == \
                _common.dtype_name(name)
        with pytest.raises(ValueError):
            _common.dtype_name("floaty")


# -------------------------------------------------------------- resolvers


def _seed_both(op, bucket, dtype, params):
    """One file, the entry under both packages' CPU kinds."""
    c = KernelCache.load(_path())
    for dk in ("cpu", "torch-cpu"):
        c.put(dk, op, bucket, dtype, params)
    c.save(_path())


class TestResolvers:
    POOL = dict(B=4, NB=64, BS=8, dtype="float32")

    @pytest.mark.parametrize("winner", [
        None, {"enabled": 1, "min_match_blocks": 2, "evict_watermark_pct": 25},
        {"enabled": 0, "min_match_blocks": 4, "evict_watermark_pct": 0}])
    def test_prefix_cache_resolves_as_jax(self, winner):
        if winner:
            _seed_both("prefix_cache", "B4,NB64,BS8", "float32", winner)
        for knobs in (("auto", "auto"), (True, "auto"), ("auto", 3),
                      (False, 1)):
            assert resolve_prefix_cache(*knobs, **self.POOL,
                                        device="cpu") == \
                j_prefix.resolve_prefix_cache(*knobs, **self.POOL)

    @pytest.mark.parametrize("winner", [
        None, {"enabled": 1, "spec_k": 8, "floor_pct": 50},
        {"enabled": 0, "spec_k": 0, "floor_pct": 35}])
    def test_spec_resolves_as_jax(self, winner):
        if winner:
            _seed_both("spec_decode", "B4,NB64,BS8", "float32", winner)
        for knobs in (("auto", "auto"), (True, 2), ("auto", 6),
                      (True, "auto")):
            assert resolve_spec(*knobs, **self.POOL, device="cpu") == \
                j_spec.resolve_spec(*knobs, **self.POOL)

    @pytest.mark.parametrize("mode", ["kernel", "dense"])
    def test_paged_modes_resolve_as_jax(self, mode):
        shape = (4, 16, 8, 2, 2, 16)
        _seed_both("paged_decode", _common.paged_decode_bucket(*shape),
                   "float32", {"mode": mode, "split_positions": 256})
        _seed_both("paged_chunk", _common.paged_chunk_bucket(*shape),
                   "float32", {"mode": mode, "block_c": 16, "splits": 2})
        for setting in ("auto", True, False):
            assert pa.resolve_paged_decode(setting, *shape, torch.float32,
                                           device="cpu") == \
                j_paged.resolve_paged_decode(setting, *shape, "float32")
            for bc in ("auto", 32):
                got = pa.resolve_paged_chunk(setting, bc, *shape,
                                             torch.float32, device="cpu")
                want = j_paged.resolve_paged_chunk(setting, bc, *shape,
                                                   "float32")
                if setting is False and bc == "auto":
                    # a forced-off kernel reads no cache: each package's
                    # own tile constant (the port's 64, JAX's 128)
                    want = (False, pa.PAGED_CHUNK_BLOCK_C)
                assert got == want
        # the port's own levers ride along on the same entries
        assert pa.resolve_paged_decode_levers(True, *shape, torch.float32,
                                              device="cpu") == (True, 256)
        assert pa.resolve_paged_chunk_levers(True, "auto", *shape,
                                             torch.float32, device="cpu") \
            == (True, 16, 2)

    def test_cold_cache_is_the_port_of_today(self):
        """A cold cache: the kernels with their shape rules, the plain
        LayerNorm and MLP products, K2, the kernels for the experts."""
        assert pa.resolve_paged_decode_levers(
            "auto", 8, 64, 64, 32, 1, 128, torch.bfloat16, "cpu") == \
            (True, pa.DECODE_SPLIT_POSITIONS)
        assert pa.resolve_paged_chunk_levers(
            "auto", "auto", 256, 64, 64, 32, 1, 128, torch.bfloat16,
            "cpu") == (True, pa.PAGED_CHUNK_BLOCK_C, None)
        from deepspeed_tpu_torch.moe import sharded_moe
        from deepspeed_tpu_torch.ops.cuda import flash_attention as fa
        assert sharded_moe.resolve_grouped_params(
            "auto", 16, 8, 4096, 14336, torch.bfloat16, "cpu") == \
            {"backend": "kernel"}
        assert fa.resolve_bwd_qmajor("auto", 1024, 64, True, True,
                                     torch.bfloat16, "cpu") is False
        for op, defaults in (("layernorm", kernel_registry.LN_DEFAULTS),
                             ("mlp_matmul", kernel_registry.MLP_DEFAULTS)):
            assert _common.dispatch(op, "T1", "bfloat16", defaults,
                                    device="cpu") == defaults

    def test_plain_decode_stands_in_for_the_kernel(self, monkeypatch):
        """A model's decode calls K4 with its split lever; the plain version
        takes the lever and ignores it, so it can stand in for K4 (as the
        card's ALiBi parity run swaps it in)."""
        from deepspeed_tpu_torch.models import llama as tl
        calls = []

        def plain(*a, **k):
            calls.append(k.get("split_positions"))
            return pa.paged_decode_attention_reference(*a, **k)

        monkeypatch.setattr(tl, "paged_decode_attention", plain)
        model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                      device="cpu")
        out = InferenceEngineV2(model, dict(dtype="float32", kv_block_size=8),
                                device="cpu").generate_all(
                                    [np.arange(5)], max_new_tokens=3)
        assert len(out[0]) == 3
        assert calls and set(calls) == {pa.DECODE_SPLIT_POSITIONS}

    def test_gpt2_knobs_follow_the_winners(self, monkeypatch):
        """GPT-2's "auto" training knobs take the cached winners: the K13
        LayerNorm, K6 on both projections, the query-major backward."""
        from deepspeed_tpu_torch.models import gpt2 as tgpt2
        cfg = GPT2Config(n_layer=1, n_head=2, d_model=128, max_seq_len=16,
                         vocab_size=64, dtype="float32",
                         use_flash_attention=True, fused_layernorm="auto",
                         mlp_kernel="auto", flash_bwd_qmajor="auto")
        model = GPT2(cfg, device="cpu")
        calls = []
        for name in ("fused_layernorm", "mlp_matmul"):
            real = getattr(tgpt2, name)
            monkeypatch.setattr(tgpt2, name, lambda *a, real=real, name=name,
                                **k: calls.append(name) or real(*a, **k))
        ids = torch.randint(0, 64, (2, 16))
        model.loss({"input_ids": ids})
        assert calls == [] and not model.flash_qmajor
        _seed("layernorm", "R32,D128", "float32", {"variant": "fused"})
        _seed("layernorm", "R2,D128", "float32", {"variant": "fused"})
        _seed("mlp_matmul", "T16,D128,F512", "float32",
              {"mode": "both", "fuse_dw": False})
        _seed("flash_attention", "T16,d64,c1,q1", "float32",
              {"bwd_qmajor": True})
        kernel_dispatch.configure(mode="cache_only")
        model.loss({"input_ids": ids})
        assert calls.count("mlp_matmul") == 2
        assert calls.count("fused_layernorm") >= 3
        assert model.flash_qmajor


# ----------------------------------------------------------- engine wiring


class TestEngineWiring:
    def test_v2_engine_sets_the_state_completely(self, tmp_path):
        model = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                      device="cpu")
        pa_path = str(tmp_path / "a.json")
        a = InferenceEngineV2(model, dict(
            dtype="float32", kv_block_size=8, autotune_mode="off",
            autotune_cache=pa_path, paged_block_c=16), device="cpu")
        assert kernel_dispatch.current_mode() == "off"
        assert kernel_dispatch.cache_path() == pa_path
        assert model.paged_block_c == 16
        InferenceEngineV2(model, dict(dtype="float32", kv_block_size=8),
                          device="cpu")
        # the second engine's "" reverts to env / default: nothing leaks
        assert kernel_dispatch._STATE["mode"] is None
        assert kernel_dispatch.current_mode() == "cache_only"
        assert kernel_dispatch.cache_path() == _path()
        assert model.paged_block_c == "auto"
        # running the first engine's programs re-installs its state
        a.generate_all([np.arange(5)], max_new_tokens=2)
        assert kernel_dispatch.current_mode() == "off"
        assert kernel_dispatch.cache_path() == pa_path
        assert model.paged_block_c == 16
        for bad in (dict(autotune_mode="sometimes"), dict(paged_block_c=0),
                    dict(paged_block_c=True)):
            with pytest.raises(ValueError):
                InferenceEngineV2(model, dict(dtype="float32", **bad),
                                  device="cpu")

    def test_training_autotune_block_sets_the_state(self, tmp_path):
        cfg = GPT2Config(n_layer=1, n_head=2, d_model=64, max_seq_len=16,
                         vocab_size=64, dtype="float32")
        base = {"train_batch_size": 2,
                "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
        p = str(tmp_path / "engine.json")
        deepspeed_tpu_torch.initialize(
            model=GPT2(cfg, device="cpu"), device="cpu", config={
                **base, "autotune": {"mode": "cache_only", "cache_path": p,
                                     "chain_lengths": [4, 12], "reps": 2}})
        assert kernel_dispatch.current_mode() == "cache_only"
        assert kernel_dispatch.cache_path() == p
        assert kernel_dispatch._STATE["chain_lengths"] == (4, 12)
        assert kernel_dispatch._STATE["reps"] == 2
        deepspeed_tpu_torch.initialize(model=GPT2(cfg, device="cpu"),
                                       device="cpu", config=base)
        assert kernel_dispatch._STATE["mode"] is None
        assert kernel_dispatch.cache_path() == _path()
        assert kernel_dispatch._STATE["chain_lengths"] == (8, 24)
        for bad in ({"mode": "always"}, {"chain_lengths": [8, 4]},
                    {"reps": 0}):
            with pytest.raises(DeepSpeedConfigError):
                deepspeed_tpu_torch.initialize(
                    model=GPT2(cfg, device="cpu"), device="cpu",
                    config={**base, "autotune": bad})
        with pytest.raises(NotImplementedError, match="M14, autotuning"):
            deepspeed_tpu_torch.initialize(
                model=GPT2(cfg, device="cpu"), device="cpu",
                config={**base, "parallelism": "auto"})


# ---------------------------------------------------------------- streams


def test_seeded_prefix_cache_winner_streams_match_jax():
    """Both engines "auto" with a seeded ``prefix_cache`` winner from one
    file: the cache turns on in both, and the fp32 greedy streams and the
    tree's counters equal the JAX engine's; a cold file leaves it off."""
    jm = JLlama(dataclasses.replace(J_TINY, dtype="float32"))
    params = jm.init(jax.random.key(0))
    pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
               device="cpu", dtype=torch.float32)
    pm.load_state_dict(llama_params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu", torch.float32))
    conf = dict(dtype="float32", kv_block_size=8, prompt_bucket=16,
                max_batch_size=4, splitfuse_tokens=16, num_kv_blocks=64,
                decode_steps_per_dispatch=2, autotune_mode="cache_only",
                autotune_cache=_path())
    assert InferenceEngineV2(pm, conf, device="cpu").prefix_cache is None
    _seed_both("prefix_cache", "B4,NB64,BS8", "float32",
               {"enabled": 1, "min_match_blocks": 1,
                "evict_watermark_pct": 0})
    # the cold engine's miss is memoised for the process (as in JAX): a
    # fresh state reads the seeded file
    kernel_dispatch.reset()
    port = InferenceEngineV2(pm, conf, device="cpu")
    jeng = JEngine(jm, params=params, config=dict(conf, paged_kernel=False))
    assert port.prefix_cache is not None and jeng.prefix_cache is not None
    rs = np.random.RandomState(0)
    template = rs.randint(0, 512, (17,)).astype(np.int32)
    for _ in range(3):
        p = np.concatenate([template, rs.randint(0, 512, (6,))]).astype(
            np.int32)
        got = port.generate_all([p], max_new_tokens=5)[0]
        want = jeng.generate_all([p], max_new_tokens=5)[0]
        np.testing.assert_array_equal(got, np.asarray(want))
    stats = port.prefix_cache.stats()
    assert stats == jeng.prefix_cache.stats() and stats["hits"] >= 2
