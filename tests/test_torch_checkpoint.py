"""The port's checkpoints (deepspeed_tpu_torch: runtime/checkpoint_engine/,
runtime/engine.py save_checkpoint / load_checkpoint, ops/native/
ckpt_writer.py, checkpoint/universal.py, utils/prng.py) held against the
JAX package on the CPU, at world size 1, on a tiny fp32 GPT-2.

One JAX engine (one device, ZeRO-2) saves after a step; the port loads
that tag at every ZeRO stage and takes the next step; the port's tags
load back into the same JAX engine, which takes the step after. The
losses agree within rtol 2e-5 and the masters within a relative error
norm of 1e-4 (S2's tolerances: fp32 sums in another order); loaded state
equals the saved arrays bitwise. A port engine that loads the JAX tag and
saves at once writes the JAX file: the same key set, index, header and
CRCs. The port-only cases (cross-stage loads, GPT2MoE, every engine,
snapshot isolation of an async save) hold resumed runs bitwise to the
uninterrupted ones."""

import os
import threading

import numpy as np
import pytest

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import universal as juni
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.models import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.runtime.checkpoint_engine import serialization as jser
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.checkpoint import universal as tuni
from deepspeed_tpu_torch.models import GPT2, GPT2Config, GPT2MoE, GPT2MoEConfig
from deepspeed_tpu_torch.runtime import config as tconfig
from deepspeed_tpu_torch.runtime.checkpoint_engine import manager
from deepspeed_tpu_torch.runtime.checkpoint_engine import serialization as ser
from deepspeed_tpu_torch.runtime.checkpoint_engine.engines import (
    ENGINES, NoneCheckpointEngine)
from deepspeed_tpu_torch.utils import groups as tgroups
from deepspeed_tpu_torch.utils import prng

CFG = dict(n_layer=2, n_head=4, d_model=32, max_seq_len=32, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)
MOE = dict(CFG, num_experts=2, moe_top_k=1, moe_backend="ragged")
MICRO = 2
LOSS_RTOL = 2e-5
MASTER_REL_NORM = 1e-4


def _config(stage=2, typ="sync", **over):
    return {"train_micro_batch_size_per_gpu": MICRO, "steps_per_print": 0,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 0.5, "zero_optimization": {"stage": stage},
            "checkpoint_engine": {"type": typ}, **over}


def _batches(n, rows=MICRO, seed=0):
    rs = np.random.RandomState(seed)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (rows, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(n)]


BATCHES = _batches(4)


def _port(stage=2, typ="sync", seed=0, moe=False, **over):
    tgroups.reset()
    model = (GPT2MoE(GPT2MoEConfig(**MOE), device="cpu", seed=seed) if moe
             else GPT2(GPT2Config(**CFG), device="cpu", seed=seed))
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=_config(stage, typ, **over), device="cpu")
    return engine


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return {k: np.asarray(v) for k, v in out.items()}


def _rel_norm(got, want):
    num = sum(float(np.square(got[n] - want[n]).sum()) for n in want)
    den = sum(float(np.square(want[n]).sum()) for n in want)
    return (num / den) ** 0.5


def _port_master(engine):
    return {n: m.numpy().copy() for n, m in engine.gathered_master().items()}


def _state(engine):
    """Every saved leaf of a port engine as numpy (master, m, v, scale,
    steps, rng words)."""
    st = engine.state
    out = {f"master.{n}": m.numpy().copy() for n, m in st["master"].items()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": x.numpy().copy()
                    for n, x in st["opt"][k].items()})
    out.update({f"scale.{k}": v.numpy().copy()
                for k, v in st["scale"].items()})
    out["opt_step"] = st["opt"]["step"].numpy().copy()
    out["step"] = np.asarray(st["step"])
    out["skipped"] = np.asarray(engine.skipped_steps)
    out["rng"] = np.asarray(engine.rng_data).copy()
    return out


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine (one device, ZeRO-2): one step, a save, the next
    step; returns it with its tag dir, the next step's loss and
    master."""
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(),
                              devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2(JGPT2Config(**CFG)), topology=topo, config=_config())
    engine.train_batch(BATCHES[0])
    d = str(tmp_path_factory.mktemp("jax_tag"))
    engine.save_checkpoint(d)
    saved = {k: np.asarray(v) for k, v in jser.load_sharded(
        os.path.join(d, "global_step1"))[0].items()}
    loss = float(engine.train_batch(BATCHES[1]))
    master = _flat(jax.tree.map(np.asarray, engine.state["master"]))
    return dict(engine=engine, dir=d, saved=saved, loss=loss, master=master)


# ----------------------------------------------------------- JAX <-> port


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_jax_tag_loads_into_port(jax_run, stage):
    """A JAX-saved tag into a port engine at each ZeRO stage: the state
    equals the saved arrays bitwise, the next step's loss and master
    match the JAX engine's next step."""
    engine = _port(stage, seed=11)
    path, client = engine.load_checkpoint(jax_run["dir"])
    assert path == os.path.join(jax_run["dir"], "global_step1")
    assert client == {} and engine.global_step == 1
    assert engine.micro_steps == 1
    saved = jax_run["saved"]
    for n, m in engine.state["master"].items():
        assert np.array_equal(m.numpy(),
                              saved[f"master/{n.replace('.', '/')}"]), n
        for k in ("m", "v"):
            assert np.array_equal(engine.state["opt"][k][n].numpy(),
                                  saved[f"opt/{k}/{n.replace('.', '/')}"])
    assert int(engine.state["opt"]["step"]) == int(saved["opt/step"]) == 1
    assert engine.state["step"] == int(saved["step"])
    assert np.array_equal(engine.rng_data, saved["rng_data"])
    loss = float(engine.train_batch(BATCHES[1]))
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=LOSS_RTOL)
    assert _rel_norm(_port_master(engine), jax_run["master"]) \
        <= MASTER_REL_NORM


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_port_tag_loads_into_jax(jax_run, tmp_path, stage):
    """A port-saved tag (the JAX tag resumed for one step at each stage)
    into the JAX engine: its state equals the port's bitwise and its next
    step's loss and master match the port's next step."""
    engine = _port(stage, seed=12)
    engine.load_checkpoint(jax_run["dir"])
    engine.train_batch(BATCHES[1])
    tag = engine.save_checkpoint(str(tmp_path))
    assert tag == "global_step2"
    want = _port_master(engine)
    jeng = jax_run["engine"]
    path, _ = jeng.load_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "global_step2")
    assert jeng.global_step == 2
    got = _flat(jax.tree.map(np.asarray, jeng.state["master"]))
    for n in want:
        assert np.array_equal(got[n], want[n]), n
    for k in ("m", "v"):      # world 1: no stage partitions anything
        jm = _flat(jax.tree.map(np.asarray, jeng.state["opt"][k]))
        for n, m in engine.state["opt"][k].items():
            assert np.array_equal(jm[n], m.numpy()), (k, n)
    jloss = float(jeng.train_batch(BATCHES[2]))
    loss = float(engine.train_batch(BATCHES[2]))
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    jmaster = _flat(jax.tree.map(np.asarray, jeng.state["master"]))
    assert _rel_norm(_port_master(engine), jmaster) <= MASTER_REL_NORM


def _shard0(d, tag):
    return jser.load_file(os.path.join(d, tag, "shard-0.npz"))


@pytest.mark.parametrize("part", ["keys", "index", "header", "crc",
                                  "latest"])
def test_format_identity(jax_run, tmp_path_factory, part):
    """The JAX tag loaded into the port and saved at once: the port's
    shard-0.npz has the JAX one's key set, index entries (shape, dtype,
    chunk keys and starts), header (every field), CRC manifest, and the
    same 'latest' / '.latest_seq' files."""
    d = str(tmp_path_factory.mktemp(f"port_{part}"))
    engine = _port(2, seed=13)
    engine.load_checkpoint(jax_run["dir"])
    assert engine.save_checkpoint(d) == "global_step1"
    jflat, jheader = _shard0(jax_run["dir"], "global_step1")
    tflat, theader = _shard0(d, "global_step1")
    if part == "keys":
        assert set(tflat) == set(jflat)
        assert {k.split("#")[0] for k in tflat} == set(jax_run["saved"])
        assert all(k.endswith("#0.0") for k in tflat)
    elif part == "index":
        assert theader["extra"]["index"] == jheader["extra"]["index"]
    elif part == "header":
        assert set(theader) == set(jheader) == {"meta", "extra", "version",
                                                "crc"}
        assert theader["version"] == jheader["version"] == 2
        assert theader["meta"] == jheader["meta"]
        assert set(theader["extra"]) == set(jheader["extra"])
        assert theader["extra"]["user_extra"] == \
            jheader["extra"]["user_extra"]
    elif part == "crc":
        assert theader["crc"] == jheader["crc"]
        for k in jflat:
            assert tflat[k].dtype == jflat[k].dtype
            assert np.array_equal(tflat[k], jflat[k]), k
    else:
        for f in ("latest", ".latest_seq"):
            with open(os.path.join(d, f)) as a, \
                    open(os.path.join(jax_run["dir"], f)) as b:
                assert a.read() == b.read() != ""


@pytest.mark.parametrize("moe", [False, True], ids=["gpt2", "gpt2moe"])
def test_key_set_equals_jax_tree(moe):
    """The port's checkpoint keys are the JAX engine's tree paths: master
    and both moments of every parameter, opt/step, the scale state,
    step, skipped and rng_data."""
    model = (JGPT2MoE(JGPT2MoEConfig(**MOE)) if moe
             else JGPT2(JGPT2Config(**CFG)))
    params = jax.eval_shape(model.init, jax.random.key(0))
    paths = ["/".join(str(p.key) for p in path)
             for path, _ in jax.tree.leaves_with_path(params)]
    want = {f"{top}/{p}" for top in ("master", "opt/m", "opt/v")
            for p in paths}
    want |= {"opt/step", "scale/scale", "scale/good_steps", "step",
             "skipped", "rng_data"}
    engine = _port(moe=moe)
    tree, _ = engine._ckpt_tree()
    flat, meta = ser.flatten_state(tree)
    assert set(flat) == want and meta == {}
    # and in the JAX flattening order (sorted dict keys)
    jorder = [k for k, _ in jser.flatten_state(jax.tree.map(
        lambda x: 0, {"master": params, "opt": {"m": params, "v": params}}
    ))[1].items()]
    assert [k for k in flat if k.split("/")[0] in ("master", "opt")
            and k != "opt/step"] == jorder


@pytest.mark.parametrize("seed", [0, 1, 41, 2 ** 31 - 2, -7])
def test_rng_data_bitwise(seed):
    """The engine's rng_data is jax.random.key_data(key(seed + 1))."""
    want = np.asarray(jax.random.key_data(jax.random.key(seed + 1)))
    assert np.array_equal(prng.key_data(seed + 1), want)
    assert prng.key_data(seed + 1).dtype == want.dtype == np.uint32
    if seed == 0:
        assert np.array_equal(_port().rng_data, want)


@pytest.mark.parametrize("data", [0, 1, 2 * 1000003 + 2, 1000003 + 1,
                                  2 ** 32 - 1])
def test_fold_in_bitwise(data):
    key = jax.random.key(1)
    want = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
    assert np.array_equal(prng.fold_in(prng.key_data(1), data), want)


def test_universal_matches_jax(jax_run, tmp_path):
    """checkpoint/universal.py against the JAX module on the JAX tag:
    the same consolidated fp32 file, universal layout, streamed param and
    inspect listing."""
    d = jax_run["dir"]
    n_j = juni.consolidate_to_fp32(d, str(tmp_path / "j.npz"))
    n_t = tuni.consolidate_to_fp32(d, str(tmp_path / "t.npz"))
    assert n_t == n_j > 0
    cj = juni.load_consolidated(str(tmp_path / "j.npz"))
    ct = tuni.load_consolidated(str(tmp_path / "t.npz"))
    assert set(ct) == set(cj)
    assert all(np.array_equal(ct[k], cj[k]) for k in cj)
    ij = juni.ds_to_universal(d, str(tmp_path / "uj"))
    it = tuni.ds_to_universal(d, str(tmp_path / "ut"))
    assert it == ij
    for k in ("master/wte", "opt/v/blocks/wqkv", "rng_data"):
        assert np.array_equal(tuni.load_universal_param(str(tmp_path / "ut"),
                                                        k),
                              juni.load_universal_param(str(tmp_path / "uj"),
                                                        k))
    with open(tmp_path / "lj.txt", "w") as fj, \
            open(tmp_path / "lt.txt", "w") as ft:
        assert juni.inspect_checkpoint(d, file=fj) == \
            tuni.inspect_checkpoint(d, file=ft)
    assert (tmp_path / "lj.txt").read_text() == \
        (tmp_path / "lt.txt").read_text()
    assert tuni.main(["inspect", d]) == 0


# ------------------------------------------------------------ port only


def _run(engine, batches):
    return [float(engine.train_batch(b)) for b in batches]


@pytest.mark.parametrize("save_stage,load_stage", [(2, 0), (0, 3), (3, 1),
                                                   (1, 2)])
def test_cross_stage_world1(tmp_path, save_stage, load_stage):
    """A tag saved at one ZeRO stage resumes at another (world 1, the
    JAX tests/unit/test_checkpoint.py:79 cases): the state bitwise, the
    resumed losses bitwise the uninterrupted run's."""
    e1 = _port(save_stage)
    _run(e1, BATCHES[:2])
    e1.save_checkpoint(str(tmp_path))
    saved = _state(e1)
    want = _run(e1, BATCHES[2:])
    e2 = _port(load_stage, seed=21)
    e2.load_checkpoint(str(tmp_path))
    _assert_bitwise(_state(e2), saved)
    assert e2.global_step == 2 and e2.micro_steps == 2
    assert _run(e2, BATCHES[2:]) == want


def test_gpt2moe_save_load(tmp_path):
    """GPT2MoE at dp = 1: save, resume in a fresh engine, the same state
    and the uninterrupted run's losses."""
    e1 = _port(moe=True)
    _run(e1, BATCHES[:1])
    e1.save_checkpoint(str(tmp_path), client_state={"epoch": 3})
    saved = _state(e1)
    want = _run(e1, BATCHES[1:3])
    e2 = _port(moe=True, seed=5)
    path, client = e2.load_checkpoint(str(tmp_path))
    assert client == {"epoch": 3}
    _assert_bitwise(_state(e2), saved)
    assert _run(e2, BATCHES[1:3]) == want


@pytest.mark.parametrize("typ", sorted(ENGINES))
def test_every_engine_roundtrips(tmp_path, typ):
    """Every engine type in ENGINES (aliases included) saves and resumes
    bitwise; 'none' writes nothing and its load finds nothing."""
    e1 = _port(typ=typ)
    _run(e1, BATCHES[:1])
    tag = e1.save_checkpoint(str(tmp_path))
    e1.checkpoint_engine.wait()
    saved = _state(e1)
    e2 = _port(typ=typ, seed=8)
    if isinstance(e1.checkpoint_engine, NoneCheckpointEngine):
        assert os.listdir(tmp_path) == []
        assert e2.load_checkpoint(str(tmp_path)) == (None, {})
        return
    assert manager.read_latest(str(tmp_path)) == tag == "global_step1"
    assert e1.last_save["latest_s"] is not None
    e2.load_checkpoint(str(tmp_path))
    _assert_bitwise(_state(e2), saved)
    assert e1.checkpoint_engine.counters["saves"] == 1
    assert e1.checkpoint_engine.counters["fallbacks"] == 0
    e1.save_checkpoint_terminate()


def test_missing_checkpoint_returns_none(tmp_path):
    engine = _port()
    assert engine.load_checkpoint(str(tmp_path)) == (None, {})
    assert engine.load_checkpoint(str(tmp_path / "absent")) == (None, {})


def test_native_writer_direct(tmp_path):
    """The C++ writer pool, built with g++ from csrc/ckpt_writer.cpp,
    writes the bytes it is given (chunked pwrite over 4 threads)."""
    from deepspeed_tpu_torch.op_builder import CkptWriterBuilder
    from deepspeed_tpu_torch.ops.native.ckpt_writer import Writer
    w = Writer(threads=4, fsync=True)
    data = np.random.RandomState(0).bytes((1 << 20) + 3)
    p = str(tmp_path / "blob.bin")
    w.write(p, data)
    with open(p, "rb") as f:
        assert f.read() == data
    w.close()
    assert os.path.exists(CkptWriterBuilder().so_path())
    with pytest.raises(OSError):
        Writer(threads=2).write(str(tmp_path / "no" / "dir" / "x"), b"x")


def test_native_engine_raises_without_its_writer(monkeypatch):
    """A writer that cannot be built raises from the engine's
    constructor: no quiet switch to the Python writer."""
    from deepspeed_tpu_torch.op_builder import builder
    monkeypatch.setattr(builder.shutil, "which", lambda name: None)
    monkeypatch.setattr(builder, "BUILD_DIR", "/nonexistent-build-dir")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _port(typ="native")


@pytest.mark.parametrize("typ", ["async", "native"])
def test_async_save_is_a_snapshot(tmp_path, monkeypatch, typ):
    """An async save held back until the next train_batch has updated
    master, m and v in place still writes the saved step's state: the
    engine hands the writer host copies, not views of live tensors."""
    e1 = _port(typ=typ)
    _run(e1, BATCHES[:1])
    gate = threading.Event()
    write = e1.checkpoint_engine._write_payload

    def held(path, tree, extra):
        assert gate.wait(30)
        return write(path, tree, extra)
    monkeypatch.setattr(e1.checkpoint_engine, "_write_payload", held)
    e1.save_checkpoint(str(tmp_path))
    saved = _state(e1)
    _run(e1, BATCHES[1:2])        # updates the state in place
    assert not np.array_equal(_state(e1)["master.wte"], saved["master.wte"])
    gate.set()
    e1.checkpoint_engine.wait()
    e2 = _port(seed=9)
    e2.load_checkpoint(str(tmp_path))
    _assert_bitwise(_state(e2), saved)


def test_reshape_keeps_global_batch_unless_explicit(tmp_path):
    """A tag of global batch 4 resumed with micro 2 at dp = 1: gas
    becomes 2 and micro_steps realign (global_step * gas); an explicit
    train_batch_size in the config wins."""
    e1 = _port(gradient_accumulation_steps=2)
    assert e1.config.train_batch_size == 4
    _run(e1, _batches(2, rows=4))
    e1.save_checkpoint(str(tmp_path))
    e2 = _port()
    assert e2.config.gradient_accumulation_steps == 1
    e2.load_checkpoint(str(tmp_path))
    assert e2.config.gradient_accumulation_steps == 2
    assert e2.config.train_batch_size == 4
    assert e2.micro_steps == 4
    e3 = _port(train_batch_size=2)
    e3.load_checkpoint(str(tmp_path))
    assert e3.config.gradient_accumulation_steps == 1
    tgroups.reset()
    e4 = _port(train_micro_batch_size_per_gpu=3)
    with pytest.raises(ValueError, match="global batch size 4"):
        e4.load_checkpoint(str(tmp_path))


@pytest.mark.parametrize("block", [
    {"hot_tier": True}, {"preempt_drain": True}])
def test_hot_tier_raises_naming_m14(block):
    with pytest.raises(NotImplementedError, match="M14, hot tier"):
        tconfig.DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                                 "checkpoint_engine": block})


@pytest.mark.parametrize("typ", sorted(ENGINES))
def test_checkpoint_engine_block_accepted(typ):
    c = tconfig.DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                                 "checkpoint_engine": {"type": typ,
                                                       "keep_last": 2}})
    assert c.checkpoint_engine.type == typ
    assert c.checkpoint_engine.keep_last == 2
    with pytest.raises(tconfig.DeepSpeedConfigError):
        tconfig.DeepSpeedConfig({"train_micro_batch_size_per_gpu": 2,
                                 "checkpoint_engine": {"keep_last": -1}})
