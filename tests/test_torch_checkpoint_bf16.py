"""bfloat16 checkpoint leaves (Adam ``moments_dtype="bfloat16"``) between
the port and the JAX package, and the top-level names the JAX package
exports (``__version__``, ``init_inference``, ``add_config_arguments``,
the GPT-2 presets).

The port writes a bf16 leaf as its two-byte words under the npy descr
``'<V2'`` and the index dtype "bfloat16", as numpy and the JAX package
write an ml_dtypes bfloat16 leaf, and reads such an entry back to a bf16
tensor without ml_dtypes.

The JAX package cannot load a tag holding a bf16 leaf, its own included:
its reassembly buffer is ``np.empty(shape, "bfloat16")`` and numpy has no
cast from the ``|V2`` records ``np.load`` returns ("No cast function
available"). ``test_jax_refuses_its_own_bf16_tag`` pins that; to load the
port's tag into the JAX engine the test views the records as ml_dtypes
bfloat16 after the JAX ``load_file`` has checked their CRCs
(``_jax_bf16_view``), which changes no byte.
"""

import argparse
import os
import zipfile

import ml_dtypes
import numpy as np
import pytest

import jax

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.checkpoint import universal as juni
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.ops.optimizers import FusedAdam as JFusedAdam
from deepspeed_tpu.runtime.checkpoint_engine import serialization as jser
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.checkpoint import universal as tuni
from deepspeed_tpu_torch.models import GPT2, GPT2Config
from deepspeed_tpu_torch.ops.optimizers import FusedAdam
from deepspeed_tpu_torch.runtime.checkpoint_engine import serialization as ser
from deepspeed_tpu_torch.utils import groups as tgroups

import torch

CFG = dict(n_layer=2, n_head=4, d_model=32, max_seq_len=32, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)
MICRO = 2
LOSS_RTOL = 2e-5
ADAM = dict(lr=1e-3, weight_decay=0.01, moments_dtype="bfloat16")


def _config(stage):
    return {"train_micro_batch_size_per_gpu": MICRO, "steps_per_print": 0,
            "gradient_clipping": 0.5, "zero_optimization": {"stage": stage}}


def _batches(n):
    rs = np.random.RandomState(0)
    return [{"input_ids": rs.randint(0, CFG["vocab_size"],
                                     (MICRO, CFG["max_seq_len"]))
             .astype(np.int32)} for _ in range(n)]


BATCHES = _batches(3)


def _port(stage, seed):
    tgroups.reset()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2(GPT2Config(**CFG), device="cpu", seed=seed),
        optimizer=FusedAdam(**ADAM), config=_config(stage), device="cpu")
    return engine


def _jax_engine():
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(),
                              devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(
        model=JGPT2(JGPT2Config(**CFG)), topology=topo,
        optimizer=JFusedAdam(**ADAM), config=_config(2))
    return engine


def _words(x):
    """bf16 words of a port tensor or a JAX / ml_dtypes array."""
    if torch.is_tensor(x):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "blocks"}
    out.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    return out


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine with bf16 moments: one step, a save, the next
    step's loss."""
    engine = _jax_engine()
    engine.train_batch(BATCHES[0])
    d = str(tmp_path_factory.mktemp("jax_bf16"))
    engine.save_checkpoint(d)
    loss = float(engine.train_batch(BATCHES[1]))
    return dict(engine=engine, dir=d, loss=loss)


def _jax_bf16_view(monkeypatch):
    """The JAX loader with its ``|V2`` records viewed as ml_dtypes
    bfloat16 (after its own CRC check)."""
    real = jser.load_file

    def load_file(path, verify=True):
        flat, header = real(path, verify)
        return ({k: (v.view(ml_dtypes.bfloat16) if v.dtype == np.dtype("V2")
                     else v) for k, v in flat.items()}, header)
    monkeypatch.setattr(jser, "load_file", load_file)


def test_jax_refuses_its_own_bf16_tag(jax_run):
    """The reference quirk: the JAX engine finds no loadable generation
    in its own bf16-moment tag (numpy cannot cast ``|V2`` to bfloat16)."""
    with pytest.raises(jser.CheckpointCorruptionError):
        _jax_engine().load_checkpoint(jax_run["dir"])


@pytest.mark.parametrize("stage", [0, 2, 3])
def test_jax_bf16_tag_loads_into_port(jax_run, stage):
    """A JAX tag with bf16 moments into the port: the moments are bf16
    and bitwise the saved words; the next loss at rtol 2e-5."""
    engine = _port(stage, seed=11)
    engine.load_checkpoint(jax_run["dir"])
    flat, _ = ser.load_sharded(os.path.join(jax_run["dir"], "global_step1"))
    for k in ("m", "v"):
        for n, x in engine.state["opt"][k].items():
            assert x.dtype == torch.bfloat16, (k, n)
            want = flat[f"opt/{k}/{n.replace('.', '/')}"]
            assert want.dtype == torch.bfloat16
            assert np.array_equal(_words(x), _words(want)), (k, n)
    loss = float(engine.train_batch(BATCHES[1]))
    np.testing.assert_allclose(loss, jax_run["loss"], rtol=LOSS_RTOL)


def test_port_bf16_tag_loads_into_jax(jax_run, tmp_path, monkeypatch):
    """A port tag with bf16 moments into the JAX engine: the JAX moments
    bitwise the port's, the next step's loss at rtol 2e-5."""
    engine = _port(2, seed=12)
    engine.load_checkpoint(jax_run["dir"])
    engine.train_batch(BATCHES[1])
    assert engine.save_checkpoint(str(tmp_path)) == "global_step2"
    _jax_bf16_view(monkeypatch)
    jeng = _jax_engine()
    path, _ = jeng.load_checkpoint(str(tmp_path))
    assert path == os.path.join(str(tmp_path), "global_step2")
    for k in ("m", "v"):
        jm = _flat(jeng.state["opt"][k])
        for n, x in engine.state["opt"][k].items():
            assert jm[n].dtype == jax.numpy.bfloat16
            assert np.array_equal(_words(jm[n]), _words(x)), (k, n)
    jloss = float(jeng.train_batch(BATCHES[2]))
    loss = float(engine.train_batch(BATCHES[2]))
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)


@pytest.mark.parametrize("part", ["records", "index"])
def test_bf16_format_identity(jax_run, tmp_path, part):
    """The JAX tag loaded into the port and saved at once: every npz
    record of shard-0 (the bf16 moments' ``'<V2'`` records included) is
    byte-identical to the JAX tag's, and so is the index (dtype
    "bfloat16")."""
    engine = _port(2, seed=13)
    engine.load_checkpoint(jax_run["dir"])
    engine.save_checkpoint(str(tmp_path))
    a = os.path.join(jax_run["dir"], "global_step1", "shard-0.npz")
    b = os.path.join(str(tmp_path), "global_step1", "shard-0.npz")
    if part == "records":
        with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
            names = [n for n in za.namelist() if n != "__meta__.npy"]
            assert sorted(names) == sorted(
                n for n in zb.namelist() if n != "__meta__.npy")
            words = [n for n in names if "opt%2Fm" in n]
            assert words and b"'descr': '<V2'" in za.read(words[0])[:128]
            for n in names:
                assert za.read(n) == zb.read(n), n
    else:
        ja = jser.load_file(a)[1]["extra"]["index"]
        ta = ser.load_file(b)[1]["extra"]["index"]
        assert ta == ja
        assert ta["opt/m/wte"]["dtype"] == "bfloat16"
        assert ta["master/wte"]["dtype"] == "float32"


def test_universal_tools_on_bf16_tag(jax_run, tmp_path, monkeypatch):
    """checkpoint/universal.py on a port tag with bf16 moments against
    the JAX module on the JAX tag (its records viewed as bfloat16): the
    same universal index, byte-identical ``.npy`` files, the same streamed
    words and the same inspect listing."""
    engine = _port(2, seed=14)
    engine.load_checkpoint(jax_run["dir"])
    engine.save_checkpoint(str(tmp_path / "port"))
    _jax_bf16_view(monkeypatch)
    it = tuni.ds_to_universal(str(tmp_path / "port"), str(tmp_path / "ut"))
    ij = juni.ds_to_universal(jax_run["dir"], str(tmp_path / "uj"))
    assert it == ij
    assert it["opt/m/wte"]["dtype"] == "bfloat16"
    for k, e in ij.items():
        assert (tmp_path / "ut" / e["file"]).read_bytes() == \
            (tmp_path / "uj" / e["file"]).read_bytes(), k
    got = tuni.load_universal_param(str(tmp_path / "ut"), "opt/v/wte")
    assert np.array_equal(got.view(np.int16), _words(
        engine.state["opt"]["v"]["wte"]))
    with open(tmp_path / "lj.txt", "w") as fj, \
            open(tmp_path / "lt.txt", "w") as ft:
        assert tuni.inspect_checkpoint(str(tmp_path / "port"), file=ft) == \
            juni.inspect_checkpoint(jax_run["dir"], file=fj)
    listing = (tmp_path / "lt.txt").read_text()
    assert listing == (tmp_path / "lj.txt").read_text()
    assert " bfloat16 " in listing


def test_bf16_leaf_roundtrip_without_ml_dtypes(tmp_path):
    """A bf16 tensor through save_file / load_file and the sharded
    layout: the same words back (a V2 record in load_file, a bf16 tensor
    from the sharded reassembly)."""
    x = torch.randn(3, 5).to(torch.bfloat16)
    ser.save_file(str(tmp_path / "a.npz"), {"x": x})
    flat, _ = ser.load_file(str(tmp_path / "a.npz"))
    assert flat["x"].dtype == np.dtype("V2")
    assert np.array_equal(flat["x"].view(np.int16), _words(x))
    chunks, index, _ = ser.extract_local_chunks(
        {"x": x}, topology=tgroups.ParallelTopology(world_size=1, rank=0))
    assert index["x"]["dtype"] == "bfloat16"
    os.makedirs(tmp_path / "t")
    ser.save_file(str(tmp_path / "t" / "shard-0.npz"), chunks,
                  extra_meta={"index": index})
    out, _ = ser.load_sharded(str(tmp_path / "t"))
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"], x)


# ------------------------------------------------------ top-level names


def test_version_equals_jax():
    assert deepspeed_tpu_torch.__version__ == deepspeed_tpu.__version__


def test_add_config_arguments_matches_jax():
    """The same three arguments with the same defaults and parses."""
    def actions(mod):
        p = mod.add_config_arguments(argparse.ArgumentParser())
        return ({a.dest: (a.default, a.type, type(a).__name__)
                 for a in p._actions if a.dest != "help"},
                vars(p.parse_args(["--deepspeed", "--deepspeed_config",
                                   "c.json", "--local_rank", "3"])))
    assert actions(deepspeed_tpu_torch) == actions(deepspeed_tpu)
    assert set(actions(deepspeed_tpu_torch)[0]) == {
        "deepspeed", "deepspeed_config", "local_rank"}


def test_init_inference_raises_naming_m9():
    with pytest.raises(NotImplementedError, match="Queue 1, M9"):
        deepspeed_tpu_torch.init_inference(None, dtype="bfloat16")


@pytest.mark.parametrize("name", ["GPT2_125M", "GPT2_1_3B"])
def test_gpt2_presets_exported(name):
    from deepspeed_tpu import models as jmodels
    from deepspeed_tpu_torch import models as tmodels
    want = getattr(jmodels, name)
    got = getattr(tmodels, name)
    assert getattr(deepspeed_tpu_torch, name) is got
    for f in ("vocab_size", "max_seq_len", "n_layer", "n_head", "d_model"):
        assert getattr(got, f) == getattr(want, f), f
