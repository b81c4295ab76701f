"""The port's PRNG (deepspeed_tpu_torch/utils/prng.py) held against
``jax.random`` bitwise under the installed JAX's default
(``jax_threefry_partitionable``): ``split``, 32-bit ``bits`` and fp32
``uniform`` over several keys, shapes and ranges, a row block of a draw
from its flat offset; and the training engine's key, which JAX folds
after every optimizer step: after 3 ``train_batch`` steps of a tiny fp32
GPT-2 at ZeRO 0, gas 1 and 2, the port's ``rng_data`` and the one its tag
holds equal the JAX engine's and its tag's."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import GPT2 as JGPT2
from deepspeed_tpu.models import GPT2Config as JGPT2Config
from deepspeed_tpu.utils import groups as jgroups
from deepspeed_tpu_torch.models import GPT2, GPT2Config
from deepspeed_tpu_torch.utils import groups as tgroups
from deepspeed_tpu_torch.utils import prng

SEEDS = [0, 1, 7, 2 ** 31 - 2]
SHAPES = [(1,), (5,), (37, 8), (3, 4, 5)]
RANGES = [(0.0, 1.0), (0.99, 1.01), (1e-20, 1.0 - 1e-20), (-3.0, 2.5)]


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bitwise(seed):
    key = jax.random.key(seed)
    for n in (1, 2, 24):
        want = np.asarray(jax.random.key_data(jax.random.split(key, n)))
        got = prng.split(prng.key_data(seed), n)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_bitwise(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.key(seed), shape,
                                      jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(
        prng.random_bits(prng.key_data(seed), shape).numpy(), want)


@pytest.mark.parametrize("lo,hi", RANGES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         jnp.float32, lo, hi))
    got = prng.uniform(prng.key_data(seed), shape, lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", RANGES[:2])
def test_uniform_rows_of_a_larger_draw(lo, hi):
    """Rows 32-63 of a (64, 4096) draw, from their flat offset."""
    whole = np.asarray(jax.random.uniform(jax.random.key(3), (64, 4096),
                                          jnp.float32, lo, hi))
    part = prng.uniform(prng.key_data(3), (32, 4096), lo, hi,
                        offset=32 * 4096).numpy()
    np.testing.assert_array_equal(part, whole[32:])


CFG = dict(n_layer=2, n_head=4, d_model=32, max_seq_len=32, vocab_size=128,
           dtype="float32", remat=False, use_flash_attention=False)


def _config(gas):
    return {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": gas, "steps_per_print": 0,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "zero_optimization": {"stage": 0}}


def _tag_rng(path):
    """The one chunk of ``rng_data`` in a world-size-1 tag's shard."""
    with np.load(path) as z:
        return np.asarray(z["rng_data#0.0"])


@pytest.mark.parametrize("gas", [1, 2])
def test_engine_key_after_steps_matches_jax(gas, tmp_path):
    rs = np.random.RandomState(gas)
    batches = [{"input_ids": rs.randint(0, 128, (2 * gas, 32))
                .astype(np.int32)} for _ in range(3)]
    jgroups.reset()
    topo = jgroups.initialize(jgroups.TopologyConfig(),
                              devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(model=JGPT2(JGPT2Config(**CFG)),
                                        topology=topo, config=_config(gas))
    tgroups.reset()
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=GPT2(GPT2Config(**CFG), device="cpu"), config=_config(gas),
        device="cpu")
    seen = []
    for b in batches:
        jeng.train_batch(b)
        eng.train_batch(b)
        want = np.asarray(jax.random.key_data(jeng.state["rng"]))
        np.testing.assert_array_equal(eng.rng_data, want)
        seen.append(want.tolist())
    assert len({tuple(w) for w in seen}) == 3     # a new key every step
    jeng.save_checkpoint(str(tmp_path / "jax"), tag="t")
    eng.save_checkpoint(str(tmp_path / "port"), tag="t")
    jgroups.reset()
    jtag = _tag_rng(os.path.join(tmp_path, "jax", "t", "shard-0.npz"))
    ptag = _tag_rng(os.path.join(tmp_path, "port", "t", "shard-0.npz"))
    np.testing.assert_array_equal(ptag, jtag)
    np.testing.assert_array_equal(ptag, seen[-1])
