"""K12, the port's blockwise int8 quantization (ops/cuda/quantization.py)
and the quantized collectives over it (comm/quantized.py), held against
the JAX package on CPU, bitwise:

- the plain versions of the quantize and dequantize kernels against JAX
  ``quantize_blockwise`` / ``dequantize_blockwise``, both the jnp path
  (``use_pallas=False``) and the Pallas kernel in interpret mode, each
  compiled as every JAX caller runs it: codes, scales and dequantized
  values identical (the scale as absmax times the fp32 reciprocal of 127,
  the product XLA folds the division into; IEEE division for the codes,
  round half to even, the same fp32 products). Eager jnp divides by 127
  and so differs by an ulp in some scales; a test pins that down;
- the four quantized collectives (``quantized_reduce_scatter``,
  ``quantized_all_gather``, ``dcn_precision_clamp``,
  ``all_to_all_quant_reduce``) in gloo worlds of 2 and 4 processes against
  the same calls in a JAX ``shard_map`` on the virtual mesh, with the
  comms logger's int8 wire bytes. The reduce-scatters sum the dequantized
  pieces in rank order as XLA compiles the JAX sum (acc = fma(q, s, acc)
  from 0), so they too are bitwise."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.comm import quantized as jquantized
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.ops.cuda import quantization as tq
from test_torch_comm import jax_program
from test_torch_dist_worker import quant_program, run_world

WORLDS = (2, 4)


def _x(shape, seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    x *= np.exp(rs.uniform(-6, 6, shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[:min(flat.size, 2048)] = 0.0           # an all-zero block: scale 1
    flat[-3:] = [0.5, -2.5, 1e-38]               # ties and a denormal-ish
    return x


def _jit_quantize(jx, block, use_pallas):
    meta = {}

    def f(a):
        q, s, m = jq.quantize_blockwise(a, block, use_pallas=use_pallas,
                                        interpret=True)
        meta.update(m)
        return q, s

    q, s = jax.jit(f)(jx)
    return q, s, meta


def test_eager_jnp_scale_divides():
    """Eager jnp computes the scale as absmax / 127 (IEEE division), the
    compiled programs (and the port) as absmax * fp32(1/127): the two
    differ by an ulp where the quotient rounds differently, and the
    codes of this input do not change."""
    x = _x((2, 8000), seed=2)[0]
    eq, es, _ = jq.quantize_blockwise(jnp.asarray(x), 2048,
                                      use_pallas=False)
    q, s, _ = tq.quantize_blockwise(torch.from_numpy(x), 2048)
    blocks = np.pad(x, (0, 4 * 2048 - x.size)).reshape(4, 2048)
    am = np.abs(blocks).max(-1, keepdims=True)
    np.testing.assert_array_equal(np.asarray(es),
                                  np.where(am > 0, am / np.float32(127), 1))
    np.testing.assert_array_equal(
        s.numpy(), np.where(am > 0, am * (np.float32(1) / np.float32(127)),
                            1))
    assert (s.numpy() != np.asarray(es)).sum() == 1
    np.testing.assert_array_equal(q.numpy(), np.asarray(eq))


CASES = [((3, 5000), 2048, "float32"), ((4096,), 2048, "float32"),
         ((7, 333), 64, "float32"), ((2, 3000), 2048, "bfloat16"),
         ((1000,), 256, "bfloat16"), ((5,), 2048, "float32")]


@pytest.mark.parametrize("shape,block,dtype", CASES)
@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp", "pallas_interpret"])
def test_plain_kernels_bitwise_match_jax(shape, block, dtype, use_pallas):
    x = _x(shape, seed=block + len(shape))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(dtype)
    jqq, js, jmeta = _jit_quantize(jx, block, use_pallas)
    q, s, meta = tq.quantize_blockwise(tx, block)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (meta["shape"], meta["pad"]) == (tuple(jmeta["shape"]),
                                            jmeta["pad"])
    assert q.dtype == torch.int8 and s.shape == (q.shape[0], 1)
    jd = jax.jit(lambda a, b: jq.dequantize_blockwise(
        a, b, jmeta, use_pallas=use_pallas, interpret=True))(jqq, js)
    d = tq.dequantize_blockwise(q, s, meta)
    assert d.dtype == tx.dtype and d.shape == tx.shape
    np.testing.assert_array_equal(d.float().numpy(),
                                  np.asarray(jd, np.float32))


def test_rows_quantize_each_row_on_its_own():
    """R rows in one call equal R separate flat calls (the reduce-scatter
    pieces), codes and dequantized rows."""
    x = torch.from_numpy(_x((3, 2100), seed=5))
    q, s = tq.quantize_rows(x, 2048)
    assert q.shape == (6, 2048)
    for r in range(3):
        qr, sr, meta = tq.quantize_blockwise(x[r], 2048)
        assert torch.equal(q[2 * r:2 * r + 2], qr)
        assert torch.equal(s[2 * r:2 * r + 2], sr)
        assert torch.equal(tq.dequantize_rows(q, s, 3, 2100,
                                              torch.float32)[r],
                           tq.dequantize_blockwise(qr, sr, meta))


def _inputs(world):
    x = _x((world, 8000), seed=world)
    return {"x": x}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {w: run_world("quant", w, _inputs(w),
                         tmp_path_factory.mktemp(f"quant{w}"))
            for w in WORLDS}


@pytest.fixture(scope="module")
def jax_results():
    return {w: jax_program(quant_program, jquantized, _inputs(w)["x"], w)
            for w in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_collectives_bitwise_match_jax(worlds, jax_results, world):
    ref, _ = jax_results[world]
    outs = worlds[world]
    assert set(outs[0]["res"]) == set(ref)
    for name, want in ref.items():
        for rank, o in enumerate(outs):
            np.testing.assert_array_equal(o["res"][name], want[rank],
                                          err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("world", WORLDS)
def test_wire_bytes_match_jax(worlds, jax_results, world):
    _, ref = jax_results[world]
    assert ref["quantized_all_gather"]["data"] == [2, 8000 + 4 * 4
                                                   + 100 + 4 * 2]
    for o in worlds[world]:
        assert o["log"] == ref
