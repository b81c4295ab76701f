"""The port's weight-only quantization (``ops/int8_weights.py``) held
against the JAX package's on CPU: ``quantize_leaf`` codes and scales
bitwise at int8, int4 and odd-In int4 (the int8 fallback); the int4
packing; which leaves ``quantize_tree`` takes (never the router);
``dequant_tree(keep=)``; ``cast_unquantized``; the per-layer slice of a
quantized leaf against JAX ``Llama._layer_slice`` (the leading-1 scale of
an (L, D) norm leaf); a model built quantized equals ``quantize_tree`` of
the float model; quantized JAX trees carry across the converters."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models.llama import LLAMA_TINY as J_TINY
from deepspeed_tpu.models.llama import Llama as JLlama
from deepspeed_tpu.ops import int8_weights as jiw
from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch import Llama, Mixtral
from deepspeed_tpu_torch.models import (LLAMA_TINY, MIXTRAL_TINY,
                                        llama_params_from_numpy,
                                        mixtral_params_from_numpy)
from deepspeed_tpu_torch.ops import int8_weights as iw


def _assert_same_node(port, jax_node):
    assert type(port).__name__ == type(jax_node).__name__
    assert port.q.dtype == torch.int8 and port.scale.dtype == torch.float32
    np.testing.assert_array_equal(port.q.numpy(), np.asarray(jax_node.q))
    np.testing.assert_array_equal(port.scale.numpy(),
                                  np.asarray(jax_node.scale))


@pytest.mark.parametrize("bits,shape", [
    (8, (3, 64, 48)), (4, (3, 64, 48)), (4, (2, 33, 40)), (8, (96, 40))])
def test_quantize_leaf_is_bitwise_jax(bits, shape):
    """Codes and scales bitwise; odd In at int4 falls back to int8; a zero
    column keeps scale 1 and codes 0; ties round half to even."""
    rs = np.random.RandomState(0)
    w = (rs.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0                                   # a zero column
    w[..., 1, 2] = np.abs(w[..., :, 2]).max(axis=-1)  # absmax ties
    got = iw.quantize_leaf(torch.from_numpy(w), bits)
    want = jiw.quantize_leaf(w, bits=bits)
    _assert_same_node(got, want)
    assert got.shape == shape
    np.testing.assert_array_equal(
        got.dequant(torch.float32).numpy(),
        np.asarray(want.dequant(jnp.float32)))


def test_quantize_slices_equal_the_whole_leaf():
    rs = np.random.RandomState(1)
    w = torch.from_numpy(rs.standard_normal((2, 3, 40, 24)).astype(
        np.float32))
    for bits in (8, 4):
        whole = iw.quantize_leaf(w, bits)
        part = iw.quantize_tensor(w, bits)
        assert type(whole) is type(part)
        assert torch.equal(whole.q, part.q)
        assert torch.equal(whole.scale, part.scale)


def test_pack_unpack_int4_match_jax():
    rs = np.random.RandomState(2)
    q = rs.randint(-7, 8, (3, 10, 6)).astype(np.int8)
    q[0, :, 0] = [-7, 7, -1, 1, 0, -8 + 1, 3, -3, 6, -6]
    packed = iw.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(iw.unpack_int4(packed).numpy(), q)
    # byte r: code 2r in the low nibble, 2r+1 in the high nibble
    b = packed.numpy().astype(np.uint8)
    np.testing.assert_array_equal(b & 0xF, q[:, 0::2].astype(np.uint8) & 0xF)
    np.testing.assert_array_equal(b >> 4, q[:, 1::2].astype(np.uint8) & 0xF)
    with pytest.raises(ValueError, match="even"):
        iw.pack_int4(torch.zeros(3, 2, dtype=torch.int8))


def _jax_tree(cfg=J_TINY, **over):
    jm = JLlama(dataclasses.replace(cfg, dtype="float32", **over))
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.key(0)))


def _torch_tree(tree):
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t))
    return walk(tree)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_tree_takes_the_same_leaves(bits):
    """Only ``blocks`` leaves with >= 2 dims and >= min_size elements, the
    router never; every node bitwise the JAX one."""
    tree = {"wte": np.ones((600, 200), np.float32),
            "blocks": {"wq": np.random.RandomState(3).standard_normal(
                           (2, 128, 96)).astype(np.float32),
                       "rms1": np.ones((2, 128), np.float32),
                       "moe_gate": np.ones((2, 128, 300), np.float32),
                       "big1d": np.ones((70000,), np.float32),
                       "ids": np.ones((2, 128, 300), np.int32)}}
    for min_size in (1 << 16, 256):
        want = jiw.quantize_tree(tree, min_size=min_size, bits=bits)
        got = iw.quantize_tree(_torch_tree(tree), min_size=min_size,
                               bits=bits)
        for k, v in want["blocks"].items():
            if jiw._is_q(v):
                _assert_same_node(got["blocks"][k], v)
            else:
                assert not iw.is_quantized(got["blocks"][k]), k
        assert not iw.is_quantized(got["wte"])
        assert iw.has_quantized(got) == jiw.has_quantized(want)
    assert iw.is_quantized(got["blocks"]["rms1"])       # at min_size 256
    assert not iw.is_quantized(got["blocks"]["moe_gate"])


def test_dequant_and_cast_trees():
    """``dequant_tree`` (keep= passes the kept keys through quantized) and
    ``cast_unquantized`` (the router keeps fp32) as in JAX."""
    rs = np.random.RandomState(4)
    tree = {"wte": rs.standard_normal((8, 4)).astype(np.float32),
            "blocks": {"wup": rs.standard_normal((2, 64, 32)).astype(
                           np.float32),
                       "wq": rs.standard_normal((2, 64, 64)).astype(
                           np.float32),
                       "moe_gate": rs.standard_normal((2, 64, 4)).astype(
                           np.float32)}}
    jt = jiw.quantize_tree(tree, min_size=64)
    pt = iw.quantize_tree(_torch_tree(tree), min_size=64)
    want = jiw.dequant_tree(jt, jnp.float32, keep=("wup",))
    got = iw.dequant_tree(pt, torch.float32, keep=("wup",))
    assert iw.is_quantized(got["blocks"]["wup"])
    _assert_same_node(got["blocks"]["wup"], want["blocks"]["wup"])
    np.testing.assert_array_equal(got["blocks"]["wq"].numpy(),
                                  np.asarray(want["blocks"]["wq"]))
    full = iw.dequant_tree(pt, torch.float32)
    assert not iw.has_quantized(full)
    cast = iw.cast_unquantized(pt, torch.bfloat16)
    assert cast["wte"].dtype == torch.bfloat16
    assert cast["blocks"]["moe_gate"].dtype == torch.float32
    assert cast["blocks"]["wq"] is pt["blocks"]["wq"]
    jcast = jiw.cast_unquantized(jt, jnp.bfloat16)
    assert str(jcast["blocks"]["moe_gate"].dtype) == "float32"


def test_layer_slice_matches_jax_layer_slice():
    """Every leaf of every layer, min_size lowered on both sides so the
    (L, D) norm scales are quantized over L with one (1, D) scale: JAX
    clamps the scale index to row 0, and so does the port. int8 against
    JAX ``_layer_slice``; int4 (where the JAX slice cannot unpack a 1-D
    row) against row i of the JAX leaf dequantized whole."""
    jm, tree = _jax_tree()
    for bits in (8, 4):
        jt = jiw.quantize_tree(tree, min_size=64, bits=bits)
        pm = Llama(dataclasses.replace(LLAMA_TINY, dtype="float32"),
                   device="cpu")
        pm.load_state_dict(llama_params_from_numpy(jt, "cpu",
                                                   torch.float32))
        assert pm.weight_quant == ("int8" if bits == 8 else "int4")
        assert set(pm.qblocks) == set(tree["blocks"])
        assert pm.qblocks["rms1"].scale.shape == (1, 128)
        jq_tree = jax.tree.map(jnp.asarray, jt)
        for i in range(2):
            if bits == 8:
                want = jm._layer_slice(jq_tree, i)
            else:
                want = {k: jiw.dequant_tree(v, jnp.float32)[i]
                        for k, v in jq_tree["blocks"].items()}
            for k in tree["blocks"]:
                np.testing.assert_array_equal(pm._w(k, i).numpy(),
                                              np.asarray(want[k]))
        pm._weight_quant_fused = True
        kept = pm._w("wup", 1)
        assert iw.is_quantized(kept)
        _assert_same_node(kept, jax.tree.map(lambda a: a[1],
                                             jt["blocks"]["wup"]))


@pytest.mark.parametrize("cls,cfg", [(Llama, LLAMA_TINY),
                                     (Mixtral, MIXTRAL_TINY)])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_model_built_quantized_is_quantize_tree_of_the_float_model(
        cls, cfg, mode):
    """``cls(cfg, quantize=mode, seed=s)`` draws and quantizes slice by
    slice; it equals ``quantize_tree`` of the float model from the same
    seed, bitwise (d_model 256: the attention weights pass min_size too;
    the router stays fp32). ``quantize_`` (the engine's path) gives the
    same."""
    cfg = dataclasses.replace(cfg, dtype="float32", d_model=256)
    bits = 8 if mode == "int8" else 4
    built = cls(cfg, device="cpu", quantize=mode, seed=5).params_tree()
    want = iw.quantize_tree(cls(cfg, device="cpu", seed=5).params_tree(),
                            bits=bits)
    later = cls(cfg, device="cpu", seed=5).quantize_(mode).params_tree()
    for k, v in want["blocks"].items():
        for got in (built["blocks"][k], later["blocks"][k]):
            if iw.is_quantized(v):
                assert type(got) is type(v), k
                assert torch.equal(got.q, v.q) and torch.equal(
                    got.scale, v.scale), k
            else:
                assert torch.equal(got, v), k
    assert {"wq", "wk", "wv", "wo"} <= {k for k, v in want["blocks"].items()
                                        if iw.is_quantized(v)}
    for k in ("wte", "norm_f", "lm_head"):
        assert torch.equal(built[k], want[k])
    if cls is Mixtral:
        assert built["blocks"]["moe_gate"].dtype == torch.float32
        assert not iw.is_quantized(built["blocks"]["moe_gate"])


def test_converters_carry_quantized_trees():
    """A quantized JAX Mixtral tree loads as it is (codes and scales
    unchanged); an unknown quantized node type raises."""
    from deepspeed_tpu.models.mixtral import MIXTRAL_TINY as JM_TINY
    from deepspeed_tpu.models.mixtral import Mixtral as JMixtral
    jm = JMixtral(dataclasses.replace(JM_TINY, dtype="float32"))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    jt = jiw.quantize_tree(tree, bits=4)
    pm = Mixtral(dataclasses.replace(MIXTRAL_TINY, dtype="float32"),
                 device="cpu")
    pm.load_state_dict(mixtral_params_from_numpy(jt, "cpu", torch.float32))
    assert pm.weight_quant == "int4"
    for k, v in jt["blocks"].items():
        if jiw._is_q(v):
            _assert_same_node(pm.qblocks[k], v)
    assert pm.blocks["moe_gate"].dtype == torch.float32

    class Quantized:                  # not a JAX Int8Weight / Int4Weight
        q = np.zeros((1, 2, 2, 2), np.int8)
        scale = np.ones((1, 2, 1, 2), np.float32)

    bad = {"wte": np.zeros((4, 2)), "blocks": {"moe_w1": Quantized()}}
    with pytest.raises(NotImplementedError, match="Int8Weight"):
        mixtral_params_from_numpy(bad, "cpu", torch.float32)
