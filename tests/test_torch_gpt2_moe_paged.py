"""GPT2MoE's paged serving programs in the port (GPT-2's four paged
programs over the MoE ``_mlp``, deepspeed_tpu_torch/models/gpt2_moe.py)
held against the JAX programs on CPU, fp32 on both sides, with both MoE
backends: the GShard capacity ``dense`` (the config's default; eval
capacity factor, no noise) and the dropless ``ragged``.

The weights are the JAX init randomized as test_torch_gpt2_paged.py's
``pair`` does (LayerNorms and biases, the expert biases too, drawn from a
numpy seed; the projections at 4x; the router at 8x so that routing is
decided, not tied): prefill, chunk, decode and verify logits and every
pool within 1e-5 of the JAX programs (``run_programs``), float and
quantized (int8 / int4 from the JAX ``quantize_tree``, every expert leaf
dequantized a layer at a time, as the JAX ``_layer_slice`` does); the
port's ``quantize_`` gives the JAX tree's codes and scales bitwise, the
router quantized where it passes ``min_size`` as in JAX. The engines'
streams are test_torch_gpt2_moe_engines.py's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.models.gpt2_moe import GPT2MoE as JGPT2MoE
from deepspeed_tpu.models.gpt2_moe import GPT2MoEConfig as JGPT2MoEConfig
from deepspeed_tpu.ops import int8_weights as jiw
from deepspeed_tpu_torch.models import (GPT2MoE, GPT2MoEConfig,
                                        gpt2_moe_params_from_numpy)
from deepspeed_tpu_torch.ops import int8_weights as iw
from test_torch_gpt2_paged import BITS, randomize, run_programs

TINY = dict(n_layer=2, n_head=4, d_model=128, max_seq_len=128,
            vocab_size=1024, dtype="float32", num_experts=4)
ROUTER_GAIN = 8.0
# (MoE config over TINY): the default dense gate (top-1, eval capacity
# factor 2.0), dense top-2, a dense gate that drops (eval capacity factor
# 0.5, min_capacity 1: 2 slots an expert in a 16-token chunk), ragged
CASES = {
    "dense": {},
    "dense_top2": dict(moe_top_k=2),
    "dense_drops": dict(eval_capacity_factor=0.5, min_capacity=1),
    "ragged": dict(moe_backend="ragged", moe_top_k=2),
}
# the engines' control: the dropless top-1 routing of the dense cases
RAGGED_TOP1 = dict(moe_backend="ragged")

_CACHE = {}


def moe_pair(case):
    """(JAX model, its randomized tree as jnp, the port's model loaded from
    it, the tree as numpy) for a CASES entry or "ragged_top1"."""
    if case not in _CACHE:
        cfg = {**TINY, **(RAGGED_TOP1 if case == "ragged_top1"
                          else CASES[case])}
        jm = JGPT2MoE(JGPT2MoEConfig(**cfg))
        tree = randomize(jax.tree.map(np.asarray, jm.init(jax.random.key(0))))
        rs = np.random.RandomState(1)
        moe = dict(tree["blocks"]["moe"])
        moe["bi"] = (0.1 * rs.standard_normal(moe["bi"].shape)).astype(
            np.float32)
        moe["gate_w"] = (ROUTER_GAIN * moe["gate_w"]).astype(np.float32)
        tree["blocks"] = dict(tree["blocks"], moe=moe)
        pm = GPT2MoE(GPT2MoEConfig(**cfg), device="cpu", dtype=torch.float32)
        pm.load_state_dict(gpt2_moe_params_from_numpy(tree, "cpu",
                                                      torch.float32))
        _CACHE[case] = (jm, jax.tree.map(jnp.asarray, tree), pm, tree)
    return _CACHE[case]


@pytest.mark.parametrize("case", list(CASES))
def test_paged_programs_match_jax(case):
    jm, params, pm, _ = moe_pair(case)
    jm._paged_kernel = False          # the JAX dense programs
    run_programs(jm, params, pm, case)


def _quantized(case, mode):
    jm, _, pm0, tree = moe_pair(case)
    qtree = jax.tree.map(np.asarray,
                         jiw.quantize_tree(tree, bits=BITS[mode]))
    pm = GPT2MoE(pm0.config, device="cpu", dtype=torch.float32)
    pm.load_state_dict(gpt2_moe_params_from_numpy(qtree, "cpu",
                                                  torch.float32))
    return jm, qtree, pm


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("case", ["dense", "ragged"])
def test_quantized_programs_match_jax(case, mode):
    """The JAX ``quantize_tree`` loaded through
    ``gpt2_moe_params_from_numpy`` (the expert leaves quantized, nested
    under ``moe``), served on the fused path: no MoE leaf is kept
    quantized, each is dequantized a layer at a time."""
    jm, qtree, pm = _quantized(case, mode)
    assert pm.weight_quant == mode
    assert set(pm.qblocks) == {"wqkv", "moe.wi", "moe.wo"}
    jm._paged_kernel = False
    jm._weight_quant_fused = pm._weight_quant_fused = True
    assert not iw.is_quantized(pm._w("moe.wi", 1))
    assert pm._w("moe.gate_w", 1).shape == (128, 4)
    run_programs(jm, jax.tree.map(jnp.asarray, qtree), pm,
                 f"{case} {mode}", verify=False)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantize_rule_matches_jax(mode):
    """The port's ``quantize_`` of the float model equals the JAX
    ``quantize_tree`` of its tree, codes and scales bitwise; the router
    ``gate_w`` is quantized where it passes ``min_size`` in both packages
    (GPT2MoE 350M widths, 4 experts: (24, 1024, 4), 98,304 elements), since
    only ``moe_gate`` is excluded."""
    _, qtree, pm = _quantized("dense", mode)
    own = GPT2MoE(pm.config, device="cpu", dtype=torch.float32)
    own.load_state_dict(gpt2_moe_params_from_numpy(
        moe_pair("dense")[3], "cpu", torch.float32))
    own.quantize_(mode)
    assert set(own.qblocks) == set(pm.qblocks)
    for k, w in pm.qblocks.items():
        assert torch.equal(w.q, own.qblocks[k].q), k
        assert torch.equal(w.scale, own.qblocks[k].scale), k
    gate = np.zeros((24, 1024, 4), np.float32)
    gate[..., 0] = 1.0
    jq = jiw.quantize_tree({"blocks": {"moe": {"gate_w": gate}}},
                           bits=BITS[mode])
    assert jiw._is_q(jq["blocks"]["moe"]["gate_w"])
    assert iw.qualifies("gate_w", gate.shape, torch.float32)
    assert not iw.qualifies("moe_gate", gate.shape, torch.float32)

