"""Parameter conversion from the JAX package's Llama, Mixtral, GPT-2 and
GPT2MoE trees (and the families on them: OPT and GPT-Neo load through
``gpt2_params_from_numpy``).

The JAX tree (``jax.tree.map(np.asarray, params)``) and the port's module
state share names and shapes, so conversion is a dtype/device move:
``model.load_state_dict(llama_params_from_numpy(tree, dev, dt))`` (or
``mixtral_params_from_numpy``, ``gpt2_params_from_numpy``,
``gpt2_moe_params_from_numpy``); the loaded parameters train as the
model's own. A quantized Llama / Mixtral / GPT-2 / GPT2MoE tree (JAX
``Int8Weight`` / ``Int4Weight`` nodes, e.g. from ``quantize_tree``) carries
across as it is: each node becomes the port's container of the same int8
codes and fp32 scales.
"""

import numpy as np
import torch

from ..ops.int8_weights import Int4Weight, Int8Weight

_QUANTIZED = {"Int8Weight": Int8Weight, "Int4Weight": Int4Weight}

# the Llama family's leaves, the knobs' optional ones included (JAX
# llama.py:241-278)
_TOP = ("wte", "norm_f", "norm_f_b", "embed_ln_s", "embed_ln_b",
        "lm_head_b", "lm_head")
_BLOCKS = ("rms1", "wq", "wk", "wv", "wo", "rms2", "wgate", "wup", "wdown",
           "bq", "bk", "bv", "bo", "bup", "bdown", "bgate", "b1", "b2")
_MIXTRAL_TOP = ("wte", "norm_f", "lm_head")
_MIXTRAL_BLOCKS = ("rms1", "wq", "wk", "wv", "wo", "rms2", "moe_gate",
                   "moe_w1", "moe_w3", "moe_w2")
_GPT2_TOP = ("wte", "wpe", "lnf_scale", "lnf_bias")
_GPT2_BLOCKS = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
                "ln2_scale", "ln2_bias", "wup", "bup", "wdown", "bdown")
_GPT2_MOE_BLOCKS = _GPT2_BLOCKS[:8] + ("moe",)
_MOE = ("gate_w", "wi", "bi", "wo", "bo")


def _quantized(a, device):
    """A JAX Int8Weight/Int4Weight node -> the port's, (q, scale) as they
    are (int8 codes, fp32 scales)."""
    cls = _QUANTIZED.get(type(a).__name__)
    if cls is None:
        raise NotImplementedError(
            f"unknown quantized leaf {type(a).__name__}: the port takes the "
            f"JAX Int8Weight / Int4Weight (weight_quant, K7/K9)")
    return cls(torch.from_numpy(np.array(a.q, np.int8)).to(device),
               torch.from_numpy(np.array(a.scale, np.float32)).to(device))


def _tensor(a, device, dtype, quantized_ok=False):
    if hasattr(a, "scale"):
        if quantized_ok:
            return _quantized(a, device)
        raise NotImplementedError(
            f"a quantized leaf ({type(a).__name__}) outside the block "
            f"weights: quantize_tree quantizes only the blocks")
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)      # ml_dtypes bf16 has no torch view
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _from_numpy(tree, device, dtype, top, blocks, model, fp32_blocks=()):
    extra = sorted(set(tree) - set(top) - {"blocks"})
    extra += sorted(f"blocks.{k}" for k in set(tree["blocks"]) - set(blocks))
    if extra:
        raise NotImplementedError(
            f"parameters the port's {model} does not carry: {extra}")
    state = {k: _tensor(tree[k], device, dtype) for k in top if k in tree}
    for k, v in tree["blocks"].items():
        dt = torch.float32 if k in fp32_blocks else dtype
        state[f"blocks.{k}"] = _tensor(v, device, dt, quantized_ok=True)
    return state


def llama_params_from_numpy(tree, device, dtype):
    """JAX Llama-family parameter tree of numpy arrays (Llama and the seven
    families built on it) -> the port's state dict (``wte``, ``norm_f``,
    ``lm_head``, ``blocks.<name>`` and the knobs' leaves: biases, LayerNorm
    shifts, the embedding norm) on ``device`` in ``dtype``; quantized
    leaves stay quantized. Raises on keys the port's Llama does not
    carry."""
    return _from_numpy(tree, device, dtype, _TOP, _BLOCKS, "Llama")


def mixtral_params_from_numpy(tree, device, dtype):
    """JAX Mixtral parameter tree of numpy arrays -> the port's state dict
    (``wte``, ``norm_f``, ``lm_head``, ``blocks.<name>`` with the experts'
    ``moe_gate``/``moe_w1``/``moe_w3``/``moe_w2``) on ``device`` in
    ``dtype``, except the router ``blocks.moe_gate``, which stays fp32 as
    the JAX ``Mixtral.init`` keeps it (mixtral.py:73-75); quantized leaves
    stay quantized. Raises on keys the port's Mixtral does not carry."""
    return _from_numpy(tree, device, dtype, _MIXTRAL_TOP, _MIXTRAL_BLOCKS,
                       "Mixtral", fp32_blocks=("moe_gate",))


def gpt2_params_from_numpy(tree, device, dtype):
    """JAX GPT-2 parameter tree of numpy arrays (GPT-2, OPT, GPT-Neo) ->
    the port's state dict (``wte``, ``wpe``, ``lnf_*``, ``blocks.<name>``)
    on ``device`` in ``dtype``, with no renames or transposes; quantized
    leaves stay quantized. Raises on keys the port's GPT2 does not carry
    (MoE experts)."""
    return _from_numpy(tree, device, dtype, _GPT2_TOP, _GPT2_BLOCKS, "GPT2")


def gpt2_moe_params_from_numpy(tree, device, dtype):
    """JAX GPT2MoE parameter tree of numpy arrays -> the port's state dict
    (``wte``, ``wpe``, ``lnf_*``, ``blocks.<name>``, ``blocks.moe.<name>``)
    on ``device`` in ``dtype``, except the router ``blocks.moe.gate_w``,
    which stays fp32 as the JAX init keeps it; quantized leaves (the
    experts, and the router where it passes ``min_size``: JAX's
    ``quantize_tree`` excludes only ``moe_gate``) stay quantized. Raises on
    keys the port's GPT2MoE does not carry."""
    moe = tree["blocks"].get("moe", {})
    extra = sorted(f"blocks.moe.{k}" for k in set(moe) - set(_MOE))
    if extra:
        raise NotImplementedError(
            f"parameters the port's GPT2MoE does not carry: {extra}")
    dense = dict(tree, blocks={k: v for k, v in tree["blocks"].items()
                               if k != "moe"})
    state = _from_numpy(dense, device, dtype, _GPT2_TOP, _GPT2_MOE_BLOCKS,
                        "GPT2MoE")
    for k, v in moe.items():
        state[f"blocks.moe.{k}"] = _tensor(
            v, device, torch.float32 if k == "gate_w" else dtype,
            quantized_ok=True)
    return state
