"""Parameter conversion from the JAX package's Llama tree.

The JAX tree (``jax.tree.map(np.asarray, params)``) and the port's
``Llama`` state share names and shapes, so conversion is a dtype/device
move: ``model.load_state_dict(llama_params_from_numpy(tree, dev, dt))``.
"""

import numpy as np
import torch

_TOP = ("wte", "norm_f", "lm_head")
_BLOCKS = ("rms1", "wq", "wk", "wv", "wo", "rms2", "wgate", "wup", "wdown")


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)      # ml_dtypes bf16 has no torch view
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def llama_params_from_numpy(tree, device, dtype):
    """JAX Llama parameter tree of numpy arrays -> the port's state dict
    (``wte``, ``norm_f``, ``lm_head``, ``blocks.<name>``) on ``device`` in
    ``dtype``. Raises on keys the port's Llama does not carry (biases,
    LayerNorm biases, embedding norm, quantized leaves)."""
    extra = sorted(set(tree) - set(_TOP) - {"blocks"})
    extra += sorted(f"blocks.{k}" for k in set(tree["blocks"]) - set(_BLOCKS))
    if extra:
        raise NotImplementedError(
            f"parameters the port's Llama does not carry: {extra}")
    state = {k: _tensor(tree[k], device, dtype) for k in _TOP if k in tree}
    for k, v in tree["blocks"].items():
        state[f"blocks.{k}"] = _tensor(v, device, dtype)
    return state
