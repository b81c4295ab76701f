"""Fused Adam/AdamW for the port's engine.

Own copy of ``deepspeed_tpu/ops/optimizers.py`` ``FusedAdam`` (reference
csrc/adam/multi_tensor_adam.cu:168, ops/adam/fused_adam.py:18) with the
same update, computed in fp32 from the upcast moments, and the same state
layout ``{"step", "m", "v"}`` (m and v keyed by parameter name). The
update is plain PyTorch: it is bandwidth-bound elementwise work, which the
JAX package also leaves to XLA (no Pallas kernel). It updates the master
parameters and the moments in place, which saves a copy of each, and
walks a contiguous leaf in slices of ``UPDATE_SLICE`` elements, so its
fp32 temporaries stay slice-sized (a stacked Mixtral-8x7B expert leaf
holds ~0.5 B elements a layer); the update is elementwise, so the slices
give the whole leaf's values bit for bit.

Protocol (as the JAX one): ``opt.init(params) -> state`` and
``opt.update(grads, state, params, lr) -> (params, state)`` over dicts of
fp32 master tensors.
"""

import torch

_TODO = "(ROADMAP Queue 1, M4: LAMB, Lion, Adagrad, SGD)"
UPDATE_SLICE = 1 << 26


def _slices(*ts):
    """Aligned slices of the tensors ``ts`` (one leaf's parameter,
    gradient and moments): ``UPDATE_SLICE``-element views of each when
    all are contiguous, else the tensors whole."""
    n = ts[0].numel()
    if n <= UPDATE_SLICE or not all(t.is_contiguous() for t in ts):
        return [ts]
    flat = [t.view(-1) for t in ts]
    return [[f[i:i + UPDATE_SLICE] for f in flat]
            for i in range(0, n, UPDATE_SLICE)]


class FusedAdam:
    """Adam/AdamW (``adam_w_mode=True`` gives decoupled weight decay, the
    reference default). ``moments_dtype``: storage dtype for m/v (e.g.
    "bfloat16"); None stores them in the master dtype (fp32)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, bias_correction=True, adam_w_mode=True,
                 moments_dtype=None):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.bias_correction = bias_correction
        self.adam_w_mode = adam_w_mode
        self.moments_dtype = None if moments_dtype is None \
            else getattr(torch, str(moments_dtype))

    def _zeros(self, p):
        return torch.zeros(p.shape, dtype=self.moments_dtype or p.dtype,
                           device=p.device)

    def init(self, params):
        dev = next(iter(params.values())).device if params else None
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "m": {k: self._zeros(p) for k, p in params.items()},
                "v": {k: self._zeros(p) for k, p in params.items()}}

    def update(self, grads, state, params, lr=None):
        """One step; ``params`` and ``state`` are updated in place and
        returned. Scalars are fp32 as in the JAX update (b1 ** step in
        fp32, lr an fp32 scalar)."""
        lr = self.lr if lr is None else lr
        state["step"] += 1
        f32 = dict(dtype=torch.float32, device=state["step"].device)
        step = state["step"].to(torch.float32)
        if self.bias_correction:
            c1 = 1.0 - torch.tensor(self.b1, **f32) ** step
            c2 = 1.0 - torch.tensor(self.b2, **f32) ** step
        else:
            c1 = c2 = torch.ones((), **f32)
        lr = torch.as_tensor(lr, **f32)
        b1, b2 = self.b1, self.b2
        for name, leaf in params.items():
            for p, g, m_s, v_s in _slices(leaf, grads[name],
                                          state["m"][name],
                                          state["v"][name]):
                g = g.float()
                m = m_s.float()
                v = v_s.float()
                if not self.adam_w_mode and self.weight_decay:
                    g = g + self.weight_decay * p          # classic L2
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g.square()
                upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
                if self.adam_w_mode and self.weight_decay:
                    upd = upd + self.weight_decay * p
                p.copy_((p - lr * upd).to(p.dtype))
                m_s.copy_(m)
                v_s.copy_(v)
        return params, state


# registry used by the engine (reference runtime/engine.py:1294)
OPTIMIZERS = {"adam": FusedAdam, "adamw": FusedAdam, "fusedadam": FusedAdam}
_NOT_PORTED = ("lamb", "fusedlamb", "lion", "fusedlion", "adagrad", "sgd")


def build_optimizer(name, params_cfg):
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"optimizer '{name}' is not ported yet {_TODO}")
    if key not in OPTIMIZERS:
        raise ValueError(
            f"unknown optimizer '{name}'; available: {sorted(OPTIMIZERS)}")
    kwargs = dict(params_cfg)
    if key in ("adam", "fusedadam"):
        kwargs.setdefault("adam_w_mode", True)
    elif key == "adamw":
        kwargs["adam_w_mode"] = True
    kwargs.pop("torch_adam", None)
    return OPTIMIZERS[key](**kwargs)
