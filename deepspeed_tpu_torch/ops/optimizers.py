"""Fused optimizers for the port's engine: Adam/AdamW, LAMB, Lion,
Adagrad, SGD.

Own copy of ``deepspeed_tpu/ops/optimizers.py`` (``FusedAdam``,
``FusedLamb``, ``FusedLion``, ``FusedAdagrad``, ``SGD``,
``build_optimizer``; reference csrc/adam/multi_tensor_adam.cu:168,
csrc/lamb/fused_lamb_cuda_kernel.cu:478, csrc/lion/multi_tensor_lion.cu:126,
csrc/adagrad/cpu_adagrad.cpp:256) with the same updates, computed in fp32,
and the same state layouts (moments keyed by parameter name). The updates
are plain PyTorch: bandwidth-bound elementwise work, which the JAX package
also leaves to XLA (no Pallas kernel). They update the master parameters
and the moments in place, which saves a copy of each, and walk a
contiguous leaf in slices of ``UPDATE_SLICE`` elements, so their fp32
temporaries stay slice-sized (a stacked Mixtral-8x7B expert leaf holds
~0.5 B elements a layer); the updates are elementwise, so the slices give
the whole leaf's values bit for bit.

LAMB's trust ratio needs two norms over the whole leaf (the parameter and
its update) before any slice is written: a first pass updates the moments
and sums both squares slice by slice, a second recomputes each slice's
update from the new moments and writes it. Where a rank holds only part
of a leaf (a ZeRO-partitioned master, an expert-parallel leaf), the
engine names the axes the leaf is split over in ``norm_axes`` and the
squares are summed over them in one collective, as GSPMD sums them in
JAX.

Protocol (as the JAX one): ``opt.init(params) -> state`` and
``opt.update(grads, state, params, lr) -> (params, state)`` over dicts of
fp32 master tensors.
"""

import torch

from ..comm import comm

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


def _fp32(state):
    return dict(dtype=torch.float32, device=state["step"].device)


def _zeros_like(params):
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _step0(params):
    dev = next(iter(params.values())).device if params else None
    return torch.zeros((), dtype=torch.int32, device=dev)


class FusedLamb:
    """LAMB (reference ops/lamb/fused_lamb.py): the Adam update rescaled
    by the per-leaf trust ratio ||p|| / ||update||, clipped to
    [min_coeff, max_coeff] (1 where either norm is 0). ``norm_axes``:
    name -> the mesh axes a leaf's master is split over on this rank
    (set by the engine; empty for whole leaves)."""

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.0, max_coeff=10.0, min_coeff=0.01):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.max_coeff = max_coeff
        self.min_coeff = min_coeff
        self.norm_axes = {}

    def init(self, params):
        return {"step": _step0(params), "m": _zeros_like(params),
                "v": _zeros_like(params)}

    def _upd(self, p, m, v, c1, c2):
        upd = (m / c1) / (torch.sqrt(v / c2) + self.eps)
        if self.weight_decay:
            upd = upd + self.weight_decay * p
        return upd

    def update(self, grads, state, params, lr=None):
        lr = self.lr if lr is None else lr
        state["step"] += 1
        f32 = _fp32(state)
        step = state["step"].to(torch.float32)
        c1 = 1.0 - torch.tensor(self.b1, **f32) ** step
        c2 = 1.0 - torch.tensor(self.b2, **f32) ** step
        lr = torch.as_tensor(lr, **f32)
        b1, b2 = self.b1, self.b2
        names = list(params)
        sq = torch.zeros(len(names), 2, **f32)     # ||p||^2, ||upd||^2
        for i, name in enumerate(names):
            for p, g, m, v in _slices(params[name], grads[name],
                                      state["m"][name], state["v"][name]):
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g.square())
                upd = self._upd(p, m, v, c1, c2)
                sq[i, 0] += p.square().sum()
                sq[i, 1] += upd.square().sum()
        by_axes = {}
        for i, name in enumerate(names):
            axes = tuple(self.norm_axes.get(name, ()))
            if axes:
                by_axes.setdefault(axes, []).append(i)
        for axes, rows in by_axes.items():
            idx = torch.tensor(rows, device=sq.device)
            sq[idx] = comm.all_reduce(sq[idx].contiguous(), axes)
        norms = torch.sqrt(sq)
        p_norm, u_norm = norms[:, 0], norms[:, 1]
        trust = torch.where(
            (p_norm > 0) & (u_norm > 0),
            torch.clamp(p_norm / u_norm, self.min_coeff, self.max_coeff),
            torch.ones_like(p_norm))
        for i, name in enumerate(names):
            for p, m, v in _slices(params[name], state["m"][name],
                                   state["v"][name]):
                p.sub_(lr * trust[i] * self._upd(p, m, v, c1, c2))
        return params, state


class FusedLion:
    """Lion (reference ops/lion/fused_lion.py): the sign of the
    interpolated momentum; one moment."""

    def __init__(self, lr=1e-4, betas=(0.9, 0.99), weight_decay=0.0):
        self.lr = lr
        self.b1, self.b2 = betas
        self.weight_decay = weight_decay

    def init(self, params):
        return {"step": _step0(params), "m": _zeros_like(params)}

    def update(self, grads, state, params, lr=None):
        lr = torch.as_tensor(self.lr if lr is None else lr, **_fp32(state))
        b1, b2 = self.b1, self.b2
        for name in params:
            for p, g, m in _slices(params[name], grads[name],
                                   state["m"][name]):
                upd = torch.sign(b1 * m + (1 - b1) * g)
                if self.weight_decay:
                    upd = upd + self.weight_decay * p
                p.sub_(lr * upd)
                m.copy_(b2 * m + (1 - b2) * g)
        state["step"] += 1
        return params, state


class FusedAdagrad:
    """Adagrad (reference csrc/adagrad/cpu_adagrad.cpp:256)."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0):
        self.lr = lr
        self.eps = eps
        self.weight_decay = weight_decay

    def init(self, params):
        return {"step": _step0(params), "v": _zeros_like(params)}

    def update(self, grads, state, params, lr=None):
        lr = torch.as_tensor(self.lr if lr is None else lr, **_fp32(state))
        for name in params:
            for p, g, v in _slices(params[name], grads[name],
                                   state["v"][name]):
                if self.weight_decay:
                    g = g + self.weight_decay * p
                v.add_(g.square())
                p.sub_(lr * g / (torch.sqrt(v) + self.eps))
        state["step"] += 1
        return params, state


class SGD:
    """SGD with optional momentum (``m = momentum * m + g``) and L2 weight
    decay folded into the gradient."""

    def __init__(self, lr=1e-2, momentum=0.0, weight_decay=0.0):
        self.lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay

    def init(self, params):
        state = {"step": _step0(params)}
        if self.momentum:
            state["m"] = _zeros_like(params)
        return state

    def update(self, grads, state, params, lr=None):
        lr = torch.as_tensor(self.lr if lr is None else lr, **_fp32(state))
        for name in params:
            leaves = [params[name], grads[name]]
            if self.momentum:
                leaves.append(state["m"][name])
            for p, g, *m in _slices(*leaves):
                if self.weight_decay:
                    g = g + self.weight_decay * p
                if self.momentum:
                    m[0].copy_(self.momentum * m[0] + g)
                    g = m[0]
                p.sub_(lr * g)
        state["step"] += 1
        return params, state


# registry used by the engine (reference runtime/engine.py:1294)
OPTIMIZERS = {
    "adam": FusedAdam,
    "adamw": FusedAdam,
    "fusedadam": FusedAdam,
    "lamb": FusedLamb,
    "fusedlamb": FusedLamb,
    "lion": FusedLion,
    "fusedlion": FusedLion,
    "adagrad": FusedAdagrad,
    "sgd": SGD,
}


def build_optimizer(name, params_cfg):
    key = name.lower()
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
