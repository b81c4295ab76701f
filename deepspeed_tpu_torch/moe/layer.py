"""MoE layer: owns the expert parameters and the router.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``MoE``): the constructor's
checks, ``init(stack=L, out_std=...)`` with the JAX parameter names and
shapes, and ``apply`` for the dropless ``backend="ragged"``. Functional, as
there: ``init`` returns a dict of tensors and ``apply(params, x)`` returns
``(y, l_aux, exp_counts)``; the model that holds the parameters registers
them (``models/gpt2_moe.py``).
"""

import torch

from .sharded_moe import gelu, moe_layer_ragged_ep

_TODO_DENSE = ("MoE dense (GShard capacity) backend (ROADMAP Queue 1, "
               "M10)")


class MoE:
    def __init__(self, hidden_size, ffn_hidden_size=None, num_experts=8,
                 k=1, capacity_factor=1.0, eval_capacity_factor=1.0,
                 min_capacity=4, noisy_gate_policy=None, drop_tokens=True,
                 top2_2nd_expert_sampling=True, activation=gelu,
                 dtype=torch.bfloat16, backend="dense",
                 grouped_kernel="auto"):
        """backend: 'ragged' = dropless grouped GEMM (the only backend the
        port carries); 'dense' = the GShard static-capacity dispatch, not
        ported yet. grouped_kernel: "auto" | True (the Hopper grouped
        kernels) | False (the ragged math)."""
        self.hidden_size = hidden_size
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.num_experts = num_experts
        self.k = k
        self.backend = backend
        if grouped_kernel not in (True, False, "auto"):
            raise ValueError(
                f"grouped_kernel must be true|false|'auto', got "
                f"{grouped_kernel!r}")
        self.grouped_kernel = grouped_kernel
        if backend != "ragged":
            raise NotImplementedError(
                f"MoE backend={backend!r}: the {_TODO_DENSE} is not ported "
                f"yet; use backend='ragged'")
        # dropless routing has no capacity knobs (vacuous) but noisy
        # gating would be silently ignored — reject, as the JAX MoE does
        if noisy_gate_policy is not None:
            raise ValueError(
                "backend='ragged' uses deterministic top-k routing; "
                f"noisy_gate_policy={noisy_gate_policy!r} is not "
                "supported (use backend='dense')")
        if k < 1:
            raise ValueError("k must be >= 1")
        self.gate = None
        self.activation = activation
        self.dtype = dtype

    def init(self, stack=None, std=0.02, out_std=None, *, device=None,
             generator=None):
        """Random parameters (N(0, std), ``wo`` N(0, out_std), zero biases,
        the router in fp32) from ``generator``; the JAX names and shapes,
        with a leading ``stack`` dim when given."""
        M, Fd, E = self.hidden_size, self.ffn_hidden_size, self.num_experts
        lead = () if stack is None else (stack,)
        out_std = std if out_std is None else out_std

        def nrm(shape, s, dtype):
            out = torch.empty(lead + shape, dtype=dtype, device=device)
            for slab in out.view(-1, *shape):   # one layer at a time
                slab.copy_(torch.randn(shape, generator=generator,
                                       device=device) * s)
            return out

        return {
            # the router stays fp32: routing decisions are precision-
            # sensitive (the engine casts it with the rest, as JAX's does)
            "gate_w": nrm((M, E), std, torch.float32),
            "wi": nrm((E, M, Fd), std, self.dtype),
            "bi": torch.zeros(lead + (E, Fd), dtype=self.dtype,
                              device=device),
            "wo": nrm((E, Fd, M), out_std, self.dtype),
            "bo": torch.zeros(lead + (E, M), dtype=self.dtype,
                              device=device),
        }

    def apply(self, params, x, *, grouped_kernel=None):
        """``grouped_kernel`` overrides the construction-time knob for this
        dispatch (None keeps it): how an engine ``moe`` block reaches a
        layer built before the engine."""
        knob = self.grouped_kernel if grouped_kernel is None \
            else grouped_kernel
        return moe_layer_ragged_ep(
            x, params["gate_w"], params["wi"], params["bi"], params["wo"],
            params["bo"], k=self.k, activation=self.activation,
            grouped_kernel=knob)

