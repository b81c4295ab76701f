"""Static and dynamic loss scaling.

Own copy of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (reference
``runtime/fp16/loss_scaler.py:91 DynamicLossScaler``). The state is a dict
of 0-d tensors, as in the JAX train state, and the update is the same
arithmetic; the eager engine reads the overflow flag on the host.
"""

import torch


class LossScaler:
    """Static scale (reference LossScalerBase). scale=1 for bf16/fp32."""

    def __init__(self, scale=1.0):
        self.static_scale = float(scale)
        self.dynamic = False

    def init_state(self, device=None):
        return {"scale": torch.tensor(self.static_scale, dtype=torch.float32,
                                      device=device),
                "good_steps": torch.zeros((), dtype=torch.int32,
                                          device=device)}

    def update(self, state, overflow):
        return state


class DynamicLossScaler(LossScaler):
    """reference runtime/fp16/loss_scaler.py:91 semantics:
    * on overflow: scale /= 2 (bounded below), reset window, skip step
      (hysteresis consumes before halving)
    * after `scale_window` consecutive good steps: scale *= 2
    """

    def __init__(self, init_scale=2**16, scale_factor=2.0, scale_window=1000,
                 min_scale=1.0, delayed_shift=1, consecutive_hysteresis=False):
        super().__init__(init_scale)
        self.dynamic = True
        self.scale_factor = float(scale_factor)
        self.scale_window = int(scale_window)
        self.min_scale = float(min_scale)
        self.delayed_shift = int(delayed_shift)
        self.consecutive_hysteresis = consecutive_hysteresis

    def init_state(self, device=None):
        state = super().init_state(device)
        state["hysteresis"] = torch.tensor(self.delayed_shift,
                                           dtype=torch.int32, device=device)
        return state

    def update(self, state, overflow):
        scale, good, hyst = (state["scale"], state["good_steps"],
                             state["hysteresis"])
        overflow = torch.as_tensor(overflow, device=scale.device)
        hyst_after = torch.where(overflow, torch.clamp(hyst - 1, min=0),
                                 hyst)
        drop = overflow & (hyst_after == 0)
        new_scale = torch.where(
            drop, torch.clamp(scale / self.scale_factor, min=self.min_scale),
            scale)
        new_good = torch.where(overflow, torch.zeros_like(good), good + 1)
        grow = new_good >= self.scale_window
        new_scale = torch.where(grow, new_scale * self.scale_factor,
                                new_scale)
        new_good = torch.where(grow, torch.zeros_like(new_good), new_good)
        if self.consecutive_hysteresis:
            # refill on good steps: only N *consecutive* overflows drop scale
            new_hyst = torch.where(overflow, hyst_after,
                                   torch.full_like(hyst, self.delayed_shift))
        else:
            # hysteresis is a budget: any N overflows (consecutive or not)
            # drop the scale (reference default semantics)
            new_hyst = hyst_after
        return {"scale": new_scale, "good_steps": new_good.to(torch.int32),
                "hysteresis": new_hyst.to(torch.int32)}


def grads_finite(grads):
    """Global overflow check (reference CheckOverflow, runtime/utils.py):
    a 0-d bool tensor, True iff every grad element is finite."""
    finite = None
    for g in grads:
        f = torch.isfinite(g).all()
        finite = f if finite is None else finite & f
    return finite if finite is not None else torch.tensor(True)


def create_loss_scaler(fp16_cfg=None, dtype=None):
    if fp16_cfg is None or not fp16_cfg.enabled or dtype != torch.float16:
        return LossScaler(1.0)
    if fp16_cfg.loss_scale and fp16_cfg.loss_scale > 0:
        return LossScaler(fp16_cfg.loss_scale)
    return DynamicLossScaler(init_scale=2.0 ** fp16_cfg.initial_scale_power,
                             scale_window=fp16_cfg.loss_scale_window,
                             min_scale=fp16_cfg.min_loss_scale,
                             delayed_shift=fp16_cfg.hysteresis)
