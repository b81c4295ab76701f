"""LR schedules.

Own copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (``WarmupLR``,
``WarmupDecayLR``, ``WarmupCosineLR``, ``OneCycle``, ``LRRangeTest``,
``build_scheduler``). Each schedule is a ``step -> lr`` callable that
computes in torch float32, as the JAX schedules compute through ``jnp`` in
float32 (Python floats would give other last bits), and returns a 0-d
float32 tensor. ``step()`` / ``get_lr()`` / ``state_dict()`` /
``load_state_dict()`` are the reference scheduler object's surface; the
engine reads ``schedule(global_step)`` for each step's lr and steps the
schedule after it.
"""

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


class _Schedule:
    def __init__(self):
        self.last_batch_iteration = -1

    def __call__(self, step):
        raise NotImplementedError

    def step(self, last_batch_iteration=None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self):
        return [float(self(max(0, self.last_batch_iteration)))]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]


class WarmupLR(_Schedule):
    """Warmup (log by default, or linear) from ``warmup_min_lr`` to
    ``warmup_max_lr`` over ``warmup_num_steps``, then constant."""

    def __init__(self, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type="log", **_):
        super().__init__()
        self.min_lr = warmup_min_lr
        self.max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type

    def _warmup(self, step):
        frac = torch.clamp(step / self.warmup_num_steps, 0.0, 1.0)
        if self.warmup_type == "log":
            frac = torch.log1p(frac * (math.e - 1.0))
        return self.min_lr + (self.max_lr - self.min_lr) * frac

    def __call__(self, step):
        step = _f32(step)
        return torch.where(step < self.warmup_num_steps, self._warmup(step),
                           _f32(self.max_lr))


class WarmupDecayLR(WarmupLR):
    """Warmup, then linear decay to 0 at ``total_num_steps``."""

    def __init__(self, total_num_steps, warmup_min_lr=0.0,
                 warmup_max_lr=0.001, warmup_num_steps=1000,
                 warmup_type="log", **_):
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                         warmup_type)
        self.total_num_steps = total_num_steps

    def __call__(self, step):
        step = _f32(step)
        decay = torch.clamp(
            (self.total_num_steps - step)
            / max(1.0, self.total_num_steps - self.warmup_num_steps),
            0.0, 1.0)
        return torch.where(step < self.warmup_num_steps, self._warmup(step),
                           self.max_lr * decay)


class WarmupCosineLR(_Schedule):
    """Linear warmup of the ratio, then cosine decay to ``cos_min_ratio``;
    the lr is ``lr`` times the ratio."""

    def __init__(self, total_num_steps, warmup_min_ratio=0.0,
                 warmup_num_steps=1000, cos_min_ratio=0.0001, lr=0.001, **_):
        super().__init__()
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(1, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.lr = lr

    def __call__(self, step):
        step = _f32(step)
        warm_ratio = self.warmup_min_ratio + (
            1 - self.warmup_min_ratio) * (step / self.warmup_num_steps)
        frac = torch.clamp(
            (step - self.warmup_num_steps)
            / max(1, self.total_num_steps - self.warmup_num_steps), 0.0, 1.0)
        cos_ratio = self.cos_min_ratio + (1 - self.cos_min_ratio) * 0.5 * (
            1 + torch.cos(math.pi * frac))
        ratio = torch.where(step < self.warmup_num_steps, warm_ratio,
                            cos_ratio)
        return self.lr * ratio


class OneCycle(_Schedule):
    """Triangular cycle, then decay (the lr part; the momentum cycle is
    not driven, as in JAX)."""

    def __init__(self, cycle_min_lr, cycle_max_lr, cycle_first_step_size=2000,
                 cycle_second_step_size=None, decay_step_size=0,
                 decay_lr_rate=0.0, **_):
        super().__init__()
        self.min_lr = cycle_min_lr
        self.max_lr = cycle_max_lr
        self.first = cycle_first_step_size
        self.second = (cycle_second_step_size
                       if cycle_second_step_size is not None
                       else cycle_first_step_size)
        self.decay_step_size = decay_step_size
        self.decay_lr_rate = decay_lr_rate

    def __call__(self, step):
        step = _f32(step)
        total = self.first + self.second
        up = self.min_lr + (self.max_lr - self.min_lr) * (step / self.first)
        down = self.max_lr - (self.max_lr - self.min_lr) * (
            (step - self.first) / self.second)
        in_cycle = torch.where(step < self.first, up, down)
        if self.decay_step_size > 0:
            decay_steps = (step - total) / self.decay_step_size
            decayed = self.min_lr / (1.0 + self.decay_lr_rate * decay_steps)
            return torch.where(step < total, torch.clamp(in_cycle, min=0.0),
                               decayed)
        return torch.clamp(in_cycle, self.min_lr, self.max_lr)


class LRRangeTest(_Schedule):
    """An lr sweep for tuning: ``min_lr * (1 + interval * step_rate)``."""

    def __init__(self, lr_range_test_min_lr=1e-3,
                 lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0,
                 lr_range_test_staircase=False, **_):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def __call__(self, step):
        step = _f32(step)
        interval = (torch.floor(step / self.step_size) if self.staircase
                    else step / self.step_size)
        return self.min_lr * (1 + interval * self.step_rate)


SCHEDULES = {
    "WarmupLR": WarmupLR,
    "WarmupDecayLR": WarmupDecayLR,
    "WarmupCosineLR": WarmupCosineLR,
    "OneCycle": OneCycle,
    "LRRangeTest": LRRangeTest,
}


def build_scheduler(name, params):
    if name not in SCHEDULES:
        raise ValueError(
            f"unknown scheduler '{name}'; available: {sorted(SCHEDULES)}")
    return SCHEDULES[name](**params)
