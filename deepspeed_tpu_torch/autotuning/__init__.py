"""The autotune winner cache of the port (counterpart of the kernel half of
``deepspeed_tpu/autotuning``): the persistent cache (``kernel_cache``), the
per-process dispatch state (``kernel_dispatch``), the measured search
(``kernel_autotuner``) and the port's registry of levers
(``kernel_registry``). The planner, the engine-level autotuner and the
collective ops are not ported (ROADMAP Queue 1, M14 / M5)."""

from . import kernel_dispatch
from .kernel_cache import KernelCache, default_cache_path, seed_entries

__all__ = ["KernelCache", "default_cache_path", "kernel_dispatch",
           "seed_entries"]
