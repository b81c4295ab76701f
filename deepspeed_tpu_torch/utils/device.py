"""Device resolution for the port's entry points."""

import torch


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given, else the
    CUDA card. With no card and no explicit device this raises — the port
    never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    return torch.device("cuda")
