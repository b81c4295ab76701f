"""Device resolution for the port's entry points."""

import os

import torch


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` when given, else the
    card of this process, ``cuda:$LOCAL_RANK`` (``cuda:0`` when
    ``LOCAL_RANK`` is unset). With no card and no explicit device this
    raises, and so it does when the process's card does not exist: the
    index is never wrapped round the cards, and the port never moves to the
    CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' explicitly to "
            "run on the CPU")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    count = torch.cuda.device_count()
    if not 0 <= local_rank < count:
        raise RuntimeError(
            f"LOCAL_RANK={local_rank} names card {local_rank}, but this "
            f"host has {count} card(s); pass device= explicitly (for "
            f"example device='cuda:0' for processes that share one card)")
    return torch.device("cuda", local_rank)
