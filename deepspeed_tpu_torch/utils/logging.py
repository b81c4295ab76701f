"""Logging for the PyTorch port.

Own copy of ``deepspeed_tpu/utils/logging.py`` (``logger``, ``log_dist``):
``log_dist`` logs on the listed ranks of the ``torch.distributed`` world
(rank 0 when no world is initialized).
"""

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name="DeepSpeedTPUTorch", level=logging.INFO):
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    return lg


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DSTPU_LOG_LEVEL", "info").lower(),
                         logging.INFO))


def _rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` when this process's rank is among ``ranks`` (None /
    [-1] = all)."""
    rank = _rank()
    if ranks is None or -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")
