"""Logging for the PyTorch port.

Own copy of ``deepspeed_tpu/utils/logging.py`` (``logger``, ``log_dist``),
single-process: the serving slice runs one process on one card, so every
message is logged as rank 0.
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


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` when rank 0 is among ``ranks`` (None / [-1] = all)."""
    if ranks is None or -1 in ranks or 0 in ranks:
        logger.log(level, f"[Rank 0] {message}")
