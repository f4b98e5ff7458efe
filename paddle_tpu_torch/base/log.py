"""Framework logging (port of ``paddle_tpu/base/log.py``): the port's one
logger, ``paddle_tpu_torch``, the logger ``inference`` warns on too. It
propagates to the root logger (Python prints its warnings to stderr when
nothing is configured); ``PADDLE_TPU_LOG_LEVEL``, when set, sets its
level."""
from __future__ import annotations

import logging
import os

__all__ = ["get_logger"]


def get_logger(name: str = "paddle_tpu_torch") -> logging.Logger:
    log = logging.getLogger(name)
    level = os.environ.get("PADDLE_TPU_LOG_LEVEL")
    if level:
        log.setLevel(level.upper())
    return log
