"""paddle.hapi for the port: ``Model`` with ``fit``/``evaluate``/
``predict``, its callbacks and ``MetricBuffer``, ``summary`` and
``flops``."""
from .callbacks import (Callback, CallbackList, EarlyStopping, LRScheduler,
                        ModelCheckpoint, ProgBarLogger, config_callbacks)
from .dynamic_flops import flops
from .metric_buffer import MetricBuffer, to_float
from .model import Model
from .model_summary import summary

__all__ = ["Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "MetricBuffer", "Model", "ModelCheckpoint", "ProgBarLogger",
           "config_callbacks", "flops", "summary", "to_float"]
