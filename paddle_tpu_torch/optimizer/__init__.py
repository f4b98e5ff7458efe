"""``paddle.optimizer`` for the port: the ten optimizers and the LR
schedulers (``optimizer.lr``)."""
from . import lr
from .optimizer import Optimizer
from .optimizers import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                         Lamb, Momentum, RMSProp)

__all__ = ["Adadelta", "Adagrad", "Adam", "AdamW", "Adamax", "LBFGS", "Lamb",
           "Momentum", "Optimizer", "RMSProp", "SGD", "lr"]
