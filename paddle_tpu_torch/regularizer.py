"""Regularizers (port of ``paddle_tpu/regularizer.py``), read by the
optimizers at update time: a parameter's ``regularizer`` attribute, or an
optimizer's ``weight_decay``, gives the coefficient. As in the JAX package
both fold ``coeff · p`` into the gradient (``Optimizer._decayed_grad``):
``L1Decay`` marks itself ``is_l1`` but is applied by the same rule."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self.is_l1 = True
