"""Neural-network building blocks of the port: the layers, the gradient
clips (``nn.ClipGradBy*``) and ``CrossEntropyLoss``."""
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, GradientClipBase,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from .layer import CrossEntropyLoss, LayerNorm, Linear, RMSNorm

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "CrossEntropyLoss", "GradientClipBase",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "LayerNorm", "Linear", "RMSNorm"]
