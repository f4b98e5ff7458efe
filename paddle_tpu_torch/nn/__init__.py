"""Neural-network building blocks of the port: ``Layer`` and the layers
(linear, embedding, normalization, convolution, pooling, activations,
dropouts, pads, upsamplers, containers, the recurrent tier, the
transformer stack, the losses), ``ParamAttr`` and the initializers
(``nn.initializer``) and the gradient clips (``nn.ClipGradBy*``)."""
from . import functional, initializer
from .clip import (ClipGradBase, ClipGradByGlobalNorm, ClipGradByNorm,
                   ClipGradByValue, GradientClipBase,
                   GradientClipByGlobalNorm, GradientClipByNorm,
                   GradientClipByValue)
from .initializer.attr_helpers import ParamAttr
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipBase", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue", "ParamAttr",
           "functional", "initializer"] + list(_layers)
