"""Parameter initializers and ``ParamAttr`` (port of
``paddle_tpu/nn/initializer``)."""
from .attr_helpers import ParamAttr, resolve_param_attr
from .initializers import (Assign, Bilinear, Constant, Dirac, Initializer,
                           KaimingNormal, KaimingUniform, Normal, Orthogonal,
                           TruncatedNormal, Uniform, XavierNormal,
                           XavierUniform, calculate_gain,
                           set_global_initializer)

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "ParamAttr", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "calculate_gain", "resolve_param_attr",
           "set_global_initializer"]
