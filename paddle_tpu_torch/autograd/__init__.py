"""``paddle.autograd`` (port of ``paddle_tpu/autograd``): ``backward``,
``grad``, ``no_grad``, ``enable_grad``, ``PyLayer``/``PyLayerContext``
(over ``torch.autograd.Function``) and ``saved_tensors_hooks``."""
from ..base.global_state import enable_grad, no_grad
from ..core.autograd import backward, grad
from .py_layer import PyLayer, PyLayerContext, once_differentiable
from .saved_tensors_hooks import saved_tensors_hooks

__all__ = ["PyLayer", "PyLayerContext", "backward", "enable_grad", "grad",
           "no_grad", "once_differentiable", "saved_tensors_hooks"]
