"""``ParamAttr`` (port of ``paddle_tpu/nn/initializer/attr_helpers.py``):
how a layer's ``weight_attr``/``bias_attr`` describe a parameter."""
from __future__ import annotations

__all__ = ["ParamAttr", "resolve_param_attr"]


class ParamAttr:
    """A parameter's name (the port's ``param_name``), initializer,
    learning-rate factor (``optimize_attr["learning_rate"]``), regularizer,
    ``trainable`` and ``need_clip``; ``do_model_average`` is kept and read
    nowhere, as in the JAX package."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip


def resolve_param_attr(attr):
    """The ``weight_attr``/``bias_attr`` convention: None gives the
    defaults, False no parameter (None), a string a named ``ParamAttr``,
    an initializer one that uses it, a ``ParamAttr`` itself."""
    if attr is None:
        return ParamAttr()
    if attr is False:
        return None
    if isinstance(attr, str):
        return ParamAttr(name=attr)
    if isinstance(attr, ParamAttr):
        return attr
    return ParamAttr(initializer=attr)
