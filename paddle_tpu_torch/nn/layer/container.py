"""``Sequential``, ``LayerList``, ``ParameterList`` and ``LayerDict`` (port
of ``paddle_tpu/nn/layer/container.py``) with Paddle's semantics, each a
``Layer`` and torch's container at once. ``Sequential``: positional layers
are named ``"0"``, ``"1"``, ...; ``(name, layer)`` pairs keep their names;
one list or tuple of either is taken as the layers; an index or a slice
picks layers (a slice renumbers them from ``"0"``). ``LayerList``: layers
named ``"0"``, ``"1"``, ... (so its state-dict keys are the JAX ones,
``reduces.0.conv.weight``), ``append``/``extend``/``insert`` renumbering,
and no forward of its own. ``ParameterList``: parameters named ``"0"``,
``"1"``, ... (a tensor becomes a ``Parameter``). ``LayerDict``: layers by
key, in insertion order, with the dict methods."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

from .layers import Layer

__all__ = ["LayerDict", "LayerList", "ParameterList", "Sequential"]


class Sequential(nn.Sequential, Layer):
    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)):
            layers = tuple(layers[0])
        if layers and isinstance(layers[0], tuple) \
                and isinstance(layers[0][0], str):
            layers = (OrderedDict(layers),)
        super().__init__(*layers)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        return super().__getitem__(idx)


class LayerList(nn.ModuleList, Layer):
    """torch's ``ModuleList`` (layers ``"0"``, ``"1"``, ..., a slice a new
    ``LayerList``) under Paddle's name; calling it raises, as in JAX."""


class ParameterList(nn.ParameterList, Layer):
    """torch's ``ParameterList`` under Paddle's name, holding
    ``Parameter`` s; calling it raises, as in JAX."""

    def __call__(self, *args, **kwargs):
        raise NotImplementedError("ParameterList is a container")


class LayerDict(nn.ModuleDict, Layer):
    """torch's ``ModuleDict`` under Paddle's name (``update`` takes a dict
    or ``(key, layer)`` pairs); calling it raises, as in JAX."""
