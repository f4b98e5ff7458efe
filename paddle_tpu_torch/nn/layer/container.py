"""``Sequential`` and ``LayerList`` (port of ``paddle_tpu/nn/layer/
container.py:10,40``) with Paddle's semantics. ``Sequential``: positional
layers are named ``"0"``, ``"1"``, ...; ``(name, layer)`` pairs keep their
names; one list or tuple of either is taken as the layers; an index or a
slice picks layers (a slice renumbers them from ``"0"``). ``LayerList``:
layers named ``"0"``, ``"1"``, ... (so its state-dict keys are the JAX
ones, ``reduces.0.conv.weight``), ``append``/``extend``/``insert``
renumbering, and no forward of its own."""
from __future__ import annotations

from collections import OrderedDict

from torch import nn

__all__ = ["LayerList", "Sequential"]


class Sequential(nn.Sequential):
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


class LayerList(nn.ModuleList):
    """torch's ``ModuleList`` (layers ``"0"``, ``"1"``, ..., a slice a new
    ``LayerList``) under Paddle's name; calling it raises, as in JAX."""
