"""``paddle.save``/``paddle.load`` for the port (port of
``paddle_tpu/framework/io.py``).

The file is the JAX package's pickle: nested dicts, lists and tuples in
which every tensor is ``("__tensor__", numpy array, dtype name)``. Each
package reads the other's f32 and integer files. numpy has no bfloat16,
so a bf16 tensor is written as its raw 16-bit words (a ``uint16`` array
named ``"bfloat16"``), which this module reads back; a JAX-written bf16
array (an ``ml_dtypes`` array) is read through the same words.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

__all__ = ["load", "save"]

_TAG = "__tensor__"


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            return (_TAG, t.view(torch.uint16).numpy().copy(), "bfloat16")
        return (_TAG, t.numpy().copy(), str(t.dtype).replace("torch.", ""))
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        packed = [_pack(v) for v in obj]
        return packed if isinstance(obj, list) else tuple(packed)
    return obj


def _tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        words = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _unpack(obj, return_numpy: bool):
    if isinstance(obj, tuple) and len(obj) == 3 and obj[0] == _TAG:
        if return_numpy:
            return obj[1]
        return _tensor(obj[1], obj[2])
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, return_numpy) for v in obj]
    if isinstance(obj, tuple):
        return tuple(_unpack(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs) -> None:
    """Pickle ``obj`` with every tensor as ``("__tensor__", array, dtype
    name)``, creating ``path``'s directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """The object :func:`save` (or the JAX package's ``paddle.save``)
    wrote, its tensors as CPU ``torch.Tensor`` s (numpy arrays with
    ``return_numpy``)."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _unpack(obj, return_numpy)
