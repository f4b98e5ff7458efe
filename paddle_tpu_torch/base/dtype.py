"""Dtypes (port of ``paddle_tpu/base/dtype.py``).

``paddle.float32`` and the rest *are* the torch dtypes
(``paddle_tpu_torch.float32 is torch.float32``): torch's dispatcher is the
port's type system, so there is no wrapper class. :func:`convert_dtype`
reads Paddle's spellings: a name (``"float32"``, ``"paddle.float32"``,
``"bool"``), a numpy dtype or scalar type, or a torch dtype. 64-bit types
stay 64-bit on the card (the JAX package narrows them to 32 bits on the
TPU). numpy has no bf16 without ``ml_dtypes``, which the port does not
import: the host copy of a bf16 tensor is float32, which holds every bf16
value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bfloat16", "bool_", "complex64", "complex128", "convert_dtype",
           "dtype_name", "finfo", "float16", "float32", "float64", "iinfo",
           "int8", "int16", "int32", "int64", "is_floating", "np_dtype",
           "uint8"]

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_BY_NAME = {"bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
            "int32": int32, "int64": int64, "float16": float16,
            "bfloat16": bfloat16, "float32": float32, "float64": float64,
            "complex64": complex64, "complex128": complex128}
_NAME = {v: k for k, v in _BY_NAME.items()}


def convert_dtype(dtype):
    """``dtype`` (a Paddle name, a numpy dtype or a torch dtype) as a torch
    dtype; None stays None. Raises ``ValueError`` for anything else."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = dtype
        for prefix in ("paddle_tpu_torch.", "paddle_tpu.", "paddle.",
                       "torch."):
            name = name.replace(prefix, "")
        name = {"bool_": "bool", "float": "float32", "half": "float16",
                "double": "float64", "int": "int32",
                "long": "int64"}.get(name, name)
        if name in _BY_NAME:
            return _BY_NAME[name]
        raise ValueError(f"unknown dtype '{dtype}'")
    try:
        name = np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None
    if name not in _BY_NAME:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _BY_NAME[name]


def dtype_name(dtype) -> str:
    """The Paddle name of ``dtype`` (``"float32"``, ``"bool"``, ...)."""
    return _NAME[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype of ``dtype``'s host copy (float32 for bf16)."""
    d = convert_dtype(dtype)
    return np.dtype("float32" if d == bfloat16 else _NAME[d])


def finfo(dtype):
    """Machine limits of a float dtype (``torch.finfo``)."""
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    """Machine limits of an integer dtype (``torch.iinfo``)."""
    return torch.iinfo(convert_dtype(dtype))
