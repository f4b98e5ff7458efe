"""AMP for the port: ``auto_cast`` and ``decorate`` at level O2 in bfloat16
(port of ``paddle_tpu/amp/auto_cast.py``).

The port keeps its own AMP state and its functionals read it (not
``torch.autocast``): each functional on the model path (``linear``,
``layer_norm``, ``cross_entropy``, ``scaled_dot_product_attention``) passes
its floating inputs through :meth:`AmpState.cast_inputs` under its op name,
exactly where the JAX dispatcher casts. So the casts fall where the JAX
package puts them, whatever torch.autocast's own op lists say.

O2 semantics, as in the JAX package:

- ``decorate`` casts every floating parameter and buffer of the model to
  bf16, LayerNorm's included. No f32 master copy is kept: the optimizer
  updates in f32 and stores back in bf16 (``optimizer/optimizers.py``).
- Inside ``auto_cast(level="O2")`` every op computes in bf16 except the
  black list (``amp_lists.BLACK_LIST``), which computes in f32: on the GPT
  path ``layer_norm`` and ``cross_entropy`` (with its log-softmax and mean).

Not ported, each raising ``NotImplementedError``: level O1, float16 and
``GradScaler`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import contextlib
import contextvars
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import amp_lists

__all__ = ["AmpState", "auto_cast", "cast_inputs", "decorate", "GradScaler"]

_EXEMPT = frozenset({"cast", "assign", "dropout", "getitem", "setitem"})
_STATE: contextvars.ContextVar = contextvars.ContextVar("paddle_amp",
                                                        default=None)


def _check_mode(level: str, dtype: str) -> torch.dtype:
    if level == "O1":
        raise NotImplementedError(
            "AMP level O1 is not ported yet (ROADMAP.md, queue 1); use O2")
    if level != "O2":
        raise ValueError(f"unknown AMP level {level!r}")
    if dtype != "bfloat16":
        raise NotImplementedError(
            f"AMP dtype {dtype!r} is not ported (ROADMAP.md, queue 1): the "
            "port runs O2 in bfloat16, which needs no loss scaling")
    return torch.bfloat16


class AmpState:
    """The level and target dtype of one ``auto_cast`` region."""

    def __init__(self, level: str = "O2", dtype: str = "bfloat16"):
        self.level = level
        self.dtype = _check_mode(level, dtype)

    def cast_inputs(self, op_name: str, *tensors):
        """``tensors`` with every floating one cast to the dtype ``op_name``
        computes in: f32 for the black list, the AMP dtype otherwise."""
        if op_name in _EXEMPT:
            return tensors
        target = (torch.float32 if op_name in amp_lists.BLACK_LIST
                  else self.dtype)
        return tuple(t.to(target) if t is not None and t.is_floating_point()
                     else t for t in tensors)


def cast_inputs(op_name: str, *tensors):
    """What the functionals call: ``tensors`` cast for ``op_name`` under
    the active AMP state, unchanged outside ``auto_cast``."""
    state = _STATE.get()
    return tensors if state is None else state.cast_inputs(op_name, *tensors)


@contextlib.contextmanager
def auto_cast(enable: bool = True, level: str = "O1",
              dtype: str = "bfloat16"):
    """``paddle.amp.auto_cast``: ops inside compute in the AMP dtype as the
    level and the op lists say. The default level, O1, is not ported and
    raises: pass ``level="O2"``."""
    if not enable:
        yield
        return
    token = _STATE.set(AmpState(level, dtype))
    try:
        yield
    finally:
        _STATE.reset(token)


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", *, device=DEFAULT_DEVICE):
    """``paddle.amp.decorate`` at O2: casts every floating parameter and
    buffer of each model to bf16 in place, on ``device`` (default CUDA;
    the models must lie there). Returns the models, and the optimizers
    unchanged when given. There is no f32 master copy, as in the JAX
    package."""
    target = _check_mode(level, dtype)
    dev = resolve_device(device)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for model in model_list:
        for t in list(model.parameters()) + list(model.buffers()):
            if t.device.type != dev.type:
                raise ValueError(f"the model lies on {t.device}, the call "
                                 f"asked for {dev}")
        model.to(target)
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)


class GradScaler:
    """Loss scaling is for float16, which the port does not run."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "GradScaler (float16 loss scaling) is not ported yet "
            "(ROADMAP.md, queue 1); bf16 O2 needs none")
