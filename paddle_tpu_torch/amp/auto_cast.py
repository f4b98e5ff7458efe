"""AMP for the port: ``auto_cast`` at levels O1 and O2 and ``decorate``, in
bfloat16 or float16 (port of ``paddle_tpu/amp/auto_cast.py``).

The port keeps its own AMP state and its functionals read it (not
``torch.autocast``): each functional on the model path (``linear``,
``layer_norm``, ``cross_entropy``, the attention ops, ...) passes its
floating inputs through :meth:`AmpState.cast_inputs` under its op name,
exactly where the JAX dispatcher casts. So the casts fall where the JAX
package puts them, whatever torch.autocast's own op lists say.

- O1: white ops (``amp_lists.white_list()``, plus ``custom_white_list``)
  compute in the AMP dtype, black ops in f32, and every other op in the
  dtype of its inputs. Parameters stay f32.
- O2: ``decorate`` casts every floating parameter and buffer of the model
  to the AMP dtype, LayerNorm's included. No f32 master copy is kept: the
  optimizer updates in f32 and stores back in the parameter's dtype
  (``optimizer/optimizers.py``). Inside ``auto_cast(level="O2")`` every op
  computes in the AMP dtype except the black list, which computes in f32.

float16 needs loss scaling (``amp.GradScaler``); bfloat16, with f32's
exponent range, does not.
"""
from __future__ import annotations

import contextlib
import contextvars
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import amp_lists

__all__ = ["AmpState", "auto_cast", "amp_guard", "cast_inputs", "decorate",
           "is_auto_cast_enabled", "get_amp_dtype", "current_state",
           "state_guard"]

_EXEMPT = frozenset({"cast", "assign", "dropout", "getitem", "setitem"})
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
_STATE: contextvars.ContextVar = contextvars.ContextVar("paddle_amp",
                                                        default=None)


def _amp_dtype(level: str, dtype) -> torch.dtype:
    if level not in ("O1", "O2"):
        raise ValueError(f"unknown AMP level {level!r}")
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPES:
        raise ValueError(f"AMP dtype {dtype!r}: bfloat16 or float16")
    return _DTYPES[name]


class AmpState:
    """The level, target dtype and op lists of one ``auto_cast`` region."""

    def __init__(self, level: str = "O1", dtype: str = "bfloat16",
                 custom_white_list=None, custom_black_list=None):
        self.level = level
        self.dtype = _amp_dtype(level, dtype)
        self.white = amp_lists.white_list()
        self.black = amp_lists.black_list()
        if custom_white_list:
            self.white |= set(custom_white_list)
            self.black -= set(custom_white_list)
        if custom_black_list:
            self.black |= set(custom_black_list)
            self.white -= set(custom_black_list)

    def target(self, op_name: str):
        """The dtype ``op_name`` computes in, or None: its inputs' own."""
        if op_name in _EXEMPT:
            return None
        if self.level == "O2":
            return torch.float32 if op_name in self.black else self.dtype
        if op_name in self.white:
            return self.dtype
        if op_name in self.black:
            return torch.float32
        return None

    def cast_inputs(self, op_name: str, *tensors):
        """``tensors`` with every floating one cast to the dtype ``op_name``
        computes in (:meth:`target`)."""
        target = self.target(op_name)
        if target is None:
            return tensors
        return tuple(t.to(target) if t is not None and t.is_floating_point()
                     else t for t in tensors)


def cast_inputs(op_name: str, *tensors):
    """What the functionals call: ``tensors`` cast for ``op_name`` under
    the active AMP state, unchanged outside ``auto_cast``."""
    state = _STATE.get()
    return tensors if state is None else state.cast_inputs(op_name, *tensors)


@contextlib.contextmanager
def auto_cast(enable: bool = True, custom_white_list=None,
              custom_black_list=None, level: str = "O1",
              dtype: str = "bfloat16", use_promote: bool = True):
    """``paddle.amp.auto_cast``: ops inside compute in the AMP dtype as the
    level and the op lists say."""
    if not enable:
        yield
        return
    token = _STATE.set(AmpState(level, dtype, custom_white_list,
                                custom_black_list))
    try:
        yield
    finally:
        _STATE.reset(token)


amp_guard = auto_cast


def current_state():
    """The active ``auto_cast`` region's :class:`AmpState` (None outside
    one): what a block run again later (a recompute, a pipeline unit's
    backward) must run under to compute what it computed first."""
    return _STATE.get()


@contextlib.contextmanager
def state_guard(state):
    """``state`` (from :func:`current_state`) active inside the block."""
    token = _STATE.set(state)
    try:
        yield
    finally:
        _STATE.reset(token)


def is_auto_cast_enabled() -> bool:
    """Whether an ``auto_cast`` region is active."""
    return _STATE.get() is not None


def get_amp_dtype() -> str:
    """The active region's AMP dtype by name, ``"float32"`` outside one."""
    state = _STATE.get()
    return str(state.dtype).replace("torch.", "") if state else "float32"


def decorate(models, optimizers=None, level: str = "O2",
             dtype: str = "bfloat16", master_weight=None, save_dtype=None, *,
             device=DEFAULT_DEVICE):
    """``paddle.amp.decorate``: at O2 casts every floating parameter and
    persistable buffer of each model (its ``state_dict``, as the JAX
    package's ``_convert_dtype``) to the AMP dtype in place; a
    non-persistable buffer keeps its dtype; O1 leaves them f32.
    ``device`` (default CUDA) is where the models must lie. Returns the
    models, and the optimizers unchanged when given. There is no f32
    master copy, as in the JAX package."""
    target = _amp_dtype(level, dtype)
    dev = resolve_device(device)
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for model in model_list:
        for t in list(model.parameters()) + list(model.buffers()):
            if t.device.type != dev.type:
                raise ValueError(f"the model lies on {t.device}, the call "
                                 f"asked for {dev}")
        if level == "O2":
            kept = [(mod, name, mod._buffers[name])
                    for mod in model.modules()
                    for name in mod._non_persistent_buffers_set
                    if mod._buffers.get(name) is not None]
            model.to(target)
            for mod, name, buf in kept:
                mod._buffers[name] = buf
    out = models if single else model_list
    return out if optimizers is None else (out, optimizers)
