"""The op-interception tier (port of ``paddle_tpu/core/hooks.py``): one
``TorchDispatchMode`` over the port's ops, and its three slots.

The JAX package funnels every op through ``core/dispatch.py``
``primitive``, which calls the three hooks. The port has no dispatcher of
its own: torch's is the op surface. So the slots live here and one
dispatch-level mode, :class:`InterceptionMode`, calls them for every op
that reaches the dispatcher below autograd: each aten call, each
registered operator of the port (``paddle_tpu_torch::flash_attention_fwd``,
``paddle_tpu_torch::rms_norm_fwd``, ...) and each ``register_op`` user op,
forward and backward alike. A registered operator is seen as one op: its
kernel runs inside the mode's handler, where torch has taken the mode off
this thread's stack.

- ``static_capture``: the recording ``static.Program`` (``before(func,
  args, kwargs)`` as an op is about to run, ``record(name, func, args, kwargs,
  out)`` after), set by ``enable_static`` and ``program_guard``;
- ``op_observer``: ``(name, outputs)`` after each op, set by the tensor
  checker and the operator stats of ``amp.debugging`` (an op that returns
  nothing, as the optimizer kernels' operators, is observed through the
  tensors its schema says it writes);
- ``op_profiler``: ``(name) -> context manager`` around each op, set by a
  recording ``profiler.Profiler``.

``FLAGS_check_nan_inf`` scans every op's float outputs on the same path
(``check_nan_inf``). Names are the ops' schema names, ``aten::mm`` or
``paddle_tpu_torch::rms_norm_fwd``, not the JAX package's primitive names.
Sizes reach the mode resolved (a reshape's ``-1`` stays, ``linear``'s
flattening arrives as ``view(x, [rows, in])``).

The mode is pushed on the thread that sets the first slot (or turns the
flag on) and popped when the last one is cleared there; autograd's worker
threads inherit it for the backward. Setting a slot is an assignment
(``hooks.op_observer = fn``), as in the JAX package: the module's class
turns assignments into :func:`_sync`.

While the mode is on, a hand-written kernel may launch only from inside a
registered operator, where the mode saw the call: every pybind launch site
calls :func:`check_launch` first, which raises ``NotImplementedError``
when the mode is on this thread's stack (inside an operator's kernel it
is not). Under CUDA-graph capture the observers
read no value on the host (the counterpart of ``_observe`` skipping
tracers).
"""
from __future__ import annotations

import contextlib
import sys
import threading
import types
from typing import Any, Callable, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack,
                                          _pop_mode, _push_mode)

from ..base.flags import get_flag, on_flag_change

__all__ = ["InterceptionMode", "active", "check_launch", "output_tensors",
           "suspended", "written_tensors"]

_SLOTS = ("static_capture", "op_observer", "op_profiler")
_slots = dict.fromkeys(_SLOTS)
# the mode that acts: the one pushed by the last _sync that wanted one
_mode: Optional["InterceptionMode"] = None
# per thread: suspension depth
_tls = threading.local()


def output_tensors(out) -> List[torch.Tensor]:
    """The tensors of an op's result (a tensor, or a tuple or list)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def written_tensors(func, args, kwargs) -> List[torch.Tensor]:
    """The tensors an op writes into, by its schema (``Tensor(a!)`` and
    ``Tensor(a!)[]`` arguments): the outputs of an op that returns
    nothing, such as the optimizer kernels' operators."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        out += output_tensors(value)
    return out


def _nan_check_on() -> bool:
    return bool(get_flag("check_nan_inf"))


def active() -> bool:
    """Whether any slot is set or ``FLAGS_check_nan_inf`` is on."""
    return (_slots["static_capture"] is not None
            or _slots["op_observer"] is not None
            or _slots["op_profiler"] is not None or _nan_check_on())


def _depth(name: str) -> int:
    return getattr(_tls, name, 0)


@contextlib.contextmanager
def _deeper(name: str):
    setattr(_tls, name, _depth(name) + 1)
    try:
        yield
    finally:
        setattr(_tls, name, _depth(name) - 1)


def suspended():
    """A block in which this thread's ops pass the mode unseen: the
    framework's own work while a slot is set (a static program's replay
    and export, its placeholders and the parameters its builders make)."""
    return _deeper("suspended")


def _intercepting_here() -> bool:
    mode = _mode
    return mode is not None and any(
        m is mode for m in _get_current_dispatch_mode_stack())


def check_launch(site: str) -> None:
    """Raise ``NotImplementedError`` when a kernel is about to launch
    while the mode intercepts this thread: outside a registered operator's
    kernel (where torch has stashed the mode), the launch would be unseen
    by the static recording, the observers and the profiler."""
    if not _intercepting_here():
        return
    raise NotImplementedError(
        f"{site} launches a hand-written kernel outside a registered "
        f"operator while an interception slot is set (static recording, "
        f"amp.debugging, FLAGS_check_nan_inf or a recording profiler): "
        f"the launch would go unseen. Every kernel launches inside its "
        f"registered operator (paddle_tpu_torch::<name>); a launch outside "
        f"one is a fault of its wrapper (ROADMAP.md, queue 3)")


def _capturing(outs) -> bool:
    return any(t.is_cuda for t in outs) \
        and torch.cuda.is_current_stream_capturing()


def _host_readable(outs) -> bool:
    """Whether the host may read the outputs now: real tensors (not fake
    or meta ones, as an export traces) and no graph capture on this
    thread's stream."""
    if any(t.device.type == "meta" or isinstance(t, FakeTensor)
           for t in outs):
        return False
    return not _capturing(outs)


def check_nan_inf(name: str, outs) -> None:
    """``FLAGS_check_nan_inf``'s scan (JAX ``dispatch._check_nan_inf``):
    every float output's ``isfinite`` reduced on the device to one flag,
    read once. At ``FLAGS_check_nan_inf_level`` 0 a NaN or Inf raises
    ``PreconditionNotMetError``; above 0 it is logged."""
    finite = [torch.isfinite(t).all() for t in outs
              if t.is_floating_point() or t.is_complex()]
    if not finite:
        return
    ok = torch.stack(finite).all() if len(finite) > 1 else finite[0]
    if bool(ok):
        return
    msg = f"op '{name}' produced NaN/Inf output"
    if int(get_flag("check_nan_inf_level")) > 0:
        from ..base.log import get_logger

        get_logger().warning(msg)
        return
    from ..base.enforce import PreconditionNotMetError

    raise PreconditionNotMetError(msg)


class InterceptionMode(TorchDispatchMode):
    """The dispatch-level mode that calls the slots (see the module)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self is not _mode or _depth("suspended"):
            return func(*args, **kwargs)
        name = func._schema.name  # aten::mm: the overload dropped
        capture = _slots["static_capture"]
        if capture is not None:
            capture.before(func, args, kwargs)
        profiler = _slots["op_profiler"]
        if profiler is not None:
            with profiler(name):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        observer = _slots["op_observer"]
        nan_check = _nan_check_on()
        if observer is not None or nan_check:
            outs = output_tensors(out) or written_tensors(func, args,
                                                          kwargs)
            if outs and _host_readable(outs):
                if nan_check:
                    check_nan_inf(name, outs)
                if observer is not None:
                    observer(name, outs)
        if capture is not None:
            capture.record(name, func, args, kwargs, out)
        return out


def _sync(*_) -> None:
    """Push the mode on this thread when a slot is set (or the NaN flag on)
    and none acts yet; pop it when nothing is set. A mode that is no
    longer on top of the stack is left there inert (it passes every op
    through) rather than popping another's."""
    global _mode
    want = active()
    if want and not _intercepting_here():
        _mode = InterceptionMode()
        _push_mode(_mode)
    elif not want and _mode is not None:
        stack = _get_current_dispatch_mode_stack()
        if stack and stack[-1] is _mode:
            _pop_mode()
        _mode = None


class _HooksModule(types.ModuleType):
    """This module's class: its slots are properties whose assignment
    pushes or pops the mode."""


def _slot_property(name: str) -> property:
    def get(self) -> Any:
        return _slots[name]

    def set_(self, value: Optional[Callable]) -> None:
        _slots[name] = value
        _sync()

    return property(get, set_)


for _name in _SLOTS:
    setattr(_HooksModule, _name, _slot_property(_name))
sys.modules[__name__].__class__ = _HooksModule
on_flag_change("check_nan_inf", _sync)
_sync()
