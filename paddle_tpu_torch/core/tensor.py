"""``paddle.Tensor`` for the port (port of ``paddle_tpu/core/tensor.py``).

``Tensor`` is a subclass of ``torch.Tensor``, made from a torch tensor
without a copy (``as_subclass``). Its ``__torch_function__`` is torch's
disabled one, so every torch op on it, inside the port's modules, CUDA
graphs and ``torch.export``, sees it as a plain ``torch.Tensor`` and
returns one. Its metaclass makes ``isinstance(x, Tensor)`` true for every
``torch.Tensor``: layer outputs and ``nn.Parameter`` s pass the check, as
every array passes it in the JAX package.

Its methods take Paddle's meaning where Paddle's and torch's share a name
(``size`` is the element count and ``shape`` a list; ``transpose(perm)``,
``split(num_or_sections)``, ``max(axis)``, ``sort`` without indices: the
functional ops of ``ops``, installed by ``core.tensor_methods``), and what
they return is a ``Tensor`` again, so a chain of Paddle calls stays
Paddle. The port's own modules call torch's methods on plain tensors; an
input that reaches them as a ``Tensor`` is first taken plain
(:func:`plain`) where a clashing method would meet it.

``numpy()`` copies to the host from any device. A bf16 tensor comes back
as float32 values, which holds each exactly: numpy has no bf16 without
``ml_dtypes``, which comes with JAX and which a PyTorch install need not
have (the JAX package returns bf16 there).
"""
from __future__ import annotations

import copy
import numbers

import numpy as np
import torch

from ..base import dtype as dtype_mod
from ..base import global_state
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["Parameter", "Tensor", "as_tensor", "paddle_out", "plain",
           "to_tensor", "wrap"]


class _TensorMeta(torch._C._TensorMeta):
    """``isinstance(x, Tensor)`` holds for every ``torch.Tensor``."""

    def __instancecheck__(cls, obj):
        if cls is Tensor:
            return isinstance(obj, torch.Tensor)
        return super().__instancecheck__(obj)


def _place(place):
    """``place`` (a Paddle device name, a ``torch.device`` or None: the
    default device) as a ``torch.device``."""
    if place is None:
        return resolve_device(DEFAULT_DEVICE)
    if isinstance(place, str):
        from ..device import _parse

        return resolve_device(_parse(place))
    return resolve_device(place)


def as_tensor(data, dtype=None, place=None) -> torch.Tensor:
    """``data`` as a plain torch tensor on ``place`` (default: the default
    device) in ``dtype``; a Python float (or a list of them) takes the
    default float dtype, as in Paddle; numpy data is copied."""
    dev = _place(place)
    dt = dtype_mod.convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        out = data.detach()
    elif isinstance(data, np.ndarray) or isinstance(data, np.generic):
        arr = np.asarray(data)
        if arr.dtype.name == "bfloat16":  # ml_dtypes, where present
            out = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out = torch.from_numpy(np.array(arr, copy=True))
    else:
        out = torch.as_tensor(data)
        if dt is None and out.is_floating_point() and not isinstance(
                data, torch.Tensor):
            out = out.to(global_state.default_dtype())
    return out.to(device=dev, dtype=dt)


def plain(x):
    """``x`` as a plain ``torch.Tensor`` (the same storage and autograd
    history); a parameter, and anything else, unchanged."""
    if isinstance(x, torch.Tensor) and type(x) is not torch.Tensor \
            and not isinstance(x, torch.nn.Parameter):
        return x.as_subclass(torch.Tensor)
    return x


def wrap(x):
    """A plain tensor (also inside a list or tuple) as a ``Tensor``, with
    no copy; anything else unchanged."""
    if type(x) is torch.Tensor:
        return x.as_subclass(Tensor)
    if isinstance(x, (list, tuple)) and any(
            type(v) is torch.Tensor for v in x):
        return type(x)(wrap(v) for v in x) if isinstance(x, list) \
            else tuple(wrap(v) for v in x)
    return x


def paddle_out(fn):
    """``fn`` returning its tensors (also inside a list or tuple) as
    ``Tensor`` s: the top level's and the methods' form of an op."""
    def op(*args, **kwargs):
        return wrap(fn(*args, **kwargs))

    op.__name__ = getattr(fn, "__name__", "op")
    op.__qualname__ = op.__name__
    op.__doc__ = fn.__doc__
    op.__wrapped__ = fn
    return op


def _grad_enabled_leaf(t: torch.Tensor, stop_gradient: bool) -> "Tensor":
    out = t.as_subclass(Tensor)
    if not stop_gradient:
        out.requires_grad_(True)
    return out


class Tensor(torch.Tensor, metaclass=_TensorMeta):
    """A torch tensor with Paddle's methods: ``Tensor(value, dtype=None,
    stop_gradient=True, place=None)`` copies ``value`` (an array, a
    number, a list or a tensor) to ``place`` (default: the default
    device)."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __new__(cls, value=None, dtype=None, stop_gradient=True, name=None,
                persistable=False, place=None):
        if value is None:
            value = []
        t = as_tensor(value, dtype, place)
        if isinstance(value, torch.Tensor) and t.data_ptr() == \
                value.data_ptr() and t.numel():
            t = t.clone()
        return _grad_enabled_leaf(t, stop_gradient)

    def __init__(self, *args, **kwargs):
        pass

    # ------------------------------------------------------------ meta
    @property
    def shape(self):
        """The dims as a list (``torch.Size`` is a tuple)."""
        return list(torch.Tensor.shape.__get__(self))

    @property
    def size(self):
        """The element count."""
        return torch.Tensor.numel(self)

    @property
    def place(self) -> str:
        """The device by Paddle's name: ``"cpu"`` or ``"gpu:N"``."""
        dev = self.device
        return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"

    @property
    def stop_gradient(self) -> bool:
        """Whether no gradient flows to this tensor (``not
        requires_grad``)."""
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value) -> None:
        self.requires_grad_(not bool(value))

    @property
    def T(self):
        """All dims reversed."""
        return wrap(self.permute(*range(self.ndim - 1, -1, -1)))

    @property
    def grad(self):
        g = torch.Tensor.grad.__get__(self)
        return None if g is None else wrap(g)

    @grad.setter
    def grad(self, value):
        torch.Tensor.grad.__set__(self, value)

    def rank(self) -> int:
        return self.ndim

    def numpy(self) -> np.ndarray:
        """A host copy (bf16 as float32 values)."""
        t = self.detach().as_subclass(torch.Tensor).cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.resolve_conj().resolve_neg().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)

    def item(self, *args):
        if args:
            return self.numpy().item(*args)
        return torch.Tensor.item(self)

    def is_integer(self) -> bool:
        return not (self.dtype.is_floating_point or self.dtype.is_complex
                    or self.dtype == torch.bool)

    def __repr__(self, *, tensor_contents=None):
        body = torch.Tensor.__repr__(self.detach().as_subclass(torch.Tensor))
        return (f"Tensor(shape={self.shape}, dtype="
                f"{dtype_mod.dtype_name(self.dtype)}, place={self.place}, "
                f"stop_gradient={self.stop_gradient},\n       {body})")

    def __reduce_ex__(self, proto):
        return (_rebuild, (self.detach().as_subclass(torch.Tensor),
                           self.stop_gradient))

    def __deepcopy__(self, memo):
        out = _rebuild(self.detach().as_subclass(torch.Tensor).clone(),
                       self.stop_gradient)
        memo[id(self)] = out
        return out

    # ------------------------------------------------------------ autograd
    def backward(self, grad_tensor=None, retain_graph=None,
                 create_graph=False, inputs=None):
        """Accumulate the gradients of this tensor into the leaves, seeded
        with ``grad_tensor`` (default: ones, whatever the shape, as in the
        JAX package). torch's engine gets the plain tensor: it calls
        ``numel`` and ``size``, which a ``Tensor`` shadows with Paddle's
        (an op, and so a copy that a CUDA-graph capture refuses)."""
        t = self.as_subclass(torch.Tensor)
        if grad_tensor is None and t.numel() != 1:
            grad_tensor = torch.ones_like(t)
        torch.Tensor.backward(t, plain(grad_tensor), retain_graph,
                              create_graph, inputs)

    def clear_grad(self) -> None:
        torch.Tensor.grad.__set__(self, None)

    clear_gradient = clear_grad

    def detach(self):
        return wrap(torch.Tensor.detach(self))

    def clone(self):
        return wrap(torch.Tensor.clone(self))

    # ------------------------------------------------------------ movement
    def astype(self, dtype):
        from ..ops.manipulation import cast

        return wrap(cast(self, dtype))

    cast = astype

    def to(self, *args, **kwargs):
        """``to(device)``, ``to(dtype)`` or both, in Paddle's names or
        torch's."""
        device, dtype = kwargs.pop("device", None), kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, torch.dtype):
                dtype = a
            elif isinstance(a, str):
                try:
                    dtype = dtype_mod.convert_dtype(a)
                except ValueError:
                    device = a
            else:
                device = a
        t = self.as_subclass(torch.Tensor)
        out = t.to(device=None if device is None else _place(device),
                   dtype=dtype_mod.convert_dtype(dtype), **kwargs)
        return wrap(out)

    def cpu(self):
        return wrap(torch.Tensor.cpu(self))

    def cuda(self, device_id=None, blocking=True):
        return self.to("cuda" if device_id is None else f"cuda:{device_id}")

    def set_value(self, value) -> None:
        """Overwrite the values in place (shape kept, cast to this dtype)."""
        with torch.no_grad():
            torch.Tensor.copy_(self, as_tensor(value, place=self.device))

    # ------------------------------------------------------------ operators
    def _op(name, reverse=False):
        def op(self, other):
            from ..ops import logic, math

            fn = getattr(math, name, None) or getattr(logic, name)
            return wrap(fn(other, self) if reverse else fn(self, other))

        op.__name__ = f"__{'r' if reverse else ''}{name}__"
        return op

    __add__, __radd__ = _op("add"), _op("add", True)
    __sub__, __rsub__ = _op("subtract"), _op("subtract", True)
    __mul__, __rmul__ = _op("multiply"), _op("multiply", True)
    __truediv__, __rtruediv__ = _op("divide"), _op("divide", True)
    __floordiv__, __rfloordiv__ = _op("floor_divide"), \
        _op("floor_divide", True)
    __mod__, __rmod__ = _op("mod"), _op("mod", True)
    __pow__, __rpow__ = _op("pow"), _op("pow", True)
    __matmul__, __rmatmul__ = _op("matmul"), _op("matmul", True)
    __eq__, __ne__ = _op("equal"), _op("not_equal")
    __lt__, __le__ = _op("less_than"), _op("less_equal")
    __gt__, __ge__ = _op("greater_than"), _op("greater_equal")
    del _op
    __hash__ = torch.Tensor.__hash__

    def __neg__(self):
        return wrap(torch.Tensor.__neg__(self))

    def __abs__(self):
        return wrap(torch.Tensor.__abs__(self))

    def __invert__(self):
        return wrap(torch.Tensor.__invert__(self))

    def __and__(self, other):
        return wrap(torch.Tensor.__and__(self, other))

    def __or__(self, other):
        return wrap(torch.Tensor.__or__(self, other))

    def __xor__(self, other):
        return wrap(torch.Tensor.__xor__(self, other))

    def __getitem__(self, index):
        return wrap(torch.Tensor.__getitem__(self, _index(index)))

    def __setitem__(self, index, value):
        if not isinstance(value, (torch.Tensor, numbers.Number)):
            value = as_tensor(value, place=self.device)
        torch.Tensor.__setitem__(self, _index(index), value)

    def __iter__(self):
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d tensor")
        return iter([self[i] for i in range(len(self))])


def _index(index):
    """An index with its ``Tensor`` s taken plain."""
    if isinstance(index, tuple):
        return tuple(plain(i) for i in index)
    return plain(index)


def _rebuild(t: torch.Tensor, stop_gradient: bool) -> Tensor:
    return _grad_enabled_leaf(t, stop_gradient)


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    """``data`` copied into a new ``Tensor`` on ``place`` (default: the
    default device) in ``dtype``; ``stop_gradient=False`` makes it a leaf
    that gradients flow to."""
    return Tensor(data, dtype=dtype, stop_gradient=stop_gradient,
                  place=place)


class Parameter(torch.nn.Parameter):
    """A trainable tensor (port of ``paddle_tpu/core/tensor.py``
    ``Parameter``): a ``torch.nn.Parameter``, so every torch module,
    optimizer and CUDA graph takes it as it is, with Paddle's attributes:
    ``trainable`` and ``stop_gradient`` (both views of ``requires_grad``),
    ``optimize_attr`` (``{"learning_rate": 1.0}``), ``regularizer``,
    ``need_clip``, ``init_fn`` (the initializer that filled it),
    ``is_parameter`` and ``persistable``, and the ``Tensor`` methods
    ``set_value``, ``clear_grad`` and ``numpy``. Its other methods are
    torch's (the port's modules call them). ``param_name`` stands for
    Paddle's ``name``: torch reserves ``Tensor.name``.

    ``Parameter(value, dtype=None, name=None, trainable=True)`` copies
    ``value`` (an array, a number, a list or a tensor) like ``Tensor``
    does; a torch tensor is taken without a copy. torch's own form,
    ``Parameter(data, requires_grad)``, also works. The subclass and the
    attributes survive ``copy.deepcopy``, pickling and the moves and casts
    of a ``Layer``."""

    def __new__(cls, value=None, dtype=None, name=None, trainable=True,
                requires_grad=None):
        if isinstance(dtype, bool):  # torch's Parameter(data, requires_grad)
            requires_grad, dtype = dtype, None
        if requires_grad is not None:
            trainable = requires_grad
        if value is None:
            value = torch.empty(0)
        if isinstance(value, torch.Tensor) and dtype is None:
            data = value.detach()
        else:
            data = as_tensor(value, dtype, value.device
                             if isinstance(value, torch.Tensor) else "cpu")
        if type(data) is not torch.Tensor:
            data = data.as_subclass(torch.Tensor)
        return torch.Tensor._make_subclass(cls, data, bool(trainable))

    def __init__(self, value=None, dtype=None, name=None, trainable=True,
                 requires_grad=None):
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.init_fn = None
        if name is not None:
            self.param_name = name

    is_parameter = True
    persistable = True

    @property
    def trainable(self) -> bool:
        return self.requires_grad

    @trainable.setter
    def trainable(self, value) -> None:
        self.requires_grad_(bool(value))

    @property
    def stop_gradient(self) -> bool:
        return not self.requires_grad

    @stop_gradient.setter
    def stop_gradient(self, value) -> None:
        self.requires_grad_(not bool(value))

    @property
    def place(self) -> str:
        dev = self.device
        return "cpu" if dev.type == "cpu" else f"gpu:{dev.index or 0}"

    @classmethod
    def like(cls, data: torch.Tensor, template: "Parameter") -> "Parameter":
        """``data`` (no copy) as a ``Parameter`` carrying ``template``'s
        attributes and ``requires_grad``."""
        p = torch.Tensor._make_subclass(cls, data.detach(),
                                        template.requires_grad)
        p.__dict__.update(template.__dict__)
        return p

    def numpy(self) -> np.ndarray:
        """A host copy (bf16 as float32 values)."""
        return Tensor.numpy(self)

    def set_value(self, value) -> None:
        """Overwrite the values in place (shape kept, cast to this dtype)."""
        with torch.no_grad():
            torch.Tensor.copy_(self, as_tensor(value, place=self.device))

    def clear_grad(self) -> None:
        self.grad = None

    clear_gradient = clear_grad

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = Parameter(self.data.clone(memory_format=torch.preserve_format),
                        requires_grad=self.requires_grad)
        memo[id(self)] = out
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out

    def __reduce_ex__(self, proto):
        return (_rebuild_parameter, (self.data, self.requires_grad,
                                     dict(self.__dict__)))

    def __repr__(self):
        return "Parameter containing:\n" + torch.Tensor.__repr__(
            self.detach())


def _rebuild_parameter(data, requires_grad, state) -> Parameter:
    p = Parameter(data, requires_grad=requires_grad)
    p.__dict__.update(state)
    return p
