"""``nn.Layer``, the base of every layer and model of the port (port of
``paddle_tpu/nn/layer/layers.py``), and how layers come to hold their
parameters.

``Layer`` is a ``torch.nn.Module`` with Paddle's API on top; torch's stays
(its own recursion calls ``state_dict(destination=, prefix=,
keep_vars=)``, ``train(mode)``, ``named_parameters(prefix=, recurse=,
remove_duplicate=)`` on every child, so each override takes torch's
keywords too). Paddle's: ``create_parameter`` (the ``ParamAttr``'s
initializer, else the layer's default, else the global one, else
``XavierNormal`` or a zero bias), ``add_parameter``, ``add_sublayer``,
``register_buffer(..., persistable=)``, ``parameters(include_sublayers)``
(a list), ``named_sublayers``/``sublayers(include_self)``, forward pre-
and post-hooks (torch's hooks: a pre-hook's non-tuple result is wrapped
and the post-hook sees the hooked inputs, as in JAX), ``state_dict``
(non-persistable buffers left out), ``set_state_dict``/``load_dict``
(returning ``(missing, unexpected)``, raising on a shape mismatch),
``to(device=, dtype=)`` with Paddle's place names, ``astype``,
``float16``, ``clear_gradients`` and ``full_name``. As in JAX, a tensor
assigned to a parameter's name becomes a ``Parameter``; so does a
``torch.nn.Parameter`` (the layers built on torch's classes create
those), and a move or cast keeps every ``Parameter`` and its attributes.
A layer that draws dropout without a generator of its own holds the
process-wide dropout generator of the default device from its
construction (:func:`held_generator`); ``to(device)`` gives it the new
device's, and ``copy.deepcopy`` shares every generator a layer holds, as
every copy of a JAX layer draws from the one global key.

Two ways to come to hold parameters:

- A ``Layer`` a user writes builds eagerly, as in JAX: ``create_parameter``
  allocates on the default device (``set_device``'s, else CUDA; raising
  when CUDA is absent and the CPU was not asked for) and fills the
  parameter at once from the process-wide build generator that
  ``paddle.seed`` seeds.
- A public constructor of the port's with parameters builds inside
  :func:`building`: its submodules are made without storage (on the
  ``meta`` device), so torch's own initializers neither run nor draw from
  the global generator. The outermost module under construction then
  takes CPU storage, draws every initial value from one explicit
  ``torch.Generator`` (default: the build generator), so one seed gives
  the same weights on every device, moves to the device the caller asked
  for and names its parameters. A module built inside another's build
  leaves all of that to the outer one.
"""
from __future__ import annotations

import contextlib
import copy
from collections import OrderedDict
from typing import Callable, Optional

import torch
from torch import nn

from ...base import dtype as dtype_mod
from ...base.global_state import (build_generator, default_dtype,
                                  dropout_generator, is_dropout_generator)
from ...core.tensor import Parameter, as_tensor, plain
from ...device import DEFAULT_DEVICE, _parse, resolve_device

__all__ = ["Layer", "building", "held_generator", "init_parameters",
           "name_parameters"]


def _building_now() -> bool:
    """Inside a :func:`building` block (tensors are made on ``meta``)."""
    return torch.empty(0).device.type == "meta"


def _promote(module: nn.Module) -> None:
    """Every plain ``torch.nn.Parameter`` held in ``module``'s tree (a torch
    layer's, such as ``nn.Embedding``'s) as a ``Parameter``, in place of
    the same storage."""
    for mod in module.modules():
        for key, p in mod._parameters.items():
            if p is not None and not isinstance(p, Parameter):
                mod._parameters[key] = Parameter(p.detach(),
                                                 requires_grad=p.requires_grad)


def name_parameters(model: nn.Module) -> None:
    """Make every parameter of ``model`` a ``Parameter`` and give each
    without a name (a ``ParamAttr``'s) a ``param_name``, its qualified
    state-dict key, which AdamW passes to
    ``apply_decay_param_fun`` where the JAX package passes ``p.name`` (a
    process-wide counter there, which cannot be matched; torch reserves
    ``Tensor.name``)."""
    _promote(model)
    for name, p in model.named_parameters():
        if getattr(p, "param_name", None) is None:
            p.param_name = name


@torch.no_grad()
def init_parameters(model: nn.Module, gen: torch.Generator) -> None:
    """Each module's initializers, in ``model.modules()`` order: every
    module that defines ``_init_parameters(gen)`` (every ``Layer``: each
    parameter's ``init_fn``; the BatchNorms also set their running stats)
    fills its own parameters and buffers."""
    for mod in model.modules():
        init = getattr(mod, "_init_parameters", None)
        if init is not None:
            init(gen)


@contextlib.contextmanager
def building(model: nn.Module, device, generator: Optional[torch.Generator],
             init: Callable[[nn.Module, torch.Generator], None]
             = init_parameters):
    """Build ``model``'s parameters and submodules inside this block
    without storage; on leaving, the outermost model under construction
    takes CPU storage, runs ``init(model, generator)``, moves to
    ``device`` and names its parameters. Inside another build it does
    nothing, and ``device`` is not resolved."""
    if _building_now():
        yield
        return
    dev = resolve_device(device)
    with torch.device("meta"):
        yield
    model.to_empty(device="cpu")
    init(model, generator if generator is not None else build_generator())
    model.to(dev)
    name_parameters(model)


def held_generator(generator: Optional[torch.Generator],
                   draws: bool) -> Optional[torch.Generator]:
    """The generator a layer that draws dropout holds from its
    construction: ``generator``, else, when the layer draws at all
    (``draws``), the process-wide dropout generator of the default device,
    resolved as ``create_parameter`` resolves it. Held from the start, it
    is registered by a captured step and saved by a snapshot taken before
    the first step."""
    if generator is not None or not draws:
        return generator
    return dropout_generator(resolve_device(DEFAULT_DEVICE))


def _place(device) -> torch.device:
    """A Paddle place name (``"gpu"``, ``"gpu:0"``, ``"cpu"``), a torch
    device name or a ``torch.device`` as a resolved ``torch.device``."""
    if isinstance(device, str) and device is not DEFAULT_DEVICE:
        device = _parse(device)
    return resolve_device(device)


def _dtype_name(value) -> bool:
    """Whether ``value`` is a dtype's name (``"bfloat16"``)."""
    if not isinstance(value, str):
        return False
    try:
        dtype_mod.convert_dtype(value)
    except ValueError:
        return False
    return True


class Layer(nn.Module):
    """The base of a layer or a model: ``forward`` computes; parameters,
    sublayers and buffers assigned as attributes register themselves."""

    def __init__(self, name_scope=None, dtype="float32"):
        super().__init__()
        self._dtype = dtype
        self._name_scope = name_scope or type(self).__name__.lower()

    # ------------------------------------------------ attribute plumbing
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if isinstance(value, nn.Parameter):
            if not isinstance(value, Parameter):
                value = Parameter(value.detach(),
                                  requires_grad=value.requires_grad)
        elif (params is not None and name in params
              and isinstance(value, torch.Tensor)):
            # the registry stays authoritative, as in JAX: a tensor
            # assigned to a parameter becomes a Parameter
            value = Parameter(plain(value).detach())
        super().__setattr__(name, value)

    def _apply(self, fn, recurse=True):
        # torch rebuilds a parameter as a plain nn.Parameter when the new
        # tensor cannot take the old one's place (meta -> CPU storage):
        # keep the subclass and its attributes
        before = {k: p for k, p in self._parameters.items()
                  if isinstance(p, Parameter)}
        out = super()._apply(fn, recurse)
        for key, old in before.items():
            new = self._parameters.get(key)
            if new is not None and not isinstance(new, Parameter):
                p = Parameter.like(new, old)
                p.grad = new.grad
                self._parameters[key] = p
        return out

    def __deepcopy__(self, memo):
        # the copy draws from the generators the original holds: a copied
        # generator would repeat the original's dropout masks
        for mod in self.modules():
            for value in vars(mod).values():
                if isinstance(value, torch.Generator):
                    memo.setdefault(id(value), value)
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(copy.deepcopy(self.__getstate__(), memo))
        return new

    # ------------------------------------------------ registration
    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None, *, transposed=False):
        """A new ``Parameter`` of ``shape``: filled by ``attr``'s
        initializer, else ``default_initializer``, else the global one
        (``set_global_initializer``), else ``XavierNormal`` (a zero bias);
        ``attr``'s ``trainable``, ``learning_rate``, ``regularizer``,
        ``need_clip`` and ``name`` (as ``param_name``) applied. ``attr=
        False`` gives None. ``transposed`` marks a tensor kept as the
        transpose of the JAX package's (a ``Linear`` weight): the
        initializer works on the JAX shape. Inside a :func:`building` block
        the parameter has no storage yet and the build fills it; otherwise
        it lies on the default device, filled from the build generator."""
        from ..initializer import Constant, XavierNormal
        from ..initializer.attr_helpers import resolve_param_attr
        from ..initializer.initializers import global_initializer

        if attr is False:
            return None
        attr = resolve_param_attr(attr)
        init = (attr.initializer or default_initializer
                or global_initializer(is_bias)
                or (Constant(0.0) if is_bias else XavierNormal()))
        dt = dtype_mod.convert_dtype(dtype or self._dtype) or default_dtype()
        eager = not _building_now()
        dev = resolve_device(DEFAULT_DEVICE) if eager else None
        # on the CPU (or without storage inside a build) until filled
        p = Parameter(torch.empty([int(s) for s in shape], dtype=dt))
        if transposed:
            p.transposed = True
        if eager:
            init(p, generator=build_generator())
            p = Parameter.like(p.data.to(dev), p)
        p.trainable = attr.trainable
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        if attr.name:
            p.param_name = attr.name
        p.init_fn = init
        return p

    @torch.no_grad()
    def _init_parameters(self, gen: torch.Generator) -> None:
        """Inside a build: each parameter this layer made with
        ``create_parameter``, filled by its ``init_fn`` from ``gen``, in
        the order they were registered."""
        for p in self._parameters.values():
            if p is not None and getattr(p, "init_fn", None) is not None:
                p.init_fn(p, generator=gen)

    def add_parameter(self, name, parameter):
        """Register ``parameter`` (a tensor becomes a ``Parameter``) under
        ``name``; returns it."""
        if parameter is not None and not isinstance(parameter, Parameter):
            parameter = Parameter(plain(parameter).detach()
                                  if isinstance(parameter, torch.Tensor)
                                  else parameter)
        self.register_parameter(name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        """Register ``sublayer`` under ``str(name)``; returns it."""
        if sublayer is not None and not isinstance(sublayer, nn.Module):
            raise TypeError("sublayer must be a Layer")
        self.add_module(str(name), sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True, *,
                        persistent=None):
        """Register ``tensor`` (an array becomes a tensor) as a buffer;
        a non-persistable one stays out of ``state_dict``. torch's
        ``persistent=`` is taken too. Returns the tensor, kept plain."""
        if persistent is not None:
            persistable = persistent
        if tensor is not None:
            tensor = plain(tensor) if isinstance(tensor, torch.Tensor) \
                else as_tensor(tensor)
        super().register_buffer(name, tensor, persistent=bool(persistable))
        return tensor

    # ------------------------------------------------ traversal
    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return super().named_parameters(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def parameters(self, include_sublayers=True, recurse=None):
        """The parameters, as a list (Paddle's; torch's is an iterator)."""
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_buffers(self, prefix="", include_sublayers=True, recurse=None,
                      remove_duplicate=True):
        return super().named_buffers(
            prefix=prefix,
            recurse=include_sublayers if recurse is None else recurse,
            remove_duplicate=remove_duplicate)

    def buffers(self, include_sublayers=True, recurse=None):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers, recurse=recurse)]

    def named_sublayers(self, prefix="", include_self=False,
                        layers_set=None):
        """``(name, layer)`` of every sublayer, depth first, each once."""
        for name, mod in self.named_modules(memo=layers_set, prefix=prefix):
            if mod is self and not include_self:
                continue
            yield name, mod

    def sublayers(self, include_self=False):
        return [m for _, m in self.named_sublayers(include_self=include_self)]

    # ------------------------------------------------ hooks
    def register_forward_pre_hook(self, hook, **kwargs):
        """``hook(layer, inputs)`` before ``forward``; a result that is not
        None replaces the inputs (a non-tuple one wrapped). ``.remove()``
        on the returned handle takes it off."""
        return super().register_forward_pre_hook(hook, **kwargs)

    def register_forward_post_hook(self, hook):
        """``hook(layer, inputs, outputs)`` after ``forward``; a result
        that is not None replaces the outputs."""
        return self.register_forward_hook(hook)

    # ------------------------------------------------ state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True, *, prefix="",
                   keep_vars=False):
        """Parameters, then persistable buffers, by qualified name (tensors
        sharing the layer's storage), as the JAX ``state_dict`` orders
        them."""
        if structured_name_prefix and not structured_name_prefix.endswith(
                "."):
            structured_name_prefix += "."
        prefix = prefix or structured_name_prefix
        if not include_sublayers:
            out = destination if destination is not None else OrderedDict()
            self._save_to_state_dict(out, prefix, keep_vars)
            return out
        out = super().state_dict(destination=destination, prefix=prefix,
                                 keep_vars=keep_vars)
        if destination is not None:  # inside torch's recursion
            return out
        # the JAX order: every parameter, then every buffer
        params = {prefix + name for name, _ in self.named_parameters()}
        ordered = OrderedDict((k, v) for k, v in out.items() if k in params)
        ordered.update((k, v) for k, v in out.items() if k not in params)
        ordered._metadata = getattr(out, "_metadata", None)
        return ordered

    @torch.no_grad()
    def set_state_dict(self, state_dict, use_structured_name=True):
        """Copy ``state_dict``'s tensors (or arrays) into this layer's, in
        place; returns ``(missing, unexpected)`` key lists; raises
        ``ValueError`` on a shape mismatch. A ``Linear`` weight is
        ``[out, in]`` here, torch's layout (``models.gpt.load_jax_state``
        takes the JAX package's ``[in, out]``)."""
        own = self.state_dict()
        missing = []
        for name, target in own.items():
            if name not in state_dict:
                missing.append(name)
                continue
            src = state_dict[name]
            src = plain(src) if isinstance(src, torch.Tensor) \
                else as_tensor(src, place=target.device)
            if list(src.shape) != list(target.shape):
                raise ValueError(f"shape mismatch for '{name}': checkpoint "
                                 f"{list(src.shape)} vs model "
                                 f"{list(target.shape)}")
            target.copy_(src)
        unexpected = [name for name in state_dict if name not in own]
        return missing, unexpected

    load_dict = set_state_dict

    # ------------------------------------------------ dtype/device movement
    def to(self, *args, **kwargs):
        """``to(device=None, dtype=None, blocking=None)`` in Paddle's names
        (``"gpu"``, ``"gpu:0"``, ``"cpu"``, ``"bfloat16"``) or torch's."""
        device, dtype = kwargs.pop("device", None), kwargs.pop("dtype", None)
        kwargs.pop("blocking", None)
        for a in args:
            if isinstance(a, bool):
                kwargs["non_blocking"] = a
            elif isinstance(a, torch.dtype) or _dtype_name(a):
                dtype = a
            elif isinstance(a, torch.Tensor):
                device, dtype = a.device, a.dtype
            elif a is not None:
                device = a
        if dtype is not None:
            dtype = dtype_mod.convert_dtype(dtype)
            self._set_dtype(dtype)
        if device is not None:
            device = _place(device)
            self._move_dropout_generators(device)
        return super().to(device=device, dtype=dtype, **kwargs)

    def _move_dropout_generators(self, device: torch.device) -> None:
        """Each layer holding a process-wide dropout generator of another
        device takes ``device``'s."""
        for mod in self.modules():
            gen = vars(mod).get("generator")
            if (isinstance(gen, torch.Generator) and gen.device != device
                    and is_dropout_generator(gen)):
                mod.generator = dropout_generator(device)

    def _set_dtype(self, dtype) -> None:
        name = dtype_mod.dtype_name(dtype)
        for layer in self.modules():
            if isinstance(layer, Layer):
                layer._dtype = name

    def astype(self, dtype):
        """Cast the floating parameters and buffers to ``dtype``."""
        return self.to(dtype=dtype)

    def float16(self):
        return self.to(dtype=torch.float16)

    def bfloat16(self):
        return self.to(dtype=torch.bfloat16)

    def float(self):
        return self.to(dtype=torch.float32)

    # ------------------------------------------------ misc
    def clear_gradients(self) -> None:
        for p in self.parameters():
            p.grad = None

    def full_name(self) -> str:
        return self._name_scope
