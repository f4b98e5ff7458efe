"""``paddle.static`` for the port (port of
``paddle_tpu/static/__init__.py``): ``InputSpec``, the static-graph
``Program``/``Executor`` (``program.py``), the builders and control flow
of ``static.nn``, ``save_inference_model``/``load_inference_model`` and
``name_scope``.

An ``InputSpec`` declares an exported input's shape and dtype for
``jit.save``: ``None`` or ``-1`` marks a dynamic dim, which the export
keeps symbolic so that one saved program serves every size on that axis.

``save_inference_model`` writes, as ``jit.save`` does, a ``torch.export``
archive (``<prefix>.pdmodel``) where the JAX package writes a StableHLO
module: the program's replay from its feeds to its fetches, its constants
as the module's buffers, its registered operators (K1's and K4's forward,
``register_op`` ops) one node each, and the feed names and specs in the
archive's extra files. A None/-1 feed dim exports as a symbolic dim; the
recording resolved the sizes its ops took, so an op that took a size
derived from that dim fails the export rather than fixing the dim. A
program with a control-flow node does not export (its predicate is data
on the host). ``load_inference_model`` moves the program to the device
asked for and returns ``(program, feed_names, None)``; ``Executor.run``
runs it.
"""
from __future__ import annotations

import io
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["Executor", "InputSpec", "Program", "append_backward", "data",
           "default_main_program", "default_startup_program",
           "disable_static", "enable_static", "in_static_mode",
           "load_inference_model", "name_scope", "nn", "program_guard",
           "save_inference_model", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` (a ``torch.dtype``, a numpy dtype or a name such as
    ``"int64"`` or ``"bfloat16"``) as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


class InputSpec:
    """Shape, dtype and name of one exported input (reference
    ``static/input.py::InputSpec``). ``None`` or ``-1`` dims are dynamic;
    ``dtype`` is a ``torch.dtype`` or its name."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name=None, stop_gradient=True):
        self.shape = [None if (s is None or s == -1) else int(s)
                      for s in shape]
        self.dtype = torch_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), str(ndarray.dtype), name)

    def batch(self, batch_size):
        return InputSpec([batch_size] + self.shape, self.dtype, self.name)

    def unbatch(self):
        if not self.shape:
            raise ValueError("cannot unbatch a 0-D InputSpec")
        return InputSpec(self.shape[1:], self.dtype, self.name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    def __eq__(self, other):
        return (isinstance(other, InputSpec) and self.shape == other.shape
                and self.dtype == other.dtype and self.name == other.name)

    def __hash__(self):
        return hash((tuple(self.shape), str(self.dtype), self.name))


from . import nn  # noqa: E402
from .program import (Executor, Program, append_backward, data,  # noqa: E402
                      default_main_program, default_startup_program,
                      disable_static, enable_static, in_static_mode,
                      program_guard, tensor_key)

_META = "paddle_static_program"


class _ProgramModule(torch.nn.Module):
    """A program's replay from ``feed_names`` to ``fetch_keys`` as a module
    for ``torch.export``: its constants are the module's buffers."""

    def __init__(self, program: Program, feed_names, fetch_keys):
        super().__init__()
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_keys = list(fetch_keys)
        self.const_keys = []
        for i, (key, t) in enumerate(program.constants().items()):
            self.register_buffer(f"c{i}", t.detach())
            self.const_keys.append(key)

    def forward(self, *feeds):
        from ..core import hooks

        env = {self.program.feeds[n]: f
               for n, f in zip(self.feed_names, feeds)}
        env.update((key, getattr(self, f"c{i}"))
                   for i, key in enumerate(self.const_keys))
        with hooks.suspended():
            self.program.run_ops(env)
        return tuple(env[k] for k in self.fetch_keys)


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         program=None, **kwargs):
    """Serialize the recorded program's feed → fetch computation and the
    constants it reads (reference ``static/io.py::save_inference_model``)
    as a ``torch.export`` archive, ``<path_prefix>.pdmodel``."""
    from torch.export.passes import move_to_device_pass

    from ..core import hooks

    prog = program or default_main_program()
    feed_vars = feed_vars if isinstance(feed_vars, (list, tuple)) \
        else [feed_vars]
    fetch_vars = fetch_vars if isinstance(fetch_vars, (list, tuple)) \
        else [fetch_vars]
    if prog.control_flow:
        raise NotImplementedError(
            "save_inference_model: a program with a static.nn control-flow "
            "node reads its predicates on the host and does not export yet "
            "(ROADMAP.md, queue 1 item 2)")
    names = sorted(prog.feeds)
    module = _ProgramModule(prog, names,
                            [tensor_key(t) for t in fetch_vars])
    examples, dynamic, rank = [], [], 0
    for n in names:
        placeholder = prog._placeholders[n]
        shape, axes = [], {}
        for ax, s in enumerate(prog.feed_specs[n][0]):
            if s is None or int(s) < 0:
                # distinct sizes of 2 and up: torch specializes 0 and 1
                axes[ax] = torch.export.Dim(f"{n}_{ax}", min=1)
                shape.append(2 + rank)
                rank += 1
            else:
                shape.append(int(s))
        examples.append(torch.zeros(shape, dtype=placeholder.dtype,
                                    device=placeholder.device))
        dynamic.append(axes or None)
    with hooks.suspended(), torch.no_grad():
        ep = torch.export.export(module, tuple(examples),
                                 dynamic_shapes=(tuple(dynamic),),
                                 strict=False)
    if any(p.device.type != "cpu" for p in prog._placeholders.values()):
        ep = move_to_device_pass(ep, "cpu")
    meta = {"feed_names": names,
            "feed_specs": [([None if s is None or int(s) < 0 else int(s)
                             for s in prog.feed_specs[n][0]],
                            str(prog.feed_specs[n][1]).replace("torch.", ""))
                           for n in names]}
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(ep, f, extra_files={_META: json.dumps(meta)})
    return path_prefix


class _LoadedProgram:
    """A loaded inference program: ``feed_names``, ``feed_specs``, and
    ``__call__(feed)`` giving the fetches as numpy arrays."""

    def __init__(self, exported, meta: dict, device: torch.device):
        self.module = exported.module()
        self.device = device
        self.feed_names = meta["feed_names"]
        self.feed_specs = [tuple(spec) for spec in meta["feed_specs"]]

    def __call__(self, feed) -> list:
        from ..core import hooks
        from .program import _host

        vals = []
        for name, (_, dtype) in zip(self.feed_names, self.feed_specs):
            v = feed[name]
            if not isinstance(v, torch.Tensor):
                v = torch.from_numpy(np.ascontiguousarray(v))
            vals.append(v.to(device=self.device, dtype=getattr(torch, dtype)))
        with hooks.suspended(), torch.inference_mode():
            return [_host(o) for o in self.module(*vals)]


def load_inference_model(path_prefix, executor=None, **kwargs):
    """``(program, feed_names, None)`` in the reference's
    ``(program, feed_target_names, fetch_targets)`` shape: the program is
    on ``executor``'s device (default: the default device)."""
    from torch.export.passes import move_to_device_pass

    from ..core import hooks
    from ..core.tensor import _place

    device = executor.device if executor is not None else _place(None)
    extra = {_META: ""}
    with open(path_prefix + ".pdmodel", "rb") as f:
        raw = io.BytesIO(f.read())
    with hooks.suspended():
        ep = move_to_device_pass(torch.export.load(raw, extra_files=extra),
                                 device)
    prog = _LoadedProgram(ep, json.loads(extra[_META]), device)
    return prog, prog.feed_names, None


class name_scope:
    """A naming block (reference ``static.name_scope``): the port names no
    ops, so it does nothing."""

    def __init__(self, *a, **k):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
