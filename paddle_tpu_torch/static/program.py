"""Static-graph ``Program`` and ``Executor`` (port of
``paddle_tpu/static/program.py``).

As in the JAX package, static mode records ops as they execute eagerly on
placeholder tensors, so a ``Program`` is an op list with feed and fetch
bindings, and shape inference is eager execution. The recorder is the
``static_capture`` slot of ``core/hooks.py``: a dispatch-level mode hands
:meth:`Program.record` every op below autograd, by its schema name
(``aten::mm``, ``paddle_tpu_torch::rms_norm_fwd``), with its arguments as
the dispatcher resolved them.

- A value is keyed by what it is in memory (:func:`tensor_key`: storage,
  offset, shape, strides, dtype, device), not by its Python object: the
  port's ``Tensor`` is an alias of the plain tensor an op returned. The
  program keeps every recorded output alive, so no key is reused.
- An op is recorded when it reads a live value: a feed, or the output of
  a recorded op. One that reads none (building and loading a model,
  creating a constant, ``set_value``) runs once, at build time, and its
  outputs enter the program as constants.
- Constants replay by reference: ``set_value`` between runs is seen. A
  recorded op that writes into a constant writes, at every run, into a
  copy of the value the constant had as the op was about to run at build
  time: a replay changes no tensor outside the program (so replays do not
  compound, and a train-mode BatchNorm's running stats stay put, as a
  JAX replay leaves them).

``Executor.run`` replays a straight-line program on the card as one CUDA
graph per (program version, feed signature, fetch list), through
``jit/functionalize.py`` ``CompiledFunction`` (its first call eager, its
second captured): the counterpart of one ``jax.jit`` per signature. A
graph holds the constants' addresses, so a constant whose storage was
rebound since (``p.data = ...``), or a view whose base was, raises instead
of replaying stale values. A program holding a ``static.nn`` control-flow
node reads its predicates on the host, which a CUDA graph cannot, and
replays eagerly; :meth:`Executor.replay_counts` shows which way each run
went. On the CPU every run is eager.
"""
from __future__ import annotations

import itertools
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..base import dtype as dtype_mod
from ..base.flags import get_flag
from ..core import hooks
from ..core.tensor import wrap
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["Executor", "Program", "append_backward", "data",
           "default_main_program", "default_startup_program",
           "disable_static", "enable_static", "in_static_mode",
           "program_guard", "tensor_key"]


def tensor_key(t: torch.Tensor) -> tuple:
    """A value's key in a program: its storage, offset, shape, strides,
    dtype and device (aliases of one tensor share it)."""
    return (t.untyped_storage().data_ptr(), t.storage_offset(),
            tuple(t.shape), tuple(t.stride()), t.dtype, t.device)


_WRITES: Dict[object, tuple] = {}


def _written(func) -> tuple:
    """The positions of ``func``'s arguments that it writes into."""
    pos = _WRITES.get(func)
    if pos is None:
        pos = tuple(i for i, a in enumerate(func._schema.arguments)
                    if a.alias_info is not None and a.alias_info.is_write)
        _WRITES[func] = pos
    return pos


def _bind(x):
    """An argument as a replayable binding: ``("v", key, tensor)`` for a
    tensor (resolved in the replay's environment, else the tensor itself,
    by reference), ``("l", type, [...])`` for a list or tuple, ``("c",
    value)`` for anything else (a dict: ``("d", {name: binding})``)."""
    if isinstance(x, torch.Tensor):
        return ("v", tensor_key(x), x)
    if isinstance(x, (list, tuple)):
        return ("l", type(x), [_bind(v) for v in x])
    if isinstance(x, dict):
        return ("d", {k: _bind(v) for k, v in x.items()})
    return ("c", x)


def _resolve(spec, env):
    kind = spec[0]
    if kind == "v":
        return env.get(spec[1], spec[2])
    if kind == "l":
        return spec[1](_resolve(s, env) for s in spec[2])
    if kind == "d":
        return {k: _resolve(s, env) for k, s in spec[1].items()}
    return spec[1]


def _keys(spec, out: list) -> list:
    """The ``(key, tensor)`` pairs a binding holds, appended to ``out``."""
    if spec[0] == "v":
        out.append((spec[1], spec[2]))
    elif spec[0] in ("l", "d"):
        for s in (spec[2] if spec[0] == "l" else spec[1].values()):
            _keys(s, out)
    return out


class _Node:
    """One recorded op: the operator, its argument bindings, the keys of
    its outputs (and the outputs, kept alive) and, per written argument
    that is a build-time constant, the value it had before the write."""

    __slots__ = ("name", "fn", "args", "kwargs", "out_keys", "out_refs",
                 "cow")

    def __init__(self, name, fn, args, kwargs, outs, cow):
        self.name = name
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.out_refs = outs
        self.out_keys = [tensor_key(t) for t in outs]
        self.cow = cow

    def bindings(self) -> list:
        return [self.args, self.kwargs]

    def run(self, env) -> None:
        args = list(_resolve(self.args, env))
        for pos, before in self.cow:
            args[pos] = before.clone()
        out = self.fn(*args, **_resolve(self.kwargs, env))
        for key, t in zip(self.out_keys, hooks.output_tensors(out)):
            env[key] = t


class Program:
    """A recorded op list with its feeds (reference
    ``base/framework.py::Program``); ``parent`` is the enclosing program of
    a control-flow branch, whose live values are live here too."""

    _uids = itertools.count()

    def __init__(self, parent: Optional["Program"] = None):
        self.ops: List[_Node] = []
        self.feeds: Dict[str, tuple] = {}         # feed name -> key
        self.feed_specs: Dict[str, tuple] = {}    # feed name -> (shape, dtype)
        self._placeholders: Dict[str, torch.Tensor] = {}
        self._live = set()
        self._before: Dict[tuple, torch.Tensor] = {}
        self._parent = parent
        # a branch program's result bindings (static/control_flow.py)
        self.results: list = []
        self.control_flow = False
        self._version = 0
        self._consts = None  # (version, constants())
        self._uid = next(Program._uids)
        self._lock = threading.Lock()

    # -- recording (installed as hooks.static_capture) ----------------------
    def is_live(self, key) -> bool:
        return key in self._live or (self._parent is not None
                                     and self._parent.is_live(key))

    def _reads_live(self, args, kwargs) -> bool:
        return any(self.is_live(k) for k, _ in
                   _keys(_bind(tuple(args)), []) + _keys(_bind(kwargs), []))

    def before(self, func, args, kwargs) -> None:
        """Called as ``func`` is about to run: when it will be recorded,
        keep the value of each constant it writes into (a tensor the
        program did not produce), for the recorded write to start from at
        every replay."""
        written = [args[pos] for pos in _written(func) if pos < len(args)
                   and isinstance(args[pos], torch.Tensor)]
        if not written or not self._reads_live(args, kwargs):
            return
        for t in written:
            key = tensor_key(t)
            if not self.is_live(key) and key not in self._before:
                self._before[key] = t.detach().clone()

    def record(self, name, func, args, kwargs, out) -> None:
        outs = hooks.output_tensors(out)
        writes = _written(func)
        if not outs and not writes:
            return  # a host read (.item(), bool()): nothing to replay
        args_b, kwargs_b = _bind(tuple(args)), _bind(dict(kwargs))
        reads = _keys(args_b, []) + _keys(kwargs_b, [])
        if not any(self.is_live(k) for k, _ in reads):
            return  # a build-time op: its outputs are constants
        cow = []
        for pos in writes:
            if pos < len(args) and isinstance(args[pos], torch.Tensor):
                key = tensor_key(args[pos])
                if not self.is_live(key) and key in self._before:
                    cow.append((pos, self._before.pop(key)))
        with self._lock:
            node = _Node(name, func, args_b, kwargs_b, outs, cow)
            self._add(node)

    def _add(self, node) -> None:
        self.ops.append(node)
        self._live.update(node.out_keys)
        self._version += 1

    def add_feed(self, name, placeholder, shape, dtype) -> None:
        key = tensor_key(placeholder)
        self.feeds[name] = key
        self.feed_specs[name] = (tuple(shape), dtype)
        self._placeholders[name] = placeholder
        self._live.add(key)
        self._version += 1

    # -- introspection -------------------------------------------------------
    def op_types(self) -> List[str]:
        return [n.name for n in self.ops]

    def __repr__(self):
        return (f"Program(feeds={list(self.feeds)}, "
                f"ops={len(self.ops)}: {self.op_types()[:8]}...)")

    def clone(self, for_test: bool = False) -> "Program":
        p = Program(self._parent)
        p.ops = list(self.ops)
        p.feeds = dict(self.feeds)
        p.feed_specs = dict(self.feed_specs)
        p._placeholders = dict(self._placeholders)
        p._live = set(self._live)
        p.control_flow = self.control_flow
        return p

    def verify(self, fetch_list=None, raise_on_error: bool = True):
        """The JAX package's well-formedness pass
        (``paddle_tpu.analysis.program_verify``), not ported yet."""
        raise NotImplementedError(
            "Program.verify: the analysis passes are not ported yet "
            "(ROADMAP.md, queue 1 item 9)")

    def constants(self) -> Dict[tuple, torch.Tensor]:
        """The tensors the program reads by reference: bound by its ops
        (and its control-flow branches) and neither fed nor produced.
        Computed once a program version (a read-only mapping)."""
        if self._consts is None or self._consts[0] != self._version:
            out: Dict[tuple, torch.Tensor] = {}
            self._constants(out, set())
            self._consts = (self._version, out)
        return self._consts[1]

    def _constants(self, out, live) -> None:
        live = live | self._live
        specs = [spec for node in self.ops for spec in node.bindings()]
        for spec in specs + self.results:
            if isinstance(spec, Program):
                spec._constants(out, live)
                continue
            for key, t in _keys(spec, []):
                if key not in live:
                    out.setdefault(key, t)

    # -- replay --------------------------------------------------------------
    def run_ops(self, env) -> None:
        """Run the ops in order over ``env`` (key -> tensor), which takes
        their outputs."""
        for node in self.ops:
            node.run(env)

    def _replay(self, feed_values: Dict[str, torch.Tensor],
                fetch_keys: Sequence[tuple]) -> List[torch.Tensor]:
        env = {key: feed_values[name] for name, key in self.feeds.items()}
        with hooks.suspended(), torch.no_grad():
            self.run_ops(env)
        return [env[k] for k in fetch_keys]


_default_main = Program()
_default_startup = Program()
_static_mode = False


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


def enable_static():
    """``paddle.enable_static``: ops start recording into the default main
    program (they still execute eagerly on placeholder values, which is
    what performs shape and dtype inference)."""
    global _static_mode
    _static_mode = True
    hooks.static_capture = _default_main


def disable_static():
    global _static_mode
    _static_mode = False
    hooks.static_capture = None


def in_static_mode() -> bool:
    return _static_mode


class program_guard:
    """Record into ``main_program`` within the block (reference
    ``static/program_guard``)."""

    def __init__(self, main_program: Program,
                 startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program
        self._prev = None

    def __enter__(self):
        self._prev = hooks.static_capture
        hooks.static_capture = self.main
        return self

    def __exit__(self, *exc):
        hooks.static_capture = self._prev
        return False


def data(name: str, shape: Sequence[Optional[int]], dtype="float32",
         lod_level=0):
    """Declare a feed (reference ``static/input.py::data``): a zero
    placeholder ``Tensor`` on the default device (None/-1 dims become 1
    for build-time inference), registered with the recording program."""
    concrete = [1 if (s is None or int(s) < 0) else int(s) for s in shape]
    dt = dtype_mod.convert_dtype(dtype)
    with hooks.suspended():
        placeholder = wrap(torch.zeros(concrete, dtype=dt,
                                       device=resolve_device(DEFAULT_DEVICE)))
    prog = hooks.static_capture or _default_main
    if isinstance(prog, Program):
        prog.add_feed(name, placeholder, shape, dt)
    return placeholder


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """Replay executor (reference ``base/executor.py::Executor``): runs on
    ``place`` (a ``CPUPlace()``/``CUDAPlace(i)`` name or a device; default:
    the default device, CUDA unless ``set_device`` chose the CPU). On the
    card a straight-line program replays as one CUDA graph per (program
    version, feed signature, fetch list); see the module."""

    def __init__(self, place=None):
        from ..core.tensor import _place

        self.place = place
        self.device = _place(place)
        self._cache: Dict[tuple, dict] = {}
        self._eager = 0

    def replay_counts(self) -> dict:
        """Runs replayed from a captured graph and runs replayed eagerly
        (the first run of each signature on the card, control-flow
        programs, every run on the CPU)."""
        stats = [e["fn"].stats for e in self._cache.values()]
        graph = sum(st["compiled_steps"] for st in stats)
        eager = self._eager + sum(st["eager_steps"] for st in stats)
        return {"graph": graph, "eager": eager}

    def _feeds(self, program: Program, feed) -> Dict[str, torch.Tensor]:
        out = {}
        for name, placeholder in program._placeholders.items():
            if name not in feed:
                raise KeyError(f"missing feed '{name}'")
            if placeholder.device.type != self.device.type:
                raise ValueError(
                    f"feed '{name}' was declared on {placeholder.device}; "
                    f"this Executor runs on {self.device}")
            value = feed[name]
            if not isinstance(value, torch.Tensor):
                value = torch.from_numpy(np.ascontiguousarray(value))
            out[name] = value.to(device=placeholder.device,
                                 dtype=placeholder.dtype)
        return out

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy=True):
        program = program or _default_main
        feed = feed or {}
        fetch_list = fetch_list or []
        if not isinstance(program, Program):
            if callable(program) and hasattr(program, "feed_names"):
                return program(feed)  # a loaded inference program
            raise TypeError(f"Executor.run expects a Program, got "
                            f"{type(program)}")
        if not program.ops:
            return []  # the startup program: parameters exist already
        if get_flag("static_verify_program"):
            raise NotImplementedError(
                "FLAGS_static_verify_program: the analysis verify pass is "
                "not ported yet (ROADMAP.md, queue 1 item 9)")
        fetch_keys = [tensor_key(t) for t in fetch_list]
        if not all(program.is_live(k) for k in fetch_keys):
            raise KeyError(
                "fetch targets were not produced by this program (fetch a "
                "Tensor created inside program_guard / static mode)")
        with hooks.suspended():
            feeds = self._feeds(program, feed)
            names = sorted(feeds)
            sig = (program._uid, program._version,
                   tuple((n, tuple(feeds[n].shape), feeds[n].dtype)
                         for n in names), tuple(fetch_keys))
            outs = self._run(program, sig, names, feeds, fetch_keys)
        if return_numpy:
            return [_host(o) for o in outs]
        return [wrap(o) for o in outs]

    def _run(self, program, sig, names, feeds, fetch_keys):
        consts = list(program.constants().values())
        _check_views(consts)
        if self.device.type != "cuda" or program.control_flow:
            self._eager += 1
            return program._replay(feeds, fetch_keys)
        entry = self._cache.get(sig)
        if entry is None:
            from ..jit.functionalize import CompiledFunction

            def replay(*values):
                return tuple(program._replay(dict(zip(names, values)),
                                             fetch_keys))

            entry = self._cache[sig] = {
                "fn": CompiledFunction(
                    replay, name=f"static program {program._uid}",
                    device=self.device),
                "addresses": [t.data_ptr() for t in consts]}
        if [t.data_ptr() for t in consts] != entry["addresses"]:
            raise RuntimeError(
                "a tensor this program reads by reference was rebound to "
                "new storage since its CUDA graph was captured (p.data = "
                "..., not set_value); the graph would read the old values. "
                "Call Executor.close() to capture anew")
        return list(entry["fn"](*[feeds[n] for n in names]))

    def close(self):
        self._cache.clear()


def _check_views(consts) -> None:
    for t in consts:
        base = t._base
        if base is not None and (base.untyped_storage().data_ptr()
                                 != t.untyped_storage().data_ptr()):
            raise RuntimeError(
                "a program constant is a view of a tensor that was rebound "
                "to new storage since recording (p.data = ...); the view "
                "still reads the old values. Record the program again, or "
                "update the tensor with set_value")


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Static-mode autodiff (reference ``base/backward.py::append_backward``)
    is not offered, as in the JAX package: train through ``jit.TrainStep``
    (one CUDA graph a step); ``Executor`` covers the feed/fetch inference
    contract."""
    raise NotImplementedError(
        "append_backward: train static programs through paddle.jit / "
        "TrainStep (the compiled-train-step path); Executor covers the "
        "feed/fetch inference contract")
