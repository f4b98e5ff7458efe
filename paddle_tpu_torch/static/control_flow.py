"""Static-mode control flow (port of ``paddle_tpu/static/control_flow.py``;
reference ``python/paddle/static/nn/control_flow.py`` — ``while_loop``
:1126, ``cond`` :943, ``case`` :1372, ``switch_case`` :1436).

Two modes per construct, as in the JAX package (which has a third, inline
under a trace, that torch has no counterpart of):

- **recording** (``program_guard`` / ``enable_static``): the user's
  callables run once each at build time, recording into branch programs
  (``Program(parent=...)``) whose ops may read anything live in the
  enclosing program (feeds, earlier outputs) and parameters by reference.
  The construct becomes ONE node of the enclosing program that, when run,
  reads its predicate on the host and replays the chosen branch program
  (the loop's condition and body, in turn). The JAX package compiles the
  node into a ``lax`` structured primitive instead; a CUDA graph cannot
  branch on data, so a program that holds such a node replays eagerly on
  the card (``Executor.replay_counts`` shows it). Its outputs are fresh
  tensors at every run.
- **dygraph**: plain Python control flow on concrete values.

The callables run with autograd off, and must be free of side effects:
they run once to record and again at every replay, the constraint the
reference's block capture imposes.
"""
from __future__ import annotations

import contextlib
from collections import ChainMap
from typing import Callable, List, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..core import hooks
from ..core.tensor import wrap
from .program import Program, _bind, _resolve, tensor_key

__all__ = ["case", "cond", "switch_case", "while_loop"]


def _recording() -> Optional[Program]:
    prog = hooks.static_capture
    return prog if isinstance(prog, Program) else None


@contextlib.contextmanager
def _into(branch: Optional[Program]):
    """Record into ``branch`` (None: record nothing) with autograd off."""
    prev = hooks.static_capture
    hooks.static_capture = branch
    try:
        with torch.no_grad():
            yield
    finally:
        hooks.static_capture = prev


def _run_fn(fn, *args):
    if fn is None:
        return None
    with torch.no_grad():
        return fn(*args)


def _as_bool(value) -> bool:
    return bool(value.item()) if isinstance(value, torch.Tensor) \
        else bool(value)


class _Branch:
    """A branch program and the bindings of what its callable returned."""

    def __init__(self, parent: Program, fn: Callable, args=(),
                 live_keys=()):
        self.program = Program(parent)
        self.program._live.update(live_keys)
        with _into(self.program):
            out = fn(*args) if fn is not None else None
        self.out = out
        self.leaves, self.spec = pytree.tree_flatten(out)
        self.bindings = [_bind(leaf) for leaf in self.leaves]
        self.program.results = self.bindings

    def run(self, env) -> list:
        local = ChainMap({}, env)
        self.program.run_ops(local)
        return [_resolve(b, local) for b in self.bindings]


def _fresh(values, like=None) -> list:
    """Node outputs as new tensors (in ``like``'s dtypes where given), so
    no node output shares a key with a value of the enclosing program."""
    out = []
    for i, v in enumerate(values):
        if isinstance(v, torch.Tensor):
            v = v.clone() if like is None else v.to(like[i].dtype).clone()
        out.append(v)
    return out


class _ControlNode:
    """A control-flow node of a program: ``run(env)`` evaluates the
    construct over ``env`` (host reads of its predicates) and stores its
    outputs under ``out_keys``."""

    def __init__(self, name: str, evaluate: Callable, branches: List[_Branch],
                 reads: list):
        self.name = name
        self.evaluate = evaluate
        self.branches = branches
        self.reads = reads
        self.out_keys: List[tuple] = []
        self.out_refs: List[torch.Tensor] = []

    def bindings(self) -> list:
        return [*self.reads, *(b.program for b in self.branches)]

    def run(self, env) -> None:
        for key, v in zip(self.out_keys, self.evaluate(env)):
            env[key] = v

    def add_to(self, program: Program) -> list:
        """Run the node once on the build-time values, append it to
        ``program`` and return its outputs."""
        with hooks.suspended(), torch.no_grad():
            outs = self.evaluate({})
        tensors = [t for t in outs if isinstance(t, torch.Tensor)]
        self.out_refs = tensors
        self.out_keys = [tensor_key(t) for t in tensors]
        program._add(self)
        program.control_flow = True
        return outs


def while_loop(cond: Callable, body: Callable, loop_vars: Sequence,
               is_test: bool = False, name: Optional[str] = None) -> List:
    """reference control_flow.py:1126. ``body`` returns the loop
    variables' structure, shapes and dtypes."""
    loop_vars = list(loop_vars)
    prog = _recording()
    if prog is None:
        while _as_bool(_run_fn(cond, *loop_vars)):
            out = _run_fn(body, *loop_vars)
            loop_vars = list(out) if isinstance(out, (tuple, list)) else [out]
        return loop_vars
    leaves, treedef = pytree.tree_flatten(loop_vars)
    keys = [tensor_key(t) for t in leaves]
    reads = [_bind(t) for t in leaves]
    c_branch = _Branch(prog, cond, loop_vars, keys)
    b_branch = _Branch(prog, lambda *v: _as_list(body(*v)), loop_vars, keys)
    if b_branch.spec != treedef:
        raise ValueError(f"while_loop body returned structure "
                         f"{b_branch.spec}, expected {treedef}")

    def evaluate(env):
        vals = [_resolve(b, env) for b in reads]
        while True:
            local = ChainMap(dict(zip(keys, vals)), env)
            (pred,) = c_branch.run(local)
            if not _as_bool(pred):
                return _fresh(vals, leaves)
            vals = b_branch.run(ChainMap(dict(zip(keys, vals)), env))

    node = _ControlNode("while_loop", evaluate, [c_branch, b_branch], reads)
    outs = node.add_to(prog)
    return pytree.tree_unflatten([wrap(t) for t in outs], treedef)


def _as_list(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def cond(pred, true_fn: Optional[Callable] = None,
         false_fn: Optional[Callable] = None, name: Optional[str] = None,
         return_names=None):
    """reference control_flow.py:943 — both branches return the same
    structure (the false branch's outputs take the true branch's
    dtypes)."""
    prog = _recording()
    if prog is None:
        return _run_fn(true_fn if _as_bool(pred) else false_fn)
    t_branch = _Branch(prog, true_fn)
    f_branch = _Branch(prog, false_fn)
    if t_branch.spec != f_branch.spec:
        raise ValueError(f"cond branches returned different structures: "
                         f"{t_branch.spec} vs {f_branch.spec}")
    if t_branch.out is None:
        return None
    pred_b = _bind(pred)
    like = t_branch.leaves

    def evaluate(env):
        taken = t_branch if _as_bool(_resolve(pred_b, env)) else f_branch
        return _fresh(taken.run(env), like)

    node = _ControlNode("cond", evaluate, [t_branch, f_branch], [pred_b])
    outs = node.add_to(prog)
    return pytree.tree_unflatten([wrap(t) for t in outs], t_branch.spec)


def case(pred_fn_pairs, default: Optional[Callable] = None,
         name: Optional[str] = None):
    """reference control_flow.py:1372 — the first true predicate wins (a
    chain of :func:`cond`). With ``default=None`` the last pair's fn is the
    fallback (reference semantics)."""
    pairs = list(pred_fn_pairs)
    if not pairs:
        raise ValueError("case expects at least one (pred, fn) pair")
    if default is None:
        pairs, default = pairs[:-1], pairs[-1][1]
        if not pairs:  # one pair: unconditional, its ops recorded directly
            return default()

    def chain(i):
        if i == len(pairs):
            return default
        pred, fn = pairs[i]
        return lambda: cond(pred, fn, chain(i + 1))

    return chain(0)()


def switch_case(branch_index, branch_fns, default: Optional[Callable] = None,
                name: Optional[str] = None):
    """reference control_flow.py:1436 — integer dispatch over branches;
    an unmatched index takes the default (or the last branch when default
    is None)."""
    items = (sorted(branch_fns.items()) if isinstance(branch_fns, dict)
             else list(enumerate(branch_fns)))
    keys = [int(k) for k, _ in items]
    fns = [f for _, f in items]
    if default is None:
        default = fns[-1]
    prog = _recording()
    if prog is None:
        idx = int(branch_index.item()) if isinstance(
            branch_index, torch.Tensor) else int(branch_index)
        return _run_fn(dict(zip(keys, fns)).get(idx, default))
    branches = [_Branch(prog, f) for f in fns + [default]]
    for b in branches[1:]:
        if b.spec != branches[0].spec:
            raise ValueError(f"switch_case branches returned different "
                             f"structures: {b.spec} vs {branches[0].spec}")
    index_b = _bind(branch_index)
    like = branches[0].leaves
    slot = {k: i for i, k in enumerate(keys)}

    def evaluate(env):
        v = _resolve(index_b, env)
        idx = int(v.item()) if isinstance(v, torch.Tensor) else int(v)
        return _fresh(branches[slot.get(idx, len(keys))].run(env), like)

    node = _ControlNode("switch_case", evaluate, branches, [index_b])
    outs = node.add_to(prog)
    return pytree.tree_unflatten([wrap(t) for t in outs], branches[0].spec)
