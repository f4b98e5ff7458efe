"""``CompiledFunction``: a per-signature cache of captured CUDA graphs (port
of ``paddle_tpu/jit/functionalize.py`` ``CompiledFunction``).

The JAX class traces a function into one XLA program per signature. Here
the program is a CUDA graph. For each cache key:

- the first call runs the function eagerly. It is a real call, and it
  fills what a capture must find ready: the kernels are built, the
  optimizer's accumulators exist, first-use caches (RoPE tables, the zero
  dropout seed) hold normal tensors, since memory made during a capture
  holds no values outside the replays;
- the second call copies the arguments into static input buffers,
  captures the function once under ``torch.cuda.graph`` on a side stream
  (which runs nothing), then replays the graph, which performs the call;
- every later call copies the arguments in, replays, and returns clones
  of the outputs, because the next replay overwrites the static ones.

The key is built as the JAX ``_cache_key`` builds it: the tree of
arguments, each tensor's shape, dtype and device, the other arguments'
values, and ``static_key_fn()`` (train or eval for ``TrainStep``).

A capture runs in the thread-local error mode, so other threads may use
the card meanwhile (a serving engine keeps serving while another warms),
and with Python's collector off, so no collection frees another owner's
graphs mid-capture.

The kernel wrappers count launches on the host, so under a graph they
would tick only at the capture. Each entry records every counter's change
during its capture, takes it back (the capture ran nothing), and adds it
at every replay: a counter keeps meaning kernel executions.

Captures may share one memory pool (``pool``, a
``torch.cuda.graph_pool_handle()``) and one side stream (``stream``): the
serving programs capture one graph per rung, run one rung at a time and
clone its outputs before the next, so one pool serves them all instead of
one private pool a graph, and one stream holds one cuBLAS workspace (32
MiB on Hopper, kept for the process's life) instead of one a family.

CUDA generators the function draws from are registered with each graph,
so every replay draws new numbers, the same stream as eager calls from the
same seed. A capture that fails raises, naming the function and the
error, and leaves the calling thread on the stream it was on. The JAX
eager fallback on data-dependent values is not carried
over: it would hide the graph. On the CPU every call runs eagerly; that is
the CPU's path, not a fallback.

``ProgramSet`` holds the programs of one server (the decode tier's
families, the batch tier's ladder) over one set of live tensors: the
shared pool and capture stream, the replay stream, the lock that orders
calls and hot swaps, and the swap's commit (:meth:`ProgramSet.flip`).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..observability.locks import named_lock
from ..distributed import communication
from ..ops.cuda import adamw, flash_attention, flashmask, momentum, rms_norm

__all__ = ["CompiledFunction", "ProgramSet", "launch_counters"]

# the kernel wrappers' launch counters and the collectives' (module,
# attribute); a dict attribute counts by key
_COUNTERS = ((flash_attention, "launches"), (flash_attention, "dq_launches"),
             (flash_attention, "dkv_launches"),
             (flash_attention, "dropout_launches"),
             (flash_attention, "tma_copies"), (rms_norm, "launches"),
             (rms_norm, "bwd_launches"), (flashmask, "fwd_launches"),
             (flashmask, "dq_launches"), (flashmask, "dkv_launches"),
             (adamw, "launches"), (momentum, "launches"),
             (communication, "launches"))


def launch_counters() -> Dict[tuple, int]:
    """Every launch counter, by ``(module, attribute, key or None)``."""
    out = {}
    for mod, attr in _COUNTERS:
        value = getattr(mod, attr)
        if isinstance(value, dict):
            out.update({(mod, attr, k): n for k, n in value.items()})
        else:
            out[(mod, attr, None)] = value
    return out


def _add_counters(delta: Dict[tuple, int], sign: int = 1) -> None:
    for (mod, attr, k), n in delta.items():
        if k is None:
            setattr(mod, attr, getattr(mod, attr) + sign * n)
        else:
            getattr(mod, attr)[k] += sign * n


_TENSOR = "tensor"


def _flatten(tree, leaves: List[torch.Tensor]):
    """A hashable spec of ``tree`` (tuples, lists, dicts, tensors, hashable
    values); its tensors are appended to ``leaves`` in order."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return (_TENSOR, tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(_flatten(x, leaves) for x in tree))
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves))
                            for k, v in tree.items()))
    try:
        hash(tree)
    except TypeError:
        raise TypeError(f"a compiled function's argument must be a tensor, "
                        f"a tuple, list or dict of them, or a hashable "
                        f"value; got {type(tree).__name__}") from None
    return ("value", type(tree), tree)


def _build(spec, it):
    kind = spec[0]
    if kind == _TENSOR:
        return next(it)
    if kind in (tuple, list):
        return kind(_build(x, it) for x in spec[1])
    if kind is dict:
        return {k: _build(x, it) for k, x in spec[1]}
    return spec[2]


def _unflatten(spec, tensors: Iterable[torch.Tensor]):
    """``spec`` rebuilt with the tensors of ``tensors`` in order. A
    module-level recursion: a closure that calls itself is a reference
    cycle, which would keep the tensors (a replay's output clones) alive
    until Python's collector ran."""
    return _build(spec, iter(tensors))


class CompiledFunction:
    """``fn`` with a per-signature cache of captured CUDA graphs; eager on
    the CPU. ``device`` is where the calls run (default CUDA);
    ``generators`` are the CUDA ``torch.Generator`` s that ``fn`` draws
    from besides the default one; ``pool`` is a graph memory pool handle
    the captures share (default: a private pool each), ``stream`` the side
    stream they run on (default: one of its own); ``capture=False`` runs
    every call eagerly (a step whose collectives go through gloo, which a
    graph cannot hold)."""

    def __init__(self, fn: Callable, static_key_fn: Optional[Callable] = None,
                 name: Optional[str] = None, *, device=DEFAULT_DEVICE,
                 generators: Iterable[torch.Generator] = (), pool=None,
                 stream: Optional["torch.cuda.Stream"] = None,
                 capture: bool = True):
        self.fn = fn
        self.capture = capture
        self.static_key_fn = static_key_fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.device = resolve_device(device)
        self.generators = list(generators)
        self.pool = pool
        self._cache: Dict[Any, dict] = {}
        self._stream: Optional[torch.cuda.Stream] = stream
        # steps run as graph replays, and steps run eagerly (the first call
        # of each key on CUDA, every call on the CPU)
        self.stats = {"compiled_steps": 0, "eager_steps": 0}

    def _cache_key(self, args, kwargs, leaves=None):
        """The cache key of a call; its tensors go to ``leaves``."""
        spec = _flatten((args, kwargs), [] if leaves is None else leaves)
        return (spec, self.static_key_fn() if self.static_key_fn else None)

    def __call__(self, *args, **kwargs):
        leaves: List[torch.Tensor] = []
        key = self._cache_key(args, kwargs, leaves)
        entry = self._cache.get(key)
        if entry is None or self.device.type != "cuda" or not self.capture:
            out = self.fn(*args, **kwargs)
            if entry is None:
                self._cache[key] = {"graph": None, "captures": 0,
                                    "replays": 0}
            self.stats["eager_steps"] += 1
            return out
        if entry["graph"] is None:
            self._capture(entry, key[0], leaves)
        return self._replay(entry, leaves)

    def _capture(self, entry: dict, spec, leaves) -> None:
        static = [t.detach().clone() for t in leaves]
        args, kwargs = _unflatten(spec, static)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        before = launch_counters()
        caller = torch.cuda.current_stream(self.device)
        # Python's collector stays off while this thread captures: a
        # collection here could free a dropped owner's graphs, whose memory
        # pool goes back to the card (cudaFree), which invalidates the
        # capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: what other threads do on the card meanwhile (a
            # serving engine's scheduler replaying, copying tokens out) does
            # not invalidate this capture; this thread is still held to it
            with torch.cuda.graph(graph, pool=self.pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                out = self.fn(*args, **kwargs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
            # torch.cuda.graph skips its stream context's exit when the
            # capture's end raises, which would leave this thread on the
            # capture stream: later work would then race the replay stream
            torch.cuda.set_stream(caller)
            if collecting:
                gc.enable()
            # the capture ran nothing: take back what the wrappers counted
            after = launch_counters()
            delta = {k: after[k] - before.get(k, 0) for k in after
                     if after[k] != before.get(k, 0)}
            _add_counters(delta, -1)
        outputs: List[torch.Tensor] = []
        entry.update(graph=graph, inputs=static, outputs=outputs,
                     out_spec=_flatten(out, outputs), counters=delta,
                     captures=entry["captures"] + 1)

    def _replay(self, entry: dict, leaves) -> Any:
        for dst, src in zip(entry["inputs"], leaves):
            dst.copy_(src)
        entry["graph"].replay()
        _add_counters(entry["counters"])
        entry["replays"] += 1
        self.stats["compiled_steps"] += 1
        return _unflatten(entry["out_spec"],
                          [t.clone() for t in entry["outputs"]])

    def graph_counts(self) -> dict:
        """Signatures met, graphs captured, calls replayed and calls run
        eagerly (pure reads)."""
        return {"signatures": len(self._cache),
                "captures": sum(e["captures"] for e in self._cache.values()),
                "replays": self.stats["compiled_steps"],
                "eager": self.stats["eager_steps"]}

    def audit_report(self) -> dict:
        """Per-cache-key captures and replays and the run accounting: pure
        reads of counters, never a capture."""
        keys = [{"key": repr(key), "captures": e["captures"],
                 "replays": e["replays"], "eager": e["graph"] is None}
                for key, e in self._cache.items()]
        return {"name": self.name, "device": str(self.device),
                "n_cache_keys": len(self._cache),
                "total_captures": sum(e["captures"]
                                      for e in self._cache.values()),
                "keys": keys, "stats": dict(self.stats)}


class ProgramSet:
    """The programs a server captures over one set of live tensors (its
    weights), which a hot swap rewrites in place.

    - :meth:`compile` makes a :class:`CompiledFunction` in the set's one
      graph memory pool and on its one capture stream: one rung runs at a
      time and its outputs are cloned before the next.
    - :meth:`guard` holds the set's lock and, on CUDA, the card and the
      replay stream: a call holds it from its inputs' copy to its outputs'
      clone, a swap from its first copy to the stream's synchronize, so a
      swap lands between two calls.
    - :meth:`flip` is the swap's commit: new values copied into the live
      tensors, whose addresses every captured graph holds; rebinding them
      would leave the graphs reading the old weights."""

    def __init__(self, name: str, device=DEFAULT_DEVICE):
        self.name = name
        self.device = resolve_device(device)
        self._lock = named_lock(name)
        cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        # the stream every call replays (and every swap copies) on
        self.replay_stream = (torch.cuda.default_stream(self.device)
                              if cuda else None)

    def compile(self, fn: Callable, name: str) -> CompiledFunction:
        return CompiledFunction(fn, name=name, device=self.device,
                                pool=self.pool, stream=self.stream)

    @contextlib.contextmanager
    def guard(self):
        with self._lock:
            if self.device.type != "cuda":
                yield
                return
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.replay_stream):
                yield

    @staticmethod
    def check(live: Mapping[Any, torch.Tensor],
              new: Mapping[Any, torch.Tensor]) -> None:
        """``new`` must name every tensor of ``live`` and nothing else,
        each with its shape and dtype (``ValueError``): the contract that
        keeps every captured graph replaying."""
        if set(new) != set(live):
            raise ValueError(
                "swap_params: the new parameter tree differs structurally "
                "from the serving one (names "
                f"{sorted(map(str, set(new) ^ set(live)))[:5]}) — a hot "
                "swap must carry the same model")
        for name, old in live.items():
            n = new[name]
            if tuple(n.shape) != tuple(old.shape) or n.dtype != old.dtype:
                raise ValueError(
                    f"swap_params: leaf {name!r} is {tuple(n.shape)}/"
                    f"{n.dtype}, the serving graphs expect "
                    f"{tuple(old.shape)}/{old.dtype} — same shapes and "
                    "dtypes are the "
                    "zero-recapture contract; convert the checkpoint first")

    def flip(self, live: Mapping[Any, torch.Tensor],
             new: Mapping[Any, torch.Tensor]) -> int:
        """Copy ``new`` (on the set's device) into ``live``, checked first
        (:meth:`check`), under :meth:`guard`; on CUDA the replay stream is
        synchronized before the lock is released, so each call runs
        entirely on one weight set. Returns the number of tensors."""
        self.check(live, new)
        with torch.no_grad(), self.guard():
            for name, dst in live.items():
                dst.copy_(new[name])
            if self.device.type == "cuda":
                self.replay_stream.synchronize()
        return len(live)
