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

The kernel wrappers count launches on the host, so under a graph they
would tick only at the capture. Each entry records every counter's change
during its capture, takes it back (the capture ran nothing), and adds it
at every replay: a counter keeps meaning kernel executions.

CUDA generators the function draws from are registered with each graph,
so every replay draws new numbers, the same stream as eager calls from the
same seed. A capture that fails raises, naming the function and the
error. The JAX eager fallback on data-dependent values is not carried
over: it would hide the graph. On the CPU every call runs eagerly; that is
the CPU's path, not a fallback.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.cuda import adamw, flash_attention, flashmask, rms_norm

__all__ = ["CompiledFunction", "launch_counters"]

# the kernel wrappers' launch counters, (module, attribute); a dict
# attribute counts by key
_COUNTERS = ((flash_attention, "launches"), (flash_attention, "dq_launches"),
             (flash_attention, "dkv_launches"),
             (flash_attention, "dropout_launches"),
             (flash_attention, "tma_copies"), (rms_norm, "launches"),
             (rms_norm, "bwd_launches"), (flashmask, "fwd_launches"),
             (flashmask, "dq_launches"), (flashmask, "dkv_launches"),
             (adamw, "launches"))


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


def _unflatten(spec, tensors: Iterable[torch.Tensor]):
    """``spec`` rebuilt with the tensors of ``tensors`` in order."""
    it = iter(tensors)

    def build(s):
        kind = s[0]
        if kind == _TENSOR:
            return next(it)
        if kind in (tuple, list):
            return kind(build(x) for x in s[1])
        if kind is dict:
            return {k: build(x) for k, x in s[1]}
        return s[2]

    return build(spec)


class CompiledFunction:
    """``fn`` with a per-signature cache of captured CUDA graphs; eager on
    the CPU. ``device`` is where the calls run (default CUDA);
    ``generators`` are the CUDA ``torch.Generator`` s that ``fn`` draws
    from besides the default one."""

    def __init__(self, fn: Callable, static_key_fn: Optional[Callable] = None,
                 name: Optional[str] = None, *, device=DEFAULT_DEVICE,
                 generators: Iterable[torch.Generator] = ()):
        self.fn = fn
        self.static_key_fn = static_key_fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.device = resolve_device(device)
        self.generators = list(generators)
        self._cache: Dict[Any, dict] = {}
        self._stream: Optional[torch.cuda.Stream] = None
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
        if entry is None or self.device.type != "cuda":
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
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                out = self.fn(*args, **kwargs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of {self.name} failed: "
                               f"{type(e).__name__}: {e}") from e
        finally:
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
