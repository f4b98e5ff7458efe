"""``paddle.inference`` for the port (port of
``paddle_tpu/inference/__init__.py``): ``Config``, ``Predictor`` and the
batch program the serving tier runs.

The saved model is a ``torch.export`` program (``jit.save``); loading it
is the whole "analysis" step. ``Predictor.run`` runs it eagerly at the
exact shape. ``Predictor.run_many`` pads a stacked batch up a ladder of
rungs (the batch ladder, and on a two-axis export the (batch × seq) grid)
and runs it through :class:`_BatchProgram`: one
``jit.functionalize.CompiledFunction`` for the whole ladder, one CUDA
graph a rung on the card, all rungs in one graph memory pool and on one
side stream. Clones share the layer and the batch program, so every
tenant serves from one set of weights and one set of graphs.

Config setters either do what they say (the device, the log level, the
CPU thread count) or warn that they cannot apply here; none is silent.
The persistent compile cache (``set_optim_cache_dir``,
``restored_rungs``) waits in ``ROADMAP.md`` queue 8.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..base.flags import get_flag
from ..device import DEFAULT_DEVICE
from ..jit.bucketing import bucket_for, bucket_grid, powers_of_two_buckets
from ..jit.functionalize import ProgramSet
from ..observability.metrics import registry
from ..observability.tracing import tracer
from ..ops.cuda import flash_attention

__all__ = ["Config", "Predictor", "Tensor_", "create_predictor"]

_log = logging.getLogger("paddle_tpu_torch")


def _warn(msg: str) -> None:
    _log.warning("[inference.Config] %s", msg)


class Config:
    """Model path prefix (as given to ``jit.save``) and engine knobs. The
    device is CUDA unless :meth:`disable_gpu` (or ``device="cpu"``) asks
    for the CPU; a :class:`Predictor` resolves it and raises without
    CUDA."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None, *,
                 device=DEFAULT_DEVICE):
        if prog_file and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[: -len(".pdmodel")]
        self._prefix = prog_file
        self._params_file = params_file
        self.device = device

    def set_prog_file(self, path: str):
        self._prefix = (path[: -len(".pdmodel")] if path.endswith(".pdmodel")
                        else path)

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self.set_prog_file(prog_file)
        self._params_file = params_file

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=None):
        """Run on CUDA device ``device_id`` (the default device)."""
        self.device = f"cuda:{int(device_id)}"

    def disable_gpu(self):
        """Run on the CPU."""
        self.device = "cpu"

    def enable_memory_optim(self, x=True):
        if not x:
            _warn("enable_memory_optim(False): torch's caching allocator "
                  "and the batch program's shared graph pool always reuse "
                  "memory; the toggle has no effect")

    def switch_ir_optim(self, x=True):
        if not x:
            _warn("switch_ir_optim(False): the exported graph runs as "
                  "saved, with no pass pipeline to bypass; the toggle has "
                  "no effect")

    def enable_tpu(self):
        _warn("enable_tpu: the port runs on CUDA or the CPU, not a TPU; "
              "request ignored")

    def disable_glog_info(self):
        _log.setLevel(logging.WARNING)

    def set_cpu_math_library_num_threads(self, n):
        """torch's intra-op CPU threads (process-wide)."""
        torch.set_num_threads(int(n))

    def set_optim_cache_dir(self, path: str):
        _warn("set_optim_cache_dir: the persistent compile cache is not "
              "ported yet (ROADMAP.md, queue 8); request ignored")

    def summary(self):
        return f"Config(prefix={self._prefix}, device={self.device})"


class Tensor_:
    """Zero-copy style IO handle (reference ZeroCopyTensor): a host array
    in, a host array out."""

    def __init__(self, name: str):
        self.name_ = name
        self._value = None

    def name(self):
        return self.name_

    def copy_from_cpu(self, arr: np.ndarray):
        self._value = np.asarray(arr)

    def copy_to_cpu(self) -> np.ndarray:
        v = self._value
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v)

    def shape(self):
        return list(self._value.shape) if self._value is not None else []

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)


def _leaves(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for v in out.values() for t in _leaves(v)]
    if isinstance(out, (list, tuple)):
        return [t for v in out for t in _leaves(v)]
    return []


class _BatchProgram:
    """The batched serving program shared by every clone of a Predictor:
    the loaded layer's module, run through one ``CompiledFunction``.

    - ``traces`` counts the rungs specialized: the first call at a rung
      key adds one, on the CPU and on the card alike; on the card the
      second call captures the rung's CUDA graph (:meth:`warmup` makes
      both), and every later call replays it.
    - ``out_seq_axes``: the output axes that carry the seq symbol, read
      from the exported graph, where :func:`run_many` and the scheduler
      slice the seq pad back off.
    - :meth:`swap_params` copies new weights into the module's own
      parameter storage, which every captured graph reads
      (``ProgramSet.flip``)."""

    def __init__(self, layer, dynamic_axes: Sequence, ladder: Sequence[int],
                 seq_ladder: Optional[Sequence[int]] = None,
                 dynamic_ranks: Optional[Sequence] = None):
        self.layer = layer
        self.device = layer.device
        self.dynamic_ranks = {(int(i), int(ax)): int(r)
                              for i, ax, r in (dynamic_ranks or [])}
        # input -> its batch axis (rank 0) only
        if self.dynamic_ranks:
            self.dynamic_axes = {i: ax for (i, ax), r
                                 in self.dynamic_ranks.items() if r == 0}
        else:
            self.dynamic_axes = {int(i): int(ax) for i, ax in dynamic_axes}
        self.ladder = sorted(int(b) for b in ladder)
        self.seq_ladder = (sorted(int(s) for s in seq_ladder)
                           if seq_ladder else None)
        self.out_seq_axes: Dict[int, int] = (
            self._seq_axes_out() if self.seq_ladder is not None else {})
        self.warmed: List = []
        self.restored: List = []
        # one pool, capture stream and replay stream for every rung, and
        # the lock of calls and swaps
        self._set = ProgramSet("inference.batch_program", self.device)
        self.replay_stream = self._set.replay_stream
        module = layer.module

        def batch_program(*arrays):
            return tuple(_leaves(module(*arrays)))

        self._compiled = self._set.compile(batch_program,
                                           "inference.batch_program")

    def _seq_axes_out(self) -> Dict[int, int]:
        """``{output leaf: axis}`` where the exported graph's output shape
        holds the symbol of a rank-1 (seq) input axis."""
        ep = self.layer._exported
        nodes = {n.name: n for n in ep.graph.nodes}
        inputs = ep.graph_signature.user_inputs
        seq_syms = set()
        for (i, ax), r in self.dynamic_ranks.items():
            if r == 1 and i < len(inputs):
                seq_syms.add(str(nodes[inputs[i]].meta["val"].shape[ax]))
        out = {}
        for j, name in enumerate(ep.graph_signature.user_outputs):
            val = nodes[name].meta.get("val") if name in nodes else None
            for ax, d in enumerate(getattr(val, "shape", ())):
                if str(d) in seq_syms:
                    out[j] = ax
                    break
        return out

    @property
    def traces(self) -> int:
        return self.graph_report()["signatures"]

    def graph_report(self) -> dict:
        """Rungs met, graphs captured, calls replayed and calls run eagerly
        (pure reads)."""
        return self._compiled.graph_counts()

    @property
    def rungs(self) -> List:
        """Every rung key: ints on the one-axis ladder, ``(batch, seq)``
        pairs over the two-axis grid."""
        if self.seq_ladder is None:
            return list(self.ladder)
        return bucket_grid(self.ladder, self.seq_ladder)

    def _bucket_shape(self, idx, spec_shape, bucket):
        rung = bucket if isinstance(bucket, (tuple, list)) else (bucket,)
        out = []
        for ax, d in enumerate(spec_shape):
            if d is None:
                rank = self.dynamic_ranks.get((idx, ax), 0)
                out.append(int(rung[min(rank, len(rung) - 1)]))
            else:
                out.append(d)
        return tuple(out)

    def warmup(self, dtype_shapes: Sequence) -> None:
        """Arm every rung with zeros of the recorded specs: one call, and
        on the card a second, which captures the rung's graph. Idempotent
        per rung."""
        if self.device.type == "cuda":
            flash_attention.build()
        for bucket in self.rungs:
            if bucket in self.warmed:
                continue
            zeros = [np.zeros(self._bucket_shape(i, s, bucket), d)
                     for i, (s, d) in enumerate(dtype_shapes)]
            self(zeros, bucket)
            if self.device.type == "cuda":
                self(zeros, bucket)
            self.warmed.append(bucket)

    def _guard(self):
        """The program lock and, on CUDA, the card and the replay stream
        (``ProgramSet.guard``): a call holds it from its inputs' copy to
        its outputs' clone."""
        return self._set.guard()

    @torch.inference_mode()
    def __call__(self, arrays: Sequence, bucket) -> tuple:
        """Run one batch already padded to ``bucket``; returns the output
        tensors on the device (clones, which the next call leaves alone),
        ready for use on the caller's stream."""
        cuda = self.device.type == "cuda"
        caller = torch.cuda.current_stream(self.device) if cuda else None
        with self._guard():
            inputs = self.layer.as_inputs(arrays)
            before = self.traces
            t0 = time.perf_counter()
            out = self._compiled(*inputs)
            if tracer.enabled and self.traces > before:
                tracer.emit("serving.compile", t0, time.perf_counter() - t0,
                            track="serving.scheduler", bucket=bucket)
        if cuda and caller != self.replay_stream:
            # the caller's stream waits for the replay, and the allocator
            # keeps the outputs until the caller's work on them is done
            caller.wait_stream(self.replay_stream)
            for t in out:
                t.record_stream(caller)
        return out

    @torch.inference_mode()
    def run_eager(self, arrays: Sequence) -> tuple:
        """The program run eagerly on ``arrays`` outside its graphs: the
        reference a replay is held to."""
        with self._guard():
            return tuple(_leaves(self.layer.module(
                *self.layer.as_inputs(arrays))))

    def swap_params(self, new_params: Dict[str, torch.Tensor]) -> int:
        """Copy ``new_params`` (name → tensor, on the program's device)
        into the module's parameters: the hot swap's commit point
        (``ProgramSet.flip``). Every name, shape and dtype must be the
        serving ones, checked before anything is copied, so every rung's
        graph keeps replaying and ``traces`` cannot move. Returns the
        number of tensors swapped."""
        return self._set.flip(self.layer._params, new_params)


class Predictor:
    """``paddle.inference.Predictor`` over a ``jit.save`` export
    (reference ``AnalysisPredictor``). Creation loads the program on the
    config's device and runs it once on the recorded specs (batch and
    dynamic dims 1), which builds the kernels.

    ``run_many`` serves a stacked batch from the ladder of the shared
    :class:`_BatchProgram`; ``clone()`` shares the layer and the batch
    program."""

    def __init__(self, config: Config, _shared_layer=None,
                 _shared_batch: Optional[_BatchProgram] = None):
        from ..jit.serialization import load as jit_load

        self.config = config
        if config._prefix is None:
            raise ValueError("Config needs a model path prefix")
        self._layer = (_shared_layer if _shared_layer is not None
                       else jit_load(config._prefix, device=config.device))
        meta = getattr(self._layer, "_meta", {})
        n = int(meta.get("n_inputs", 1))
        self._input_names = [f"x{i}" for i in range(n)]
        self._inputs: Dict[str, Tensor_] = {name: Tensor_(name)
                                            for name in self._input_names}
        self._outputs: List[Tensor_] = []
        self._input_shapes = meta.get("input_shapes")
        self._dynamic_axes = list(meta.get("dynamic_axes") or [])
        self._dynamic_ranks = list(
            meta.get("dynamic_ranks")
            or [(i, ax, 0) for i, ax in self._dynamic_axes])
        self._batch_program = _shared_batch
        if _shared_layer is None and self._input_shapes:
            self._layer(*[np.zeros([1 if d is None else d for d in s], dt)
                          for s, dt in self._input_shapes])

    def clone(self) -> "Predictor":
        """A predictor for another thread or tenant sharing the loaded
        weights, the program and the batch program's graphs; only the IO
        handles are its own."""
        shared = (self._ensure_batch_program()
                  if getattr(self._layer, "_exported", None) is not None
                  else None)
        return Predictor(self.config, _shared_layer=self._layer,
                         _shared_batch=shared)

    # ------------------------------------------------------------ batched
    @property
    def dynamic_batch(self) -> bool:
        return bool(self._dynamic_axes)

    @property
    def dynamic_seq(self) -> bool:
        return any(r == 1 for _, _, r in self._dynamic_ranks)

    @property
    def batch_ladder(self) -> List[int]:
        return list(self._ensure_batch_program().ladder)

    @property
    def seq_ladder(self) -> Optional[List[int]]:
        sl = self._ensure_batch_program().seq_ladder
        return list(sl) if sl is not None else None

    @property
    def compile_count(self) -> int:
        """Rungs the batch program specialized (on the card, captured):
        warmup pays one per rung, steady traffic adds none."""
        return self._ensure_batch_program().traces

    @property
    def restored_rungs(self) -> List:
        """Rungs restored from a persistent compile cache: always empty,
        since that cache is not ported (``ROADMAP.md`` queue 8)."""
        return list(self._ensure_batch_program().restored)

    def _ensure_batch_program(self) -> _BatchProgram:
        if self._batch_program is None:
            if getattr(self._layer, "_exported", None) is None:
                raise ValueError(
                    "run_many needs a program-carrying export (jit.save "
                    "with input_spec); this model saved params only")
            if self._dynamic_axes:
                ladder = powers_of_two_buckets(
                    1, int(get_flag("serving_max_batch")))
            else:
                # fixed-shape export: the ladder is the one exported batch
                shape0 = (self._input_shapes or [([1], "float32")])[0][0]
                ladder = [int(shape0[0])]
            seq_ladder = None
            if self.dynamic_seq:
                max_seq = int(get_flag("serving_max_seq")) or 128
                seq_ladder = powers_of_two_buckets(
                    int(get_flag("serving_seq_bucket_min")), max_seq)
            self._batch_program = _BatchProgram(
                self._layer, self._dynamic_axes, ladder,
                seq_ladder=seq_ladder, dynamic_ranks=self._dynamic_ranks)
        return self._batch_program

    def set_batch_ladder(self, buckets: Sequence[int]) -> None:
        """Override the batch ladder (before :meth:`warmup_ladder`; a
        fixed-shape export cannot re-ladder)."""
        prog = self._ensure_batch_program()
        if not self.dynamic_batch and list(buckets) != prog.ladder:
            raise ValueError("fixed-shape export: ladder is pinned to "
                             f"{prog.ladder}")
        prog.ladder = sorted(int(b) for b in buckets)

    def set_seq_ladder(self, buckets: Sequence[int]) -> None:
        """Override the seq rungs of a two-axis export (before
        :meth:`warmup_ladder`)."""
        prog = self._ensure_batch_program()
        if prog.seq_ladder is None:
            raise ValueError("this export has no dynamic sequence axis; "
                             "only the batch ladder applies")
        prog.seq_ladder = sorted(int(b) for b in buckets)

    def warmup_ladder(self) -> List:
        """Arm every rung (on the card, capture its graph); returns the
        rungs."""
        prog = self._ensure_batch_program()
        prog.warmup(self._input_shapes or [])
        return list(prog.warmed)

    # ------------------------------------------------------------ hot swap
    def swap_weights(self, source) -> dict:
        """Hot-swap new weights into the program every clone serves from,
        between two calls: no new rung, no capture. ``source`` is a sharded
        checkpoint directory in the reference's layout, as the JAX package
        and the decode tier write and read it (``distributed.checkpoint.
        sharded``; each tensor read onto the live one's device and dtype;
        a Linear weight, named by the export's ``linear_weights``, stored
        ``[in, out]`` and transposed here, square ones included), or a
        dict of name → tensor or array in the port's layout. Names are the
        exported model's state-dict keys: a missing one raises
        ``KeyError``; extra entries are ignored and counted. Only float casts to float; any other dtype change
        raises ``ValueError``, as does a shape mismatch. Returns a
        report."""
        from ..distributed.checkpoint.sharded import (load_sharded_like,
                                                      values_like)

        t0 = time.perf_counter()
        prog = self._ensure_batch_program()
        live = self._layer._params
        if isinstance(source, (str, os.PathLike)):
            linear = self._layer.linear_weights
            flip = {k: (v.t() if k in linear else v) for k, v in live.items()}
            new = {k: (v.t() if k in linear else v) for k, v in
                   load_sharded_like(str(source), flip).items()}
            extra = 0
        else:
            source = dict(source)
            new = values_like(source, live, where="swap_weights source")
            extra = sum(k not in live for k in source)
        if prog.device.type == "cuda":
            torch.cuda.current_stream(prog.device).synchronize()
        n = prog.swap_params(new)
        registry.counter(
            "serving.weight_swaps",
            "weight hot-swaps committed into live serving engines").inc()
        return {
            "n_tensors": len(new),
            "n_leaves": n,
            "ignored_extra_entries": extra,
            "bytes": int(sum(t.numel() * t.element_size()
                             for t in new.values())),
            "seconds": time.perf_counter() - t0,
            "compile_count": self.compile_count,
        }

    def _pad(self, arrays, n, prog):
        """``arrays`` padded to their rung, the rung, and the real seq
        length (None on a one-axis ladder)."""
        ranks = {(i, ax): r for i, ax, r in self._dynamic_ranks}
        bucket = bucket_for(n, prog.ladder)
        seq = seq_bucket = None
        if prog.seq_ladder is not None:
            seq = max(arrays[i].shape[ax]
                      for (i, ax), r in ranks.items() if r == 1)
            seq_bucket = bucket_for(seq, prog.seq_ladder)
        targets = {(i, ax): (seq_bucket if r == 1 else bucket)
                   for (i, ax), r in ranks.items()}
        if not targets:  # fixed-shape export: axis 0 to the one rung
            targets = {(i, 0): bucket for i in range(len(arrays))}
        padded = []
        for i, a in enumerate(arrays):
            widths = [(0, max(targets.get((i, ax), 0) - a.shape[ax], 0))
                      for ax in range(a.ndim)]
            padded.append(np.pad(a, widths) if any(w for _, w in widths)
                          else a)
        rung = (bucket, seq_bucket) if seq_bucket is not None else bucket
        return padded, rung, seq

    def run_many(self, inputs: Sequence[np.ndarray],
                 n: Optional[int] = None) -> List[np.ndarray]:
        """Serve a stacked batch: ``n`` samples on each input's batch axis
        (and, on a two-axis export, any length up to the top seq rung),
        padded to the rung, run through the rung's graph, and sliced back
        to ``n`` rows and the real seq length. Returns one host array per
        output."""
        prog = self._ensure_batch_program()
        arrays = [np.asarray(a) for a in inputs]
        if n is None:
            idx0, ax0 = (self._dynamic_axes or [(0, 0)])[0]
            n = arrays[idx0].shape[ax0]
        padded, rung, seq = self._pad(arrays, n, prog)
        outs = []
        for i, leaf in enumerate(prog(padded, rung)):
            arr = leaf[:n]
            ax = prog.out_seq_axes.get(i)
            if ax is not None and seq is not None:
                arr = arr.narrow(ax, 0, seq)
            outs.append(arr.cpu().numpy())
        return outs

    # -------------------------------------------------------------- eager
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> Tensor_:
        return self._inputs[name]

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Feed, run eagerly at the exact shape, stash the outputs. With
        ``inputs`` given, returns the output arrays."""
        if inputs is not None:
            for name, arr in zip(self._input_names, inputs):
                self._inputs[name].copy_from_cpu(np.asarray(arr))
        out = self._layer(*[self._inputs[n]._value
                            for n in self._input_names])
        self._outputs = []
        for i, leaf in enumerate(_leaves(out)):
            h = Tensor_(f"out{i}")
            h._value = leaf
            self._outputs.append(h)
        if inputs is not None:
            return [o.copy_to_cpu() for o in self._outputs]
        return True

    def get_output_names(self) -> List[str]:
        return [o.name_ for o in self._outputs]

    def get_output_handle(self, name: str) -> Tensor_:
        for o in self._outputs:
            if o.name_ == name:
                return o
        raise KeyError(name)


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
