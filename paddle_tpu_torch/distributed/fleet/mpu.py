"""Tensor-parallel (model-parallel) layers (port of
``paddle_tpu/distributed/fleet/mpu.py``).

Reference: fleet/layers/mpu/mp_layers.py — ``VocabParallelEmbedding``
(:49), ``ColumnParallelLinear`` (:336), ``RowParallelLinear`` (:543),
``ParallelCrossEntropy`` (:744), built from the c_identity/c_split/
c_concat/mp_allreduce autograd ops of mpu/mp_ops.py; ``RNGStatesTracker``
(mpu/random.py:34).

The JAX package keeps each weight whole on a single controller, pins its
layout over the ``mp`` mesh axis, and leaves the movements to GSPMD. The
port runs one process a rank: each rank holds its own shard of each
weight, in torch's ``[out, in]`` layout, and every movement is an explicit
``torch.autograd.Function`` over the ``mp`` group, as Megatron and upstream
Paddle write them:

- :func:`copy_to_model_parallel` — identity forward, all-reduce backward
  (a column-parallel input);
- :func:`reduce_from_model_parallel` — all-reduce forward, identity
  backward (a row-parallel output, the vocab-parallel lookup);
- :func:`scatter_to_model_parallel` — this rank's slice forward,
  all-gather backward (``input_is_parallel=False``);
- :func:`gather_from_model_parallel` — all-gather forward, this rank's
  slice backward (``gather_output=True``);
- ``ParallelCrossEntropy`` — the max, sum and target-logit all-reduces
  over the class shards, and the softmax-minus-one-hot gradient.

Over one rank each is the identity, so a tensor-parallel model on a world
of one computes bit for bit what the single-device model computes.
:data:`op_calls` counts the applications by op.

A weight is cut along its output rows (column-parallel, vocab-parallel)
or its input columns (row-parallel) into ``mp`` equal parts; a packed
projection (Llama's ``[q | k | v]`` and ``[gate | up]``) is cut segment by
segment (``segments=``), so rank ``r`` holds ``[q_r | k_r | v_r]``. The
layers build their shard of the weight a single-device layer would draw
from the same generator (:func:`normal_`), and ``models.gpt``'s
``load_jax_state``/``jax_state_dict`` cut and gather the reference's
global state (:func:`shard_of`, :func:`gather_param`).

The RNG tracker (divergence): ``model_parallel_rng`` is seeded per ``mp``
rank, as upstream Paddle's ``mpu/random.py`` seeds it
(``seed · 1024 + mp_rank · 100``). Dropout on tensors that differ by rank
(the attention's local heads, a sequence shard) draws from it; dropout on
tensors every ``mp`` rank holds draws from the model's own generator,
equal on every rank, so the replicated residual streams stay bit-equal.
The JAX package draws one global mask that GSPMD shards
(``paddle_tpu/distributed/fleet/mpu.py:214-225``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence

import torch

from ...amp.auto_cast import cast_inputs
from ...base import global_state
from ...device import DEFAULT_DEVICE, resolve_device
from ...nn import functional as F
from ...nn.layer.common import Embedding, Linear
from ...nn.layer.layers import Layer
from .. import communication as comm
from .. import env as env_mod

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy", "RNGStatesTracker",
           "RowParallelLinear", "VocabParallelEmbedding",
           "all_gather_sequence", "copy_to_model_parallel",
           "gather_from_model_parallel",
           "gather_param", "get_rng_state_tracker",
           "model_parallel_random_seed", "mp_degree", "mp_rank", "normal_",
           "op_calls", "reduce_from_model_parallel",
           "reduce_scatter_sequence", "scatter_to_model_parallel",
           "shard_of", "sharded_params"]

MP_AXIS = "mp"

#: applications of the model-parallel autograd ops, by op
op_calls: Dict[str, int] = {name: 0 for name in (
    "copy", "reduce", "scatter", "gather", "all_gather_seq",
    "reduce_scatter_seq", "parallel_cross_entropy")}

_comms: dict = {}


def group_comm(axis: str = MP_AXIS) -> "comm._Comm":
    """The communicator of this rank's group over ``axis`` (made once a
    mesh; every rank makes it in the same order)."""
    env = env_mod.instance()
    mesh = env_mod.get_mesh()
    key = (axis, env.initialized)
    hit = _comms.get(key)
    if hit is None or hit[0] is not mesh:
        hit = _comms[key] = (mesh, comm._comm(comm.Group((axis,))))
    return hit[1]


def mp_degree() -> int:
    return env_mod.get_mesh().shape[MP_AXIS]


def mp_rank() -> int:
    return env_mod.get_mesh().coords(env_mod.get_rank())[MP_AXIS]


# ----------------------------------------------------------- movements
def _gather(x: torch.Tensor, dim: int, c) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim``, in member order."""
    return comm._all_gather(x, c).movedim(0, dim).flatten(dim, dim + 1)


def _mine(x: torch.Tensor, dim: int, c) -> torch.Tensor:
    """This member's contiguous slice of ``x`` along ``dim``."""
    size = x.shape[dim]
    if size % c.n:
        raise ValueError(f"dimension {dim} of size {size} does not split "
                         f"over {c.n} ranks")
    part = size // c.n
    return x.narrow(dim, c.me * part, part).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, c) -> torch.Tensor:
    """``x`` summed over the members, this member's slice along ``dim``."""
    moved = x.movedim(dim, 0).contiguous()
    return comm._reduce_scatter(moved, comm.ReduceOp.SUM, c).movedim(0, dim)


def _sum(x: torch.Tensor, c) -> torch.Tensor:
    return comm._all_reduce_(x.contiguous().clone(), comm.ReduceOp.SUM, c)


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.c.n == 1 else _sum(g, ctx.c)), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        return x.view_as(x) if c.n == 1 else _sum(x, c)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, c):
        ctx.dim, ctx.c = dim, c
        return x.view_as(x) if c.n == 1 else _mine(x, dim, c)

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        return (g if c.n == 1 else _gather(g, ctx.dim, c)), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, c):
        ctx.dim, ctx.c = dim, c
        return x.view_as(x) if c.n == 1 else _gather(x, dim, c)

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        return (g if c.n == 1 else _mine(g, ctx.dim, c)), None, None


class _AllGatherSeq(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward (upstream
    ``AllGatherOp``)."""

    @staticmethod
    def forward(ctx, x, dim, c):
        ctx.dim, ctx.c = dim, c
        return x.view_as(x) if c.n == 1 else _gather(x, dim, c)

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        return (g if c.n == 1 else _reduce_scatter(g, ctx.dim, c)), None, \
            None


class _ReduceScatterSeq(torch.autograd.Function):
    """Reduce-scatter forward, all-gather backward (upstream
    ``ReduceScatterOp``)."""

    @staticmethod
    def forward(ctx, x, dim, c):
        ctx.dim, ctx.c = dim, c
        return x.view_as(x) if c.n == 1 else _reduce_scatter(x, dim, c)

    @staticmethod
    def backward(ctx, g):
        c = ctx.c
        return (g if c.n == 1 else _gather(g, ctx.dim, c)), None, None


def copy_to_model_parallel(x, axis: str = MP_AXIS):
    """Identity forward, the gradient all-reduced over ``axis`` (Megatron's
    ``copy_to_tensor_model_parallel_region``, upstream's ``c_identity``)."""
    op_calls["copy"] += 1
    return _Copy.apply(x, group_comm(axis))


def reduce_from_model_parallel(x, axis: str = MP_AXIS):
    """All-reduce forward, identity backward (``mp_allreduce``)."""
    op_calls["reduce"] += 1
    return _Reduce.apply(x, group_comm(axis))


def scatter_to_model_parallel(x, dim: int = -1, axis: str = MP_AXIS):
    """This rank's slice of ``dim`` forward, all-gather backward
    (``c_split``)."""
    op_calls["scatter"] += 1
    return _Scatter.apply(x, dim % x.dim(), group_comm(axis))


def gather_from_model_parallel(x, dim: int = -1, axis: str = MP_AXIS):
    """All-gather of ``dim`` forward, this rank's slice backward
    (``c_concat``)."""
    op_calls["gather"] += 1
    return _Gather.apply(x, dim % x.dim(), group_comm(axis))


def all_gather_sequence(x, dim: int = 1, axis: str = MP_AXIS):
    """All-gather of ``dim`` forward, reduce-scatter backward."""
    op_calls["all_gather_seq"] += 1
    return _AllGatherSeq.apply(x, dim % x.dim(), group_comm(axis))


def reduce_scatter_sequence(x, dim: int = 1, axis: str = MP_AXIS):
    """Reduce-scatter over ``dim`` forward, all-gather backward."""
    op_calls["reduce_scatter_seq"] += 1
    return _ReduceScatterSeq.apply(x, dim % x.dim(), group_comm(axis))


# ------------------------------------------------------------ sharding
class ShardSpec:
    """How a parameter is cut over ``mp``: along ``dim`` (torch layout),
    in ``n`` parts, segment by segment (``segments``: the global sizes of
    the packed blocks along ``dim``; None for one block); rank ``rank``
    holds its part of each. ``global_shape`` is the whole parameter's."""

    __slots__ = ("dim", "segments", "n", "rank", "global_shape")

    def __init__(self, dim, segments, n, rank, global_shape):
        self.dim, self.n, self.rank = dim, n, rank
        self.segments = list(segments) if segments else None
        self.global_shape = tuple(global_shape)
        sizes = self.segments or [global_shape[dim]]
        if sum(sizes) != global_shape[dim] or any(s % n for s in sizes):
            raise ValueError(f"dimension {dim} of {tuple(global_shape)} "
                             f"(blocks {sizes}) does not split over {n} "
                             f"ranks of '{MP_AXIS}'")

    def local_shape(self):
        shape = list(self.global_shape)
        shape[self.dim] //= self.n
        return shape


def shard_of(full: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
    """This rank's part of the whole parameter ``full``."""
    blocks = (full.split(spec.segments, spec.dim) if spec.segments
              else [full])
    return torch.cat([b.chunk(spec.n, spec.dim)[spec.rank] for b in blocks],
                     spec.dim)


def _assemble(parts: Sequence[torch.Tensor], spec: ShardSpec) -> torch.Tensor:
    """The whole parameter from every rank's part, in rank order."""
    if not spec.segments:
        return torch.cat(list(parts), spec.dim)
    local = [s // spec.n for s in spec.segments]
    pieces = [p.split(local, spec.dim) for p in parts]
    return torch.cat([torch.cat([pieces[r][j] for r in range(spec.n)],
                                spec.dim) for j in range(len(local))],
                     spec.dim)


def gather_param(local: torch.Tensor, spec: ShardSpec) -> torch.Tensor:
    """The whole parameter, all-gathered over ``mp`` from every rank's
    part (collective: every ``mp`` rank calls it)."""
    if spec.n == 1:
        return local
    stacked = comm._all_gather(local.detach().contiguous(), group_comm())
    return _assemble(list(stacked.unbind(0)), spec)


def sharded_params(model: torch.nn.Module) -> Dict[str, ShardSpec]:
    """``model``'s parameters that are cut over ``mp``, by name."""
    out = {}
    for mname, mod in model.named_modules():
        for pname, spec in getattr(mod, "_shard_specs", {}).items():
            out[f"{mname}.{pname}" if mname else pname] = spec
    return out


@torch.no_grad()
def normal_(module: torch.nn.Module, name: str, mean: float, std: float,
            generator: torch.Generator) -> None:
    """``module``'s parameter ``name`` drawn normal: a cut parameter takes
    its part of the whole one drawn from ``generator``, so a
    tensor-parallel model holds the parts of the weights a single-device
    model draws from the same generator."""
    p = getattr(module, name)
    spec = getattr(module, "_shard_specs", {}).get(name)
    if spec is None:
        p.normal_(mean, std, generator=generator)
        return
    full = torch.empty(spec.global_shape, dtype=p.dtype)
    full.normal_(mean, std, generator=generator)
    p.copy_(shard_of(full, spec))


class _Sharded:
    """What the parallel layers share: their cut parameters' specs, and an
    initializer that fills each cut parameter with its part of the whole
    one its ``init_fn`` draws."""

    _shard_specs: Dict[str, ShardSpec]

    def _shard(self, name: str, dim: int, segments, global_shape) -> None:
        self._shard_specs[name] = ShardSpec(dim, segments, mp_degree(),
                                            mp_rank(), global_shape)

    @torch.no_grad()
    def _init_parameters(self, gen: torch.Generator) -> None:
        for name, p in self._parameters.items():
            init = getattr(p, "init_fn", None) if p is not None else None
            if init is None:
                continue
            spec = self._shard_specs.get(name)
            if spec is None:
                init(p, generator=gen)
                continue
            full = torch.empty(spec.global_shape, dtype=p.dtype)
            if getattr(p, "transposed", False):
                full.transposed = True
            init(full, generator=gen)
            p.copy_(shard_of(full, spec))


def _split(size: int, what: str) -> int:
    n = mp_degree()
    if size % n:
        raise ValueError(f"{what} {size} does not split over {n} ranks of "
                         f"'{MP_AXIS}'")
    return size // n


class VocabParallelEmbedding(_Sharded, Embedding):
    """An embedding whose vocab rows are cut over ``mp`` (reference
    mp_layers.py:49): each rank looks up the ids in its rows (0 for the
    others), and the partial lookups are all-reduced."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self._shard_specs = {}
        local = _split(num_embeddings, "num_embeddings")
        super().__init__(local, embedding_dim, weight_attr=weight_attr,
                         device=device, generator=generator)
        self._shard("weight", 0, None, (num_embeddings, embedding_dim))
        self.global_num_embeddings = num_embeddings
        self.vocab_start = mp_rank() * local

    def forward(self, x):
        n = self._shard_specs["weight"].n
        if n == 1:
            return reduce_from_model_parallel(F.embedding(x, self.weight))
        local = self.weight.shape[0]
        outside = (x < self.vocab_start) | (x >= self.vocab_start + local)
        ids = torch.where(outside, 0, x - self.vocab_start)
        out = F.embedding(ids, self.weight)
        out = torch.where(outside[..., None], 0.0, out)
        return reduce_from_model_parallel(out)

    def extra_repr(self):
        return (f"{self.global_num_embeddings}, {self.embedding_dim}, "
                f"vocab rows {self.vocab_start}.. on this rank of "
                f"'{MP_AXIS}'")


class ColumnParallelLinear(_Sharded, Linear):
    """A linear layer whose output features are cut over ``mp`` (reference
    mp_layers.py:336): the input's gradient is all-reduced (identity
    forward); ``gather_output`` all-gathers the features after the matmul.
    ``segments`` (a port keyword) lists the global sizes of packed output
    blocks, each cut over the ranks apart."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, bias_attr=None, *,
                 segments: Optional[Sequence[int]] = None,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self._shard_specs = {}
        use_bias = has_bias if has_bias is not None else (
            bias_attr is not False)
        local = _split(out_features, "out_features")
        super().__init__(in_features, local, weight_attr=weight_attr,
                         bias_attr=(bias_attr if use_bias else False),
                         device=device, generator=generator)
        self._shard("weight", 0, segments, (out_features, in_features))
        if use_bias:
            self._shard("bias", 0, segments, (out_features,))
        self.gather_output = gather_output
        self.global_out_features = out_features

    def _input(self, x):
        return copy_to_model_parallel(x)

    def forward(self, x):
        out = F.linear(self._input(x), self.weight, self.bias)
        return gather_from_model_parallel(out) if self.gather_output else out

    def extra_repr(self):
        return (f"in={self.in_features}, out={self.global_out_features} "
                f"(column-cut over '{MP_AXIS}'), gather_output="
                f"{self.gather_output}")


class RowParallelLinear(_Sharded, Linear):
    """A linear layer whose input features are cut over ``mp`` (reference
    mp_layers.py:543): the partial products are all-reduced, then the
    (replicated) bias is added; ``input_is_parallel=False`` takes this
    rank's slice of a whole input first."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 bias_attr=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        self._shard_specs = {}
        use_bias = has_bias if has_bias is not None else (
            bias_attr is not False)
        local = _split(in_features, "in_features")
        super().__init__(local, out_features, weight_attr=weight_attr,
                         bias_attr=(bias_attr if use_bias else False),
                         device=device, generator=generator)
        self._shard("weight", 1, None, (out_features, in_features))
        self.input_is_parallel = input_is_parallel
        self.global_in_features = in_features

    def _output(self, y):
        return reduce_from_model_parallel(y)

    def forward(self, x):
        if not self.input_is_parallel:
            x = scatter_to_model_parallel(x)
        out = self._output(F.linear(x, self.weight))
        if self.bias is None:
            return out
        (bias,) = cast_inputs("linear", self.bias)
        return out + bias

    def extra_repr(self):
        return (f"in={self.global_in_features} (row-cut over '{MP_AXIS}'), "
                f"out={self.out_features}")


class _VocabParallelCE(torch.autograd.Function):
    """Softmax cross entropy over class-cut logits ``[N, V/mp]``, computed
    in f32: the row max, the exp-sum and the target logit all-reduced over
    ``mp``; the gradient is softmax minus the one-hot on this rank's
    classes. Rows whose label is ``ignore_index`` give 0."""

    @staticmethod
    def forward(ctx, logits, label, ignore_index, c):
        z = logits.float()
        with torch.no_grad():
            m = z.amax(-1)
            if c.n > 1:
                comm._all_reduce_(m, comm.ReduceOp.MAX, c)
        z = z - m[:, None]
        local = z.shape[-1]
        start = c.me * local
        valid = label != ignore_index
        mine = valid & (label >= start) & (label < start + local)
        idx = torch.where(mine, label - start, 0)
        target = torch.where(mine, z.gather(-1, idx[:, None])[:, 0], 0.0)
        e = torch.exp(z)
        total = e.sum(-1)
        if c.n > 1:
            target = _sum(target, c)
            total = _sum(total, c)
        loss = torch.where(valid, torch.log(total) - target, 0.0)
        ctx.save_for_backward(e, total, idx, mine, valid)
        ctx.dtype = logits.dtype
        return loss.to(logits.dtype)

    @staticmethod
    def backward(ctx, g):
        e, total, idx, mine, valid = ctx.saved_tensors
        grad = e / total[:, None]
        grad.scatter_add_(-1, idx[:, None], -mine.to(grad.dtype)[:, None])
        grad = grad * torch.where(valid, g.float(), 0.0)[:, None]
        return grad.to(ctx.dtype), None, None, None


class ParallelCrossEntropy(Layer):
    """Softmax cross entropy over class-cut logits (reference
    mp_layers.py:744): ``input`` ``[..., V/mp]`` this rank's classes,
    ``label`` the global class ids; returns the per-row loss (no
    reduction), equal on every ``mp`` rank, 0 where ``label`` is
    ``ignore_index``. Under AMP it computes in f32, as ``cross_entropy``
    does."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):
        (z,) = cast_inputs("cross_entropy", input)
        lead = z.shape[:-1]
        flat = z.reshape(-1, z.shape[-1])
        y = label.reshape(-1)
        op_calls["parallel_cross_entropy"] += 1
        loss = _VocabParallelCE.apply(flat, y, int(self.ignore_index),
                                      group_comm())
        return loss.reshape(lead)


# ----------------------------------------------------------- RNG tracker
MODEL_PARALLEL_RNG = "model_parallel_rng"
# the JAX tracker's first seed, and upstream's per-rank local seed rule
_DEFAULT_SEED = 2718


def _local_seed(seed: int) -> int:
    return int(seed) * 1024 + mp_rank() * 100


class RNGStatesTracker:
    """Named random streams (reference mpu/random.py:34): each name has a
    seed and one ``torch.Generator`` a device, made at first use.
    ``rng_state(name)`` makes the stream the process-wide dropout
    generator of the default device for a block, so a functional dropout
    without ``generator=`` inside draws from it; a layer that holds its
    own generator keeps it."""

    def __init__(self):
        self._seeds: Dict[str, int] = {}
        self._gens: Dict[tuple, torch.Generator] = {}

    def reset(self):
        self._seeds.clear()
        self._gens.clear()

    def add(self, name, seed):
        if name in self._seeds:
            raise ValueError(f"rng state {name} already exists")
        self._seeds[name] = int(seed)

    def generator(self, name=MODEL_PARALLEL_RNG,
                  device=DEFAULT_DEVICE) -> torch.Generator:
        """The stream ``name`` on ``device`` (default: the default
        device); ``model_parallel_rng`` is added, seeded per ``mp`` rank
        from 2718, if it was not."""
        if name not in self._seeds:
            if name != MODEL_PARALLEL_RNG:
                raise KeyError(f"rng state {name} was not added")
            self.add(name, _local_seed(_DEFAULT_SEED))
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        gen = self._gens.get((name, dev))
        if gen is None:
            gen = self._gens[(name, dev)] = torch.Generator(
                device=dev).manual_seed(self._seeds[name])
        return gen

    def get_states_tracker(self):
        """``{name: {device: generator state}}`` of the streams made."""
        out: Dict[str, dict] = {}
        for (name, dev), gen in self._gens.items():
            out.setdefault(name, {})[str(dev)] = gen.get_state()
        return out

    def set_states_tracker(self, states):
        for name, by_dev in states.items():
            for dev, state in by_dev.items():
                if name not in self._seeds:
                    self._seeds[name] = 0
                self.generator(name, torch.device(dev)).set_state(state)

    def rng_state(self, name=MODEL_PARALLEL_RNG):
        @contextlib.contextmanager
        def guard():
            dev = resolve_device(DEFAULT_DEVICE)
            prev = global_state.swap_dropout_generator(
                dev, self.generator(name, dev))
            try:
                yield
            finally:
                global_state.swap_dropout_generator(dev, prev)

        return guard()


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker


def model_parallel_random_seed(seed=None):
    """Reseed the tracker: ``model_parallel_rng`` from ``seed · 1024 +
    mp_rank · 100`` (``seed`` default 2718), as upstream Paddle seeds each
    ``mp`` rank's local stream."""
    _tracker.reset()
    _tracker.add(MODEL_PARALLEL_RNG, _local_seed(seed or _DEFAULT_SEED))
