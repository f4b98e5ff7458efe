"""Pipeline-parallel schedules (port of ``paddle_tpu/distributed/fleet/
pipeline_schedules.py``): ``PipelinedStack`` and its rotation, 1F1B,
eager-1F1B, ZB-H1 and interleaved (VPP) schedules.

Reference: fleet/meta_parallel/pipeline_parallel.py — 1F1B (:575), the
interleaved virtual pipeline (:1174); pipeline_zero_bubble.py:66 (ZB-H1),
pipeline_eager_1f1b.py:36. Upstream runs a stage a process and moves
activations with P2pHelper's batched isend/irecv.

In the JAX package a stage is a slice of the ``pp`` mesh axis inside one
``shard_map`` program, whose tick loop computes every stage at every tick
(predicated zeros where a stage has nothing to do). Here, as upstream, a
stage is a process: rank ``d`` of the ``pp`` group holds its contiguous
block of the stacked layer dim (the JAX shard), and at each tick it runs
only the units its schedule gives it, then exchanges with its neighbours
through one ``communication.batch_isend_irecv`` (an NCCL group call: two
neighbours that each send before receiving would deadlock on blocking
sends). A tick where a rank has no unit and no message launches nothing.
The tick rules are the JAX package's:

- the forward of every schedule is the rotation: microbatch ``i`` enters
  chunk 0 at tick ``(i // p)·v·p + i % p`` and moves one chunk a tick;
  chunk ``c`` lives on stage ``c % p`` (:func:`solve_tick`);
- ``"rotation"`` keeps each unit's input (``remat``, the default) and runs
  the backward as the forward's ticks reversed, recomputing each chunk;
- ``"1f1b"``/``"eager_1f1b"`` (one chunk a stage) keep nothing in the
  forward; the backward runs F(s, i) at tick ``i + s`` and B(s, i) at
  ``i + 2(p−1) − s``, recomputing each chunk from its parked input, so
  stage ``s`` holds at most ``2(p−1−s)`` inputs at a tick's end; the last
  stage's F feeds its B in the same tick and computes nothing else;
- ``"zb"`` (ZB-H1) is 1F1B whose drain ticks compute the input gradient
  only (``torch.autograd.grad`` with ``inputs=`` the chunk input) and defer
  the weight gradients to the end, each recomputing its chunk;
- with ``num_chunks = v > 1``, ``"1f1b"`` is the interleaved 1F1B of the
  JAX ``_pipeline_vpp_1f1b``: F(c, i) at ``inj(i) + c``, B(c, i) at
  ``inj(i) + 2L − 1 − c`` (``L = v·p``; :func:`solve_backward_tick`).

The stack is one ``torch.autograd.Function``: its forward runs the forward
units and exchanges and ends with the last stage's output rows broadcast
over ``pp``; its backward runs the schedule's backward units, takes the
output cotangent from the last stage's own (every ``pp`` rank computes the
same loss: summing them, as a broadcast's backward does, would count it
``p`` times) and ends with stage 0's input gradient broadcast over ``pp``.
So the output and the input gradient are whole on every ``pp`` rank, each
rank gets the gradients of its own layers, and the layers around the stack
(embedding, head), whole on every rank, get the same gradients on every
rank with no all-reduce over ``pp``. The exchanges are capturable on NCCL,
so a ``TrainStep`` on NCCL is one CUDA graph; on gloo (which stages CUDA
tensors through the host) it runs eagerly.

Dropout inside the stack draws from one stream a unit (chunk, microbatch):
a stack call draws one seed from the model's generator (the first
generator its layers hold) and each unit's draws are hashed from it
(``base.draws.SeededStream``), so every run of a unit (its forward, the
1F1B backward's F, the recompute) draws the same masks, and a captured
step draws new ones at each replay. The masks cannot be the JAX package's
(``fold_in`` of a threefry key). The backward units run under the AMP
state of the forward (``amp.auto_cast`` has ended when the backward runs).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.func import functional_call

from ...amp.auto_cast import current_state, state_guard
from ...base import draws
from ...core.tensor import Tensor, plain, wrap
from ...device import DEFAULT_DEVICE
from ...nn.layer.layers import Layer, building, init_parameters
from .. import communication as comm
from .. import env as env_mod

__all__ = ["PipelinedStack", "chunk_permutation",
           "forward_backward_pipeline_1f1b",
           "forward_backward_pipeline_eager_1f1b",
           "forward_backward_pipeline_interleave",
           "forward_backward_pipeline_rotation",
           "forward_backward_pipeline_zero_bubble", "schedule_cost_report",
           "solve_backward_tick", "solve_tick", "stacked_state",
           "serial_state"]

SCHEDULES = ("rotation", "1f1b", "eager_1f1b", "zb", "zbh1")


def chunk_permutation(num_layers: int, num_stages: int,
                      num_chunks: int) -> List[int]:
    """Layer order for stacking so a contiguous ``pp`` block of the leading
    dim holds stage d's chunks {d, d+p, …, d+(v-1)p} in local slot order.

    Returns perm with perm[new_position] = original_layer_index.
    """
    p, v = num_stages, num_chunks
    k = num_layers // (p * v)
    order = []
    for d in range(p):
        for j in range(v):
            c = j * p + d
            order.extend(range(c * k, (c + 1) * k))
    return order


def solve_tick(t: int, d: int, *, p: int, v: int,
               m: int) -> Optional[Tuple[int, int, int]]:
    """``(j, c, i)``: the local chunk slot, global chunk and microbatch
    stage ``d`` runs forward at tick ``t``, or None (the JAX
    ``_solve_tick``: microbatch i enters chunk 0 at tick
    ``(i // p)·v·p + i % p`` and moves one chunk a tick)."""
    L = v * p
    for j in range(v):
        c = d + p * j
        inj = t - c
        if inj < 0:
            continue
        q, r = divmod(inj, L)
        i = q * p + r
        if r < p and i < m:
            return j, c, i
    return None


def solve_backward_tick(u: int, d: int, *, p: int, v: int,
                        m: int) -> Optional[Tuple[int, int, int]]:
    """The interleaved 1F1B backward's ``(j, c, i)`` on stage ``d`` at
    tick ``u``: B(c, i) at ``inj(i) + 2L − 1 − c`` (the JAX ``_solve_b``),
    or None."""
    L = v * p
    for j in range(v):
        c = d + p * j
        inj = u - (2 * L - 1) + c
        if inj < 0:
            continue
        q, r = divmod(inj, L)
        i = q * p + r
        if r < p and i < m:
            return j, c, i
    return None


def schedule_cost_report(p: int, m: int, schedule: str) -> dict:
    """Traced-unit accounting for one train step of the tick-interleaved
    schedules (the SPMD analog of the reference's per-stage job-list bubble
    accounting). Unit model, with per-chunk remat: F = 1 unit,
    combined vjp = 3 (recompute + dx + dW), dx-only vjp = 2, dW-only
    vjp = 2. In the lockstep tick loop every traced tick costs its full
    body on every stage, active or not, so wasted = total − useful is the
    bubble — the quantity ZB-H1 shrinks by giving warmup ticks an F-only
    body and bubble-filling the deferred dW jobs.
    """
    useful = 4 * m  # per stage: m forwards + m combined backwards
    if schedule in ("1f1b", "eager_1f1b"):
        total = (m + 2 * (p - 1)) * 4  # every tick: F + combined vjp
    elif schedule in ("zb", "zbh1"):
        total = ((p - 1) * 1          # warmup: F only
                 + m * 4              # steady: F + combined vjp
                 + (p - 1) * 2        # drain: dx-only vjp
                 + (p - 1) * 2)       # epilogue: deferred dW block
    else:
        raise ValueError(f"no cost model for schedule {schedule!r}")
    return {
        "schedule": schedule, "p": p, "m": m,
        "total_units": total, "useful_units": useful,
        "wasted_units": total - useful,
        "bubble_fraction": (total - useful) / total,
    }


def _stacked_name(name: str) -> str:
    return "stack_" + name.replace(".", "__")


def _pp_place(num_stages: int) -> int:
    """This rank's stage: its coordinate on the mesh's ``pp`` axis, which
    must have ``num_stages`` ranks (one process a stage)."""
    if num_stages == 1:
        return 0
    mesh = env_mod.get_mesh()
    have = mesh.shape.get("pp", 1) if mesh is not None else 1
    if have != num_stages:
        raise ValueError(
            f"a pipeline of {num_stages} stages runs one process a stage: "
            f"the mesh's pp axis has {have} rank(s) (fleet.init with "
            f"pp_degree={num_stages})")
    return mesh.coords(env_mod.get_rank())["pp"]


class PipelinedStack(Layer):
    """A stack of ``num_layers`` homogeneous layers from ``layer_factory``,
    run by a pipeline schedule over the ``pp`` ranks (module notes).

    Each template weight ``name`` is one parameter ``stack_<name with "."
    → "__">`` of shape ``[num_layers // p, ...]``: this rank's contiguous
    block of the JAX package's ``[num_layers, ...]`` stack in
    :func:`chunk_permutation` order, so the names are the JAX names. The
    template layer (``template``, a sublayer whose own parameters take no
    gradient, as in JAX) runs each local layer through
    ``torch.func.functional_call`` with that layer's slices (views, no
    copy). Built alone, the layers draw their initial values in their own
    order from ``generator`` (default: the build generator), as a serial
    list of ``num_layers`` layers would; inside a model's build, the model
    initializes them (:meth:`init_stacked`).

    ``num_microbatches`` (default ``2·p``) is cut to the largest ``m`` with
    ``m % p == 0`` and ``batch % m == 0``; when there is none, one
    microbatch passes through the stages (the JAX package's serial scan
    gives the same numbers), which an interleaved stack refuses. ``p == 1``
    runs the layers in order, as a serial list would, with no recompute.
    """

    def __init__(self, layer_factory: Callable[[], Layer], num_layers: int,
                 num_stages: Optional[int] = None, num_chunks: int = 1,
                 num_microbatches: Optional[int] = None, remat: bool = True,
                 schedule: str = "rotation", *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        degrees = env_mod.instance().axis_degrees or {}
        self.num_stages = num_stages or max(degrees.get("pp", 1), 1)
        self.num_chunks = num_chunks
        self.num_layers = num_layers
        self.remat = remat
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown pipeline schedule {schedule!r}")
        if schedule in ("zb", "zbh1") and num_chunks != 1:
            raise ValueError(
                "ZB-H1 covers num_chunks == 1; interleaved stacks use "
                "schedule='1f1b' (tick-interleaved VPP) or 'rotation'")
        self.schedule = schedule
        if num_layers % (self.num_stages * num_chunks) != 0:
            raise ValueError(
                f"num_layers {num_layers} must divide by "
                f"num_stages*num_chunks {self.num_stages * num_chunks}")
        self.num_microbatches = num_microbatches or 2 * self.num_stages
        self.stage = _pp_place(self.num_stages)
        self.local_layers = num_layers // self.num_stages
        self._factory = layer_factory
        self._perm = chunk_permutation(num_layers, self.num_stages,
                                       num_chunks)
        if self.num_stages > 1:
            # every rank makes the pp group here, in the same order
            self._comm = comm._comm(comm.Group(("pp",)))
        # what the last call ran: its units in order and the most chunk
        # inputs it held at a tick's end
        self.trace: List[Tuple[str, int, int]] = []
        self.peak_saved = 0
        with building(self, device, generator, init=_init_alone):
            self.template = layer_factory()
            self._param_names = [n for n, _ in
                                 self.template.named_parameters()]
            specs = {}
            for name, tp in self.template.named_parameters():
                setattr(self, _stacked_name(name), torch.nn.Parameter(
                    torch.empty((self.local_layers,) + tuple(tp.shape),
                                dtype=tp.dtype, device=tp.device)))
                if getattr(tp, "sequence_parallel", False):
                    # its gradient is a partial sum over mp, as the
                    # template's is
                    getattr(self, _stacked_name(name)).sequence_parallel = \
                        True
                tp.requires_grad_(False)
                owner, _, attr = name.rpartition(".")
                spec = getattr(self.template.get_submodule(owner),
                               "_shard_specs", {}).get(attr)
                if spec is not None:
                    specs[_stacked_name(name)] = _stacked_spec(
                        spec, self.local_layers)
            if specs:
                # cut over mp as the template's weights, dim 0 kept
                self._shard_specs = specs
        self._stacked_names = [_stacked_name(n) for n in self._param_names]
        for sn in self._stacked_names:
            getattr(self, sn).requires_grad_(True)

    # ------------------------------------------------------------ weights
    @property
    def block(self) -> Tuple[int, int]:
        """This rank's positions ``[lo, hi)`` of the stacked dim."""
        lo = self.stage * self.local_layers
        return lo, lo + self.local_layers

    def linear_weights(self) -> set:
        """The stacked names whose template weight is a ``torch.nn.Linear``
        weight (JAX ``[L, in, out]``, here ``[L, out, in]``)."""
        out = set()
        for mname, mod in self.template.named_modules():
            if isinstance(mod, torch.nn.Linear):
                out.add(_stacked_name(f"{mname}.weight" if mname
                                      else "weight"))
        return out

    @torch.no_grad()
    def init_stacked(self, init_layer: Callable[[Layer], None]) -> None:
        """Fill the stack as a serial list of ``num_layers`` layers would be
        filled: layer by layer in original order, each built by the
        factory on the CPU and passed to ``init_layer`` (which draws its
        values), this rank keeping its own; the template takes layer 0's
        values, as the JAX template is layer 0."""
        lo, hi = self.block
        for idx in range(self.num_layers):
            with torch.device("meta"):
                layer = self._factory()
            layer.to_empty(device="cpu")
            init_layer(layer)
            named = dict(layer.named_parameters())
            if idx == 0:
                for name, tp in self.template.named_parameters():
                    tp.copy_(named[name])
            pos = self._perm.index(idx)
            if lo <= pos < hi:
                for name in self._param_names:
                    getattr(self, _stacked_name(name))[pos - lo].copy_(
                        named[name])

    def layer_state_dict(self, idx: int) -> Dict[str, torch.Tensor]:
        """Original layer ``idx``'s weights under the template's names, in
        the port's layout (this rank's ``mp`` part): the un-permuted
        single-layer view the JAX method gives. The owner stage holds them;
        with ``p > 1`` they are broadcast over ``pp``, so every ``pp`` rank
        must call it."""
        pos = self._perm.index(idx)
        owner, at = divmod(pos, self.local_layers)
        out = {}
        for name, sn in zip(self._param_names, self._stacked_names):
            stacked = getattr(self, sn).detach()
            value = (stacked[at].clone() if owner == self.stage
                     else torch.empty_like(stacked[0]))
            if self.num_stages > 1:
                comm._broadcast_(value, owner, self._comm)
            out[name] = value
        return out

    # ------------------------------------------------------------ running
    def _views(self, detach: bool) -> List[Dict[str, torch.Tensor]]:
        """Each local layer's weights by template name: views of the
        stacked parameters (detached ones when ``detach``)."""
        cols = {name: (getattr(self, sn).detach() if detach
                       else getattr(self, sn)).unbind(0)
                for name, sn in zip(self._param_names, self._stacked_names)}
        return [{name: cols[name][l] for name in self._param_names}
                for l in range(self.local_layers)]

    def _run_layer(self, x, params: Dict[str, torch.Tensor]):
        return functional_call(self.template, params, (x,))

    def _micro_count(self, batch: int) -> int:
        """The microbatch count a batch of ``batch`` rows runs with (0: no
        split into at least ``p``)."""
        p = self.num_stages
        m = (self.num_microbatches // p) * p
        while m >= p:
            if batch % m == 0:
                return m
            m -= p
        return 0

    def _call_seed(self, device) -> Optional[torch.Tensor]:
        """One int64 seed drawn this call from the model's generator (the
        first the layers hold), while training; None otherwise."""
        if not self.training:
            return None
        from ...jit.api import model_generators

        gens = model_generators(self.template)
        if not gens:
            return None
        return torch.randint(0, 2**31 - 1, (1,), generator=gens[0],
                             device=gens[0].device,
                             dtype=torch.int64).to(device)

    def forward(self, x):
        xp = plain(x)
        if self.num_stages == 1:
            # the JAX p <= 1 path: the layers in order, no recompute
            out = xp
            for params in self._views(detach=False):
                out = self._run_layer(out, params)
        else:
            m = self._micro_count(xp.shape[0])
            schedule = self.schedule
            if not m:
                if self.num_chunks > 1:
                    raise ValueError(
                        f"batch {xp.shape[0]} cannot split into "
                        f"≥{self.num_stages} microbatches for the "
                        f"interleaved pipeline (num_chunks="
                        f"{self.num_chunks})")
                m, schedule = 1, "rotation"
            run = _Run(self, schedule, m, self._call_seed(xp.device))
            out = _Pipeline.apply(run, xp, *[getattr(self, sn) for sn in
                                              self._stacked_names])
        return wrap(out) if isinstance(x, Tensor) else out


def _stacked_spec(spec, local_layers: int):
    from .mpu import ShardSpec

    return ShardSpec(spec.dim + 1, spec.segments, spec.n, spec.rank,
                     (local_layers,) + tuple(spec.global_shape))


def _init_alone(stack: PipelinedStack, gen: torch.Generator) -> None:
    """A stack built alone: every layer initialized by its own
    initializers from ``gen``, in original order."""
    stack.init_stacked(lambda layer: init_parameters(layer, gen))


class _Pipeline(torch.autograd.Function):
    """The stack's one autograd node (module notes)."""

    @staticmethod
    def forward(ctx, run, x, *params):
        ctx.run = run
        ctx.save_for_backward(x)
        return run.forward(x)

    @staticmethod
    def backward(ctx, g):
        run, ctx.run = ctx.run, None
        (x,) = ctx.saved_tensors
        dx, grads = run.backward(x, g.contiguous(), ctx.needs_input_grad[1])
        return (None, dx, *grads)


class _Run:
    """One call of a stack on this rank: the forward units, then the
    schedule's backward units (module notes)."""

    def __init__(self, stack: PipelinedStack, schedule: str, m: int,
                 key: Optional[torch.Tensor]):
        self.stack = stack
        self.schedule = {"eager_1f1b": "1f1b", "zbh1": "zb"}.get(schedule,
                                                                 schedule)
        self.p, self.v, self.m = stack.num_stages, stack.num_chunks, m
        self.d = stack.stage
        self.k = stack.local_layers // self.v
        self.key = key
        self.amp = current_state()
        self.saved: Dict[Tuple[int, int], object] = {}
        stack.trace = self.trace = []
        stack.peak_saved = 0

    # ------------------------------------------------------------ units
    def _stream(self, c: int, i: int):
        """Unit (``c``, ``i``)'s draw stream (none outside training)."""
        if self.key is None:
            return contextlib.nullcontext()
        return draws.pushed(draws.SeededStream(draws.mix(self.key, c, i)))

    def _chunk(self, j: int, x, params):
        for l in range(j * self.k, (j + 1) * self.k):
            x = self.stack._run_layer(x, params[l])
        return x

    def _run(self, j, c, i, x):
        """Chunk ``c`` (local slot ``j``) on microbatch ``i``, no graph."""
        with self._stream(c, i), torch.no_grad():
            y = self._chunk(j, x, self.views)
        if y.shape != x.shape or y.dtype != x.dtype:
            raise ValueError(f"a pipelined layer must keep its input's shape "
                             f"and dtype: {tuple(x.shape)} {x.dtype} -> "
                             f"{tuple(y.shape)} {y.dtype}")
        return y

    def _vjp(self, j, c, i, x, ct, want_x: bool, want_w: bool):
        """Recompute chunk ``c`` on ``x`` and pull ``ct`` back
        (:meth:`_pull`)."""
        with self._stream(c, i), torch.enable_grad():
            xl = x.detach().requires_grad_(want_x)
            y = self._chunk(j, xl, self.leaves if want_w else self.views)
            return self._pull(j, xl, y, ct, want_x, want_w)

    def _pull(self, j, xl, y, ct, want_x: bool, want_w: bool):
        """``ct`` pulled back through slot ``j``'s graph from ``xl`` to
        ``y``: the input gradient (``want_x``, returned) and the weight
        gradients (``want_w``, added into ``self.grads``)."""
        layers = range(j * self.k, (j + 1) * self.k)
        inputs = [xl] if want_x else []
        if want_w:
            inputs += [self.leaves[l][n] for l in layers
                       for n in self.stack._param_names]
        got = torch.autograd.grad(y, inputs, ct, allow_unused=True)
        if want_w:
            weights = iter(got[1:] if want_x else got)
            with torch.no_grad():
                for l in layers:
                    for n in self.stack._param_names:
                        g = next(weights)
                        if g is not None:
                            self.grads[n][l].add_(g)
        return got[0] if want_x else None

    def _exchange(self, sends, recvs, like) -> List[torch.Tensor]:
        """One tick's messages: ``sends`` ``(tensor, stage)``, ``recvs``
        stages; every rank orders them alike (F stream, then B stream), so
        two messages between one pair match in order. One
        ``batch_isend_irecv``; the received tensors in ``recvs`` order."""
        if not sends and not recvs:
            return []
        group = comm.Group(("pp",))
        bufs = [torch.empty_like(like) for _ in recvs]
        ops = [comm.P2POp(comm.isend, t.contiguous(), peer=s, group=group)
               for t, s in sends]
        ops += [comm.P2POp(comm.irecv, b, peer=s, group=group)
                for b, s in zip(bufs, recvs)]
        comm.batch_isend_irecv(ops)
        return bufs

    def _note_saved(self, held: int) -> None:
        self.stack.peak_saved = max(self.stack.peak_saved, held)

    # ------------------------------------------------------------ forward
    def forward(self, x):
        p, v, m, d = self.p, self.v, self.m, self.d
        L = v * p
        self.views = self.stack._views(detach=True)
        x_mb = list(x.split(x.shape[0] // m))
        keep = self.schedule == "rotation"
        out = torch.empty_like(x)
        outs = list(out.split(x.shape[0] // m))
        cur = None
        for t in range(m * v + p - 1):
            sends, recvs = [], []
            unit = solve_tick(t, d, p=p, v=v, m=m)
            if unit is not None:
                j, c, i = unit
                x_in = x_mb[i] if c == 0 else cur
                self.trace.append(("F", c, i))
                if keep:
                    self.saved[(c, i)] = self._keep(j, c, i, x_in)
                y = (self.saved[(c, i)][1] if keep and not self.stack.remat
                     else self._run(j, c, i, x_in))
                if c == L - 1:
                    outs[i].copy_(y)
                else:
                    sends.append((y.detach(), (d + 1) % p))
            prev = solve_tick(t, (d - 1) % p, p=p, v=v, m=m)
            if prev is not None and prev[1] != L - 1:
                recvs.append((d - 1) % p)
            got = self._exchange(sends, recvs, x_mb[0])
            cur = got[0] if got else None
            self._note_saved(len(self.saved))
        comm._broadcast_(out, p - 1, self.stack._comm)
        return out

    def _keep(self, j, c, i, x_in):
        """What the rotation keeps of a unit: its input (``remat``), or
        its graph (input leaf, output) built now."""
        if self.stack.remat:
            return x_in
        with self._stream(c, i), torch.enable_grad():
            xl = x_in.detach().requires_grad_(True)
            if not hasattr(self, "leaves"):
                self.leaves = self._new_leaves()
            return xl, self._chunk(j, xl, self.leaves)

    def _new_leaves(self):
        leaves = self.stack._views(detach=True)
        for params in leaves:
            for t in params.values():
                t.requires_grad_(True)
        return leaves

    # ------------------------------------------------------------ backward
    def backward(self, x, g, need_dx: bool):
        with state_guard(self.amp):
            return self._backward(x, g, need_dx)

    def _backward(self, x, g, need_dx: bool):
        p, d, m = self.p, self.d, self.m
        stack = self.stack
        self.views = stack._views(detach=True)
        if not hasattr(self, "leaves"):
            self.leaves = self._new_leaves()
        gstack = [torch.zeros(getattr(stack, sn).shape,
                              dtype=getattr(stack, sn).dtype,
                              device=x.device)
                  for sn in stack._stacked_names]
        # each local layer's gradient, a view of its stack's
        self.grads = {n: g.unbind(0)
                      for n, g in zip(stack._param_names, gstack)}
        self.x_mb = list(x.split(x.shape[0] // m))
        self.g_mb = list(g.split(g.shape[0] // m))
        self.need_dx = need_dx
        self.dx = [None] * m
        if self.schedule == "rotation":
            self._rotation_backward()
        elif self.v > 1:
            self._vpp_backward()
        else:
            self._1f1b_backward(zb=self.schedule == "zb")
        dx = None
        if need_dx:
            dx = (torch.cat(self.dx) if d == 0 else torch.empty_like(x))
            comm._broadcast_(dx, 0, stack._comm)
        self.saved.clear()
        return dx, gstack

    def _unit_backward(self, j, c, i, x_in, ct, sends):
        """B(c, i): the chunk's gradients; its input gradient to the
        previous chunk's stage, or kept when ``c == 0``."""
        want_x = c > 0 or self.need_dx
        if isinstance(x_in, tuple):  # the rotation kept its graph
            dx = self._pull(j, x_in[0], x_in[1], ct, want_x, True)
        else:
            dx = self._vjp(j, c, i, x_in, ct, want_x, True)
        self.trace.append(("B", c, i))
        self._send_dx(c, i, dx, sends)

    def _send_dx(self, c, i, dx, sends):
        if c == 0:
            self.dx[i] = dx
        else:
            sends.append((dx, (self.d - 1) % self.p))

    def _rotation_backward(self):
        p, v, m, d = self.p, self.v, self.m, self.d
        L = v * p
        bcur = None
        for t in reversed(range(m * v + p - 1)):
            sends, recvs = [], []
            unit = solve_tick(t, d, p=p, v=v, m=m)
            if unit is not None:
                j, c, i = unit
                ct = self.g_mb[i] if c == L - 1 else bcur
                self._unit_backward(j, c, i, self.saved.pop((c, i)), ct,
                                    sends)
            nxt = solve_tick(t, (d + 1) % p, p=p, v=v, m=m)
            if nxt is not None and nxt[1] != 0:
                recvs.append((d + 1) % p)
            got = self._exchange(sends, recvs, self.x_mb[0])
            bcur = got[0] if got else None

    def _1f1b_backward(self, zb: bool):
        """1F1B (and ZB-H1 with ``zb``) with one chunk a stage."""
        p, m, d = self.p, self.m, self.d
        last = d == p - 1
        fcur = bcur = None
        deferred = []
        for u in range(m + 2 * (p - 1)):
            f_sends, b_sends, recvs = [], [], []
            i_f, i_b = u - d, u - 2 * (p - 1) + d
            x_in = None
            if 0 <= i_f < m:
                x_in = self.x_mb[i_f] if d == 0 else fcur
            if 0 <= i_b < m:
                ct = self.g_mb[i_b] if last else bcur
                # the last stage's F(d, i) feeds its own B(d, i) this tick
                x_b = x_in if last else self.saved.pop((d, i_b))
                if zb and u >= m + p - 1:
                    # the drain: the input gradient now, the weights' later
                    want_x = d > 0 or self.need_dx
                    dx = (self._vjp(0, d, i_b, x_b, ct, True, False)
                          if want_x else None)
                    self.trace.append(("Bx", d, i_b))
                    deferred.append((i_b, x_b, ct))
                    self._send_dx(d, i_b, dx, b_sends)
                else:
                    self._unit_backward(0, d, i_b, x_b, ct, b_sends)
            if x_in is not None and not last:
                self.saved[(d, i_f)] = x_in
                self.trace.append(("F", d, i_f))
                f_sends.append((self._run(0, d, i_f, x_in), d + 1))
            if d > 0 and 0 <= u - (d - 1) < m:
                recvs.append(d - 1)
            if d < p - 1 and 0 <= u - 2 * (p - 1) + d + 1 < m:
                recvs.append(d + 1)
            got = self._exchange(f_sends + b_sends, recvs, self.x_mb[0])
            by_peer = dict(zip(recvs, got))
            fcur, bcur = by_peer.get(d - 1), by_peer.get(d + 1)
            # a drained input stays held until its weight gradient
            self._note_saved(len(self.saved) + len(deferred))
        for i, x_b, ct in deferred:
            self._vjp(0, d, i, x_b, ct, False, True)
            self.trace.append(("W", d, i))

    def _vpp_backward(self):
        """The interleaved 1F1B backward (``num_chunks > 1``)."""
        p, v, m, d = self.p, self.v, self.m, self.d
        L = v * p
        fcur = bcur = None
        for u in range(m * v + v * p + p - 1):
            f_sends, b_sends, recvs = [], [], []
            f = solve_tick(u, d, p=p, v=v, m=m)
            b = solve_backward_tick(u, d, p=p, v=v, m=m)
            x_in = None
            if f is not None:
                jf, cf, i_f = f
                x_in = self.x_mb[i_f] if cf == 0 else fcur
            if b is not None:
                jb, cb, i_b = b
                ct = self.g_mb[i_b] if cb == L - 1 else bcur
                self._unit_backward(jb, cb, i_b, self.saved.pop((cb, i_b)),
                                    ct, b_sends)
            if f is not None:
                self.saved[(cf, i_f)] = x_in
                if cf < L - 1:
                    self.trace.append(("F", cf, i_f))
                    f_sends.append((self._run(jf, cf, i_f, x_in),
                                    (d + 1) % p))
            prev = solve_tick(u, (d - 1) % p, p=p, v=v, m=m)
            nxt = solve_backward_tick(u, (d + 1) % p, p=p, v=v, m=m)
            f_from = prev is not None and prev[1] < L - 1
            b_from = nxt is not None and nxt[1] > 0
            recvs = ([(d - 1) % p] if f_from else []) + (
                [(d + 1) % p] if b_from else [])
            got = self._exchange(f_sends + b_sends, recvs, self.x_mb[0])
            it = iter(got)
            fcur = next(it) if f_from else None
            bcur = next(it) if b_from else None
            self._note_saved(len(self.saved))


def _swapped(stack: PipelinedStack, schedule: str, x):
    prev, stack.schedule = stack.schedule, schedule
    try:
        return stack(x)
    finally:
        stack.schedule = prev


def forward_backward_pipeline_rotation(stack: PipelinedStack, x):
    """The rotation schedule, one chunk a stage: all forwards, then the
    backwards in reverse, each chunk recomputed from its saved input
    (``remat``); a stage holds ``m`` inputs."""
    assert stack.num_chunks == 1
    return stack(x)


def forward_backward_pipeline_1f1b(stack: PipelinedStack, x):
    """1F1B (reference pipeline_parallel.py:575): the stack run with the
    ``"1f1b"`` schedule whatever its own; stage ``s`` holds at most
    ``2(p-1-s)`` inputs."""
    assert stack.num_chunks == 1
    return _swapped(stack, "1f1b", x)


def forward_backward_pipeline_zero_bubble(stack: PipelinedStack, x):
    """ZB-H1 (reference pipeline_zero_bubble.py:66): 1F1B whose drain
    computes input gradients only, the weight gradients deferred to the
    end."""
    assert stack.num_chunks == 1
    return _swapped(stack, "zb", x)


def forward_backward_pipeline_eager_1f1b(stack: PipelinedStack, x):
    """Eager 1F1B (reference pipeline_eager_1f1b.py:36): F(s, i) already
    runs at its earliest tick ``i + s`` and stage ``s`` parks at most
    ``2(p-1-s)`` inputs, the eager profile, so this is the 1F1B tick
    mapping, as in JAX."""
    assert stack.num_chunks == 1
    return _swapped(stack, "eager_1f1b", x)


def forward_backward_pipeline_interleave(stack: PipelinedStack, x):
    """Reference-named entry (pipeline_parallel.py:1174): the interleaved
    stack (stage d owns chunks {d, d+p, ...}) run with its own schedule;
    bubble (p-1)/(m·v+p-1)."""
    assert stack.num_chunks > 1
    return stack(x)


# ------------------------------------------------------------ state helpers
def stacked_state(state: Dict[str, object], prefix: str, num_layers: int,
                  num_stages: int, num_chunks: int = 1) -> Dict[str, object]:
    """A serial model's state (layers under ``<prefix>.<i>.<name>``) in the
    pipelined layout of the JAX package: each ``<name>`` stacked as
    ``<prefix>.stack_<name>`` ``[num_layers, ...]`` in
    :func:`chunk_permutation` order, and layer 0's values as
    ``<prefix>.template.<name>``; every other entry as it is. Arrays or
    tensors, stacked with their own library."""
    import numpy as np

    perm = chunk_permutation(num_layers, num_stages, num_chunks)
    head = prefix + "."
    names = sorted({k[len(head):].partition(".")[2] for k in state
                    if k.startswith(head)
                    and k[len(head):].partition(".")[0] == "0"})
    out = {k: v for k, v in state.items()
           if not (k.startswith(head)
                   and k[len(head):].partition(".")[0].isdigit())}
    for name in names:
        rows = [state[f"{head}{i}.{name}"] for i in perm]
        out[f"{head}{_stacked_name(name)}"] = (
            torch.stack(rows) if isinstance(rows[0], torch.Tensor)
            else np.stack(rows))
        out[f"{head}template.{name}"] = state[f"{head}0.{name}"]
    return out


def serial_state(state: Dict[str, object], prefix: str, num_layers: int,
                 num_stages: int, num_chunks: int = 1) -> Dict[str, object]:
    """The inverse of :func:`stacked_state`: a pipelined model's state
    (the JAX layout, whole stacks) as the serial model's."""
    perm = chunk_permutation(num_layers, num_stages, num_chunks)
    head = prefix + "."
    stack_head = head + "stack_"
    out = {}
    for k, v in state.items():
        if k.startswith(head + "template."):
            continue
        if k.startswith(stack_head):
            name = k[len(stack_head):].replace("__", ".")
            for pos, idx in enumerate(perm):
                out[f"{head}{idx}.{name}"] = v[pos]
            continue
        out[k] = v
    return out
