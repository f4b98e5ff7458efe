"""Functional collectives and ``Group`` (port of
``paddle_tpu/distributed/communication.py``).

A :class:`Group` is a view over mesh axes, as in the JAX package; here it
resolves to the ``torch.distributed`` process group of this rank's
sub-mesh over those axes (``env.axes_group``). Every rank calls every
collective, as upstream Paddle's scripts do. Inside an :func:`~.spmd.spmd`
region a collective acts over the group's axes that the region names (all
the region's axes when the group names none of them), as the JAX
collectives restrict themselves to the region's axes.

The numbers a test sees are the JAX package's, gradients included: each
collective that carries one is a ``torch.autograd.Function`` whose
backward is the transpose that JAX gives it inside ``shard_map``
(``psum`` → ``psum``, ``all_gather`` → ``psum_scatter``, ``psum_scatter``
→ ``all_gather``, ``all_to_all`` → itself, a shift → the opposite shift,
``broadcast`` → the cotangents summed onto the source). ``MAX`` and
``MIN`` reductions have no derivative in JAX and raise in a backward here.
``reduce`` and ``gather`` are ``all_reduce`` and ``all_gather`` (every
rank keeps the result), and ``scatter`` hands each rank its entry of the
source's list, as in JAX.

In-place collectives (``all_reduce``, ``broadcast``, ``reduce_scatter``,
``scatter``, ``recv``) write their tensor, which keeps its autograd history
through the collective, as JAX's ``_replace_value`` rebinds it.

Backends: NCCL runs each collective natively. Gloo takes host and CUDA
tensors for ``all_reduce``, ``all_gather`` and ``broadcast``; the port
builds ``reduce_scatter`` and ``all_to_all`` from those on gloo, and stages
a point-to-point message on the host. Gloo cannot be captured into a CUDA
graph, so a gloo collective on a capturing stream raises.

A world of one that was never initialized runs every collective as the
identity (``all_gather`` adds the leading dimension of one rank), as the
JAX eager world of one does. ``launches`` counts the backend collectives
issued, by name, where they are issued (a captured graph's replays add
theirs, as with the kernel counters). ``send``/``recv`` work between
processes, where the JAX package's single controller refuses them; a
``new_group`` over a proper subset of ranks raises, as in JAX.
"""
from __future__ import annotations

import functools
import json
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as tdist

from ..core.tensor import plain, wrap
from ..reliability.faults import fault_point
from . import env as env_mod
from .spmd import current_region_axes

__all__ = ["Group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
           "all_reduce", "all_to_all", "all_to_all_single", "alltoall",
           "barrier", "batch_isend_irecv", "broadcast", "gather",
           "get_backend", "get_group", "irecv", "isend", "launches",
           "new_group", "recv", "reduce", "reduce_scatter", "scatter", "send",
           "shift", "stream_allreduce", "wait"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {ReduceOp.SUM: tdist.ReduceOp.SUM,
              ReduceOp.MAX: tdist.ReduceOp.MAX,
              ReduceOp.MIN: tdist.ReduceOp.MIN,
              ReduceOp.PROD: tdist.ReduceOp.PRODUCT,
              ReduceOp.AVG: tdist.ReduceOp.SUM}

# backend collectives issued, by name
launches: Dict[str, int] = {name: 0 for name in (
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all", "broadcast",
    "p2p")}


class Group:
    """A communicator over mesh ``axes`` (reference Group:
    communication/group.py:29; ProcessGroup: paddle/phi/core/distributed/
    collective/process_group.h:48)."""

    def __init__(self, axes: Sequence[str], gid: int = 0,
                 name: Optional[str] = None):
        self.axes = tuple(axes)
        self.id = gid
        self.name = name or ("world" if gid == 0 else f"group_{gid}")

    def _members(self) -> List[int]:
        return env_mod.get_mesh().members(env_mod.get_rank(), self.axes)

    @property
    def nranks(self) -> int:
        return len(self._members())

    world_size = nranks

    @property
    def rank(self) -> int:
        """This process's rank in the group (-1 outside it); the JAX
        single controller gives its process index here."""
        members = self._members()
        me = env_mod.get_rank()
        return members.index(me) if me in members else -1

    def get_group_rank(self, rank):
        members = self._members()
        return members.index(rank) if rank in members else -1

    @property
    def process_ids(self) -> List[int]:
        return self._members()

    ranks = process_ids

    def __repr__(self):
        return f"Group(axes={self.axes}, nranks={self.nranks})"


_groups: dict = {}
_next_gid = [1]


def _world_group() -> Group:
    mesh = env_mod.get_mesh()
    g = _groups.get(0)
    if g is None or g.axes != mesh.axis_names:
        g = _groups[0] = Group(mesh.axis_names, gid=0)
    return g


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return _world_group()
    return _groups[gid]


def new_group(ranks=None, backend=None, axes: Optional[Sequence[str]] = None,
              timeout=None) -> Group:
    """A communicator over mesh ``axes`` (every rank must call it, as every
    rank creates the group), or the world for ``ranks`` of the whole world
    (or none). ``backend`` and ``timeout`` are the world's. A proper subset
    of ranks has no mesh-axis form and raises, as in the JAX package."""
    if axes is None and ranks is not None and \
            len(ranks) not in (0, env_mod.get_world_size()):
        raise NotImplementedError(
            "new_group(ranks=<proper subset>) has no mesh-axis mapping; "
            "pass axes=... (e.g. axes=('dp',)) to communicate over a mesh "
            "axis")
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(axes if axes is not None else _world_group().axes, gid=gid)
    env_mod.axes_group(g.axes)
    _groups[gid] = g
    return g


class _Comm:
    """One collective's communicator: the process group (None for one
    rank), the members (global ranks, in group order), this rank's index
    among them."""

    __slots__ = ("pg", "members", "me", "n")

    def __init__(self, pg, members):
        self.pg = pg
        self.members = members
        self.me = members.index(env_mod.get_rank())
        self.n = len(members)

    def backend(self) -> Optional[str]:
        return None if self.pg is None else tdist.get_backend(self.pg)


def _comm(group: Optional[Group]) -> _Comm:
    axes = (group if group is not None else _world_group()).axes
    region = current_region_axes()
    if region is not None:
        inside = tuple(ax for ax in axes if ax in region)
        axes = inside if inside else tuple(region)
    pg, members = env_mod.axes_group(axes)
    if pg is None and len(members) > 1:
        raise RuntimeError(f"a collective over {len(members)} ranks before "
                           f"init_parallel_env()")
    return _Comm(pg, members)


# ----------------------------------------------------------- backend calls
def _check_capture(c: _Comm, t: torch.Tensor) -> None:
    if (t.is_cuda and c.backend() == "gloo"
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("a gloo collective cannot be captured into a "
                           "CUDA graph (gloo stages CUDA tensors through the "
                           "host); run the step eagerly or use NCCL")


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backends carry it (bool as uint8)."""
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def _all_reduce_(t: torch.Tensor, op: int, c: _Comm) -> torch.Tensor:
    """Reduce ``t`` in place over ``c``."""
    if c.pg is None:
        return t
    _check_capture(c, t)
    buf = _wire(t.contiguous())
    launches["all_reduce"] += 1
    tdist.all_reduce(buf, _TORCH_OPS[op], group=c.pg)
    if buf is not t:
        t.copy_(buf)
    if op == ReduceOp.AVG:
        t.div_(c.n)
    return t


def _all_gather(t: torch.Tensor, c: _Comm) -> torch.Tensor:
    """Every member's ``t``, stacked in member order."""
    t = t.contiguous()
    if c.pg is None:
        return t.unsqueeze(0).clone()
    _check_capture(c, t)
    buf = _wire(t)
    launches["all_gather"] += 1
    if c.backend() == "nccl":
        out = buf.new_empty((c.n,) + tuple(buf.shape))
        tdist.all_gather_into_tensor(out, buf, group=c.pg)
    else:
        parts = [torch.empty_like(buf) for _ in range(c.n)]
        tdist.all_gather(parts, buf, group=c.pg)
        out = torch.stack(parts)
    return out.to(t.dtype) if buf is not t else out


def _broadcast_(t: torch.Tensor, src: int, c: _Comm) -> torch.Tensor:
    """Member ``src``'s ``t`` into every member's ``t``, in place."""
    if c.pg is None:
        return t
    _check_capture(c, t)
    buf = _wire(t.contiguous())
    launches["broadcast"] += 1
    tdist.broadcast(buf, src=c.members[src], group=c.pg)
    if buf is not t:
        t.copy_(buf)
    return t


def _reduce_scatter(x: torch.Tensor, op: int, c: _Comm) -> torch.Tensor:
    """This member's dim-0 chunk of ``x`` reduced over ``c``."""
    if x.shape[0] % c.n:
        raise ValueError(f"reduce_scatter: scatter dimension size "
                         f"{x.shape[0]} must be divisible by the group's "
                         f"{c.n} ranks")
    chunk = x.shape[0] // c.n
    if c.pg is None:
        return x.clone()
    _check_capture(c, x)
    if c.backend() == "nccl" and x.dtype != torch.bool:
        out = x.new_empty((chunk,) + tuple(x.shape[1:]))
        launches["reduce_scatter"] += 1
        tdist.reduce_scatter_tensor(out, x.contiguous(), _TORCH_OPS[op],
                                    group=c.pg)
        return out
    full = _all_reduce_(x.clone(), op, c)
    return full.narrow(0, c.me * chunk, chunk).clone()


def _all_to_all(x: torch.Tensor, c: _Comm) -> torch.Tensor:
    """``x`` of leading dim ``n``: entry ``j`` goes to member ``j``; the
    result's entry ``j`` came from member ``j``."""
    if x.shape[0] != c.n:
        raise ValueError(f"all_to_all: leading dimension {x.shape[0]} != "
                         f"the group's {c.n} ranks")
    if c.pg is None:
        return x.clone()
    _check_capture(c, x)
    if c.backend() == "nccl" and x.dtype != torch.bool:
        out = torch.empty_like(x)
        launches["all_to_all"] += 1
        tdist.all_to_all_single(out, x.contiguous(), group=c.pg)
        return out
    return _all_gather(x, c)[:, c.me].clone()


def _exchange(x: torch.Tensor, dst: int, src: int, c: _Comm) -> torch.Tensor:
    """Send ``x`` to member ``dst`` while receiving one like it from
    member ``src``."""
    if c.pg is None or c.n == 1:
        return x.clone()
    _check_capture(c, x)
    staged = c.backend() == "gloo" and x.is_cuda
    out_dev, out_dtype = x.device, x.dtype
    x = _wire(x.contiguous())
    if staged:
        x = x.cpu()
    got = torch.empty_like(x)
    launches["p2p"] += 1
    ops = [tdist.P2POp(tdist.isend, x, c.members[dst], group=c.pg),
           tdist.P2POp(tdist.irecv, got, c.members[src], group=c.pg)]
    for work in tdist.batch_isend_irecv(ops):
        work.wait()
    return got.to(device=out_dev, dtype=out_dtype)


def _world_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every rank of the world (the spmd assembly)."""
    env = env_mod.instance()
    if not env.initialized or env.world_size == 1:
        return t
    pg, members = env_mod.axes_group(env_mod.get_mesh().axis_names)
    dtype = t.dtype
    t = t.to(torch.int32) if dtype == torch.bool else t
    _all_reduce_(t, ReduceOp.SUM, _Comm(pg, members))
    return t.to(dtype)


# ------------------------------------------------------ autograd functions
class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, c):
        ctx.op, ctx.c = op, c
        return _all_reduce_(x.clone(), op, c)

    @staticmethod
    def backward(ctx, ct):
        if ctx.op not in (ReduceOp.SUM, ReduceOp.AVG):
            name = {ReduceOp.MAX: "pmax", ReduceOp.MIN: "pmin"}.get(
                ctx.op, "pprod")
            raise NotImplementedError(
                f"Differentiation rule for '{name}' not implemented")
        return _all_reduce_(ct.clone(), ctx.op, ctx.c), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return _all_gather(x, c)

    @staticmethod
    def backward(ctx, ct):
        c = ctx.c
        flat = ct.contiguous().reshape((c.n * ct.shape[1],) + ct.shape[2:])
        return _reduce_scatter(flat, ReduceOp.SUM, c), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, c):
        ctx.op, ctx.c = op, c
        return _reduce_scatter(x, op, c)

    @staticmethod
    def backward(ctx, ct):
        if ctx.op != ReduceOp.SUM:
            raise NotImplementedError(
                "Differentiation rule for a MAX/MIN reduce_scatter not "
                "implemented")
        g = _all_gather(ct, ctx.c)
        return g.reshape((-1,) + tuple(ct.shape[1:])), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return _all_to_all(x, c)

    @staticmethod
    def backward(ctx, ct):
        return _all_to_all(ct.contiguous(), ctx.c), None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, c):
        ctx.src, ctx.c = src, c
        return _broadcast_(x.clone(), src, c)

    @staticmethod
    def backward(ctx, ct):
        total = _all_reduce_(ct.clone(), ReduceOp.SUM, ctx.c)
        if ctx.c.me != ctx.src:
            total.zero_()
        return total, None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, c):
        ctx.offset, ctx.c = offset, c
        return _exchange(x, (c.me + offset) % c.n, (c.me - offset) % c.n, c)

    @staticmethod
    def backward(ctx, ct):
        c, off = ctx.c, ctx.offset
        return _exchange(ct, (c.me - off) % c.n, (c.me + off) % c.n, c), \
            None, None


def _tracks_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def _write(tensor, value: torch.Tensor):
    """``tensor`` ← ``value`` in place, its autograd history through
    ``value``."""
    plain(tensor).copy_(value)
    return tensor


def _fault() -> None:
    fault_point("collective")  # chaos hook: a failed or slow collective


# ----------------------------------------------------------- collectives
def all_reduce(tensor, op=ReduceOp.SUM, group: Optional[Group] = None,
               sync_op=True, quantized=None):
    """In-place all-reduce (reference communication/all_reduce.py:29).
    ``quantized=True`` asks for the int8 tier of ``collective_opt``, which
    is not ported (ROADMAP.md, queue 7)."""
    _fault()
    if quantized:
        raise NotImplementedError(
            "all_reduce(quantized=True): the int8 collectives of "
            "collective_opt are not ported yet (ROADMAP.md, queue 7)")
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown ReduceOp {op}")
    c = _comm(group)
    t = plain(tensor)
    if _tracks_grad(t):
        return _write(tensor, _AllReduce.apply(t, op, c))
    _all_reduce_(t, op, c)
    return tensor


def all_gather(tensor_list: Optional[List], tensor, group=None, sync_op=True,
               axis: int = 0):
    """Every rank's ``tensor`` stacked on a new leading dimension (the
    list, when given, filled with the entries)."""
    c = _comm(group)
    t = plain(tensor)
    out = _AllGather.apply(t, c) if _tracks_grad(t) else _all_gather(t, c)
    out = wrap(out)
    if tensor_list is not None:
        tensor_list.clear()
        tensor_list.extend(wrap(list(out.unbind(0))))
    return out


def all_gather_object(object_list: List, obj, group=None):
    """One JSON-serializable object a rank, gathered on every rank (the
    JAX package's JSON round trip: tuples come back as lists)."""
    object_list.clear()
    c = _comm(group)
    if c.pg is None:
        object_list.append(obj)
        return
    gathered = [None] * c.n
    tdist.all_gather_object(gathered, json.dumps(obj), group=c.pg)
    object_list.extend(json.loads(s) for s in gathered)


def reduce_scatter(tensor, tensor_or_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """This rank's dim-0 chunk of the reduction, written into ``tensor``
    (reference communication/reduce_scatter.py). SUM, MAX and MIN, as the
    JAX package supports."""
    _fault()
    src = tensor_or_list
    if isinstance(src, (list, tuple)):
        src = torch.cat([plain(s) for s in src], 0)
    src = plain(src)
    if op not in (ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN):
        name = {ReduceOp.PROD: "PROD", ReduceOp.AVG: "AVG"}.get(op, repr(op))
        raise NotImplementedError(
            f"reduce_scatter(op=ReduceOp.{name}) is not supported; "
            f"supported reductions: SUM, MAX and MIN")
    c = _comm(group)
    if _tracks_grad(src):
        return _write(tensor, _ReduceScatter.apply(src, op, c))
    return _set(tensor, _reduce_scatter(src, op, c))


def _set(tensor, value: torch.Tensor):
    with torch.no_grad():
        plain(tensor).copy_(value)
    return tensor


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """Entry ``j`` of this rank's list goes to rank ``j``; the result's
    entry ``j`` came from rank ``j`` (reference communication/
    all_to_all.py)."""
    if isinstance(in_tensor_list, torch.Tensor):
        stacked = plain(in_tensor_list)
    else:
        stacked = torch.stack([plain(t) for t in in_tensor_list], 0)
    c = _comm(group)
    out = wrap(_AllToAll.apply(stacked, c) if _tracks_grad(stacked)
               else _all_to_all(stacked, c))
    if out_tensor_list is not None:
        out_tensor_list.clear()
        out_tensor_list.extend(wrap(list(out.unbind(0))))
    return out


def alltoall(in_tensor_or_list, out_tensor_list=None, group=None,
             sync_op=True):
    return all_to_all(out_tensor_list, in_tensor_or_list, group=group,
                      sync_op=sync_op)


def all_to_all_single(out_tensor, in_tensor, in_split_sizes=None,
                      out_split_sizes=None, group=None, sync_op=True):
    """``in_tensor``'s dim 0 in equal chunks, chunk ``j`` to rank ``j``,
    the received chunks concatenated."""
    if in_split_sizes or out_split_sizes:
        raise NotImplementedError("uneven all_to_all splits are not "
                                  "supported; pad to equal splits")
    c = _comm(group)
    x = plain(in_tensor)
    if x.shape[0] % c.n:
        raise ValueError(f"all_to_all_single: dimension 0 of size "
                         f"{x.shape[0]} does not split over {c.n} ranks")
    stacked = x.reshape((c.n, x.shape[0] // c.n) + tuple(x.shape[1:]))
    got = (_AllToAll.apply(stacked, c) if _tracks_grad(x)
           else _all_to_all(stacked, c))
    out = got.reshape(x.shape)
    if out_tensor is not None:
        return (_write if _tracks_grad(x) else _set)(out_tensor, out)
    return wrap(out)


def broadcast(tensor, src: int = 0, group=None, sync_op=True):
    """Rank ``src``'s (its index in the group) ``tensor`` into every
    rank's, in place (reference communication/broadcast.py)."""
    c = _comm(group)
    t = plain(tensor)
    if _tracks_grad(t):
        return _write(tensor, _Broadcast.apply(t, src, c))
    _broadcast_(t, src, c)
    return tensor


def reduce(tensor, dst: int = 0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Every rank keeps the reduction, as in the JAX package."""
    return all_reduce(tensor, op=op, group=group, sync_op=sync_op)


def scatter(tensor, tensor_list=None, src: int = 0, group=None,
            sync_op=True):
    """Entry ``i`` of rank ``src``'s list into rank ``i``'s ``tensor``
    (reference communication/scatter.py). The list crosses from ``src``;
    the gradient reaches this rank's own entry, as JAX's per-device index
    gives it."""
    c = _comm(group)
    t = plain(tensor)
    if tensor_list:
        stacked = torch.stack([plain(x) for x in tensor_list], 0)
    else:
        stacked = t.new_empty((c.n,) + tuple(t.shape))
    if c.pg is not None:
        with torch.no_grad():
            sent = _broadcast_(stacked.detach().clone(), src, c)
        if stacked.requires_grad:
            # the source's values, this rank's own entries' gradients
            stacked = stacked + (sent - stacked).detach()
        else:
            stacked = sent
    pick = stacked[c.me]
    return (_write if _tracks_grad(pick) else _set)(tensor, pick)


def gather(tensor, gather_list=None, dst: int = 0, group=None, sync_op=True):
    return all_gather(gather_list, tensor, group=group, sync_op=sync_op)


def send(tensor, dst: int = 0, group=None, sync_op=True):
    """Point-to-point send to rank ``dst`` of the group (reference
    communication/send.py)."""
    c = _comm(group)
    if c.n == 1:
        raise ValueError("send to self on a 1-process world")
    t = plain(tensor).contiguous()
    _check_capture(c, t)
    staged = c.backend() == "gloo" and t.is_cuda
    launches["p2p"] += 1
    tdist.send(_wire(t.cpu() if staged else t), c.members[dst], group=c.pg)
    return None


def recv(tensor, src: int = 0, group=None, sync_op=True):
    """Point-to-point receive from rank ``src`` of the group, into
    ``tensor``."""
    c = _comm(group)
    if c.n == 1:
        raise ValueError("recv from self on a 1-process world")
    t = plain(tensor)
    _check_capture(c, t)
    staged = c.backend() == "gloo" and t.is_cuda
    buf = torch.empty_like(_wire(t.detach()),
                           device="cpu" if staged else t.device)
    launches["p2p"] += 1
    tdist.recv(buf, c.members[src], group=c.pg)
    return _set(tensor, buf.to(t.device))


def shift(tensor, offset: int = 1, group=None):
    """Ring shift over the group's ranks: rank ``i``'s tensor goes to rank
    ``(i + offset) % n`` (the pipeline and ring-attention primitive)."""
    c = _comm(group)
    t = plain(tensor)
    if _tracks_grad(t):
        return wrap(_Shift.apply(t, offset, c))
    return wrap(_exchange(t, (c.me + offset) % c.n, (c.me - offset) % c.n,
                          c))


class _Task:
    """Async task handle (reference ProcessGroup::Task): the collectives
    here complete on the caller's stream, so ``wait()`` has nothing to
    wait for."""

    def __init__(self, result=None):
        self.result = result

    def wait(self):
        return True

    def is_completed(self):
        return True


def isend(tensor, dst=0, group=None):
    return _Task(send(tensor, dst, group))


def irecv(tensor, src=0, group=None):
    return _Task(recv(tensor, src, group))


class P2POp:
    """One edge of a batched exchange: ``peer`` (a rank of the group), or
    ``offset`` on the group's ring (dst = rank + offset for a send, src =
    rank - offset for a receive), as the JAX package pairs them."""

    def __init__(self, op, tensor, peer=None, group=None, offset=None):
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group
        self.offset = offset


def batch_isend_irecv(p2p_op_list: List[P2POp]):
    """The edges exchanged together (reference communication/
    batch_isend_irecv.py; an NCCL group call)."""
    edges = []
    staged = []
    for p in p2p_op_list:
        c = _comm(p.group)
        is_send = p.op in (isend, "isend", send)
        if p.offset is not None:
            peer = (c.me + p.offset) % c.n if is_send \
                else (c.me - p.offset) % c.n
        elif p.peer is not None:
            peer = p.peer
        else:
            raise ValueError("P2POp needs a peer or an offset")
        t = plain(p.tensor)
        _check_capture(c, t)
        host = c.backend() == "gloo" and t.is_cuda
        buf = _wire(t.detach().contiguous())
        buf = buf.cpu() if host else (buf if is_send else buf.clone())
        if not is_send:
            staged.append((p.tensor, buf))
        edges.append(tdist.P2POp(tdist.isend if is_send else tdist.irecv,
                                 buf, c.members[peer], group=c.pg))
    launches["p2p"] += 1
    for work in tdist.batch_isend_irecv(edges):
        work.wait()
    for tensor, buf in staged:
        _set(tensor, buf.to(plain(tensor).device))
    return [_Task()]


def stream_allreduce(*a, **k):
    return all_reduce(*a, **k)


def wait(tensor, group=None, use_calc_stream=True):
    return None


def get_backend(group=None):
    """The group's backend: ``"nccl"`` or ``"gloo"`` (None before
    ``init_parallel_env``); the JAX package says ``"xla"``."""
    env = env_mod.instance()
    if not env.initialized:
        return None
    pg = _comm(group).pg
    return tdist.get_backend(pg) if pg is not None else env.backend


# ---------------------------------------------------------------- watchdog
# every collective launch is registered with the watchdog (no-op until
# enable_comm_watchdog is called), as the reference's comm_task_manager
def _with_watchdog(fn, tag):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        from .utils import watchdog as _wd

        _wd.maybe_watch(tag, out if out is not None else args[:1])
        return out

    return wrapped


for _name in ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
              "broadcast", "reduce", "scatter"):
    globals()[_name] = _with_watchdog(globals()[_name], _name)
del _name


def barrier(group: Optional[Group] = None):
    """Block until every rank of ``group`` reaches here (reference
    paddle.distributed.barrier): an all-reduce of one zero, then a wait
    for it."""
    c = _comm(group)
    if c.pg is None:
        return None
    env = env_mod.instance()
    dev = env.device if env.device is not None else torch.device("cpu")
    if c.backend() == "gloo":
        dev = torch.device("cpu")
    t = torch.zeros((), device=dev)
    _all_reduce_(t, ReduceOp.SUM, c)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return None
