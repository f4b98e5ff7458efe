"""Shape, layout and indexing ops (port of ``paddle_tpu/ops/
manipulation.py``).

The ops that the JAX package routes through its AMP dispatch name
themselves to ``amp.auto_cast`` by the same op name; ``concat``,
``stack``, ``reshape`` and ``transpose``, like the rest of this module, are
gray: O1 leaves their inputs' dtype, O2 computes them in the AMP dtype.
So an f32 BatchNorm or channel-mean output that meets bf16 tensors in a
``concat`` joins them in bf16 (PP-LiteSeg's STDC blocks and UAFM), where
``torch.cat`` alone would promote the result to f32. Index and mask
operands are read as they are.

``reshape`` and ``transpose`` return views where the strides allow (the
JAX package copies, as XLA arrays are values); the in-place forms
(``reshape_``, ``scatter_``, ``fill_``) write into ``x`` and return it.
Ops whose output size depends on the data (``masked_select``, ``unique``,
``nonzero``) read the data to the host, as in the JAX package.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs
from ..base import dtype as dtype_mod
from . import _common as c

__all__ = [
    "as_complex", "as_real", "as_strided", "assign", "broadcast_shape",
    "broadcast_tensors", "broadcast_to", "builtins_sum", "cast", "chunk",
    "coalesce_tensor", "concat", "crop", "expand", "expand_as", "fill",
    "fill_", "fill_diagonal", "fill_diagonal_tensor", "flatten", "flip",
    "gather", "gather_nd", "getitem", "index_add", "index_fill",
    "index_put", "index_sample", "index_select", "masked_fill",
    "masked_scatter", "masked_select", "moveaxis", "numel", "pad",
    "put_along_axis", "repeat_interleave", "reshape", "reshape_", "reverse",
    "roll", "rot90", "scatter", "scatter_", "scatter_nd", "scatter_nd_add",
    "sequence_mask", "set_value", "setitem_", "shard_index", "slice",
    "split", "squeeze", "squeeze_", "stack", "strided_slice", "swapaxes",
    "swapdims", "take_along_axis", "tensordot", "tile", "tolist",
    "transpose", "unbind", "unfold_axis", "unique", "unique_consecutive",
    "unsqueeze", "unsqueeze_", "unstack", "view", "view_dtype",
    "view_shape", "view_slice", "where"]

_builtin_slice = builtins.slice  # ``slice`` is the paddle.slice op below


def _one(op, x):
    (x,) = cast_inputs(op, c.tensor(x))
    return x


def _int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def cast(x, dtype):
    """``x`` in ``dtype`` (itself when it already is)."""
    x = c.tensor(x)
    dt = dtype_mod.convert_dtype(dtype)
    return x if x.dtype == dt else x.to(dt)


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1), copied where its strides
    do not allow a view (op ``reshape``)."""
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, int):
        shape = [shape]
    return _one("reshape", x).reshape([_int(s) for s in shape])


def reshape_(x, shape, name=None):
    """``x`` given ``shape`` in place; returns ``x``."""
    with torch.no_grad():
        torch.Tensor.set_(x, c.tensor(x).reshape(list(c.shape(shape))))
    return x


def view(x, shape_or_dtype, name=None):
    """``reshape`` for a shape, ``cast`` for a dtype."""
    if isinstance(shape_or_dtype, (list, tuple, int)):
        return reshape(x, shape_or_dtype)
    return cast(x, shape_or_dtype)


def transpose(x, perm, name=None):
    """``x`` with its axes in the order ``perm``: a strided view (op
    ``transpose``)."""
    return _one("transpose", x).permute([int(p) for p in perm])


def moveaxis(x, source, destination, name=None):
    return torch.movedim(_one("moveaxis", x), source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_one("swapaxes", x), int(axis0), int(axis1))


swapdims = swapaxes


def concat(x, axis=0, name=None):
    """The tensors of ``x`` joined along ``axis`` (op ``concat``)."""
    return torch.cat(cast_inputs("concat", *[c.tensor(t) for t in x]),
                     dim=_int(axis))


def stack(x, axis=0, name=None):
    """The tensors of ``x`` stacked on a new ``axis`` (op ``stack``)."""
    return torch.stack(cast_inputs("stack", *[c.tensor(t) for t in x]),
                       dim=_int(axis))


def builtins_sum(it):
    """The sum of an iterable of Python numbers."""
    return builtins.sum(it)


def split(x, num_or_sections, axis=0, name=None):
    """``x`` cut along ``axis`` into ``num_or_sections`` equal parts, or
    parts of the listed sizes (one may be -1: the rest)."""
    x = _one("split", x)
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(f"cannot split dim {dim} into "
                             f"{num_or_sections}")
        sections = [dim // num_or_sections] * num_or_sections
    else:
        sections = [_int(s) for s in num_or_sections]
        unknown = [i for i, s in enumerate(sections) if s < 0]
        if len(unknown) > 1:
            raise ValueError("at most one section may be -1")
        if unknown:
            sections[unknown[0]] = dim - builtins.sum(
                s for s in sections if s >= 0)
    return list(torch.split(x, sections, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(input, axis=0, name=None):
    return list(torch.unbind(_one("unbind", input), dim=int(axis)))


def squeeze(x, axis=None, name=None):
    """``x`` without its size-1 axes (those of ``axis`` only, when
    given; an axis of another size stays)."""
    x = _one("squeeze", x)
    if axis is None:
        return x.squeeze()
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    dims = tuple(a % x.ndim for a in axes if x.shape[a % x.ndim] == 1)
    return x.squeeze(dims) if dims else x


def unsqueeze(x, axis, name=None):
    """``x`` with size-1 axes inserted at ``axis`` (an int or a list)."""
    x = _one("unsqueeze", x)
    axes = [_int(a) for a in (axis if isinstance(axis, (list, tuple))
                              else [axis])]
    for a in sorted(a if a >= 0 else a + x.ndim + len(axes) for a in axes):
        x = x.unsqueeze(a)
    return x


squeeze_ = squeeze
unsqueeze_ = unsqueeze


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = _one("flatten", x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape`` (-1 keeps a dim)."""
    x = _one("expand", x)
    shape = [_int(s) for s in (shape.tolist() if isinstance(
        shape, torch.Tensor) else shape)]
    return x.expand(shape)


broadcast_to = expand


def expand_as(x, y, name=None):
    return expand(x, list(c.tensor(y).shape))


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def broadcast_tensors(input, name=None):
    tensors = [c.tensor(t) for t in input]
    target = torch.broadcast_shapes(*[t.shape for t in tensors])
    return [expand(t, list(target)) for t in tensors]


def tile(x, repeat_times, name=None):
    if isinstance(repeat_times, torch.Tensor):
        repeat_times = repeat_times.tolist()
    return torch.tile(_one("tile", x), [_int(r) for r in repeat_times])


def roll(x, shifts, axis=None, name=None):
    x = _one("roll", x)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def flip(x, axis, name=None):
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return torch.flip(_one("flip", x), [int(a) for a in axes])


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(_one("rot90", x), k, list(axes))


def gather(x, index, axis=0, name=None):
    """The slices of ``x`` along ``axis`` at ``index`` (flattened)."""
    x = _one("gather", x)
    idx = c.tensor(index, x).long()
    if idx.ndim == 0:
        return torch.select(x, _int(axis), int(idx))
    return torch.index_select(x, _int(axis), idx.reshape(-1))


def _index_tuple(idx):
    return tuple(idx[..., i] for i in range(idx.shape[-1]))


def gather_nd(x, index, name=None):
    """``x`` at the leading coordinates listed in ``index``'s last axis."""
    x = _one("gather_nd", x)
    return x[_index_tuple(c.tensor(index, x).long())]


def scatter(x, index, updates, overwrite=True, name=None):
    """``x`` with rows ``index`` set to ``updates`` (``overwrite=False``:
    the rows zeroed, then every update added)."""
    x, updates = cast_inputs("scatter", c.tensor(x), c.tensor(updates))
    idx = c.tensor(index, x).long().reshape(-1)
    if overwrite:
        return x.index_put((idx,), updates)
    zeroed = x.index_put((idx,), torch.zeros_like(updates))
    return zeroed.index_put((idx,), updates, accumulate=True)


def scatter_(x, index, updates, overwrite=True, name=None):
    torch.Tensor.copy_(x, scatter(x, index, updates, overwrite))
    return x


def scatter_nd_add(x, index, updates, name=None):
    x, updates = cast_inputs("scatter_nd_add", c.tensor(x),
                             c.tensor(updates))
    idx = c.tensor(index, x).long()
    return x.index_put(_index_tuple(idx), updates, accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = c.tensor(updates)
    base = torch.zeros(c.shape(shape), dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(base, index, updates)


def index_select(x, index, axis=0, name=None):
    x = _one("index_select", x)
    return torch.index_select(x, int(axis), c.tensor(index, x).long())


def index_sample(x, index):
    x = _one("index_sample", x)
    return torch.gather(x, 1, c.tensor(index, x).long())


def index_add(x, index, axis, value, name=None):
    x, value = cast_inputs("index_add", c.tensor(x), c.tensor(value))
    return torch.index_add(x, int(axis), c.tensor(index, x).long(), value)


def index_put(x, indices, value, accumulate=False, name=None):
    x, value = cast_inputs("index_put", c.tensor(x), c.tensor(value))
    idx = tuple(c.tensor(i, x) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    return x.index_put(idx, value.to(x.dtype), accumulate=accumulate)


def index_fill(x, index, axis, fill_value, name=None):
    x = _one("index_fill", x)
    return torch.index_fill(x, int(axis), c.tensor(index, x).long(),
                            c.scalar(fill_value))


def masked_select(x, mask, name=None):
    x = c.tensor(x)
    return torch.masked_select(x, c.tensor(mask, x).bool())


def masked_fill(x, mask, value, name=None):
    """``x`` with ``value`` where ``mask`` holds (op ``masked_fill``)."""
    x = _one("masked_fill", x)
    value = c.scalar(value) if not isinstance(value, torch.Tensor) or \
        value.numel() == 1 else c.tensor(value).to(x.dtype)
    return torch.where(c.tensor(mask, x).bool(),
                       torch.as_tensor(value, dtype=x.dtype, device=x.device),
                       x)


def masked_scatter(x, mask, value, name=None):
    """``x`` with the leading values of ``value`` placed, in order, where
    ``mask`` holds."""
    x = c.tensor(x)
    mask = c.tensor(mask, x).bool()
    return torch.masked_scatter(x, mask.expand_as(x),
                                c.tensor(value, x).to(x.dtype))


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition`` holds, else ``y`` (op ``where``); with
    neither, the coordinates where it holds, one tensor per axis."""
    if x is None and y is None:
        from .search import nonzero

        return nonzero(condition, as_tuple=True)
    cond = c.tensor(condition)
    x, y = c.operands(x, y)
    tensors = [t for t in (x, y) if isinstance(t, torch.Tensor)]
    cast = iter(cast_inputs("where", *tensors))
    x, y = (next(cast) if isinstance(t, torch.Tensor) else t for t in (x, y))
    return torch.where(cond.bool(), x, y)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr = _one("take_along_axis", arr)
    idx = c.tensor(indices, arr).long()
    if broadcast:
        shape = [max(a, i) if d != axis % arr.ndim else i for d, (a, i) in
                 enumerate(zip(arr.shape, idx.shape))]
        idx = idx.expand(shape)
        arr = arr.expand([s if d != axis % arr.ndim else arr.shape[d]
                          for d, s in enumerate(shape)])
    return torch.take_along_dim(arr, idx, dim=int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    """``arr`` with ``values`` written along ``axis`` at ``indices``:
    ``reduce`` is ``assign``, ``add``, ``multiply``/``mul``, ``amin`` or
    ``amax`` (op ``put_along_axis``)."""
    arr = _one("put_along_axis", arr)
    idx = c.tensor(indices, arr).long()
    vals = torch.as_tensor(values, device=arr.device).to(arr.dtype) \
        if not isinstance(values, torch.Tensor) else c.tensor(values).to(
            arr.dtype)
    vals = vals.expand(idx.shape)
    if reduce == "assign":
        return torch.scatter(arr, int(axis), idx, vals)
    how = {"add": "sum", "multiply": "prod", "mul": "prod", "amin": "amin",
           "amax": "amax"}[reduce]
    return torch.scatter_reduce(arr, int(axis), idx, vals, how,
                                include_self=include_self)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _one("repeat_interleave", x)
    if isinstance(repeats, torch.Tensor):
        repeats = c.tensor(repeats).to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted distinct values of ``x`` (along ``axis``), with the
    first index of each, the inverse map and the counts when asked."""
    x = c.tensor(x)
    arr = x.detach().cpu().numpy()
    res = np.unique(arr, return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not (return_index or return_inverse or return_counts):
        return torch.from_numpy(np.ascontiguousarray(res)).to(x.device)
    out = [torch.from_numpy(np.ascontiguousarray(res[0])).to(x.device)]
    for r in res[1:]:
        out.append(torch.from_numpy(np.asarray(r).astype(np.int64)).to(
            device=x.device, dtype=c.dtype(dtype)).reshape(-1))
    return tuple(out)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    if axis is not None:
        raise NotImplementedError("unique_consecutive with axis")
    x = c.tensor(x)
    out, inverse, counts = torch.unique_consecutive(
        x.reshape(-1), return_inverse=True, return_counts=True)
    results = [out]
    if return_inverse:
        results.append(inverse.to(c.dtype(dtype)))
    if return_counts:
        results.append(counts.to(c.dtype(dtype)))
    return results[0] if len(results) == 1 else tuple(results)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW",
        pad_from_left_axis=True, name=None):
    """``x`` padded: ``pad`` lists (before, after) for every axis from
    the first, or for the trailing spatial axes from the last (torch's
    order); ``mode`` is ``constant``, ``reflect``, ``replicate`` or
    ``circular`` (op ``pad``)."""
    x = _one("pad", x)
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.ndim
    if len(pad) == 2 * nd:
        pairs = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
        if not pad_from_left_axis:
            pairs = pairs[::-1]
    else:
        k = len(pad) // 2
        spatial = [(pad[2 * i], pad[2 * i + 1]) for i in range(k)][::-1]
        pairs = [(0, 0)] * (nd - k) + spatial
        if data_format in ("NHWC", "NLC", "NDHWC") and nd >= 3:
            pairs = [(0, 0)] + spatial + [(0, 0)]
    if mode == "constant":
        flat = [v for pair in pairs[::-1] for v in pair]
        return torch.nn.functional.pad(x, flat, value=value)
    np_mode = {"reflect": "reflect", "replicate": "edge",
               "circular": "wrap"}[mode]
    # the non-constant modes index only: gather by numpy-computed indices
    index = [torch.as_tensor(np.pad(np.arange(n), p, mode=np_mode),
                             device=x.device) for n, p in zip(x.shape, pairs)]
    out = x
    for d, ix in enumerate(index):
        out = torch.index_select(out, d, ix)
    return out


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Each index made local to shard ``shard_id`` of ``nshards`` equal
    shards of ``[0, index_num)``, ``ignore_value`` outside it."""
    v = c.tensor(input)
    size = (index_num + nshards - 1) // nshards
    lo = shard_id * size
    inside = (v >= lo) & (v < lo + size)
    return torch.where(inside, v - lo, torch.full_like(v, ignore_value))


def numel(x, name=None):
    """The element count as a 0-d int64 tensor."""
    x = c.tensor(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def as_complex(x, name=None):
    x = _one("as_complex", x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.view_as_real(_one("as_real", x)).clone()


def tensordot(x, y, axes=2, name=None):
    x, y = cast_inputs("tensordot", c.tensor(x), c.tensor(y))
    return torch.tensordot(x, y, dims=axes)


def tolist(x):
    return c.tensor(x).tolist()


def crop(x, shape=None, offsets=None, name=None):
    """The block of ``x`` of ``shape`` (-1: the whole dim) at
    ``offsets``."""
    x = _one("crop", x)
    if shape is None:
        return x
    shape = [x.shape[i] if int(s) == -1 else int(s)
             for i, s in enumerate(c.shape(shape))]
    offsets = [0] * x.ndim if offsets is None else list(c.shape(offsets))
    return x[tuple(_builtin_slice(o, o + s) for o, s in zip(offsets, shape))]


def _normalize_index(idx):
    if isinstance(idx, tuple):
        return tuple(_normalize_index(e) for e in idx)
    if isinstance(idx, torch.Tensor):
        t = c.tensor(idx)
        return t if t.dtype == torch.bool else t.long()
    if isinstance(idx, list) and builtins.any(
            isinstance(e, torch.Tensor) for e in idx):
        return torch.as_tensor([c.scalar(e) for e in idx])
    if isinstance(idx, _builtin_slice):
        return _builtin_slice(c.scalar(idx.start), c.scalar(idx.stop),
                              c.scalar(idx.step))
    return idx


def getitem(x, idx):
    """``x[idx]`` (op ``getitem``)."""
    return _one("getitem", x)[_normalize_index(idx)]


def setitem_(x, idx, value):
    """``x[idx] = value`` in place; returns ``x``."""
    target = c.tensor(x)
    value = c.tensor(value, target) if not isinstance(
        value, (int, float, bool)) else value
    if isinstance(value, torch.Tensor):
        value = value.to(target.dtype)
    target[_normalize_index(idx)] = value
    return x


def slice(input, axes, starts, ends):  # noqa: A001 — paddle.slice
    """``input[starts:ends]`` along each of ``axes`` (op ``slice``)."""
    x = _one("slice", input)
    index = [_builtin_slice(None)] * x.ndim
    for ax, s, e in zip(axes, starts, ends):
        index[int(ax)] = _builtin_slice(_int(s), _int(e))
    return x[tuple(index)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """``x[start:end:stride]`` along each of ``axes``; a negative stride
    runs backward (op ``strided_slice``)."""
    x = _one("strided_slice", x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        ax, s, e, st = int(ax), _int(s), _int(e), _int(st)
        index = np.arange(x.shape[ax])[_builtin_slice(s, e, st)]
        x = torch.index_select(x, ax, torch.as_tensor(
            index.copy(), device=x.device, dtype=torch.long))
    return x


def assign(x, output=None, name=None):
    """A copy of ``x``; with ``output``, written into it."""
    from .creation import assign as _assign

    return _assign(x, output)


def fill(x, value):
    """A tensor like ``x`` filled with ``value``."""
    return torch.full_like(_one("fill", x), c.scalar(value))


def fill_(x, value):
    with torch.no_grad():
        torch.Tensor.fill_(x, c.scalar(value))
    return x


def fill_diagonal(x, value, offset=0, wrap=False, name=None):
    """``x`` with ``value`` on the ``offset`` diagonal of its last two
    axes."""
    x = _one("fill_diagonal", x)
    n, m = x.shape[-2], x.shape[-1]
    rows = torch.arange(n, device=x.device)
    cols = rows + offset
    ok = (cols >= 0) & (cols < m)
    mask = torch.zeros((n, m), dtype=torch.bool, device=x.device)
    mask[rows[ok], cols[ok]] = True
    return torch.where(mask, torch.as_tensor(value, dtype=x.dtype,
                                             device=x.device), x)


def fill_diagonal_tensor(x, y, offset=0, dim1=0, dim2=1, name=None):
    """``x`` with ``y`` (its last axis along the diagonal) on the
    ``offset`` diagonal of the ``(dim1, dim2)`` planes."""
    x, y = cast_inputs("fill_diagonal_tensor", c.tensor(x), c.tensor(y))
    out = x.clone()
    diag = torch.diagonal(out, offset, dim1, dim2)
    diag.copy_(y.to(x.dtype).expand_as(diag))
    return out


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(_one("unstack", x), dim=int(axis)))


def reverse(x, axis, name=None):
    return flip(x, axis)


def as_strided(x, shape, stride, offset=0, name=None):
    """The strided view of ``x``'s elements in row-major order."""
    x = _one("as_strided", x).contiguous()
    return torch.as_strided(x, list(shape), list(stride), int(offset))


def unfold_axis(x, axis, size, step, name=None):
    """Windows of ``size`` every ``step`` along ``axis``: the window count
    replaces the axis and the window's elements make a new last axis."""
    return _one("tensor_unfold", x).unfold(int(axis), int(size), int(step))


def view_dtype(x, dtype, name=None):
    """``x``'s bits read as ``dtype``; the last axis scales by the ratio
    of the element widths."""
    return _one("view_dtype", x).contiguous().view(
        dtype_mod.convert_dtype(dtype))


def view_shape(x, shape, name=None):
    return reshape(x, shape)


def view_slice(x, begin_idx, end_idx, name=None):
    return _one("view_slice", x)[int(begin_idx):int(end_idx)]


def set_value(x, value, name=None):
    """A tensor like ``x`` holding ``value`` broadcast to its shape."""
    x, = cast_inputs("set_value", c.tensor(x))
    value = c.tensor(value, x) if not isinstance(
        value, (int, float, bool)) else torch.as_tensor(value,
                                                        device=x.device)
    return value.to(x.dtype).expand(x.shape).clone()


def coalesce_tensor(inputs, dtype=None, name=None):
    """The inputs packed into one flat buffer, and views of it in their
    shapes: ``(fused, outs)``."""
    tensors = [c.tensor(t) for t in inputs]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    outs, off = [], 0
    for t in tensors:
        outs.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return flat, outs


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """``mask[..., j] = j < x[...]`` over ``j < maxlen`` (default: the
    largest length)."""
    x = c.tensor(x)
    m = int(maxlen) if maxlen is not None else int(x.max())
    return (torch.arange(m, device=x.device) < x[..., None]).to(
        c.dtype(dtype))
