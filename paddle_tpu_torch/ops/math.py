"""Element-wise arithmetic, reductions and scans (port of ``paddle_tpu/ops/
math.py``).

Every op that the JAX package routes through its AMP dispatch names
itself to ``amp.auto_cast`` by the same op name: under O2 a gray op (``add``,
``subtract``, ``multiply``, ``max``, ...) computes in the AMP dtype, so an
f32 normalization output meets a bf16 branch in bf16, where torch alone
would promote the result to f32; a black op (``mean``, ``sum``, ``exp``,
``pow``, ...) computes in f32, and a white one (``matmul``, ``addmm``) in
the AMP dtype. Predicates, ``all``/``any`` and counts read their inputs
as they are. A Python scalar operand stays a scalar.

``max`` and ``min`` send a tie's gradient to every tied element in equal
shares, as ``jnp.max`` does (``torch.amax``; ``torch.max(dim)`` would send
it all to one index). The in-place ops (``add_``, ``exp_``, ...) write the
result into ``x`` (``copy_``) and return ``x``.
"""
from __future__ import annotations

import builtins

import torch

from ..amp.auto_cast import cast_inputs
from . import _common as c

__all__ = [
    "abs", "abs_", "acos", "acosh", "add", "add_", "addmm", "all", "amax",
    "amin", "angle", "any", "asin", "asinh", "assign", "atan", "atan2",
    "atanh", "bincount", "bmm", "builtins_max", "ceil", "ceil_", "clip",
    "clip_", "clip_by_norm", "conj", "copysign", "cos", "cos_", "cosh",
    "count_nonzero", "cross", "cummax", "cummin", "cumprod", "cumsum",
    "deg2rad", "diagonal", "diff", "digamma", "divide", "divide_",
    "divide_no_nan", "dot", "erf", "erfinv", "exp", "exp_", "expm1",
    "floor", "floor_", "floor_divide", "floor_mod", "fmax", "fmin", "frac",
    "gcd", "heaviside", "histogram", "hypot", "i0", "i0e", "i1", "i1e",
    "imag", "increment", "inner", "inverse", "isfinite", "isinf", "isnan",
    "isneginf", "isposinf", "isreal", "kron", "l1_norm", "lcm", "lerp",
    "lgamma", "log", "log10", "log1p", "log2", "logaddexp", "logcumsumexp",
    "logit", "logsumexp", "matmul", "max", "maximum", "mean", "min",
    "minimum", "mm", "mod", "multiplex", "multiply", "multiply_", "mv",
    "nan_to_num", "nanmean", "nansum", "neg", "neg_", "nextafter", "outer",
    "pow", "prod", "rad2deg", "real", "reciprocal", "reduce_as",
    "remainder", "renorm", "rint", "round", "round_", "rsqrt", "rsqrt_",
    "scale", "scale_", "sigmoid", "sign", "sin", "sin_", "sinh", "sqrt",
    "sqrt_", "square", "squared_l2_norm", "stanh", "subtract", "subtract_",
    "sum", "take", "tan", "tanh", "tanh_", "trace", "trunc"]

_NARROW = (torch.bfloat16, torch.float16)


def _cast(op, *args):
    """``args`` cast for ``op`` under AMP; a Python number passes as it
    is."""
    tensors = [t for t in args if isinstance(t, torch.Tensor)]
    cast = iter(cast_inputs(op, *tensors))
    return tuple(next(cast) if isinstance(t, torch.Tensor) else t
                 for t in args)


def _one(op, x):
    (x,) = cast_inputs(op, c.tensor(x))
    return x


# ---------------------------------------------------------------- binary
def _binop(op_name, fn, doc):
    def op(x, y, name=None):
        x, y = _cast(op_name, *c.operands(x, y))
        return fn(x, y)

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"{doc} (op ``{op_name}``)."
    return op


def _true_divide(x, y):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=y.device)
    return torch.true_divide(x, y)


def _pow(x, y):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, device=y.device, dtype=y.dtype)
    return torch.pow(x, y)


def _tensors(fn):
    """``fn`` with a Python-number operand made a tensor beside the
    other (for torch functions that take only tensors)."""
    def call(x, y):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=y.device, dtype=y.dtype)
        if not isinstance(y, torch.Tensor):
            y = torch.as_tensor(y, device=x.device, dtype=x.dtype)
        return fn(x, y)

    return call


add = _binop("add", lambda x, y: x + y, "``x + y``")
subtract = _binop("subtract", lambda x, y: x - y, "``x - y``")
multiply = _binop("multiply", lambda x, y: x * y, "``x * y``")
divide = _binop("divide", _true_divide, "``x / y``, true division")
floor_divide = _binop("floor_divide", _tensors(torch.floor_divide),
                      "``x // y``, rounded toward minus infinity")
mod = _binop("mod", _tensors(torch.remainder),
             "``x mod y`` with the sign of ``y``")
remainder = mod
floor_mod = mod
pow = _binop("pow", _pow, "``x ** y``")  # noqa: A001
maximum = _binop("maximum", _tensors(torch.maximum),
                 "The larger of ``x`` and ``y``, NaN if either is")
minimum = _binop("minimum", _tensors(torch.minimum),
                 "The smaller of ``x`` and ``y``, NaN if either is")
fmax = _binop("fmax", _tensors(torch.fmax),
              "The larger of ``x`` and ``y``, ignoring a NaN")
fmin = _binop("fmin", _tensors(torch.fmin),
              "The smaller of ``x`` and ``y``, ignoring a NaN")
atan2 = _binop("atan2", _tensors(torch.atan2), "``atan(x / y)`` by quadrant")
hypot = _binop("hypot", _tensors(torch.hypot), "``sqrt(x² + y²)``")
logaddexp = _binop("logaddexp", _tensors(torch.logaddexp),
                   "``log(exp(x) + exp(y))``")
heaviside = _binop("heaviside", _tensors(torch.heaviside),
                   "The step function of ``x``, ``y`` where ``x`` is 0")
copysign = _binop("copysign", _tensors(torch.copysign),
                  "``|x|`` with the sign of ``y``")
nextafter = _binop("nextafter", _tensors(torch.nextafter),
                   "The next float after ``x`` toward ``y``")
gcd = _binop("gcd", _tensors(torch.gcd), "The greatest common divisor")
lcm = _binop("lcm", _tensors(torch.lcm), "The least common multiple")
inner = _binop("inner", _tensors(torch.inner),
               "The sum of products over the last axes")
outer = _binop("outer", _tensors(lambda x, y: torch.outer(
    x.reshape(-1), y.reshape(-1))), "The outer product of the flattened "
    "inputs")
kron = _binop("kron", _tensors(torch.kron), "The Kronecker product")


def divide_no_nan(x, y, name=None):
    """``x / y``, and 0 where ``y`` is 0 (op ``divide_no_nan``)."""
    x, y = _cast("divide_no_nan", *c.operands(x, y))
    y = y if isinstance(y, torch.Tensor) else torch.as_tensor(
        y, device=x.device)
    zero = y == 0
    return torch.where(zero, torch.zeros((), dtype=x.dtype, device=x.device),
                       x / torch.where(zero, torch.ones_like(y), y))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``x @ y``, either operand's last two axes swapped first when asked
    (op ``matmul``, white under AMP)."""
    x, y = _cast("matmul", c.tensor(x), c.tensor(y, x))
    if transpose_x and x.ndim > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.ndim > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return matmul(x, y)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    """The sum of ``x * y`` over the last axis; a bf16 or fp16 sum is
    taken in f32 and rounded once (op ``dot``)."""
    x, y = _cast("dot", c.tensor(x), c.tensor(y, x))
    if x.dtype in _NARROW:
        return (x * y).float().sum(-1).to(x.dtype)
    return (x * y).sum(-1)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """``beta * input + alpha * (x @ y)`` (op ``addmm``)."""
    i, x, y = _cast("addmm", c.tensor(input), c.tensor(x), c.tensor(y))
    return beta * i + alpha * torch.matmul(x, y)


def lerp(x, y, weight, name=None):
    """``x + weight * (y - x)`` (op ``lerp``)."""
    x, y, w = _cast("lerp", c.tensor(x), c.tensor(y),
                    weight if not isinstance(weight, (list, tuple))
                    else c.tensor(weight))
    return x + w * (y - x)


def multiplex(inputs, index, name=None):
    """Row ``b`` of ``inputs[index[b]]`` for each row ``b`` (op
    ``multiplex``)."""
    stacked = torch.stack(_cast("multiplex", *[c.tensor(t) for t in inputs]))
    idx = c.tensor(index, stacked).reshape(-1).long()
    return stacked[idx, torch.arange(idx.numel(), device=stacked.device)]


# ---------------------------------------------------------------- unary
def _unop(op_name, fn, doc):
    def op(x, name=None):
        return fn(_one(op_name, x))

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"{doc} (op ``{op_name}``)."
    return op


def _float(fn):
    """``fn`` over a float copy of an integer or bool input, as jnp
    promotes one."""
    def call(x):
        if not (x.is_floating_point() or x.is_complex()):
            x = x.to(torch.float32)
        return fn(x)

    return call


exp = _unop("exp", torch.exp, "``e ** x``")
expm1 = _unop("expm1", torch.expm1, "``e ** x - 1``")
log = _unop("log", torch.log, "The natural log")
log2 = _unop("log2", torch.log2, "The base-2 log")
log10 = _unop("log10", torch.log10, "The base-10 log")
log1p = _unop("log1p", torch.log1p, "``log(1 + x)``")
sqrt = _unop("sqrt", torch.sqrt, "The square root")
rsqrt = _unop("rsqrt", _float(torch.rsqrt), "``1 / sqrt(x)``")
abs = _unop("abs", torch.abs, "``|x|``")  # noqa: A001
neg = _unop("neg", torch.neg, "``-x``")
sign = _unop("sign", torch.sign, "-1, 0 or 1 by the sign of ``x``")
sin = _unop("sin", torch.sin, "The sine")
cos = _unop("cos", torch.cos, "The cosine")
tan = _unop("tan", torch.tan, "The tangent")
asin = _unop("asin", torch.asin, "The arcsine")
acos = _unop("acos", torch.acos, "The arccosine")
atan = _unop("atan", torch.atan, "The arctangent")
sinh = _unop("sinh", torch.sinh, "The hyperbolic sine")
cosh = _unop("cosh", torch.cosh, "The hyperbolic cosine")
tanh = _unop("tanh", torch.tanh, "The hyperbolic tangent")
asinh = _unop("asinh", torch.asinh, "The inverse hyperbolic sine")
acosh = _unop("acosh", torch.acosh, "The inverse hyperbolic cosine")
atanh = _unop("atanh", torch.atanh, "The inverse hyperbolic tangent")
floor = _unop("floor", torch.floor, "Rounded toward minus infinity")
ceil = _unop("ceil", torch.ceil, "Rounded toward infinity")
round = _unop("round", torch.round,  # noqa: A001
              "Rounded to the nearest integer, halves to even")
trunc = _unop("trunc", torch.trunc, "Rounded toward 0")
frac = _unop("frac", lambda x: x - torch.trunc(x),
             "``x`` less its integer part")
reciprocal = _unop("reciprocal", _float(torch.reciprocal), "``1 / x``")
square = _unop("square", torch.square, "``x * x``")
erf = _unop("erf", _float(torch.special.erf), "The error function")
erfinv = _unop("erfinv", _float(torch.special.erfinv),
               "The inverse error function")
lgamma = _unop("lgamma", _float(torch.lgamma), "``log |Γ(x)|``")
digamma = _unop("digamma", _float(torch.digamma), "``Γ'(x) / Γ(x)``")
i0 = _unop("i0", _float(torch.special.i0), "The Bessel function I₀")
i0e = _unop("i0e", _float(torch.special.i0e), "``exp(-|x|) I₀(x)``")
i1 = _unop("i1", _float(torch.special.i1), "The Bessel function I₁")
i1e = _unop("i1e", _float(torch.special.i1e), "``exp(-|x|) I₁(x)``")
angle = _unop("angle", _float(torch.angle), "The complex argument")
conj = _unop("conj", lambda x: torch.conj(x).resolve_conj(),
             "The complex conjugate")
real = _unop("real", lambda x: torch.real(x) if x.is_complex() else x,
             "The real part")
imag = _unop("imag", lambda x: torch.imag(x) if x.is_complex()
             else torch.zeros_like(x), "The imaginary part")
deg2rad = _unop("deg2rad", _float(torch.deg2rad), "Degrees as radians")
rad2deg = _unop("rad2deg", _float(torch.rad2deg), "Radians as degrees")
sigmoid = _unop("sigmoid", torch.sigmoid, "``1 / (1 + e ** -x)``")
logit = _unop("logit", lambda x: torch.log(x / (1 - x)),
              "``log(x / (1 - x))``")


def clip(x, min=None, max=None, name=None):  # noqa: A002
    """``x`` held to ``[min, max]`` (op ``clip``); with neither bound,
    ``x`` itself, as the JAX function returns it."""
    x = _one("clip", x)
    if min is None and max is None:
        return x
    return torch.clamp(x, c.scalar(min), c.scalar(max))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    """NaN as ``nan``, infinities as ``posinf``/``neginf`` (default: the
    dtype's extremes; op ``nan_to_num``)."""
    return torch.nan_to_num(_one("nan_to_num", x), nan, posinf, neginf)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    """``scale_b * tanh(scale_a * x)`` (op ``stanh``)."""
    return scale_b * torch.tanh(scale_a * _one("stanh", x))


def rint(x, name=None):
    """Rounded to the nearest integer, halves to even (op ``rint``)."""
    return torch.round(_one("rint", x))


# ---------------------------------------------------------------- reductions
def _dims(axis):
    d = c.axes(axis)
    return () if d is None else d


def sum(x, axis=None, dtype=None, keepdim=False, name=None):  # noqa: A001
    """The sum over ``axis`` (all axes when None; op ``sum``, black under
    AMP)."""
    x = _one("sum", x)
    dt = None if dtype is None else c.dtype(dtype)
    return torch.sum(x, dim=c.axes(axis), keepdim=keepdim, dtype=dt)


def mean(x, axis=None, keepdim=False, name=None):
    """The mean over ``axis`` (all axes when None; op ``mean``, black)."""
    return _one("mean", x).mean(dim=c.axes(axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """The largest value over ``axis`` (all axes when None; op ``max``,
    gray); tied elements share the gradient equally."""
    return _one("max", x).amax(dim=_dims(axis), keepdim=keepdim)


def min(x, axis=None, keepdim=False, name=None):  # noqa: A001
    """The smallest value over ``axis`` (op ``min``); tied elements share
    the gradient equally."""
    return _one("min", x).amin(dim=_dims(axis), keepdim=keepdim)


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def prod(x, axis=None, keepdim=False, dtype=None, name=None):
    """The product over ``axis`` (op ``prod``, black)."""
    x = _one("prod", x)
    if dtype is not None:
        x = x.to(c.dtype(dtype))
    dims = c.axes(axis)
    if dims is None:
        out = x.reshape(-1).prod()
        return out.reshape((1,) * x.ndim) if keepdim else out
    for d in sorted(dims if isinstance(dims, tuple) else (dims,),
                    key=lambda d: -(d % x.ndim)):
        x = x.prod(dim=d, keepdim=keepdim)
    return x


def logsumexp(x, axis=None, keepdim=False, name=None):
    """``log(sum(exp(x)))`` over ``axis`` (op ``logsumexp``, black)."""
    x = _one("logsumexp", x)
    dims = c.axes(axis)
    return torch.logsumexp(x, dim=tuple(range(x.ndim)) if dims is None
                           else dims, keepdim=keepdim)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    return torch.nansum(_one("nansum", x), dim=_dims(axis), keepdim=keepdim)


def nanmean(x, axis=None, keepdim=False, name=None):
    return torch.nanmean(_one("nanmean", x), dim=_dims(axis) or None,
                         keepdim=keepdim)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = c.tensor(x)
    out = (x != 0).sum(dim=_dims(axis), keepdim=keepdim)
    return out.to(torch.int64)


# ---------------------------------------------------------------- scans
def cumsum(x, axis=None, dtype=None, name=None):
    """Running sums along ``axis`` (over the flattened ``x`` when None;
    op ``cumsum``, black)."""
    x = _one("cumsum", x)
    dt = None if dtype is None else c.dtype(dtype)
    if axis is None:
        return torch.cumsum(x.reshape(-1), 0, dtype=dt)
    return torch.cumsum(x, int(axis), dtype=dt)


def cumprod(x, dim=None, dtype=None, name=None):
    x = _one("cumprod", x)
    dt = None if dtype is None else c.dtype(dtype)
    if dim is None:
        return torch.cumprod(x.reshape(-1), 0, dtype=dt)
    return torch.cumprod(x, int(dim), dtype=dt)


def cummax(x, axis=None, dtype="int64", name=None):
    """Running maxima along ``axis`` and, for each, the last index at
    which ``x`` equals it."""
    x = _one("cummax", x)
    a = 0 if axis is None else int(axis)
    v = x.reshape(-1) if axis is None else x
    vals = torch.cummax(v, a).values
    shape = [1] * v.ndim
    shape[a] = -1
    idx = torch.arange(v.shape[a], device=v.device).reshape(shape)
    inds = torch.cummax(torch.where(v == vals, idx, -1), a).values
    return vals, inds.to(c.dtype(dtype))


def cummin(x, axis=None, dtype="int64", name=None):
    vals, inds = cummax(-c.tensor(x), axis=axis, dtype=dtype)
    return -vals, inds


def logcumsumexp(x, axis=None, name=None):
    x = _one("logcumsumexp", x)
    if axis is None:
        return torch.logcumsumexp(x.reshape(-1), 0)
    return torch.logcumsumexp(x, int(axis))


# ---------------------------------------------------------------- predicates
def isnan(x, name=None):
    return torch.isnan(c.tensor(x))


def isinf(x, name=None):
    return torch.isinf(c.tensor(x))


def isfinite(x, name=None):
    return torch.isfinite(c.tensor(x))


def isneginf(x, name=None):
    return torch.isneginf(c.tensor(x))


def isposinf(x, name=None):
    return torch.isposinf(c.tensor(x))


def isreal(x, name=None):
    return torch.isreal(c.tensor(x))


def all(x, axis=None, keepdim=False, name=None):  # noqa: A001
    x = c.tensor(x)
    return torch.all(x, dim=_dims(axis) or tuple(range(x.ndim)),
                     keepdim=keepdim) if x.ndim else x.bool()


def any(x, axis=None, keepdim=False, name=None):  # noqa: A001
    x = c.tensor(x)
    return torch.any(x, dim=_dims(axis) or tuple(range(x.ndim)),
                     keepdim=keepdim) if x.ndim else x.bool()


# ---------------------------------------------------------------- misc
def assign(x, output=None):
    from .creation import assign as _assign

    return _assign(x, output)


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    with torch.no_grad():
        torch.Tensor.add_(x, c.scalar(value))
    return x


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias`` (or ``(x + bias) * scale``), then the
    activation ``act`` if named (op ``scale``)."""
    x = _one("scale", x)
    s, b = c.scalar(scale), c.scalar(bias)
    out = x * s + b if bias_after_scale else (x + b) * s
    if act is not None:
        from . import activation

        out = getattr(activation, act)(out)
    return out


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    """The sum of the ``offset`` diagonal of the ``(axis1, axis2)``
    planes (op ``trace``)."""
    return torch.diagonal(_one("trace", x), offset, axis1, axis2).sum(-1)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_one("diagonal", x), offset, axis1, axis2)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = _one("diff", x)
    pre = None if prepend is None else c.tensor(prepend, x)
    app = None if append is None else c.tensor(append, x)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


def cross(x, y, axis=None, name=None):
    """The cross product along ``axis`` (default: the last; op
    ``cross``)."""
    x, y = _cast("cross", c.tensor(x), c.tensor(y))
    return torch.linalg.cross(x, y, dim=-1 if axis is None else int(axis))


def histogram(input, bins=100, min=0, max=0, name=None):  # noqa: A002
    """Counts of ``input`` in ``bins`` equal bins over ``[min, max]``
    (the data's range when both are 0), the last bin closed, as
    ``jnp.histogram`` counts."""
    v = c.tensor(input).reshape(-1)
    vf = v if v.is_floating_point() else v.float()
    lo, hi = (min, max) if (min != 0 or max != 0) else (
        float(vf.min()), float(vf.max()))
    edges = torch.linspace(float(lo), float(hi), bins + 1,
                           dtype=torch.float64).to(vf.dtype).to(v.device)
    idx = torch.bucketize(vf, edges, right=True)
    idx = torch.where(vf == edges[-1], bins, idx)
    counts = torch.zeros(bins + 2, dtype=torch.int64, device=v.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    return counts[1:-1]


def bincount(x, weights=None, minlength=0, name=None):
    x = c.tensor(x)
    w = None if weights is None else c.tensor(weights, x)
    return torch.bincount(x.reshape(-1), w, int(minlength))


def builtins_max(a, b):
    """The larger of two Python numbers."""
    return builtins.max(a, b)


def take(x, index, mode="raise", name=None):
    """``x.flatten()[index]``; an index out of range wraps with
    ``mode="wrap"`` and is clipped otherwise, as the JAX package does."""
    x = _one("take", x)
    flat = x.reshape(-1)
    idx = c.tensor(index, x).long()
    n = flat.numel()
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    return flat[idx]


def clip_by_norm(x, max_norm, name=None):
    """``x`` scaled down to L2 norm ``max_norm`` when its norm exceeds it
    (op ``clip_by_norm``)."""
    x = _one("clip_by_norm", x)
    norm = torch.sqrt(torch.sum(x * x))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


def _make_inplace(op):
    def inplace(x, *args, **kwargs):
        out = op(x, *args, **kwargs)
        torch.Tensor.copy_(x, out)
        return x

    inplace.__name__ = inplace.__qualname__ = op.__name__ + "_"
    inplace.__doc__ = f"``{op.__name__}`` written into ``x``."
    return inplace


add_ = _make_inplace(add)
subtract_ = _make_inplace(subtract)
multiply_ = _make_inplace(multiply)
divide_ = _make_inplace(divide)
clip_ = _make_inplace(clip)
scale_ = _make_inplace(scale)
exp_ = _make_inplace(exp)
sqrt_ = _make_inplace(sqrt)
tanh_ = _make_inplace(tanh)
floor_ = _make_inplace(floor)
ceil_ = _make_inplace(ceil)
round_ = _make_inplace(round)
neg_ = _make_inplace(neg)
abs_ = _make_inplace(abs)
sin_ = _make_inplace(sin)
cos_ = _make_inplace(cos)
rsqrt_ = _make_inplace(rsqrt)


def reduce_as(x, target, name=None):
    """``x`` summed down to ``target``'s shape (op ``reduce_as``)."""
    x = _one("reduce_as", x)
    tshape = list(c.tensor(target).shape)
    lead = x.ndim - len(tshape)
    dims = tuple(range(lead)) + tuple(
        lead + i for i, (a, b) in enumerate(zip(x.shape[lead:], tshape))
        if b == 1 and a != 1)
    out = x.sum(dim=dims) if dims else x
    return out.reshape(tshape)


def mv(x, vec, name=None):
    """The matrix-vector product (op ``mv``)."""
    x, vec = _cast("mv", c.tensor(x), c.tensor(vec))
    return x @ vec


def inverse(x, name=None):
    """The matrix inverse (op ``inverse``)."""
    return torch.linalg.inv(_one("inverse", x))


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along ``axis`` scaled down to ``p``-norm ``max_norm``
    where its norm exceeds it, as the JAX package scales (by
    ``max_norm / (norm + 1e-7)``; op ``renorm``)."""
    x = _one("renorm", x)
    red = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
    norms = torch.sum(torch.abs(x) ** p, dim=red, keepdim=True) ** (1.0 / p)
    factor = torch.where(norms > max_norm, max_norm / (norms + 1e-7),
                         torch.ones_like(norms))
    return x * factor


def squared_l2_norm(x, name=None):
    """The sum of squares (op ``squared_l2_norm``)."""
    return torch.sum(torch.square(_one("squared_l2_norm", x)))


def l1_norm(x, name=None):
    """The sum of absolute values (op ``l1_norm``)."""
    return torch.sum(torch.abs(_one("l1_norm", x)))
