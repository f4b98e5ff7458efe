"""The port's top level against the JAX package's, on the CPU.

One table-driven, parametrised test per JAX ops module (creation, math,
manipulation, logic, search, stat): each case draws its inputs with
``np.random.RandomState(seed)``, hands the same numpy arrays to
``paddle_tpu.<name>`` and ``paddle_tpu_torch.<name>`` (each side's
``to_tensor``), and compares every output. The tolerance, unless the case
names another: f32 within 1e-6 relative (and 1e-6 absolute, for values
near 0), integers and booleans exact. Dtypes agree up to the JAX package's
narrowing of 64-bit types to 32 bits (the port keeps int64 and float64).

Also here: the random ops (shapes, dtypes, bounds, moments and that one
seed repeats, not values: the streams are torch's, not threefry), the
dtypes, the seed and build contract, the grad mode, ``set_device``,
``paddle.grad`` against JAX's, and that every other name of the JAX top
level raises ``NotImplementedError`` naming ``ROADMAP.md``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import device as device_mod

RTOL, ATOL = 1e-6, 1e-6


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for each test; the default comes back
    after."""
    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    yield


# ------------------------------------------------------------ comparison
def _narrowed(got: np.dtype, want: np.dtype) -> bool:
    return got == want or (got, want) in {
        (np.dtype("int64"), np.dtype("int32")),
        (np.dtype("float64"), np.dtype("float32")),
        (np.dtype("complex128"), np.dtype("complex64"))}


def _host(x, jax_side):
    if isinstance(x, (list, tuple)):
        return [_host(v, jax_side) for v in x]
    if jax_side and isinstance(x, P.Tensor):
        return np.asarray(x.numpy())
    if not jax_side and isinstance(x, torch.Tensor):
        return T.Tensor.numpy(x.as_subclass(T.Tensor))
    return x


def _compare(got, want, tol, what):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), what
        for g, w in zip(got, want):
            _compare(g, w, tol, what)
        return
    if not isinstance(want, np.ndarray):
        if isinstance(got, np.ndarray):
            got = got.item()
        assert got == pytest.approx(want, rel=RTOL, abs=ATOL) \
            if isinstance(want, float) else got == want, (what, got, want)
        return
    got = np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert _narrowed(got.dtype, want.dtype), (what, got.dtype, want.dtype)
    if want.dtype.kind in "fc":
        rtol, atol = tol or (RTOL, ATOL)
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=rtol,
                                   atol=atol, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)


def _args(args, pkg):
    def one(a):
        if isinstance(a, np.ndarray):
            return pkg.to_tensor(a)
        if isinstance(a, list) and a and all(isinstance(v, np.ndarray)
                                             for v in a):
            return [pkg.to_tensor(v) for v in a]
        return a
    return [one(a) for a in args]


def _run(name, make, kwargs=None, tol=None, seed=0, fn=None):
    """``name`` (or ``fn(pkg)``) in both packages on the same inputs; a
    name the JAX top level lacks (or holds as a submodule) comes from
    ``paddle.tensor`` in the port and from the ops module in JAX."""
    kwargs = kwargs or {}
    args = make(np.random.RandomState(seed))
    want_args, got_args = _args(args, P), _args(args, T)
    # ``tensor`` names a submodule at both top levels (once imported)
    if fn is None and (not hasattr(P, name) or name == "tensor"):
        fn = _module_fn(MODULE_OF[name], name)
    jax_fn = fn(P) if fn else getattr(P, name)
    port_fn = fn(T) if fn else getattr(T, name)
    want = jax_fn(*want_args, **kwargs)
    got = port_fn(*got_args, **kwargs)
    _compare(_host(got, False), _host(want, True), tol, name)
    # an in-place op's target holds the result in both
    if name.endswith("_") and not name.endswith("__"):
        _compare(_host(got_args[0], False), _host(want_args[0], True), tol,
                 name + " target")


def _module_fn(module, name):
    """``name`` from the ops module ``module``: JAX's, and the port's as
    ``paddle.tensor`` exports it."""
    import importlib

    def pick(pkg):
        if pkg is T:
            return getattr(T.tensor, name)
        return getattr(importlib.import_module(
            f"{pkg.__name__}.ops.{module}"), name)
    return pick


def F(*shape, lo=-2.0, hi=2.0):
    return lambda rs: rs.uniform(lo, hi, shape).astype(np.float32)


def I(*shape, lo=0, hi=10):  # noqa: E743
    return lambda rs: rs.randint(lo, hi, shape).astype(np.int64)


def B(*shape):
    return lambda rs: rs.rand(*shape) > 0.5


def args(*makers):
    """A case's inputs: each maker drawn in order from one RandomState
    (a plain value passes as it is)."""
    return lambda rs: [m(rs) if callable(m) else m for m in makers]


def nonzero_f(*shape):
    return lambda rs: (rs.uniform(0.5, 2.0, shape)
                       * rs.choice([-1, 1], shape)).astype(np.float32)


# ------------------------------------------------------------ creation
CREATION = [
    ("to_tensor", args(F(3, 4)), {}, None),
    ("to_tensor", args(I(5)), {}, None),
    ("to_tensor", args([[1.0, 2.0], [3.0, 4.0]]), {}, None),
    ("to_tensor", args(F(2, 3)), {"dtype": "float16"}, (1e-3, 1e-3)),
    ("tensor", args(F(2, 2)), {}, None),
    ("zeros", args([2, 3]), {}, None),
    ("zeros", args([4]), {"dtype": "int32"}, None),
    ("ones", args([3, 2]), {}, None),
    ("full", args([2, 2], 1.5), {}, None),
    ("full", args([3], 7), {"dtype": "int64"}, None),
    ("empty", args([2, 3]), {}, None),
    ("zeros_like", args(F(2, 3)), {}, None),
    ("ones_like", args(I(4)), {}, None),
    ("full_like", args(F(3), 2.5), {}, None),
    ("empty_like", args(F(2)), {}, None),
    ("arange", args(5), {}, None),
    ("arange", args(1, 10, 3), {}, None),
    ("arange", args(0.0, 1.0, 0.25), {}, None),
    ("linspace", args(0.0, 1.0, 7), {}, None),
    ("logspace", args(0.0, 2.0, 5), {}, (1e-5, 1e-6)),
    ("eye", args(3), {}, None),
    ("eye", args(2, 4), {}, None),
    ("diag", args(F(4)), {}, None),
    ("diag", args(F(3)), {"offset": 1, "padding_value": 9}, None),
    ("diag", args(F(3, 3)), {"offset": -1}, None),
    ("diagflat", args(F(2, 2)), {}, None),
    ("diag_embed", args(F(2, 3)), {}, None),
    ("tril", args(F(4, 4)), {"diagonal": -1}, None),
    ("triu", args(F(3, 5)), {"diagonal": 1}, None),
    ("meshgrid", args(F(3), F(4)), {}, None),
    ("assign", args(F(2, 3)), {}, None),
    ("clone", args(F(3)), {}, None),
    ("complex", args(F(3), F(3)), {}, None),
    ("tril_indices", args(4, 4, -1), {}, None),
    ("triu_indices", args(3, 4, 1), {}, None),
    ("one_hot", args(I(5, hi=4), 4), {}, None),
    ("full_batch_size_like", args(F(3, 2), [1, 5], "float32", 2.0), {},
     None),
]


@pytest.mark.parametrize("case", CREATION, ids=lambda c: c[0])
def test_creation_matches_jax(case):
    name, make, kwargs, tol = case
    _run(name, make, kwargs, tol)


# ------------------------------------------------------------ math
_UNARY = {  # name: input domain
    "exp": F(3, 4), "expm1": F(3, 4), "log": F(3, 4, lo=0.1),
    "log2": F(3, 4, lo=0.1), "log10": F(3, 4, lo=0.1),
    "log1p": F(3, 4, lo=-0.5), "sqrt": F(3, 4, lo=0.0),
    "rsqrt": F(3, 4, lo=0.1), "abs": F(3, 4), "neg": F(3, 4),
    "sign": F(3, 4), "sin": F(3, 4), "cos": F(3, 4), "tan": F(3, 4, lo=-1.2,
                                                               hi=1.2),
    "asin": F(3, 4, lo=-0.9, hi=0.9), "acos": F(3, 4, lo=-0.9, hi=0.9),
    "atan": F(3, 4), "sinh": F(3, 4), "cosh": F(3, 4), "tanh": F(3, 4),
    "asinh": F(3, 4), "acosh": F(3, 4, lo=1.1, hi=3.0),
    "atanh": F(3, 4, lo=-0.9, hi=0.9), "floor": F(3, 4, lo=-5, hi=5),
    "ceil": F(3, 4, lo=-5, hi=5), "round": F(3, 4, lo=-5, hi=5),
    "trunc": F(3, 4, lo=-5, hi=5), "frac": F(3, 4, lo=-5, hi=5),
    "reciprocal": nonzero_f(3, 4), "square": F(3, 4), "erf": F(3, 4),
    "erfinv": F(3, 4, lo=-0.9, hi=0.9), "lgamma": F(3, 4, lo=0.2, hi=5),
    "digamma": F(3, 4, lo=0.2, hi=5), "i0": F(3, 4), "i0e": F(3, 4),
    "i1": F(3, 4), "i1e": F(3, 4), "angle": F(3, 4), "conj": F(3, 4),
    "real": F(3, 4), "imag": F(3, 4), "deg2rad": F(3, 4, lo=-180, hi=180),
    "rad2deg": F(3, 4), "sigmoid": F(3, 4),
    "logit": F(3, 4, lo=0.1, hi=0.9), "rint": F(3, 4, lo=-5, hi=5),
    "stanh": F(3, 4), "isnan": F(3, 4), "isinf": F(3, 4),
    "isfinite": F(3, 4), "isneginf": F(3, 4), "isposinf": F(3, 4),
    "isreal": F(3, 4),
}
_UNARY_TOL = {"lgamma": (1e-5, 1e-6), "digamma": (1e-5, 1e-5),
              "i0": (1e-5, 1e-6), "i0e": (1e-5, 1e-6), "i1": (1e-5, 1e-6),
              "i1e": (1e-5, 1e-6), "erfinv": (1e-5, 1e-6),
              "expm1": (1e-6, 1e-6), "acosh": (1e-6, 1e-6)}
_BINARY = {  # name: (x, y)
    "add": (F(3, 4), F(3, 4)), "subtract": (F(3, 4), F(1, 4)),
    "multiply": (F(3, 4), F(3, 1)), "divide": (F(3, 4), nonzero_f(3, 4)),
    "floor_divide": (F(3, 4, lo=-9, hi=9), nonzero_f(3, 4)),
    "mod": (F(3, 4, lo=-9, hi=9), nonzero_f(3, 4)),
    "remainder": (I(3, 4, lo=-9, hi=9), I(3, 4, lo=1, hi=5)),
    "floor_mod": (F(3, 4, lo=-9, hi=9), nonzero_f(3, 4)),
    "pow": (F(3, 4, lo=0.1, hi=3), F(3, 4)), "maximum": (F(3, 4), F(3, 4)),
    "minimum": (F(3, 4), F(3, 4)), "fmax": (F(3, 4), F(3, 4)),
    "fmin": (F(3, 4), F(3, 4)), "atan2": (F(3, 4), F(3, 4)),
    "hypot": (F(3, 4), F(3, 4)), "logaddexp": (F(3, 4), F(3, 4)),
    "heaviside": (F(3, 4), F(3, 4)), "copysign": (F(3, 4), F(3, 4)),
    "nextafter": (F(3, 4), F(3, 4)),
    "gcd": (I(3, 4, lo=1, hi=40), I(3, 4, lo=1, hi=40)),
    "lcm": (I(3, 4, lo=1, hi=20), I(3, 4, lo=1, hi=20)),
    "inner": (F(3, 4), F(2, 4)), "outer": (F(3), F(4)),
    "kron": (F(2, 2), F(2, 3)), "divide_no_nan": (F(3, 4), I(3, 4, hi=2)),
}
MATH = (
    [(n, args(m), {}, _UNARY_TOL.get(n)) for n, m in _UNARY.items()]
    + [(n, args(x, y), {}, None) for n, (x, y) in _BINARY.items()]
    + [
        ("add", args(F(3, 4), 2.0), {}, None),
        ("divide", args(I(3, 4), I(3, 4, lo=1, hi=5)), {}, None),
        ("matmul", args(F(4, 5), F(5, 3)), {}, None),
        ("matmul", args(F(2, 5, 4), F(2, 3, 5)),
         {"transpose_x": True, "transpose_y": True}, None),
        ("mm", args(F(3, 4), F(4, 2)), {}, None),
        ("bmm", args(F(2, 3, 4), F(2, 4, 5)), {}, None),
        ("dot", args(F(3, 4), F(3, 4)), {}, None),
        ("addmm", args(F(3, 2), F(3, 4), F(4, 2)),
         {"beta": 0.5, "alpha": 2.0}, None),
        ("lerp", args(F(3, 4), F(3, 4), 0.3), {}, None),
        ("multiplex", args([F(3, 4)(np.random.RandomState(1)),
                            F(3, 4)(np.random.RandomState(2))],
                           I(3, 1, hi=2)), {}, None),
        ("mv", args(F(3, 4), F(4)), {}, None),
        ("inverse", lambda rs: [(np.eye(3) * 4 + rs.uniform(-1, 1, (3, 3)))
                                .astype(np.float32)], {}, (1e-5, 1e-6)),
        ("cross", args(F(4, 3), F(4, 3)), {}, None),
        ("trace", args(F(4, 5)), {"offset": 1}, None),
        ("diagonal", args(F(2, 3, 4)), {"axis1": 1, "axis2": 2}, None),
        ("diff", args(F(3, 5)), {"axis": 1}, None),
        ("diff", args(F(5)), {"n": 2}, None),
        ("histogram", args(F(50)), {"bins": 7}, None),
        ("histogram", args(F(40)), {"bins": 4, "min": -1, "max": 1}, None),
        ("bincount", args(I(20, hi=6)), {"minlength": 8}, None),
        ("take", args(F(3, 4), I(5, hi=12)), {}, None),
        ("take", args(F(3, 4), I(5, lo=-20, hi=20)), {"mode": "wrap"}, None),
        ("clip_by_norm", args(F(3, 4), 1.0), {}, None),
        ("reduce_as", args(F(2, 3, 4), F(3, 1)), {}, None),
        ("renorm", args(F(3, 4), 2.0, 0, 1.0), {}, None),
        ("squared_l2_norm", args(F(3, 4)), {}, None),
        ("l1_norm", args(F(3, 4)), {}, None),
        ("scale", args(F(3, 4)), {"scale": 2.0, "bias": 0.5}, None),
        ("scale", args(F(3, 4)), {"scale": 2.0, "bias": 0.5,
                                  "bias_after_scale": False}, None),
        ("increment", args(F(1)), {"value": 3.0}, None),
        ("clip", args(F(3, 4)), {"min": -0.5, "max": 0.7}, None),
        ("nan_to_num", lambda rs: [np.array([np.nan, np.inf, -np.inf, 1.0],
                                            np.float32)], {"nan": 2.0}, None),
        ("sum", args(F(3, 4)), {}, None),
        ("sum", args(F(2, 3, 4)), {"axis": [0, 2], "keepdim": True}, None),
        ("sum", args(I(3, 4)), {"axis": 1}, None),
        ("mean", args(F(3, 4)), {"axis": 0}, None),
        ("max", args(F(3, 4)), {"axis": 1, "keepdim": True}, None),
        ("min", args(F(3, 4)), {}, None),
        ("amax", args(F(3, 4)), {"axis": 0}, None),
        ("amin", args(F(3, 4)), {"axis": [0, 1]}, None),
        ("prod", args(F(3, 4)), {"axis": 1}, None),
        ("prod", args(F(2, 3)), {}, None),
        ("logsumexp", args(F(3, 4)), {"axis": 1}, None),
        ("logsumexp", args(F(3, 4)), {}, None),
        ("nansum", lambda rs: [np.array([1.0, np.nan, 2.5], np.float32)],
         {}, None),
        ("nanmean", lambda rs: [np.array([[1.0, np.nan], [2.5, 3.0]],
                                         np.float32)], {"axis": 1}, None),
        ("count_nonzero", args(I(3, 4, hi=3)), {"axis": 1}, None),
        ("cumsum", args(F(3, 4)), {"axis": 1}, None),
        ("cumsum", args(F(3, 4)), {}, None),
        ("cumprod", args(F(3, 4)), {"dim": 0}, None),
        ("cummax", args(I(3, 6, hi=4)), {"axis": 1}, None),
        ("cummin", args(F(3, 4)), {"axis": 0}, None),
        ("logcumsumexp", args(F(3, 4)), {"axis": 1}, None),
        ("all", args(B(3, 4)), {"axis": 1}, None),
        ("any", args(B(3, 4)), {}, None),
        ("assign", args(F(3)), {}, None),
        ("builtins_max", args(3, 7), {}, None),
    ]
    + [(n, args(m, *rest), kw, None) for n, m, rest, kw in (
        ("add_", F(3, 4), [F(3, 4)], {}),
        ("subtract_", F(3, 4), [F(3, 4)], {}),
        ("multiply_", F(3, 4), [F(3, 4)], {}),
        ("divide_", F(3, 4), [nonzero_f(3, 4)], {}),
        ("clip_", F(3, 4), [], {"min": -1.0, "max": 1.0}),
        ("scale_", F(3, 4), [], {"scale": 3.0}),
        ("exp_", F(3, 4), [], {}), ("sqrt_", F(3, 4, lo=0), [], {}),
        ("tanh_", F(3, 4), [], {}), ("floor_", F(3, 4), [], {}),
        ("ceil_", F(3, 4), [], {}), ("round_", F(3, 4), [], {}),
        ("neg_", F(3, 4), [], {}), ("abs_", F(3, 4), [], {}),
        ("sin_", F(3, 4), [], {}), ("cos_", F(3, 4), [], {}),
        ("rsqrt_", F(3, 4, lo=0.1), [], {}))]
)


@pytest.mark.parametrize("case", MATH, ids=lambda c: c[0])
def test_math_matches_jax(case):
    name, make, kwargs, tol = case
    _run(name, make, kwargs, tol)


# ------------------------------------------------------------ manipulation
def _perm4(rs):
    return rs.permutation(4).astype(np.int64)


MANIPULATION = [
    ("cast", args(F(3, 4), "int32"), {}, None),
    ("cast", args(I(3), "float32"), {}, None),
    ("reshape", args(F(3, 4), [2, -1]), {}, None),
    ("reshape_", args(F(3, 4), [6, 2]), {}, None),
    ("view", args(F(3, 4), [4, 3]), {}, None),
    ("transpose", args(F(2, 3, 4), [2, 0, 1]), {}, None),
    ("moveaxis", args(F(2, 3, 4), 0, 2), {}, None),
    ("swapaxes", args(F(2, 3, 4), 0, 2), {}, None),
    ("swapdims", args(F(2, 3, 4), 1, 2), {}, None),
    ("concat", args([F(2, 3)(np.random.RandomState(1)),
                     F(4, 3)(np.random.RandomState(2))]), {}, None),
    ("concat", args([F(2, 3)(np.random.RandomState(1)),
                     F(2, 1)(np.random.RandomState(2))], 1), {}, None),
    ("stack", args([F(2, 3)(np.random.RandomState(1)),
                    F(2, 3)(np.random.RandomState(2))], 1), {}, None),
    ("split", args(F(6, 4), 3), {}, None),
    ("split", args(F(6, 4), [1, -1, 2]), {"axis": 0}, None),
    ("split", args(F(2, 6), [2, 4], 1), {}, None),
    ("chunk", args(F(6, 4), 2, 0), {}, None),
    ("unbind", args(F(3, 4)), {"axis": 1}, None),
    ("squeeze", args(F(1, 3, 1, 4)), {}, None),
    ("squeeze", args(F(1, 3, 1, 4)), {"axis": [0, 1]}, None),
    ("squeeze_", args(F(3, 1)), {"axis": 1}, None),
    ("unsqueeze", args(F(3, 4), [0, -1]), {}, None),
    ("unsqueeze_", args(F(3, 4), 1), {}, None),
    ("flatten", args(F(2, 3, 4)), {"start_axis": 1}, None),
    ("flatten", args(F(2, 3, 4, 5)), {"start_axis": 1, "stop_axis": 2},
     None),
    ("expand", args(F(1, 4), [3, -1]), {}, None),
    ("broadcast_to", args(F(3, 1), [3, 5]), {}, None),
    ("expand_as", args(F(1, 4), F(3, 4)), {}, None),
    ("broadcast_shape", args([3, 1], [1, 4]), {}, None),
    ("broadcast_tensors", args([F(3, 1)(np.random.RandomState(1)),
                                F(1, 4)(np.random.RandomState(2))]), {},
     None),
    ("tile", args(F(2, 3), [2, 1, 2]), {}, None),
    ("roll", args(F(3, 4), 2), {}, None),
    ("roll", args(F(3, 4), [1, -1], [0, 1]), {}, None),
    ("flip", args(F(3, 4), [0, 1]), {}, None),
    ("rot90", args(F(3, 4)), {"k": 3}, None),
    ("gather", args(F(5, 3), I(4, hi=5)), {}, None),
    ("gather", args(F(3, 5), I(2, hi=5)), {"axis": 1}, None),
    ("gather_nd", args(F(3, 4, 2), I(5, 2, hi=3)), {}, None),
    ("scatter", args(F(5, 3), _perm4, F(4, 3)), {}, None),
    ("scatter", args(F(5, 3), I(4, hi=5), F(4, 3)), {"overwrite": False},
     None),
    ("scatter_", args(F(5, 3), _perm4, F(4, 3)), {}, None),
    ("scatter_nd_add", args(F(4, 3), I(6, 1, hi=4), F(6, 3)), {}, None),
    ("scatter_nd", args(I(5, 1, hi=4), F(5, 2), [4, 2]), {}, None),
    ("index_select", args(F(5, 3), I(4, hi=5)), {}, None),
    ("index_select", args(F(3, 5), I(2, hi=5)), {"axis": 1}, None),
    ("index_sample", args(F(3, 6), I(3, 4, hi=6)), {}, None),
    ("index_add", args(F(5, 3), I(4, hi=5), 0, F(4, 3)), {}, None),
    ("index_put", args(F(4, 3), (np.array([0, 2]), np.array([1, 2])),
                       F(2)), {}, None),
    ("index_put", args(F(4, 3), (np.array([0, 0]), np.array([1, 1])),
                       F(2)), {"accumulate": True}, None),
    ("index_fill", args(F(4, 3), I(2, hi=3), 1, 9.0), {}, None),
    ("masked_select", args(F(3, 4), B(3, 4)), {}, None),
    ("masked_fill", args(F(3, 4), B(3, 4), 5.0), {}, None),
    ("masked_scatter", args(F(3, 4), B(3, 4), F(12)), {}, None),
    ("where", args(B(3, 4), F(3, 4), F(3, 4)), {}, None),
    ("where", args(B(3, 4)), {}, None),
    ("take_along_axis", args(F(3, 5), I(3, 2, hi=5), 1), {}, None),
    ("put_along_axis", args(F(3, 5), I(3, 1, hi=5), F(3, 1), 1), {}, None),
    ("put_along_axis", args(F(3, 5), I(3, 2, hi=5), F(3, 2), 1),
     {"reduce": "add"}, None),
    ("repeat_interleave", args(F(3, 2), 2), {"axis": 0}, None),
    ("repeat_interleave", args(F(3), 3), {}, None),
    ("unique", args(I(12, hi=5)), {}, None),
    ("unique", args(I(12, hi=5)), {"return_index": True,
                                   "return_inverse": True,
                                   "return_counts": True}, None),
    ("unique_consecutive", args(I(12, hi=3)), {"return_inverse": True,
                                               "return_counts": True}, None),
    ("pad", args(F(2, 3), [1, 2, 0, 1]), {"value": 0.5}, None),
    ("pad", args(F(1, 2, 4, 5), [1, 2]), {"mode": "reflect"}, None),
    ("pad", args(F(1, 2, 4, 5), [1, 1, 2, 0]), {"mode": "replicate"}, None),
    ("pad", args(F(1, 2, 4, 5), [2, 1]), {"mode": "circular"}, None),
    ("shard_index", args(I(8, hi=20), 20, 2, 1), {}, None),
    ("numel", args(F(3, 4)), {}, None),
    ("as_complex", args(F(3, 2)), {}, None),
    ("as_real", lambda rs: [(rs.randn(3) + 1j * rs.randn(3))
                            .astype(np.complex64)], {}, None),
    ("tensordot", args(F(2, 3, 4), F(3, 4, 5)), {}, None),
    ("tensordot", args(F(2, 3), F(3, 4)), {"axes": 1}, None),
    ("tolist", args(I(2, 3)), {}, None),
    ("crop", args(F(4, 5), [2, 3], [1, 1]), {}, None),
    ("crop", args(F(4, 5), [-1, 2]), {}, None),
    ("slice", args(F(4, 5, 6), [0, 2], [1, 2], [3, 5]), {}, None),
    ("strided_slice", args(F(4, 6), [0, 1], [0, 5], [4, 0], [2, -2]), {},
     None),
    ("assign", args(F(2, 2)), {}, None),
    ("fill", args(F(2, 3), 4.0), {}, None),
    ("fill_", args(F(2, 3), 4.0), {}, None),
    ("fill_diagonal", args(F(3, 4), 7.0), {"offset": 1}, None),
    ("fill_diagonal_tensor", args(F(3, 4), F(3)), {}, None),
    ("fill_diagonal_tensor", args(F(4, 3), F(3)), {"offset": -1}, None),
    ("unstack", args(F(3, 4)), {"axis": 1}, None),
    ("reverse", args(F(3, 4), [1]), {}, None),
    ("as_strided", args(F(4, 4), [3, 2], [4, 1]), {"offset": 1}, None),
    ("unfold_axis", args(F(2, 7), 1, 3, 2), {}, None),
    ("view_dtype", args(F(2, 4), "int32"), {}, None),
    ("view_shape", args(F(3, 4), [2, 6]), {}, None),
    ("view_slice", args(F(5, 2), 1, 4), {}, None),
    ("set_value", args(F(2, 3), F(3)), {}, None),
    ("coalesce_tensor", args([F(2, 3)(np.random.RandomState(1)),
                              F(4)(np.random.RandomState(2))]), {}, None),
    ("sequence_mask", args(I(4, lo=1, hi=6)), {"maxlen": 7}, None),
    ("builtins_sum", args([1, 2, 3]), {}, None),
]


def _getitem_cases():
    from paddle_tpu.ops import manipulation as jm
    from paddle_tpu_torch.ops import manipulation as tm
    rs = np.random.RandomState(0)
    x = rs.uniform(-2, 2, (4, 5, 3)).astype(np.float32)
    for idx in ((1,), (slice(1, 3), 2), (Ellipsis, 0),
                (np.array([0, 2, 3]),), (x[..., 0] > 0,)):
        want = jm.getitem(P.to_tensor(x), tuple(
            P.to_tensor(i) if isinstance(i, np.ndarray) else i for i in idx))
        got = tm.getitem(T.to_tensor(x), tuple(
            T.to_tensor(i) if isinstance(i, np.ndarray) else i for i in idx))
        _compare(_host(got, False), _host(want, True), None, f"getitem {idx}")
    want, got = P.to_tensor(x), T.to_tensor(x)
    jm.setitem_(want, (slice(0, 2), 1), P.to_tensor(np.ones(3, np.float32)))
    tm.setitem_(got, (slice(0, 2), 1), T.to_tensor(np.ones(3, np.float32)))
    _compare(_host(got, False), _host(want, True), None, "setitem_")


@pytest.mark.parametrize("case", MANIPULATION, ids=lambda c: c[0])
def test_manipulation_matches_jax(case):
    name, make, kwargs, tol = case
    _run(name, make, kwargs, tol)


def test_getitem_and_setitem_match_jax():
    _getitem_cases()


# ------------------------------------------------------------ logic
LOGIC = (
    [(n, args(I(3, 4, hi=4), I(3, 4, hi=4)), {}, None) for n in (
        "equal", "not_equal", "greater_than", "greater_equal", "less_than",
        "less_equal", "bitwise_and", "bitwise_or", "bitwise_xor")]
    + [(n, args(B(3, 4), B(3, 4)), {}, None) for n in (
        "logical_and", "logical_or", "logical_xor")]
    + [
        ("equal", args(F(3), 0.5), {}, None),
        ("bitwise_left_shift", args(I(5, hi=9), I(5, hi=4)), {}, None),
        ("bitwise_right_shift", args(I(5, hi=99), I(5, hi=4)), {}, None),
        ("logical_not", args(B(3, 4)), {}, None),
        ("bitwise_not", args(I(3, 4)), {}, None),
        ("equal_all", args(I(3, hi=2), I(3, hi=2)), {}, None),
        ("equal_all", lambda rs: [np.arange(3), np.arange(3)], {}, None),
        ("allclose", lambda rs: [np.ones(3, np.float32),
                                 np.ones(3, np.float32) + 1e-7], {}, None),
        ("allclose", args(F(3), F(3)), {}, None),
        ("isclose", lambda rs: [np.array([1.0, 2.0, np.nan], np.float32),
                                np.array([1.0, 2.1, np.nan], np.float32)],
         {"equal_nan": True}, None),
        ("is_empty", args(F(0, 3)), {}, None),
        ("is_empty", args(F(2)), {}, None),
        ("is_tensor", args(F(2)), {}, None),
        ("is_tensor", args(3), {}, None),
        ("isin", args(I(6, hi=8), I(3, hi=8)), {}, None),
        ("isin", args(I(6, hi=8), I(3, hi=8)), {"invert": True}, None),
        ("in1d", args(I(6, hi=8), I(3, hi=8)), {}, None),
        ("check_numerics", args(F(3)), {}, None),
    ]
)


@pytest.mark.parametrize("case", LOGIC, ids=lambda c: c[0])
def test_logic_matches_jax(case):
    name, make, kwargs, tol = case
    _run(name, make, kwargs, tol)


def test_check_numerics_raises_on_nan():
    bad = T.to_tensor(np.array([1.0, np.nan], np.float32))
    with pytest.raises(ValueError, match="NaN/Inf"):
        T.tensor.check_numerics(bad)


# ------------------------------------------------------------ search
def _distinct(*shape):
    """Distinct values (no ties: the sorts' tie orders are the device's)."""
    n = int(np.prod(shape))
    return lambda rs: (rs.permutation(n).reshape(shape) * 0.25 - 1).astype(
        np.float32)


SEARCH = [
    ("argmax", args(F(3, 4)), {}, None),
    ("argmax", args(F(3, 4)), {"axis": 1, "keepdim": True}, None),
    ("argmin", args(F(3, 4)), {"axis": 0}, None),
    ("argmin", args(F(3, 4)), {"keepdim": True}, None),
    ("argsort", args(_distinct(3, 5)), {}, None),
    ("argsort", args(I(3, 6, hi=3)), {"axis": 1, "stable": True}, None),
    ("argsort", args(_distinct(4, 3)), {"axis": 0, "descending": True},
     None),
    ("sort", args(F(3, 5)), {}, None),
    ("sort", args(F(3, 5)), {"axis": 0, "descending": True}, None),
    ("topk", args(_distinct(3, 6), 2), {}, None),
    ("topk", args(I(3, 6, hi=3), 3), {"axis": 1}, None),
    ("topk", args(_distinct(5, 3), 2), {"axis": 0, "largest": False}, None),
    ("kthvalue", args(_distinct(3, 6), 2), {}, None),
    ("kthvalue", args(_distinct(4, 3), 3), {"axis": 0, "keepdim": True},
     None),
    ("mode", args(I(3, 8, hi=3)), {}, None),
    ("nonzero", args(I(3, 4, hi=2)), {}, None),
    ("nonzero", args(I(3, 4, hi=2)), {"as_tuple": True}, None),
    ("searchsorted", lambda rs: [np.sort(rs.uniform(0, 1, 8)).astype(
        np.float32), rs.uniform(0, 1, 5).astype(np.float32)], {}, None),
    ("searchsorted", lambda rs: [np.array([1, 3, 3, 5]), np.array([3, 4])],
     {"right": True}, None),
    ("searchsorted", lambda rs: [np.sort(rs.uniform(0, 1, (2, 6)), 1)
                                 .astype(np.float32),
                                 rs.uniform(0, 1, (2, 3)).astype(np.float32)],
     {}, None),
    ("bucketize", lambda rs: [rs.uniform(0, 1, 5).astype(np.float32),
                              np.linspace(0, 1, 6).astype(np.float32)], {},
     None),
    ("index_sample", args(F(3, 5), I(3, 2, hi=5)), {}, None),
    ("masked_fill", args(F(3, 4), B(3, 4), -1.0), {}, None),
    ("where", args(B(3, 4), F(3, 4), 0.0), {}, None),
]


@pytest.mark.parametrize("case", SEARCH, ids=lambda c: c[0])
def test_search_matches_jax(case):
    name, make, kwargs, tol = case
    fn = _module_fn("search", name) if name in (
        "index_sample", "masked_fill", "where") else None
    _run(name, make, kwargs, tol, fn=fn)


# ------------------------------------------------------------ stat
STAT = [
    ("mean", args(F(3, 4)), {"axis": 1}, None),
    ("std", args(F(3, 4)), {}, None),
    ("std", args(F(3, 4)), {"axis": 1, "unbiased": False, "keepdim": True},
     None),
    ("var", args(F(3, 4)), {"axis": 0}, None),
    ("median", args(F(3, 5)), {}, None),
    ("median", args(F(3, 4)), {"axis": 1}, None),
    ("median", args(F(3, 4)), {"axis": 1, "mode": "min", "keepdim": True},
     None),
    ("nanmedian", lambda rs: [np.array([[1.0, np.nan, 3.0, 4.0],
                                        [2.0, 5.0, np.nan, 1.0]],
                                       np.float32)], {"axis": 1}, None),
    ("quantile", args(F(3, 5), 0.3), {}, None),
    ("quantile", args(F(3, 5), [0.25, 0.75]), {"axis": 1}, None),
    ("quantile", args(F(3, 5), 0.6), {"axis": 0, "keepdim": True,
                                      "interpolation": "nearest"}, None),
    ("nanquantile", lambda rs: [np.array([1.0, np.nan, 3.0, 2.0],
                                         np.float32), 0.5], {}, None),
]


@pytest.mark.parametrize("case", STAT, ids=lambda c: c[0])
def test_stat_matches_jax(case):
    name, make, kwargs, tol = case
    fn = _module_fn("stat", name) if name == "mean" else None
    _run(name, make, kwargs, tol, fn=fn)


# ------------------------------------------------------------ AMP classes
_AMP_OPS = {
    "add": lambda m, x: m.add(x, x), "divide": lambda m, x: m.divide(x, x),
    "abs": lambda m, x: m.abs(x), "sqrt": lambda m, x: m.sqrt(x),
    "tanh": lambda m, x: m.tanh(x), "clip": lambda m, x: m.clip(x, 0.1, 0.5),
    "max": lambda m, x: m.max(x), "sort": lambda m, x: m.sort(x),
    "concat": lambda m, x: m.concat([x, x]),
    "reshape": lambda m, x: m.reshape(x, [4, 3]),
    "where": lambda m, x: m.where(x > 0.5, x, x),
    "exp": lambda m, x: m.exp(x), "log": lambda m, x: m.log(x),
    "square": lambda m, x: m.square(x), "pow": lambda m, x: m.pow(x, 2.0),
    "sum": lambda m, x: m.sum(x), "mean": lambda m, x: m.mean(x),
    "prod": lambda m, x: m.prod(x), "logsumexp": lambda m, x: m.logsumexp(x),
    "cumsum": lambda m, x: m.cumsum(x, 1), "std": lambda m, x: m.std(x),
    "matmul": lambda m, x: m.matmul(x, m.transpose(x, [1, 0])),
    "addmm": lambda m, x: m.addmm(m.ones([3, 3]), x, m.transpose(x, [1, 0])),
}


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("name", sorted(_AMP_OPS))
def test_amp_classes_match_jax(name, level):
    """Under ``auto_cast`` (bf16) each op computes in the dtype JAX's does:
    gray ops in the inputs' dtype at O1 and bf16 at O2, black ones in f32,
    white ones in bf16."""
    a = np.random.RandomState(0).uniform(0.1, 1, (3, 4)).astype(np.float32)
    fn = _AMP_OPS[name]
    with P.amp.auto_cast(level=level, dtype="bfloat16"):
        want = fn(P, P.to_tensor(a))
    with T.amp.auto_cast(level=level, dtype="bfloat16"):
        got = fn(T, T.to_tensor(a))
    from paddle_tpu_torch.base.dtype import dtype_name
    assert dtype_name(got.dtype) == want.dtype.name
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.numpy(), np.float32),
                               rtol=2 ** -7, atol=1e-6)


# ------------------------------------------------------------ coverage
JAX_OPS = ("creation", "math", "manipulation", "logic", "search", "stat",
           "random")


def _jax_top_level_from(module):
    """The names the JAX top level exports from ``paddle_tpu.ops.module``:
    the functions it defines that the top level holds."""
    import importlib
    import inspect

    mod = importlib.import_module(f"paddle_tpu.ops.{module}")
    return sorted(n for n in dir(P) if not n.startswith("_")
                  and inspect.isfunction(getattr(P, n))
                  and getattr(P, n) is getattr(mod, n, None)
                  and getattr(P, n).__module__ == mod.__name__)


MODULE_OF = {**{c[0]: "creation" for c in CREATION},
             **{c[0]: "math" for c in MATH},
             **{c[0]: "manipulation" for c in MANIPULATION},
             **{c[0]: "logic" for c in LOGIC}}
TESTED = ({c[0] for c in CREATION + MATH + MANIPULATION + LOGIC + SEARCH
           + STAT} | {"getitem", "setitem_"})


@pytest.mark.parametrize("module", JAX_OPS)
def test_every_jax_export_is_ported_and_held_to_jax(module):
    names = _jax_top_level_from(module)
    assert names
    for name in names:
        assert callable(getattr(T, name)), name
        if module != "random":
            assert name in TESTED, f"{module}.{name} has no parity case"
        else:
            assert name in RANDOM_TESTED, f"random.{name} has no case"


# ------------------------------------------------------------ random
RANDOM = [  # name, args, kwargs, (lo, hi) bounds or None, mean, var
    ("rand", ([4000],), {}, (0.0, 1.0), 0.5, 1 / 12),
    ("randn", ([4000],), {}, None, 0.0, 1.0),
    ("standard_normal", ([4000],), {}, None, 0.0, 1.0),
    ("normal", (), {"mean": 1.0, "std": 2.0, "shape": [4000]}, None, 1.0, 4.0),
    ("gaussian", ([4000],), {"mean": -1.0, "std": 0.5}, None, -1.0, 0.25),
    ("uniform", ([4000],), {"min": 2.0, "max": 4.0}, (2.0, 4.0), 3.0, 1 / 3),
    ("randint", (0, 10, [4000]), {}, (0, 9), 4.5, 8.25),
    ("randperm", (50,), {}, (0, 49), 24.5, None),
    ("truncated_normal", ([4000],), {"a": -1.0, "b": 1.0}, (-1.0, 1.0), 0.0,
     None),
]
RANDOM_TESTED = {c[0] for c in RANDOM} | {
    "randint_like", "bernoulli", "multinomial", "poisson", "binomial",
    "uniform_", "normal_", "exponential_", "cauchy_", "geometric_",
    "log_normal_", "bernoulli_", "shuffle", "standard_gamma", "dirichlet"}


@pytest.mark.parametrize("case", RANDOM, ids=lambda c: c[0])
def test_random_draws_match_jax_in_law(case):
    """Shape and dtype as JAX's; within the bounds; mean and variance
    within 5 standard errors of the law's; one seed repeats the draw."""
    name, a, kw, bounds, mean, var = case
    from paddle_tpu.ops import random as jax_random
    want = getattr(jax_random, name)(*a, **kw).numpy()
    T.seed(11)
    got = getattr(T, name)(*a, **kw)
    T.seed(11)
    again = getattr(T, name)(*a, **kw)
    assert torch.equal(got, again)
    got = got.numpy()
    assert got.shape == want.shape and _narrowed(got.dtype, want.dtype)
    if bounds is not None:
        assert got.min() >= bounds[0] and got.max() <= bounds[1]
    n = got.size
    if mean is not None and var is not None:
        assert abs(got.mean() - mean) < 5 * np.sqrt(var / n)
        assert abs(got.var() - var) < 0.1 * var
    if name == "randperm":
        assert sorted(got.tolist()) == list(range(50))


def test_random_like_and_in_place_draws():
    T.seed(3)
    x = T.zeros([2000])
    assert T.randint_like(x, 0, 5).numpy().max() <= 4
    p = T.full([2000], 0.3)
    b = T.bernoulli(p).numpy()
    assert set(np.unique(b)) <= {0.0, 1.0} and abs(b.mean() - 0.3) < 0.05
    rows = T.multinomial(T.to_tensor([[0.0, 1.0, 0.0]]), 4, replacement=True)
    assert rows.numpy().tolist() == [[1, 1, 1, 1]]
    lam = T.full([2000], 4.0)
    assert abs(T.poisson(lam).numpy().mean() - 4.0) < 0.3
    c = T.binomial(T.full([2000], 10.0), T.full([2000], 0.5)).numpy()
    assert c.dtype == np.int64 and abs(c.mean() - 5) < 0.3
    for name, kw, check in (
            ("uniform_", {"min": 0.0, "max": 2.0},
             lambda v: v.min() >= 0 and v.max() <= 2),
            ("normal_", {"mean": 3.0, "std": 0.1},
             lambda v: abs(v.mean() - 3) < 0.05),
            ("exponential_", {"lam": 2.0},
             lambda v: v.min() >= 0 and abs(v.mean() - 0.5) < 0.05),
            ("cauchy_", {}, lambda v: np.isfinite(v).all()),
            ("geometric_", {"probs": 0.5},
             lambda v: v.min() >= 1 and abs(v.mean() - 2) < 0.2),
            ("log_normal_", {"mean": 0.0, "std": 0.25},
             lambda v: v.min() > 0),
            ("bernoulli_", {"p": 0.2}, lambda v: abs(v.mean() - 0.2) < 0.05)):
        t = T.zeros([2000])
        out = getattr(T, name)(t, **kw)
        assert out is t and check(t.numpy()), name
    perm = T.shuffle(T.arange(20)).numpy()
    assert sorted(perm.tolist()) == list(range(20))
    g = T.standard_gamma(T.full([2000], 2.0)).numpy()
    assert abs(g.mean() - 2.0) < 0.2
    d = T.dirichlet(T.full([5, 3], 1.0)).numpy()
    np.testing.assert_allclose(d.sum(-1), 1.0, rtol=1e-5)


# ------------------------------------------------------------ dtypes
@pytest.mark.parametrize("name", ["bool", "uint8", "int8", "int16", "int32",
                                  "int64", "float16", "bfloat16", "float32",
                                  "float64", "complex64", "complex128"])
def test_dtypes_are_torch_dtypes(name):
    want = getattr(torch, name)
    assert getattr(T, name) is want
    from paddle_tpu_torch.base import dtype as d
    for spelling in (name, "paddle." + name, getattr(P, name)):
        got = d.convert_dtype(spelling if not hasattr(spelling, "name")
                              else spelling.name)
        assert got is want
    if name != "bfloat16":
        assert d.convert_dtype(np.dtype(name if name != "bool" else
                                        np.bool_)) is want
    assert d.dtype_name(want) == name


@pytest.mark.parametrize("name", ["float16", "bfloat16", "float32"])
def test_finfo_matches_jax(name):
    got, want = T.finfo(name), P.finfo(name)
    for field in ("bits", "eps", "max", "min", "tiny"):
        assert float(getattr(got, field)) == float(getattr(want, field)), \
            field


@pytest.mark.parametrize("name", ["uint8", "int8", "int16", "int32"])
def test_iinfo_matches_jax(name):
    got, want = T.iinfo(name), P.iinfo(name)
    assert (got.bits, got.min, got.max) == (want.bits, want.min, want.max)


def test_default_dtype_and_grad_mode_match_jax():
    assert T.get_default_dtype() == P.get_default_dtype() == "float32"
    T.set_default_dtype("float64")
    try:
        assert T.get_default_dtype() == "float64"
        assert T.to_tensor([1.0]).dtype == torch.float64
        assert T.zeros([2]).dtype == torch.float64
    finally:
        T.set_default_dtype("float32")
    with pytest.raises(TypeError):
        T.set_default_dtype("int32")
    assert T.is_grad_enabled() and P.is_grad_enabled()
    with T.no_grad(), P.no_grad():
        assert not T.is_grad_enabled() and not P.is_grad_enabled()
        with T.enable_grad(), P.enable_grad():
            assert T.is_grad_enabled() and P.is_grad_enabled()
    T.set_grad_enabled(False)
    try:
        assert not T.is_grad_enabled()
    finally:
        T.set_grad_enabled(True)
    with T.set_grad_enabled(False):
        assert not T.is_grad_enabled()
    assert T.is_grad_enabled()
    assert T.in_dynamic_mode() and T.in_dygraph_mode()


# ------------------------------------------------------------ seed and build
def test_seed_then_a_build_gives_the_default_weights_and_a_second_differs():
    from paddle_tpu_torch.models import gpt

    cfg = gpt.gpt_tiny()
    want = gpt.GPTForCausalLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    T.seed(0)
    first = gpt.GPTForCausalLM(cfg, device="cpu")
    second = gpt.GPTForCausalLM(cfg, device="cpu")
    pairs = list(zip(want.parameters(), first.parameters(),
                     second.parameters()))
    assert all(torch.equal(a, b) for a, b, _ in pairs)
    assert any(not torch.equal(a, c) for a, _, c in pairs)
    T.seed(0)
    again = gpt.GPTForCausalLM(cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(want.parameters(),
                                                 again.parameters()))
    # the vision models draw from the same generator
    from paddle_tpu_torch.vision.models import resnet18
    T.seed(5)
    r1 = resnet18(num_classes=4, device="cpu")
    r2 = resnet18(num_classes=4, device="cpu",
                  generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a, b) for a, b in zip(r1.parameters(),
                                                 r2.parameters()))
    # and the random ops from torch's
    T.seed(9)
    a = T.rand([5])
    T.seed(9)
    assert torch.equal(a, T.rand([5]))


# ------------------------------------------------------------ device
def test_set_device_cpu_and_the_names_it_refuses():
    assert T.get_device() == "cpu"
    assert T.to_tensor([1.0]).place == "cpu"
    assert T.zeros([1]).device.type == "cpu"
    for bad in ("tpu", "tpu:0", "xpu", "gpu:x", "meta", "cuda:a"):
        with pytest.raises(ValueError):
            T.set_device(bad)
    assert T.get_device() == "cpu"
    assert T.CPUPlace() == "cpu" and T.CUDAPlace(1) == "gpu:1"
    assert T.device_count() == torch.cuda.device_count()
    T.synchronize()
    assert isinstance(T.is_compiled_with_cuda(), bool)
    if not torch.cuda.is_available():
        for name in ("gpu", "gpu:0", "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                T.set_device(name)
        assert T.get_device() == "cpu"


def test_the_default_is_cuda_until_set_device(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    assert T.get_device() == "gpu:0"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.zeros([1])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.to_tensor([1.0])


# ------------------------------------------------------------ grad
def test_grad_matches_jax():
    rs = np.random.RandomState(0)
    xa = rs.uniform(-1, 1, (3, 4)).astype(np.float32)
    wa = rs.uniform(-1, 1, (4, 2)).astype(np.float32)

    def f(pkg, x, w):
        return pkg.sum(pkg.tanh(pkg.matmul(x, w)) ** 2)

    outs = []
    for pkg in (P, T):
        x = pkg.to_tensor(xa, stop_gradient=False)
        w = pkg.to_tensor(wa, stop_gradient=False)
        y = f(pkg, x, w)
        gx, gw = pkg.grad([y], [x, w], retain_graph=True)
        (gw2,) = pkg.grad(y, w)
        outs.append([g.numpy() for g in (gx, gw, gw2)])
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    x = T.to_tensor(xa, stop_gradient=False)
    z = T.to_tensor(wa, stop_gradient=False)
    y = T.sum(x * 2)
    assert T.grad(y, [x, z], allow_unused=True, retain_graph=True)[1] is None
    with pytest.raises(ValueError):
        T.grad(y, [x, z])
    # create_graph: a second derivative
    x = T.to_tensor(xa, stop_gradient=False)
    (g,) = T.grad(T.sum(x ** 3), x, create_graph=True)
    (gg,) = T.grad(T.sum(g), x)
    np.testing.assert_allclose(gg.numpy(), 6 * xa, rtol=1e-6)
    assert type(g) is T.Tensor


# ------------------------------------------------------------ the rest
def _fresh_jax_top_level() -> list:
    """The public names of ``paddle_tpu`` right after its import, in a
    fresh process (this one's may hold submodules other tests loaded)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import json, paddle_tpu\n"
            "print(json.dumps([n for n in dir(paddle_tpu)"
            " if not n.startswith('_')]))\n")
    env = dict(os.environ, PYTHONPATH=str(root), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_other_jax_top_level_name_raises_naming_the_roadmap():
    skip = {"jax", "jnp", "annotations"}  # the JAX package's own imports
    names = _fresh_jax_top_level()
    assert len(names) > 300
    for name in names:
        if name in skip:
            continue
        try:
            getattr(T, name)
        except NotImplementedError as e:
            assert "ROADMAP.md" in str(e), name
        except AttributeError:
            pytest.fail(f"paddle_tpu_torch.{name} is silently absent")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.primitive
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        T.fft
    # the interception tier's names are ported
    assert T.TensorArray and T.SelectedRows and T.StringTensor
    assert callable(T.enable_static) and callable(T.disable_static)
    assert callable(T.register_op) and callable(T.run_custom_op)
    # the model-authoring names are ported
    assert T.nn.Layer is T.Layer and callable(T.einsum)
    assert T.Parameter and T.autograd.PyLayer and T.linalg.svd
    with pytest.raises(AttributeError):
        T.no_such_name


def test_import_touches_no_cuda_and_loads_no_jax():
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = ("import sys, torch\n"
            "import paddle_tpu_torch as paddle\n"
            "print('CUDA', torch.cuda.is_initialized())\n"
            "print('LOADED', sorted(m for m in sys.modules if m.split('.')[0]"
            " in ('jax', 'jaxlib', 'paddle_tpu', 'ml_dtypes')))\n")
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "CUDA False" in proc.stdout and "LOADED []" in proc.stdout, \
        proc.stdout
