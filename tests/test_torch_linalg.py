"""``paddle.linalg``, the top level's linear algebra and ``einsum`` of the
port against the JAX package's, in f32 and float64 on the same numpy
inputs: every function of ``paddle_tpu/ops/linalg.py`` (the 26 of the top
level, ``vector_norm``, ``matrix_norm``, ``svdvals``, ``pca_lowrank`` and
``t_nd``), ``matmul``'s transposes and ``einsum`` with its operands spread
out or in a list. The JAX package computes float64 inputs in f32 (x64 off),
so both dtypes are held to f32 tolerances: within 1e-4 of the largest
magnitude of the expected output (1e-3 for ``eig``'s, ``pinv``'s and
``lstsq``'s, whose conditioning is worse). The conventions each case pins
down: ``norm``'s ``p``/``axis`` rules, ``lu``'s 1-based int32 pivots,
``eig``'s complex outputs, ``cov``'s ``ddof`` and ``rowvar``, ``lstsq``'s
four outputs, ``slogdet``'s pair, ``matrix_rank``'s threshold.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.ops import linalg as jlinalg
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.ops import linalg as tlinalg


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for each test; the default comes back after."""
    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    yield


def _spd(rs, n):
    a = rs.randn(n, n)
    return a @ a.T + n * np.eye(n)


def _upper(rs, n):
    return np.triu(rs.randn(n, n)) + 3 * np.eye(n)


def _m(rs, *shape):
    return rs.randn(*shape)


# (id, function name, inputs(rs) -> list of arrays, kwargs, tolerance)
CASES = [
    ("t", "t", lambda rs: [_m(rs, 3, 4)], {}, 1e-4),
    ("t_3d", "t", lambda rs: [_m(rs, 2, 3, 4)], {}, 1e-4),
    ("t_nd", "t_nd", lambda rs: [_m(rs, 2, 3, 4)], {}, 1e-4),
    ("norm_all", "norm", lambda rs: [_m(rs, 3, 4)], {}, 1e-4),
    ("norm_fro_axes", "norm", lambda rs: [_m(rs, 2, 3, 4)],
     dict(p="fro", axis=[1, 2]), 1e-4),
    ("norm_2_axis", "norm", lambda rs: [_m(rs, 3, 4)], dict(p=2, axis=1),
     1e-4),
    ("norm_inf_all", "norm", lambda rs: [_m(rs, 3, 4)],
     dict(p=float("inf")), 1e-4),
    ("norm_-inf_axis", "norm", lambda rs: [_m(rs, 3, 4)],
     dict(p=float("-inf"), axis=0), 1e-4),
    ("norm_1_all", "norm", lambda rs: [_m(rs, 3, 4)], dict(p=1), 1e-4),
    ("norm_3_keepdim", "norm", lambda rs: [_m(rs, 3, 4)],
     dict(p=3, axis=1, keepdim=True), 1e-4),
    ("norm_nuc", "norm", lambda rs: [_m(rs, 3, 4)],
     dict(p="nuc", axis=[0, 1]), 1e-4),
    ("norm_matrix_1", "norm", lambda rs: [_m(rs, 3, 4)],
     dict(p=1, axis=[0, 1]), 1e-4),
    ("vector_norm", "vector_norm", lambda rs: [_m(rs, 3, 4)], {}, 1e-4),
    ("vector_norm_1_axis", "vector_norm", lambda rs: [_m(rs, 3, 4)],
     dict(p=1, axis=[1], keepdim=True), 1e-4),
    ("matrix_norm_fro", "matrix_norm", lambda rs: [_m(rs, 2, 3, 4)], {},
     1e-4),
    ("matrix_norm_nuc", "matrix_norm", lambda rs: [_m(rs, 3, 4)],
     dict(p="nuc"), 1e-4),
    ("matrix_norm_2", "matrix_norm", lambda rs: [_m(rs, 3, 4)], dict(p=2),
     1e-4),
    ("dist", "dist", lambda rs: [_m(rs, 3, 4), _m(rs, 3, 4)], {}, 1e-4),
    ("dist_1", "dist", lambda rs: [_m(rs, 3, 4), _m(rs, 4)], dict(p=1),
     1e-4),
    ("cdist", "cdist", lambda rs: [_m(rs, 5, 3), _m(rs, 4, 3)], {}, 1e-4),
    ("cdist_1", "cdist", lambda rs: [_m(rs, 2, 5, 3), _m(rs, 2, 4, 3)],
     dict(p=1.0), 1e-4),
    ("cholesky", "cholesky", lambda rs: [_spd(rs, 4)], {}, 1e-4),
    ("cholesky_upper", "cholesky", lambda rs: [_spd(rs, 4)],
     dict(upper=True), 1e-4),
    ("cholesky_solve", "cholesky_solve",
     lambda rs: [_m(rs, 4, 2), np.linalg.cholesky(_spd(rs, 4))], {}, 1e-4),
    ("qr", "qr", lambda rs: [_m(rs, 5, 3)], {}, 1e-4),
    ("qr_complete", "qr", lambda rs: [_m(rs, 4, 3)], dict(mode="complete"),
     1e-4),
    ("svd", "svd", lambda rs: [_m(rs, 5, 3)], {}, 1e-4),
    ("svdvals", "svdvals", lambda rs: [_m(rs, 2, 5, 3)], {}, 1e-4),
    ("pca_lowrank", "pca_lowrank", lambda rs: [_m(rs, 8, 5)], dict(q=3),
     1e-4),
    ("eig", "eig", lambda rs: [_m(rs, 4, 4)], {}, 1e-3),
    ("eigh", "eigh", lambda rs: [_spd(rs, 4)], {}, 1e-4),
    ("eigh_upper", "eigh", lambda rs: [_spd(rs, 4)], dict(UPLO="U"), 1e-4),
    ("eigvals", "eigvals", lambda rs: [_m(rs, 4, 4)], {}, 1e-3),
    ("eigvalsh", "eigvalsh", lambda rs: [_spd(rs, 4)], {}, 1e-4),
    ("inv", "inv", lambda rs: [_spd(rs, 4)], {}, 1e-4),
    ("pinv", "pinv", lambda rs: [_m(rs, 5, 3)], {}, 1e-3),
    ("solve", "solve", lambda rs: [_spd(rs, 4), _m(rs, 4, 2)], {}, 1e-4),
    ("triangular_solve", "triangular_solve",
     lambda rs: [_upper(rs, 4), _m(rs, 4, 2)], {}, 1e-4),
    ("triangular_solve_lower_t", "triangular_solve",
     lambda rs: [_upper(rs, 4).T, _m(rs, 4, 3)],
     dict(upper=False, transpose=True), 1e-4),
    ("triangular_solve_unit", "triangular_solve",
     lambda rs: [_upper(rs, 4), _m(rs, 4, 1)], dict(unitriangular=True),
     1e-4),
    ("lstsq", "lstsq", lambda rs: [_m(rs, 6, 3), _m(rs, 6, 2)], {}, 1e-3),
    ("det", "det", lambda rs: [_m(rs, 2, 4, 4)], {}, 1e-4),
    ("slogdet", "slogdet", lambda rs: [_m(rs, 4, 4)], {}, 1e-4),
    ("matrix_power", "matrix_power", lambda rs: [_m(rs, 3, 3) * 0.5],
     dict(n=3), 1e-4),
    ("matrix_power_neg", "matrix_power", lambda rs: [_spd(rs, 3)],
     dict(n=-2), 1e-4),
    ("matrix_rank", "matrix_rank",
     lambda rs: [_m(rs, 5, 2) @ _m(rs, 2, 4)], {}, 0.0),
    ("lu", "lu", lambda rs: [_m(rs, 4, 4)], {}, 1e-4),
    ("lu_infos", "lu", lambda rs: [_m(rs, 2, 3, 3)], dict(get_infos=True),
     1e-4),
    ("corrcoef", "corrcoef", lambda rs: [_m(rs, 3, 6)], {}, 1e-4),
    ("corrcoef_cols", "corrcoef", lambda rs: [_m(rs, 6, 3)],
     dict(rowvar=False), 1e-4),
    ("cov", "cov", lambda rs: [_m(rs, 3, 6)], {}, 1e-4),
    ("cov_ddof0_cols", "cov", lambda rs: [_m(rs, 6, 3)],
     dict(rowvar=False, ddof=False), 1e-4),
    ("multi_dot", "multi_dot",
     lambda rs: [[_m(rs, 3, 4), _m(rs, 4, 5), _m(rs, 5, 2)]], {}, 1e-4),
    ("householder_product", "householder_product",
     lambda rs: [_m(rs, 4, 3), rs.rand(3) + 0.5], {}, 1e-4),
    ("matmul_tt", "matmul", lambda rs: [_m(rs, 2, 4, 3), _m(rs, 2, 5, 4)],
     dict(transpose_x=True, transpose_y=True), 1e-4),
]


def _to(pkg, a, dtype):
    if isinstance(a, list):
        return [_to(pkg, v, dtype) for v in a]
    arr = np.asarray(a, dtype)
    return pkg.to_tensor(arr)


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        return x.numpy()
    return np.asarray(x.numpy())


# factorizations whose singular or eigen vectors are each defined up to a
# sign, which two LAPACK paths may choose apart: each 2-d factor's columns
# (U, V, eigenvectors) and rows (Vh) are compared with their signs fixed
# name -> the last factor's rows (svd's Vh) rather than its columns
SIGNED = {"svd": True, "pca_lowrank": False, "eigh": False}


def _signs(outs, rows_last):
    """Each matrix of ``outs`` with the sign of every column (of every row
    for the last factor when ``rows_last``: svd's ``Vh``) made that of its
    largest entry."""
    fixed = []
    for i, m in enumerate(outs):
        m = np.asarray(m, np.float64)
        if m.ndim >= 2:
            ax = -1 if rows_last and i == len(outs) - 1 else -2
            idx = np.abs(m).argmax(axis=ax)
            m = m * np.sign(np.take_along_axis(m, np.expand_dims(idx, ax),
                                               ax))
        fixed.append(m)
    return fixed


def _compare(got, want, tol, name):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), name
        for g, w in zip(got, want):
            _compare(g, w, tol, name)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    scale = max(float(np.abs(w).max()) if w.size else 0.0, 1.0)
    # numpy's eig (JAX's route) returns real arrays when every eigenvalue
    # is real; the port's are complex always, as torch's and Paddle's
    dt = np.result_type(g.dtype, w.dtype)
    err = float(np.abs(g.astype(dt) - w.astype(dt)).max()) if w.size else 0.0
    assert err <= tol * scale, (name, err)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_linalg_matches_jax(case, dtype):
    cid, name, make, kwargs, tol = case
    args = make(np.random.RandomState(len(cid)))
    jfn = getattr(P.linalg, name, None) or getattr(jlinalg, name)
    tfn = getattr(T.linalg, name, None)
    if tfn is None:
        tfn = T.core.tensor.paddle_out(getattr(tlinalg, name))
    want = jfn(*_to(P, args, dtype), **kwargs)
    got = tfn(*_to(T, args, dtype), **kwargs)
    if name in SIGNED:
        _compare(_signs(_host(got), SIGNED[name]),
                 _signs(_host(want), SIGNED[name]), tol, cid)
    elif name == "eig":
        # eigenvectors are defined up to a complex phase, and the order of
        # the eigenvalues is LAPACK's: the values are compared sorted and
        # the port's pairs checked to satisfy A v = w v
        (w, v), (jw, _) = _host(got), _host(want)
        _compare(np.sort_complex(w), np.sort_complex(jw), tol, cid)
        a = np.asarray(args[0], np.complex128)
        _compare(a @ v, v * w[None, :], tol, cid)
    else:
        _compare(_host(got), _host(want), tol, cid)
    outs = got if isinstance(got, (list, tuple)) else [got]
    for out in outs:
        assert isinstance(out, T.Tensor)
    if name in ("eig", "eigvals"):
        assert np.iscomplexobj(_host(outs[0]))
    if name == "lu":
        assert outs[1].dtype == T.int32 and int(outs[1].min()) >= 1


def test_top_level_names_are_the_jax_top_levels():
    for name in ("cdist", "cholesky", "cholesky_solve", "corrcoef", "cov",
                 "det", "dist", "eig", "eigh", "eigvals", "eigvalsh",
                 "householder_product", "inv", "lstsq", "lu",
                 "matrix_power", "matrix_rank", "multi_dot", "norm", "pinv",
                 "qr", "slogdet", "solve", "svd", "t", "triangular_solve",
                 "einsum"):
        assert hasattr(P, name) and callable(getattr(T, name)), name
    x = np.random.RandomState(0).randn(3, 3).astype(np.float32)
    _compare(_host(T.to_tensor(x).inv()), _host(P.to_tensor(x).inv()),
             1e-4, "method inv")
    _compare(_host(T.to_tensor(x).norm()), _host(P.to_tensor(x).norm()),
             1e-4, "method norm")


def test_matrix_rank_threshold_and_pivots_stop_gradient():
    rs = np.random.RandomState(0)
    a = (_m(rs, 5, 2) @ _m(rs, 2, 4)).astype(np.float32)
    assert int(T.linalg.matrix_rank(T.to_tensor(a))) == int(
        P.linalg.matrix_rank(P.to_tensor(a)).numpy()) == 2
    s = np.linalg.svd(a, compute_uv=False)
    assert int(T.linalg.matrix_rank(T.to_tensor(a), tol=float(s[0]) * 0.5)) \
        == int((s > s[0] * 0.5).sum())
    x = T.to_tensor(rs.randn(3, 3).astype(np.float32), stop_gradient=False)
    lu_, piv = T.linalg.lu(x)
    assert piv.stop_gradient and not lu_.stop_gradient


EINSUM = [("ij,jk->ik", [(3, 4), (4, 5)]), ("bij->bji", [(2, 3, 4)]),
          ("i,i->", [(6,), (6,)]), ("bhqd,bhkd->bhqk", [(2, 2, 3, 4),
                                                       (2, 2, 5, 4)])]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("listed", [False, True])
@pytest.mark.parametrize("eq,shapes", EINSUM, ids=[e[0] for e in EINSUM])
def test_einsum_matches_jax(eq, shapes, listed, dtype):
    rs = np.random.RandomState(1)
    arrays = [rs.randn(*s) for s in shapes]
    jops, tops = _to(P, arrays, dtype), _to(T, arrays, dtype)
    want = P.einsum(eq, jops) if listed else P.einsum(eq, *jops)
    got = T.einsum(eq, tops) if listed else T.einsum(eq, *tops)
    assert isinstance(got, T.Tensor)
    _compare(_host(got), _host(want), 1e-4, eq)
