"""Linear algebra (port of ``paddle_tpu/ops/linalg.py``) over
``torch.linalg``, with the JAX functions' conventions where torch's
differ:

- ``norm``: ``p`` None or ``"fro"`` over all axes is the square root of
  the sum of squares, ``±inf`` over all axes the max or min of ``|x|``,
  another ``p`` over all axes ``(Σ|x|^p)^(1/p)`` (never a matrix norm); one
  axis gives a vector norm, two a matrix norm (``"fro"``, ``"nuc"``,
  ``±1``, ``±2``, ``±inf``), as ``jnp.linalg.norm``;
- ``matrix_norm`` always takes the last two axes (``axis`` is read
  nowhere, as in JAX);
- ``lu`` returns LAPACK's 1-based pivots (int32), and with
  ``get_infos`` zeros;
- ``eig`` and ``eigvals`` give complex outputs;
- ``cov``'s ``ddof`` is a bool (1 or 0), ``rowvar=False`` takes columns;
- ``lstsq`` returns ``(solution, residuals, rank, singular values)``, the
  residuals always ``Σ (y − x·solution)²`` over the rows;
- ``matrix_rank``'s ``tol`` is an absolute threshold on the singular
  values (its default ``max(S)·max(M, N)·eps``);
- ``cdist`` at ``p = 2`` is ``sqrt(Σ d² + 1e-30)``;
- ``slogdet`` returns ``(sign, log|det|)``.

``norm``, ``vector_norm`` and ``matrix_norm`` are black under AMP (f32),
as the JAX ``norm``; the others compute in their inputs' dtype.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from . import _common as c
from .math import matmul

__all__ = ["cdist", "cholesky", "cholesky_solve", "corrcoef", "cov", "det",
           "dist", "eig", "eigh", "eigvals", "eigvalsh",
           "householder_product", "inv", "lstsq", "lu", "matmul",
           "matrix_norm", "matrix_power", "matrix_rank", "multi_dot", "norm",
           "pca_lowrank", "pinv", "qr", "slogdet", "solve", "svd", "svdvals",
           "t", "t_nd", "triangular_solve", "vector_norm"]

_INF = float("inf")


def t(input, name=None):
    """``input`` with its axes reversed; a 0-d or 1-d one as it is."""
    v = c.tensor(input)
    return v if v.ndim < 2 else v.permute(*range(v.ndim - 1, -1, -1))


def t_nd(input):
    """All axes reversed (``Tensor.T``)."""
    v = c.tensor(input)
    return v.permute(*range(v.ndim - 1, -1, -1))


def _axis(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def _jnp_norm(v, ord, axis, keepdim):
    """``jnp.linalg.norm(v, ord, axis, keepdims)`` for an int axis or a
    tuple of one or two."""
    if isinstance(axis, int) or len(axis) == 1:
        return torch.linalg.vector_norm(v, 2 if ord is None else ord,
                                        axis, keepdim)
    return torch.linalg.matrix_norm(v, "fro" if ord is None else ord, axis,
                                    keepdim)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    (v,) = cast_inputs("norm", c.tensor(x))
    a = _axis(axis)
    if p == "inf":
        p = _INF
    elif p == "-inf":
        p = -_INF
    if p is None or p == "fro":
        if a is None:
            return torch.sqrt(torch.sum(torch.square(v)))
        return _jnp_norm(v, None, a, keepdim)
    if p == "nuc":
        return torch.linalg.matrix_norm(v, "nuc", tuple(axis), keepdim)
    if a is None:
        if p == _INF:
            return torch.max(v.abs())
        if p == -_INF:
            return torch.min(v.abs())
        return torch.sum(v.abs() ** p) ** (1.0 / p)
    return _jnp_norm(v, p, a, keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    (v,) = cast_inputs("vector_norm", c.tensor(x))
    return torch.linalg.vector_norm(v, p, _axis(axis), keepdim)


def matrix_norm(x, p="fro", axis=[-2, -1], keepdim=False, name=None):  # noqa: B006
    (v,) = cast_inputs("matrix_norm", c.tensor(x))
    return torch.linalg.matrix_norm(v, p, (-2, -1), keepdim)


def dist(x, y, p=2, name=None):
    """The ``p``-norm of ``x - y`` flattened."""
    a, b = c.operands(x, y)
    return torch.linalg.vector_norm((a - b).reshape(-1), p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    a, b = c.tensor(x), c.tensor(y)
    diff = a[..., :, None, :] - b[..., None, :, :]
    if p == 2.0:
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-30)
    return torch.sum(diff.abs() ** p, dim=-1) ** (1.0 / p)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(c.tensor(x), upper=upper)


def cholesky_solve(x, y, upper=False, name=None):
    """Solve ``A z = x`` for ``A`` given by its Cholesky factor ``y``."""
    return torch.cholesky_solve(c.tensor(x), c.tensor(y), upper=upper)


def qr(x, mode="reduced", name=None):
    q, r = torch.linalg.qr(c.tensor(x), mode=mode)
    return r if mode == "r" else (q, r)


def svd(x, full_matrices=False, name=None):
    return tuple(torch.linalg.svd(c.tensor(x), full_matrices=full_matrices))


def svdvals(x, name=None):
    return torch.linalg.svdvals(c.tensor(x))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """The first ``q`` (default ``min(6, m, n)``) singular triples of the
    (centred) matrix, exactly, as the JAX function computes them:
    ``(U, S, V)``."""
    v = c.tensor(x)
    qq = q or min(6, v.shape[-2], v.shape[-1])
    if center:
        v = v - v.mean(dim=-2, keepdim=True)
    u, s, vh = torch.linalg.svd(v, full_matrices=False)
    return u[..., :qq], s[..., :qq], vh.mT[..., :qq]


def eig(x, name=None):
    return tuple(torch.linalg.eig(c.tensor(x)))


def eigh(x, UPLO="L", name=None):
    return tuple(torch.linalg.eigh(c.tensor(x), UPLO=UPLO))


def eigvals(x, name=None):
    return torch.linalg.eigvals(c.tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(c.tensor(x), UPLO=UPLO)


def inv(x, name=None):
    return torch.linalg.inv(c.tensor(x))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(c.tensor(x), rtol=rcond, hermitian=hermitian)


def solve(x, y, name=None):
    a, b = c.tensor(x), c.tensor(y)
    return torch.linalg.solve(a, b)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    """Solve ``x z = y`` (``xᵀ z = y`` with ``transpose``) for a triangular
    ``x``; a 1-d ``y`` gives a 1-d ``z``."""
    a, b = c.tensor(x), c.tensor(y)
    if transpose:
        a, upper = a.mT, not upper
    vec = b.ndim == 1
    out = torch.linalg.solve_triangular(a, b[:, None] if vec else b,
                                        upper=upper,
                                        unitriangular=unitriangular)
    return out[:, 0] if vec else out


def lstsq(x, y, rcond=None, driver=None, name=None):
    a, b = c.tensor(x), c.tensor(y)
    sol = torch.linalg.lstsq(a, b, rcond=rcond, driver=driver).solution
    res = torch.sum(torch.square(b - a @ sol), dim=-2)
    return sol, res, torch.linalg.matrix_rank(a), torch.linalg.svdvals(a)


def det(x, name=None):
    return torch.linalg.det(c.tensor(x))


def slogdet(x, name=None):
    return tuple(torch.linalg.slogdet(c.tensor(x)))


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(c.tensor(x), int(n))


def matrix_rank(x, tol=None, hermitian=False, name=None):
    """Singular values above ``tol`` (default ``max(S)·max(M, N)·eps``),
    counted; ``hermitian`` is read nowhere, as in the JAX function."""
    v = c.tensor(x)
    if tol is None:
        return torch.linalg.matrix_rank(v)
    return torch.sum(torch.linalg.svdvals(v) > c.scalar(tol), dim=-1)


def lu(x, pivot=True, get_infos=False, name=None):
    """``(LU, pivots)`` with the pivots 1-based int32, and with
    ``get_infos`` zeros ``[*batch]`` int32 as a third output."""
    v = c.tensor(x)
    lu_, piv = torch.linalg.lu_factor(v)
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_, piv, torch.zeros(v.shape[:-2], dtype=torch.int32,
                                     device=v.device)
    return lu_, piv


def corrcoef(x, rowvar=True, name=None):
    v = c.tensor(x)
    return torch.corrcoef(v if rowvar else v.mT)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    v = c.tensor(x)
    fw = None if fweights is None else c.tensor(fweights, v)
    aw = None if aweights is None else c.tensor(aweights, v)
    return torch.cov(v if rowvar or v.ndim < 2 else v.mT,
                     correction=1 if ddof else 0, fweights=fw, aweights=aw)


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([c.tensor(v) for v in x])


def householder_product(x, tau, name=None):
    """The first ``n`` columns of ``H_0 ⋯ H_{n-1}``, ``H_i = I − τ_i v_i
    v_iᵀ`` from the reflectors below ``x``'s diagonal."""
    return torch.linalg.householder_product(c.tensor(x), c.tensor(tau))
