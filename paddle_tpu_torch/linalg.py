"""The ``paddle.linalg`` namespace (port of ``paddle_tpu/linalg.py``): the
functions of ``ops/linalg.py``, each returning ``Tensor`` s."""
from .core.tensor import paddle_out
from .ops import linalg as _linalg

__all__ = ["cdist", "cholesky", "cholesky_solve", "corrcoef", "cov", "det",
           "dist", "eig", "eigh", "eigvals", "eigvalsh",
           "householder_product", "inv", "lstsq", "lu", "matmul",
           "matrix_norm", "matrix_power", "matrix_rank", "multi_dot", "norm",
           "pca_lowrank", "pinv", "qr", "slogdet", "solve", "svd", "svdvals",
           "triangular_solve", "vector_norm"]

for _name in __all__:
    globals()[_name] = paddle_out(getattr(_linalg, _name))
del _name
