"""``nn.initializer`` of the port against the JAX package's.

``Constant``, ``Assign``, ``Dirac`` and ``Bilinear`` are exact: the same
values bit for bit, a ``Linear`` weight included (the port keeps it as the
transpose of JAX's ``[in, out]``). The random initializers draw from
torch's generator, not JAX's threefry, so their values differ; held equal
to JAX's are the fans, bounds and scales they compute on the JAX shape
(the same formulas read from both), every draw within the bounds, the
sample standard deviation of 40,000 draws within 3% of the law's in both
packages, and one seed giving the same draws twice.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu.nn as jnn
import paddle_tpu_torch as T
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.nn.initializer import initializers as jinit
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn.initializer import initializers as tinit


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """``set_device("cpu")`` for each test; the default comes back after."""
    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    yield


def _jax_param(shape, init):
    """A JAX parameter of ``shape`` filled by ``init``."""
    p = JaxParameter(np.zeros(shape, np.float32))
    init(p)
    return p


def _attr(pkg, init):
    return pkg.nn.ParamAttr(initializer=init)


def _linear_pair(jinit_obj, tinit_obj, fan_in, fan_out):
    jlin = jnn.Linear(fan_in, fan_out, weight_attr=_attr(P, jinit_obj))
    lin = nn.Linear(fan_in, fan_out, weight_attr=_attr(T, tinit_obj))
    return np.asarray(jlin.weight.numpy()), lin.weight.detach().numpy()


@pytest.mark.parametrize("shape", [[3, 5], [7], [4, 2, 3, 3]])
def test_constant_and_assign_are_exact(shape):
    value = np.random.RandomState(0).randn(*shape).astype(np.float32)
    for make in (lambda m: m.Constant(1.25), lambda m: m.Assign(value)):
        jp = _jax_param(shape, make(P.nn.initializer))
        tp = T.Parameter(torch.empty(shape))
        make(nn.initializer)(tp)
        assert np.array_equal(tp.detach().numpy(), np.asarray(jp.numpy()))


def test_assign_reaches_a_linear_weight_in_the_jax_layout():
    value = np.arange(12, dtype=np.float32).reshape(3, 4)  # [in, out]
    jw, w = _linear_pair(P.nn.initializer.Assign(value),
                         nn.initializer.Assign(value), 3, 4)
    assert np.array_equal(jw, value)
    assert np.array_equal(w, value.T)  # the port's [out, in]
    lin = nn.Linear(3, 4, weight_attr=nn.initializer.Assign(T.to_tensor(
        value)))
    assert np.array_equal(lin.weight.detach().numpy(), value.T)


@pytest.mark.parametrize("groups", [1, 2])
def test_dirac_and_bilinear_are_exact(groups):
    shape = [4, 4 // groups if groups > 1 else 3, 3, 3]
    for jmake, tmake in (
            (lambda: P.nn.initializer.Dirac(groups),
             lambda: nn.initializer.Dirac(groups)),
            (P.nn.initializer.Bilinear, nn.initializer.Bilinear)):
        jp = _jax_param(shape, jmake())
        tp = T.Parameter(torch.empty(shape))
        tmake()(tp)
        assert np.array_equal(tp.detach().numpy(), np.asarray(jp.numpy()))
    conv = nn.Conv2D(3, 4, 3, weight_attr=nn.initializer.Dirac())
    jconv = jnn.Conv2D(3, 4, 3, weight_attr=P.nn.initializer.Dirac())
    assert np.array_equal(conv.weight.detach().numpy(),
                          np.asarray(jconv.weight.numpy()))


FAN_SHAPES = [(200, 200), (300, 100), (64, 3, 5, 5), (100,)]


@pytest.mark.parametrize("shape", FAN_SHAPES, ids=str)
def test_fans_equal_jax(shape):
    assert tinit._fan_in_out(shape) == jinit._fan_in_out(shape)
    assert tinit.calculate_gain("leaky_relu", 0.2) == \
        jinit.calculate_gain("leaky_relu", 0.2)
    for name in ("tanh", "relu", "selu", "sigmoid"):
        assert tinit.calculate_gain(name) == jinit.calculate_gain(name)


def _law(name, shape):
    """The std (normal laws) or the bound (uniform laws) JAX computes on
    ``shape``."""
    fi, fo = jinit._fan_in_out(shape)
    gain = jinit.calculate_gain("relu", 0.0)
    return {"XavierNormal": np.sqrt(2.0 / (fi + fo)),
            "XavierUniform": np.sqrt(6.0 / (fi + fo)),
            "KaimingNormal": gain / np.sqrt(fi),
            "KaimingUniform": gain * np.sqrt(3.0 / fi),
            "Normal": 0.5, "TruncatedNormal": 0.5, "Uniform": 0.3}[name]


RANDOM = [("XavierNormal", ()), ("XavierUniform", ()),
          ("KaimingNormal", ()), ("KaimingUniform", ()),
          ("Normal", (0.0, 0.5)), ("TruncatedNormal", (0.0, 0.5, -1.0, 1.0)),
          ("Uniform", (-0.3, 0.3))]


@pytest.mark.parametrize("name,args", RANDOM, ids=[r[0] for r in RANDOM])
@pytest.mark.parametrize("layout", ["linear", "conv"])
def test_random_laws_equal_jax_on_the_jax_shape(name, args, layout):
    if layout == "linear":
        # a Linear weight, [in, out] in JAX and its transpose here: the
        # fans are JAX's (in = 400, out = 100), not the [out, in] shape's
        jw, w = _linear_pair(getattr(P.nn.initializer, name)(*args),
                             getattr(nn.initializer, name)(*args), 400, 100)
        jshape = (400, 100)
        assert w.shape == (100, 400) and jw.shape == jshape
    else:
        jshape = (64, 16, 5, 5)
        jp = _jax_param(list(jshape), getattr(
                                    P.nn.initializer, name)(*args))
        tp = T.Parameter(torch.empty(jshape))
        getattr(nn.initializer, name)(*args)(tp)
        jw, w = np.asarray(jp.numpy()), tp.detach().numpy()
    law = _law(name, jshape)
    if "Uniform" in name:
        for v in (w, jw):
            assert np.abs(v).max() <= law + 1e-7
            # a uniform law on [-b, b] has std b / sqrt(3)
            assert abs(v.std() - law / np.sqrt(3)) < 0.03 * law / np.sqrt(3)
    else:
        truncated = 0.87962566 if name == "TruncatedNormal" else 1.0
        for v in (w, jw):
            assert abs(v.std() - law * truncated) < 0.03 * law, (
                v.std(), law)
            if name == "TruncatedNormal":
                assert np.abs(v).max() <= 1.0  # mean ± 2 std
    assert not np.array_equal(w, np.zeros_like(w))


@pytest.mark.parametrize("name,args", RANDOM, ids=[r[0] for r in RANDOM])
def test_random_draws_are_per_seed(name, args):
    def draw(seed):
        T.seed(seed)
        return nn.Linear(30, 20, weight_attr=getattr(nn.initializer, name)(
            *args)).weight.detach().clone()

    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
    gen = torch.Generator().manual_seed(9)
    p = T.Parameter(torch.empty(4, 4))
    getattr(nn.initializer, name)(*args)(p, generator=gen)
    q = T.Parameter(torch.empty(4, 4))
    getattr(nn.initializer, name)(*args)(
        q, generator=torch.Generator().manual_seed(9))
    assert torch.equal(p, q)


def test_orthogonal_is_orthogonal_on_the_jax_shape():
    jw, w = _linear_pair(P.nn.initializer.Orthogonal(),
                         nn.initializer.Orthogonal(), 16, 8)
    # JAX [16, 8]: orthonormal columns; the port's [8, 16] is its transpose
    np.testing.assert_allclose(jw.T @ jw, np.eye(8), atol=1e-5)
    np.testing.assert_allclose(w @ w.T, np.eye(8), atol=1e-5)
    p = T.Parameter(torch.empty(4, 2, 3, 3))
    nn.initializer.Orthogonal(gain=2.0)(p)
    flat = p.detach().reshape(4, -1).numpy()
    np.testing.assert_allclose(flat @ flat.T, 4.0 * np.eye(4), atol=1e-4)


def test_default_linear_and_conv_draws_are_unchanged():
    """The layers' default initializers draw on the JAX shape, one path
    for every law: a ``Linear`` weight is the transpose of ``normal_`` on
    ``[in, out]``; the convolution's ``uniform_`` draws (whose JAX shape is
    its own) are what the port's convolutions drew before
    ``create_parameter``."""
    import math

    lin = nn.Linear(6, 4, generator=torch.Generator().manual_seed(3))
    want = torch.empty(6, 4).normal_(0.0, math.sqrt(2.0 / 10),
                                     generator=torch.Generator()
                                     .manual_seed(3))
    assert torch.equal(lin.weight.detach(), want.t())
    conv = nn.Conv2D(2, 3, 3, generator=torch.Generator().manual_seed(4))
    gen = torch.Generator().manual_seed(4)
    limit = math.sqrt(2.0) * math.sqrt(3.0 / 18)
    w = torch.empty(3, 2, 3, 3).uniform_(-limit, limit, generator=gen)
    b = torch.empty(3).uniform_(-1 / math.sqrt(18), 1 / math.sqrt(18),
                                generator=gen)
    assert torch.equal(conv.weight.detach(), w)
    assert torch.equal(conv.bias.detach(), b)
