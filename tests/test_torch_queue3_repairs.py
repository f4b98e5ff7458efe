"""Three faults of the port against the reference, repaired, each guarded
here on the CPU:

1. ``Tensor`` carries the activation ops as methods, as the JAX ``Tensor``
   does (``paddle_tpu/core/tensor_methods.py:63``): each method's result
   equals the JAX method's on the same numpy input (``x.softmax()`` and
   ``x.log_softmax()`` take Paddle's ``axis=-1``, not torch's methods).
2. The functional random ops draw from the process-wide dropout generator
   when no ``generator=`` is given, so ``paddle.seed`` governs them:
   ``dropout`` (and ``p = 1`` gives zeros, as in JAX), ``dropout2d``,
   ``dropout3d``, ``alpha_dropout``, ``rrelu(training=True)``, and
   ``scaled_dot_product_attention``/``flash_attention`` with dropout. The
   JAX stream differs, so these hold the keep rate, the scaling, ``p = 1``
   and reproducibility under ``paddle.seed``, not JAX's bits.
3. ``clip`` with neither bound returns ``x`` (``paddle.clip``, ``x.clip()``,
   ``clip_``), as JAX's does (``paddle_tpu/ops/math.py:186-189``).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import activation

# the activation methods taken with their defaults (maxout and prelu need
# an argument each, given below)
PLAIN = [n for n in activation.__all__ if n not in ("maxout", "prelu")]


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _x(shape=(3, 8), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 2


@pytest.mark.parametrize("name", PLAIN)
def test_activation_methods_match_jax(name, cpu):
    x = _x()
    got = getattr(paddle.to_tensor(x), name)()
    want = getattr(jpaddle.to_tensor(x), name)()
    assert isinstance(got, paddle.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                               rtol=1e-5, atol=1e-6, err_msg=name)


def test_activation_methods_with_arguments_match_jax(cpu):
    x = _x((2, 4, 3, 3))
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    for name, args, jargs in (
            ("maxout", (2,), (2,)),
            ("prelu", (paddle.to_tensor(w),), (jpaddle.to_tensor(w),)),
            ("softmax", (1,), (1,)), ("log_softmax", (0,), (0,)),
            ("leaky_relu", (0.3,), (0.3,)), ("gelu", (True,), (True,))):
        got = getattr(paddle.to_tensor(x), name)(*args)
        want = getattr(jpaddle.to_tensor(x), name)(*jargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _seeded(fn, s=7):
    paddle.seed(s)
    return fn()


@pytest.mark.parametrize("name", ["dropout", "dropout2d", "dropout3d",
                                  "alpha_dropout"])
def test_functional_dropout_draws_from_the_seeded_generator(name, cpu):
    shape = {"dropout": (64, 128), "dropout2d": (8, 64, 4, 4),
             "dropout3d": (8, 64, 2, 2, 2), "alpha_dropout": (64, 128)}[name]
    x = torch.full(shape, 2.0)
    fn = getattr(F, name)
    a = _seeded(lambda: fn(x, 0.25))
    b = _seeded(lambda: fn(x, 0.25))
    c = _seeded(lambda: fn(x, 0.25), s=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    if name == "alpha_dropout":
        # two values: the kept ones' and the dropped ones'
        assert len(torch.unique(a)) == 2
        keep = a == a.max()
    else:
        assert set(torch.unique(a).tolist()) <= {0.0, float(
            torch.tensor(2.0) / 0.75)}
        keep = a != 0
        if name != "dropout":
            # whole channels: one mask entry per (sample, channel)
            flat = keep.reshape(shape[0], shape[1], -1)
            assert (flat.all(-1) | ~flat.any(-1)).all()
    rate = float(keep.float().mean())
    assert 0.70 < rate < 0.80, rate


def test_dropout_p_one_gives_zeros_and_a_zero_gradient(cpu):
    x = torch.randn(4, 5, requires_grad=True)
    y = F.dropout(x, 1.0)
    assert torch.equal(y, torch.zeros(4, 5))
    y.sum().backward()
    assert torch.equal(x.grad, torch.zeros(4, 5))
    want = jpaddle.nn.functional.dropout(jpaddle.to_tensor(x.detach()
                                                           .numpy()), 1.0)
    np.testing.assert_array_equal(np.asarray(want.numpy()), y.detach())
    with pytest.raises(ValueError, match=r"\[0, 1\]"):
        F.dropout(x, 1.5)


def test_rrelu_training_draws_from_the_seeded_generator(cpu):
    x = torch.full((256,), -1.0)
    a = _seeded(lambda: activation.rrelu(x, training=True))
    b = _seeded(lambda: activation.rrelu(x, training=True))
    assert torch.equal(a, b)
    assert ((-a >= 1 / 8) & (-a <= 1 / 3)).all()
    assert len(torch.unique(a)) > 100


@pytest.mark.parametrize("fn", ["scaled_dot_product_attention",
                                "flash_attention"])
def test_attention_dropout_draws_from_the_seeded_generator(fn, cpu):
    rs = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rs.randn(1, 32, 2, 16).astype(np.float32))
               for _ in range(3))

    def run():
        if fn == "flash_attention":
            return F.flash_attention(q, k, v, dropout=0.3)[0]
        return F.scaled_dot_product_attention(q, k, v, dropout_p=0.3)

    a, b = _seeded(run), _seeded(run)
    assert torch.equal(a, b)
    dense = F.scaled_dot_product_attention(q, k, v)
    assert not torch.equal(a, dense)
    assert not torch.equal(a, _seeded(run, s=9))


def test_clip_without_bounds_returns_x(cpu):
    x = _x()
    want = np.asarray(jpaddle.clip(jpaddle.to_tensor(x)).numpy())
    t = paddle.to_tensor(x)
    for got in (paddle.clip(t), t.clip(), paddle.clip_(paddle.to_tensor(x))):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, x)
    # one bound still clips
    np.testing.assert_array_equal(paddle.clip(t, min=0.0).numpy(),
                                  np.maximum(x, 0.0))
