"""``register_op``/``run_custom_op`` of the port (``core/custom_op.py``)
against the JAX package's: a tanh-GELU with a hand-written backward in
both, forward and gradient within 1e-6; the op seen as one op by the
operator stats, recorded as one node of a static program and replayed,
and differentiable without a backward (the forward's own gradient)."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.amp import debugging as dbg
from paddle_tpu_torch.core import custom_op

C = 0.7978845608028654


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _torch_gelu(x):
    return 0.5 * x * (1 + torch.tanh(C * (x + 0.044715 * x ** 3)))


def _torch_gelu_bwd(res, g):
    (x,), _ = res
    t = torch.tanh(C * (x + 0.044715 * x ** 3))
    d = 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * C * (1 + 3 * 0.044715 * x * x)
    return (g * d,)


def test_gelu_with_backward_matches_jax():
    import jax.numpy as jnp

    import paddle_tpu as jp
    from paddle_tpu.core.custom_op import register_op as jax_register

    def jax_gelu(x):
        return 0.5 * x * (1 + jnp.tanh(C * (x + 0.044715 * x ** 3)))

    def jax_gelu_bwd(res, g):
        (x,), _ = res
        t = jnp.tanh(C * (x + 0.044715 * x ** 3))
        d = 0.5 * (1 + t) + 0.5 * x * (1 - t * t) * C * (
            1 + 3 * 0.044715 * x * x)
        return (g * d,)

    jop = jax_register("t_gelu", jax_gelu, backward=jax_gelu_bwd)
    op = paddle.register_op("t_gelu", _torch_gelu, backward=_torch_gelu_bwd)
    xs = np.random.RandomState(0).randn(4, 7).astype(np.float32) * 2
    jx = jp.to_tensor(xs, stop_gradient=False)
    jy = jop(jx)
    jy.sum().backward()
    x = torch.tensor(xs, requires_grad=True)
    y = paddle.run_custom_op("t_gelu", x)
    y.sum().backward()
    # within 1e-6 of each output's largest magnitude: the two packages'
    # f32 tanh differ in the last ulp, and the gradient's two terms cancel
    # where it crosses zero
    for got, want in ((y.detach().numpy(), np.asarray(jy.numpy())),
                      (x.grad.numpy(), np.asarray(jx.grad.numpy()))):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert op.__name__ == "t_gelu"
    assert paddle.get_custom_op("t_gelu")["backward"] is _torch_gelu_bwd


def test_custom_op_is_one_op_counted_and_recorded():
    paddle.register_op("t_gelu2", _torch_gelu, backward=_torch_gelu_bwd)
    with dbg.collect_operator_stats():
        paddle.run_custom_op("t_gelu2", torch.ones(3))
        stats = dbg.get_operator_stats()
    assert stats["paddle_tpu_torch_custom::t_gelu2"] == {"fp32": 1}
    assert not any(k.startswith("aten::tanh") for k in stats)
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [None, 3], "float32")
        y = paddle.run_custom_op("t_gelu2", x)
    assert main.op_types() == ["paddle_tpu_torch_custom::t_gelu2"]
    feed = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    (got,) = paddle.static.Executor().run(main, feed={"x": feed},
                                          fetch_list=[y])
    np.testing.assert_array_equal(got, _torch_gelu(torch.from_numpy(feed)))


def test_without_backward_the_forward_is_differentiated():
    op = paddle.register_op("t_scaled_pair",
                            lambda a, b, scale=1.0: (a * b * scale, a + b))
    a = torch.randn(3, dtype=torch.float64, requires_grad=True)
    b = torch.randn(3, dtype=torch.float64, requires_grad=True)
    p, s = op(a, b, scale=2.0)
    (p.sum() + 3 * s.sum()).backward()
    torch.testing.assert_close(a.grad, 2 * b.detach() + 3)
    torch.testing.assert_close(b.grad, 2 * a.detach() + 3)
    with pytest.raises(KeyError, match="not registered"):
        paddle.run_custom_op("t_no_such_op", a)


def test_reregistering_replaces_the_forward():
    paddle.register_op("t_swap", lambda x: x + 1)
    paddle.register_op("t_swap", lambda x: x * 3)
    out = paddle.run_custom_op("t_swap", torch.ones(2))
    assert out.tolist() == [3.0, 3.0]
    assert custom_op.CUSTOM_OPS["t_swap"]["op"] is not None
