"""``paddle.autograd`` of the port against the JAX package's
(``tests/test_autograd.py``'s backward and ``PyLayer`` cases, and more):
``PyLayer`` with saved tensors, several inputs and outputs, non-tensor
arguments, non-differentiable outputs and materialized gradients;
``backward`` on several roots with ``grad_tensors``; ``grad``;
``saved_tensors_hooks`` around ``PyLayerContext.save_for_backward``.
Gradients within 1e-6 of JAX's (f32; the values are of order 1-10).

``saved_tensors_hooks``: the JAX package's module says the pair applies
to the tensors a ``PyLayer`` saves, but its ``save_for_backward`` never
reads the pair (``paddle_tpu/autograd/saved_tensors_hooks.py`` sets a
thread-local that nothing reads), so JAX packs and unpacks nothing. The
port applies the pair as that module describes: one pack a saved tensor,
one unpack a read; the test holds both counts.
"""
import contextlib

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.autograd import PyLayer as JaxPyLayer
from paddle_tpu.autograd import saved_tensors_hooks as jax_hooks
from paddle_tpu_torch import autograd
from paddle_tpu_torch.autograd import PyLayer, saved_tensors_hooks

TOL = 1e-6


def _grad(t):
    return np.asarray(t.grad.numpy(), np.float32)


def _both(fn):
    """``fn(pkg, PyLayer)`` run with each package; returns (port, jax)."""
    return fn(T, PyLayer), fn(P, JaxPyLayer)


def _leaf(pkg, value):
    if pkg is T:
        return T.to_tensor(np.asarray(value, np.float32), place="cpu",
                           stop_gradient=False)
    return P.to_tensor(np.asarray(value, np.float32), stop_gradient=False)


def test_exp_saves_its_output():
    def run(pkg, base):
        class Exp(base):
            @staticmethod
            def forward(ctx, x):
                y = pkg.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, gy):
                (y,) = ctx.saved_tensor()
                return gy * y

        x = _leaf(pkg, [0.5, 1.5, -1.0])
        y = Exp.apply(x)
        pkg.sum(y * y).backward()
        return _grad(x), type(y)

    (got, kind), (want, _) = _both(run)
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert kind is T.Tensor


def test_several_inputs_outputs_and_non_tensor_arguments():
    def run(pkg, base):
        class MulAdd(base):
            @staticmethod
            def forward(ctx, a, b, k, scale=1.0):
                ctx.save_for_backward(a, b)
                ctx.k, ctx.scale = k, scale
                return a * b * scale + a * k, a - b

            @staticmethod
            def backward(ctx, g1, g2):
                a, b = ctx.saved_tensor()
                return (g1 * (b * ctx.scale + ctx.k) + g2,
                        g1 * a * ctx.scale - g2)

        a, b = _leaf(pkg, [2.0, 1.0]), _leaf(pkg, [3.0, -1.0])
        out, diff = MulAdd.apply(a, b, 4.0, scale=0.5)
        pkg.sum(out * 2 + diff * 3).backward()
        return _grad(a), _grad(b), np.asarray(out.numpy() if pkg is P
                                              else out.detach().numpy())

    got, want = _both(run)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL)


def test_non_differentiable_outputs_and_materialized_grads():
    def run(pkg, base):
        class Split(base):
            @staticmethod
            def forward(ctx, x):
                idx = pkg.argmax(x)
                ctx.mark_non_differentiable(idx)
                return x * 2, idx

            @staticmethod
            def backward(ctx, g, g_idx):
                return g * 2

        x = _leaf(pkg, [1.0, 3.0, 2.0])
        y, idx = Split.apply(x)
        pkg.sum(y).backward()
        return _grad(x), bool(idx.stop_gradient), int(np.asarray(
            idx.numpy() if pkg is P else idx.detach().numpy()))

    got, want = _both(run)
    np.testing.assert_allclose(got[0], want[0], rtol=TOL)
    assert got[1:] == want[1:] == (True, 1)

    def unused_output(pkg, base, materialize):
        seen = []

        class Two(base):
            @staticmethod
            def forward(ctx, x):
                ctx.set_materialize_grads(materialize)
                return x * 1, x * 3

            @staticmethod
            def backward(ctx, g1, g2):
                seen.append(g2)
                return g1 + (0 if g2 is None else g2 * 3)

        x = _leaf(pkg, [1.0, 2.0])
        a, _ = Two.apply(x)
        pkg.sum(a).backward()
        return _grad(x), seen[0]

    (g, seen), (jg, jseen) = (unused_output(T, PyLayer, True),
                              unused_output(P, JaxPyLayer, True))
    np.testing.assert_allclose(g, jg, rtol=TOL)
    # an output the loss does not use gets zeros, as in JAX
    assert np.array_equal(seen.numpy(), np.zeros(2, np.float32))
    assert np.array_equal(np.asarray(jseen.numpy()), np.zeros(2))
    g, seen = unused_output(T, PyLayer, False)
    assert seen is None and np.array_equal(g, np.ones(2, np.float32))


def test_backward_on_several_roots_with_grad_tensors():
    def run(pkg, backward):
        x = _leaf(pkg, [1.0, 2.0])
        y = x * x
        z = pkg.sum(x * 3)
        seed = (T.to_tensor(np.array([1.0, 10.0], np.float32), place="cpu")
                if pkg is T else P.to_tensor(np.array([1.0, 10.0],
                                                     np.float32)))
        backward([y, z], [seed, None])
        u = _leaf(pkg, [3.0, -1.0])
        backward(u * u)  # a non-scalar root without a seed: ones
        return _grad(x), _grad(u)

    got = run(T, autograd.backward)
    want = run(P, P.autograd.backward)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL)
    np.testing.assert_allclose(got[0], [5.0, 43.0])


def test_tensor_backward_hands_torch_the_plain_tensor(monkeypatch):
    """``loss.backward()`` on a ``paddle.Tensor`` (a loss layer's output, a
    Paddle op's) reaches none of the Paddle methods that shadow torch's:
    torch's engine calls ``numel``, and Paddle's ``numel`` is an op whose
    host copy a CUDA-graph capture refuses (a captured ``TrainStep`` failed
    so). A non-scalar root is seeded with ones, as in JAX."""
    def refuse(*args, **kwargs):
        raise AssertionError("a Paddle method reached torch's engine")

    x = _leaf(T, [1.0, 2.0, 3.0])
    loss = T.nn.CrossEntropyLoss()(T.reshape(x, [1, 3]),
                                   T.to_tensor(np.array([2]), place="cpu"))
    root = x * x
    assert type(loss) is T.Tensor and type(root) is T.Tensor
    monkeypatch.setattr(T.Tensor, "numel", refuse)
    monkeypatch.setattr(T.Tensor, "size", property(refuse))
    loss.backward()
    first = _grad(x).copy()
    root.backward()
    monkeypatch.undo()
    probs = np.exp([1.0, 2.0, 3.0]) / np.exp([1.0, 2.0, 3.0]).sum()
    np.testing.assert_allclose(first, probs - [0, 0, 1], rtol=1e-5)
    np.testing.assert_allclose(_grad(x), first + [2.0, 4.0, 6.0], rtol=1e-5)


def test_grad_and_grad_modes():
    x = T.to_tensor(np.array([1.0, 2.0], np.float32), place="cpu",
                    stop_gradient=False)
    (g,) = autograd.grad(T.sum(x * x), x)
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    with autograd.no_grad():
        assert not (x * 2).requires_grad
        with autograd.enable_grad():
            assert (x * 2).requires_grad


@pytest.mark.parametrize("saved", [1, 2])
def test_saved_tensors_hooks_apply_to_pylayer_saves_only(saved):
    def run(pkg, base, hooks):
        counts = {"pack": 0, "unpack": 0}

        def pack(t):
            counts["pack"] += 1
            return t

        def unpack(t):
            counts["unpack"] += 1
            return t

        class Square(base):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(*([x] * saved))
                return x * x

            @staticmethod
            def backward(ctx, g):
                xs = ctx.saved_tensor()
                return g * 2 * xs[0]

        x = _leaf(pkg, [1.0, -2.0, 3.0])
        with hooks(pack, unpack):
            # a built-in op's residuals are not the hooks' business
            y = pkg.sum(pkg.exp(x) + Square.apply(x))
        y.backward()
        return counts, _grad(x)

    (counts, g), (jcounts, jg) = (run(T, PyLayer, saved_tensors_hooks),
                                  run(P, JaxPyLayer, jax_hooks))
    np.testing.assert_allclose(g, jg, rtol=TOL)
    assert counts == {"pack": saved, "unpack": saved}
    assert jcounts == {"pack": 0, "unpack": 0}  # JAX reads no pair
    # without the hooks the save is torch's own
    counts, g2 = run(T, PyLayer, lambda p, u: contextlib.nullcontext())
    assert counts == {"pack": 0, "unpack": 0}
    np.testing.assert_allclose(g2, g, rtol=TOL)
