"""The port's small vision classifiers (``vision/models/small.py``) against
the JAX package's, on the CPU.

Each constructor is built after ``paddle.seed(0)`` in JAX, its weights
carried into the port's model with ``load_jax_state`` (``Linear`` weights
transposed), and both run in eval mode on the same numpy input:

- ``LeNet`` (1 × 28²), ``alexnet``, ``vgg11`` with and without
  ``batch_norm`` (10 classes), ``mobilenet_v1`` and ``mobilenet_v2`` at
  scales 1.0 and 0.5: logits within 1e-4 of the largest (f32);
- ``vgg13``/``vgg16``/``vgg19``, with and without ``batch_norm``, as
  feature extractors (``num_classes=0``; their classifier is ``vgg11``'s):
  the pooled features within 1e-4 of the largest;
- ``InvertedResidual`` with and without its residual add, in train mode:
  output and every gradient within 1e-4 of the largest;
- state-dict keys line up with JAX's; ``pretrained=True`` raises; the
  constructors raise on a host without CUDA unless asked for the CPU; the
  dropout layers draw from the model's own generator in train mode.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.vision.models import small as jax_small
from paddle_tpu_torch.vision import models
from paddle_tpu_torch.vision.models import resnet, small

TOL = 1e-4


def _np(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _close_to(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _pair(name, *args, **kw):
    paddle.seed(0)
    ref = getattr(jax_small, name)(*args, **kw)
    model = getattr(small, name)(*args, device="cpu", **kw)
    state = {k: np.array(v.numpy(), copy=True)
             for k, v in ref.state_dict().items()}
    assert sorted(model.state_dict()) == sorted(state)
    resnet.load_jax_state(model, state)
    return ref, model


CASES = {
    "lenet": ("LeNet", (), {}, (2, 1, 28, 28)),
    "alexnet": ("alexnet", (), dict(num_classes=10), (1, 3, 80, 80)),
    "vgg11": ("vgg11", (), dict(num_classes=10), (1, 3, 32, 32)),
    "vgg11-bn": ("vgg11", (), dict(num_classes=10, batch_norm=True),
                 (1, 3, 32, 32)),
    "vgg13-features": ("vgg13", (), dict(num_classes=0), (1, 3, 32, 32)),
    "vgg13-bn-features": ("vgg13", (), dict(num_classes=0, batch_norm=True),
                          (1, 3, 32, 32)),
    "vgg16-features": ("vgg16", (), dict(num_classes=0), (1, 3, 32, 32)),
    "vgg16-bn-features": ("vgg16", (), dict(num_classes=0, batch_norm=True),
                          (1, 3, 32, 32)),
    "vgg19-features": ("vgg19", (), dict(num_classes=0), (1, 3, 32, 32)),
    "vgg19-bn-features": ("vgg19", (), dict(num_classes=0, batch_norm=True),
                          (1, 3, 32, 32)),
    "mobilenet_v1": ("mobilenet_v1", (), dict(num_classes=10),
                     (2, 3, 64, 64)),
    "mobilenet_v1-half": ("mobilenet_v1", (), dict(scale=0.5,
                                                   num_classes=10),
                          (2, 3, 64, 64)),
    "mobilenet_v2": ("mobilenet_v2", (), dict(num_classes=10),
                     (2, 3, 64, 64)),
    "mobilenet_v2-half": ("mobilenet_v2", (), dict(scale=0.5,
                                                   num_classes=10),
                          (2, 3, 64, 64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_constructor_forward_matches_jax(case):
    name, args, kw, shape = CASES[case]
    ref, model = _pair(name, *args, **kw)
    ref.eval()
    model.eval()
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = _np(ref(paddle.to_tensor(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    _close_to(got, want, TOL, case)


@pytest.mark.parametrize("inp,oup,stride,t", [(8, 8, 1, 6), (8, 12, 2, 6),
                                              (8, 8, 1, 1)],
                         ids=["residual", "strided", "no-expansion"])
def test_inverted_residual_matches_jax_in_train_mode(inp, oup, stride, t):
    ref, model = _pair("InvertedResidual", inp, oup, stride, t)
    assert model.use_res == (stride == 1 and inp == oup)
    rs = np.random.RandomState(1)
    x = rs.randn(2, inp, 12, 12).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    want = ref(jx)
    g = rs.randn(*want.shape).astype(np.float32)
    (want * paddle.to_tensor(g)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    got = model(tx)
    (got * torch.from_numpy(g)).sum().backward()
    _close_to(got.detach().numpy(), _np(want), TOL, "output")
    _close_to(tx.grad.numpy(), _np(jx.grad), TOL, "input gradient")
    jgrads = {n: _np(p.grad) for n, p in ref.named_parameters()}
    for n, p in model.named_parameters():
        _close_to(p.grad.numpy(), jgrads[n], TOL, n)


def test_exports_pretrained_dropout_and_cuda_defaults():
    from paddle_tpu.vision import models as jax_models

    exported = {n for n in dir(jax_models) if not n.startswith("_")}
    assert exported - {"resnet", "segdet", "small"} <= set(models.__all__)
    for ctor in (small.alexnet, small.vgg11, small.mobilenet_v1,
                 small.mobilenet_v2):
        with pytest.raises(NotImplementedError, match="pretrained"):
            ctor(pretrained=True, device="cpu")
    model = small.mobilenet_v2(scale=0.25, num_classes=4, device="cpu",
                               dropout_seed=3)
    x = torch.randn(2, 3, 32, 32)
    model.train()
    a = model(x)
    model.eval()
    b = model(x)
    assert not torch.equal(a, b) and torch.isfinite(a).all()
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the defaults would not raise")
    for ctor in (small.LeNet, small.mobilenet_v2,
                 lambda: small.vgg11(num_classes=0),
                 lambda: small.InvertedResidual(8, 8, 1, 6)):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctor()
