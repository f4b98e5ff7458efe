"""The ``nn`` pieces the static builders need, against the JAX package:
``conv1d/2d/3d_transpose`` (strides, pads, dilations, groups, output
padding, ``"SAME"``, channel-last), ``group_norm`` and ``instance_norm``
(f32 within 1e-5), their layers with the JAX layers' parameters, and
``spectral_norm`` (the op and the layer)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import device as device_mod

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _both(fn_t, fn_j, arrays, **kw):
    got = fn_t(*[torch.from_numpy(a) for a in arrays], **kw).numpy()
    want = np.asarray(fn_j(*[jp.to_tensor(a) for a in arrays], **kw).numpy())
    return got, want


CASES = [
    # n, x shape, weight shape, kwargs
    (1, (2, 4, 9), (4, 3, 3), dict(stride=2, padding=1, output_padding=1)),
    (2, (2, 4, 6, 5), (4, 6, 3, 3), dict(stride=2, padding=1, groups=2,
                                         dilation=2)),
    (2, (1, 3, 5, 5), (3, 2, 2, 3), dict(stride=(2, 1),
                                         padding=[1, 0, 0, 2])),
    (2, (1, 3, 7, 6), (3, 2, 3, 3), dict(stride=2, padding="SAME")),
    (2, (1, 5, 6, 3), (3, 2, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1,
                                         data_format="NHWC")),
    (3, (1, 2, 3, 4, 3), (2, 2, 3, 2, 2), dict(stride=(1, 2, 2), padding=1)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_conv_transpose_matches_jax(case):
    n, xs, ws, kw = CASES[case]
    rs = np.random.RandomState(case)
    x = rs.randn(*xs).astype(np.float32)
    w = rs.randn(*ws).astype(np.float32)
    b = rs.randn(ws[1] * kw.get("groups", 1)).astype(np.float32)
    name = f"conv{n}d_transpose"
    got, want = _both(getattr(F, name), getattr(JF, name), [x, w, b], **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_group_and_instance_norm_match_jax(fmt):
    rs = np.random.RandomState(1)
    x = (rs.randn(2, 6, 5, 4) * 3 + 1).astype(np.float32)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w, b = rs.randn(6).astype(np.float32), rs.randn(6).astype(np.float32)
    got, want = _both(lambda *a, **k: F.group_norm(*a, **k),
                      lambda *a, **k: JF.group_norm(*a, **k),
                      [x], num_groups=3, epsilon=1e-5, data_format=fmt)
    np.testing.assert_allclose(got, want, **TOL)
    got = F.group_norm(torch.from_numpy(x), 2, 1e-5, torch.from_numpy(w),
                       torch.from_numpy(b), fmt).numpy()
    want = np.asarray(JF.group_norm(jp.to_tensor(x), 2, 1e-5,
                                    jp.to_tensor(w), jp.to_tensor(b),
                                    fmt).numpy())
    np.testing.assert_allclose(got, want, **TOL)
    got = F.instance_norm(torch.from_numpy(x), weight=torch.from_numpy(w),
                          bias=torch.from_numpy(b), data_format=fmt).numpy()
    want = np.asarray(JF.instance_norm(jp.to_tensor(x), weight=jp.to_tensor(w),
                                       bias=jp.to_tensor(b),
                                       data_format=fmt).numpy())
    np.testing.assert_allclose(got, want, **TOL)


def test_layers_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(2, 4, 6, 6).astype(np.float32)
    pairs = [
        (paddle.nn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, groups=2),
         jp.nn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, groups=2)),
        (paddle.nn.GroupNorm(2, 4), jp.nn.GroupNorm(2, 4)),
        (paddle.nn.InstanceNorm2D(4), jp.nn.InstanceNorm2D(4)),
    ]
    for port, ref in pairs:
        state = {k: np.array(v.numpy(), copy=True) for k, v in
                 ref.state_dict().items()}
        assert sorted(state) == sorted(port.state_dict())
        for k, v in port.state_dict().items():
            assert tuple(v.shape) == state[k].shape
            v.copy_(torch.from_numpy(state[k]))
        got = port(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(ref(jp.to_tensor(x))
                                                   .numpy()), **TOL)
    for cls, x_shape in ((paddle.nn.Conv1DTranspose, (2, 4, 5)),
                         (paddle.nn.Conv3DTranspose, (1, 4, 3, 3, 3))):
        layer = cls(4, 2, 3, stride=2)
        out = layer(torch.randn(*x_shape))
        assert out.shape[1] == 2 and out.shape[2] == 2 * x_shape[2] + 1
    for cls in (paddle.nn.InstanceNorm1D, paddle.nn.InstanceNorm3D):
        assert tuple(cls(3).weight.shape) == (3,)


def test_spectral_norm_matches_jax():
    from paddle_tpu.ops import misc_ops as jax_misc
    from paddle_tpu_torch.ops import misc_ops

    rs = np.random.RandomState(3)
    w = rs.randn(4, 3, 2).astype(np.float32)
    u, v = rs.randn(3).astype(np.float32), rs.randn(8).astype(np.float32)
    got, want = _both(misc_ops.spectral_norm, jax_misc.spectral_norm,
                      [w, u, v], dim=1, power_iters=3)
    np.testing.assert_allclose(got, want, **TOL)
    port, ref = (paddle.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2),
                 jp.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2))
    with torch.no_grad():
        port.weight_u.copy_(torch.from_numpy(np.array(
            ref.weight_u.numpy())))
        port.weight_v.copy_(torch.from_numpy(np.array(
            ref.weight_v.numpy())))
    got = port(torch.from_numpy(w)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref(jp.to_tensor(w)).numpy()),
                               **TOL)
    assert port.weight_u.stop_gradient and port.weight_v.stop_gradient
