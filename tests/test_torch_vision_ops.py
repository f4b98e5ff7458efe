"""``vision.ops`` ``roi_align``, ``box_coder`` and ``yolo_box`` against the
JAX package on the CPU (f32 within 1e-5 relative), with what the port adds
to them held against the JAX function case by case: ``box_coder``'s
``axis`` over ``[N, M, 4]`` deltas and a four-float variance, and
``yolo_box``'s ``iou_aware``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.vision.ops as JO
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.vision import ops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x.numpy())


def _boxes(rs, n, size):
    xy = rs.uniform(-2, size - 4, (n, 2))
    wh = rs.uniform(0.5, size / 2, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(output_size=3, spatial_scale=0.5, sampling_ratio=2, aligned=True),
    dict(output_size=(2, 4), spatial_scale=1.0, sampling_ratio=-1,
         aligned=False),
])
def test_roi_align_matches_jax(kw):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 9, 11).astype(np.float32)
    boxes = _boxes(rs, 5, 16)
    num = np.array([2, 3], np.int32)
    xt = torch.from_numpy(x).requires_grad_()
    xj = jp.to_tensor(x, stop_gradient=False)
    got = ops.roi_align(xt, torch.from_numpy(boxes), torch.from_numpy(num),
                        **kw)
    want = JO.roi_align(xj, jp.to_tensor(boxes), jp.to_tensor(num), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(xj.grad), **TOL)


def test_box_coder_matches_jax():
    rs = np.random.RandomState(1)
    prior, target = _boxes(rs, 7, 20), _boxes(rs, 7, 20)
    var = rs.uniform(0.1, 0.3, (7, 4)).astype(np.float32)
    deltas = (rs.randn(7, 4) * 0.2).astype(np.float32)
    for normalized in (True, False):
        for code, t in (("encode_center_size", target),
                        ("decode_center_size", deltas)):
            for v in (var, None):
                got = ops.box_coder(
                    torch.from_numpy(prior),
                    None if v is None else torch.from_numpy(v),
                    torch.from_numpy(t), code, normalized)
                want = JO.box_coder(
                    jp.to_tensor(prior), None if v is None
                    else jp.to_tensor(v), jp.to_tensor(t), code, normalized)
                np.testing.assert_allclose(_np(got), _np(want), **TOL)
    # four floats: the JAX function given them as a tensor of rows
    four = [0.1, 0.1, 0.2, 0.2]
    got = ops.box_coder(torch.from_numpy(prior), four,
                        torch.from_numpy(target))
    want = JO.box_coder(jp.to_tensor(prior),
                        jp.to_tensor(np.tile(np.float32(four), (7, 1))),
                        jp.to_tensor(target))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_box_coder_decode_axis(axis):
    """``[N, M, 4]`` deltas against ``[M, 4]`` priors (axis 0) or ``[N,
    4]`` (axis 1): each row of the other axis as the JAX row-by-row
    decode."""
    rs = np.random.RandomState(2)
    n, m = 3, 5
    prior = _boxes(rs, m if axis == 0 else n, 10)
    var = rs.uniform(0.1, 0.3, prior.shape).astype(np.float32)
    deltas = (rs.randn(n, m, 4) * 0.2).astype(np.float32)
    got = _np(ops.box_coder(torch.from_numpy(prior), torch.from_numpy(var),
                            torch.from_numpy(deltas), "decode_center_size",
                            axis=axis))
    for i in range(n if axis == 0 else m):
        rows = deltas[i] if axis == 0 else deltas[:, i]
        want = JO.box_coder(jp.to_tensor(prior), jp.to_tensor(var),
                            jp.to_tensor(rows), "decode_center_size")
        np.testing.assert_allclose(got[i] if axis == 0 else got[:, i],
                                   _np(want), **TOL)


def test_yolo_box_matches_jax():
    rs = np.random.RandomState(3)
    anchors, classes = [10, 13, 16, 30, 33, 23], 4
    x = rs.randn(2, 3 * (5 + classes), 5, 6).astype(np.float32)
    img = np.array([[300, 320], [200, 240]], np.int32)
    for kw in (dict(clip_bbox=True), dict(clip_bbox=False, scale_x_y=1.05)):
        got = ops.yolo_box(torch.from_numpy(x), torch.from_numpy(img),
                           anchors, classes, 0.5, 32, **kw)
        want = JO.yolo_box(jp.to_tensor(x), jp.to_tensor(img), anchors,
                           classes, 0.5, 32, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), **TOL)
    # iou_aware: factor 0 is the JAX head without the IoU channels; at 0.5
    # the confidence is sqrt(obj · iou)
    iou = rs.randn(2, 3, 5, 6).astype(np.float32)
    xi = np.concatenate([iou, x], 1)
    got = ops.yolo_box(torch.from_numpy(xi), torch.from_numpy(img), anchors,
                       classes, 0.0, 32, iou_aware=True, iou_aware_factor=0.0)
    want = JO.yolo_box(jp.to_tensor(x), jp.to_tensor(img), anchors, classes,
                       0.0, 32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)
    _, scores = ops.yolo_box(torch.from_numpy(xi), torch.from_numpy(img),
                             anchors, classes, 0.0, 32, iou_aware=True)
    sig = lambda a: 1 / (1 + np.exp(-a))  # noqa: E731
    p = x.reshape(2, 3, 5 + classes, 5, 6)
    conf = np.sqrt(sig(p[:, :, 4]) * sig(iou))
    cls = sig(p[:, :, 5:]) * conf[:, :, None]
    want = np.moveaxis(cls, 2, -1).reshape(2, -1, classes)
    np.testing.assert_allclose(_np(scores), want, rtol=1e-5, atol=1e-6)
