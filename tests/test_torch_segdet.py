"""The port's PP-LiteSeg training path and PP-YOLOE against the JAX
package's, on the CPU.

The JAX side runs on the CPU as its own tests run it; no function of this
path reaches a Pallas kernel. Inputs come from numpy seeds, the JAX
weights are carried across with ``load_jax_state``, and each check states
its tolerance:

- ``interpolate`` in every mode (``nearest``, ``linear``, ``bilinear``,
  ``trilinear``, ``bicubic``, ``area``), enlarging and shrinking,
  ``align_corners`` both ways, 1-D/2-D/3-D, NHWC, ``scale_factor``:
  outputs and input gradients within 1e-5 (f32); in bf16 bit for bit
  (the axes contracted in JAX's order). ``resize_weights`` against
  ``jax.image``'s
  ``compute_weight_mat``: bit for bit where the scale is a whole number
  (every resize of the bench arm), within 4e-7 elsewhere (XLA's compiled
  f32 arithmetic rounds a few weights differently). torch's own
  ``F.interpolate`` is shown to miss JAX by more than 0.05 when it
  shrinks and in ``bicubic``;
- the adaptive pools (``adaptive_avg_pool1d/2d/3d``,
  ``adaptive_max_pool1d/2d/3d``), even and uneven bins, ties inside the
  max windows, ``return_mask``: outputs and gradients within 1e-6;
- ``ops.math`` ``mean``/``max``: a tie's gradient split evenly, pinned
  exactly (``[0.25] * 4``), as ``jnp.max``'s; ``concat``/``stack``/
  ``reshape``/``transpose`` cast to bf16 under O2 as JAX's gray ops do;
  ``sigmoid``, ``silu``, ``softplus`` (both sides of its threshold) and
  ``relu6`` (at 0 and 6): outputs and gradients within 1e-6;
- ``binary_cross_entropy_with_logits`` (``weight``, ``pos_weight``, every
  reduction): within 1e-6 with gradients; ``nms`` with and without
  categories and scores, with ``top_k``: the same indices;
- each PP-LiteSeg block (``ConvBNReLU`` plain and depthwise, ``STDCBlock``
  at stride 1 and 2, ``STDCNet``, ``SPPM``, ``UAFM``) in train mode:
  outputs within 1e-5 of the largest, gradients within ``BLOCK_GRAD_TOL``;
- ``pp_liteseg(num_classes=4, base=16)`` at ``bench.py``'s CPU size (2 ×
  3 × 64², see ``HW``): logits within ``DEEP_TOL`` of the largest, the
  per-pixel loss within 1e-5; its train-mode gradients, ill-conditioned
  in f32 in both packages, each within ``GRAD64_TOL`` of the tensor's
  largest float64 gradient, its eval-mode gradients within 1e-4 of JAX's;
  3 ``TrainStep`` steps of ``Momentum(0.01, 0.9)`` against the JAX
  ``TrainStep``: losses within 1e-4 relative, parameters and running
  stats within 1e-3 of each tensor's largest, then eval logits within
  ``EVAL_TOL``;
- the O2 bf16 path: the dtype of every stage of an STDC block's depthwise
  ``down`` and of UAFM equals JAX's (channel means f32, channel max,
  resize, ``concat`` and blend bf16), and one O2 step's loss within one
  bf16 step of JAX's and its running stats within 2^-6 relative;
- state-dict keys and layouts line up with JAX's, BatchNorm buffers
  included;
- PP-YOLOE (``num_classes=3, base=8`` at 2 × 3 × 64²): per-scale outputs
  and ``decode`` within 1e-4 of the largest, ``postprocess`` the same
  kept classes and boxes within 1e-4, ``loss`` within 1e-5, its
  train-mode gradients within ``YOLO_GRAD_TOL`` of JAX's and of float64,
  and its eval-mode gradients within ``YOLO_GRAD_TOL`` of JAX's;
- the constructors raise on a host without CUDA unless asked for the CPU.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

import jax
import jax.numpy as jnp
from jax._src.image import scale as jax_scale

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.nn.functional import pooling as jax_pooling
from paddle_tpu.ops import manipulation as jman
from paddle_tpu.ops import math as jmath
from paddle_tpu.vision import ops as jax_vops
from paddle_tpu.vision.models import segdet as jax_segdet
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional.common import resize_weights
from paddle_tpu_torch.ops import manipulation as pman
from paddle_tpu_torch.ops import math as pmath
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import ops as vops
from paddle_tpu_torch.vision.models import segdet

# bench.py's CPU smoke: pp_liteseg(num_classes=4, base=16) at 2 x 3 x 64^2.
# Its 1/32 feature is 2x2, so SPPM's bin-1 BatchNorm normalizes 2 values a
# channel; the forward still agrees to 4e-5 of the largest logit (measured)
B, HW, CLASSES, BASE = 2, 64, 4, 16
DEEP_TOL = 2e-4
# train-mode gradients against float64: the port's f32 gradients sit up to
# 8.4e-3, JAX's up to 1.4e-2, of each tensor's largest float64 gradient
# (measured; the STDC stages' BatchNorm weights, sums of near-cancelling
# terms)
GRAD64_TOL = 0.05
BLOCK_GRAD_TOL = 1e-4
# PP-YOLOE (num_classes=3, base=8 at 2 x 3 x 64^2) is well conditioned:
# train-mode gradients, port against JAX, within 5.1e-6 of each tensor's
# largest (port against float64 3.3e-6, JAX against float64 4.7e-6);
# eval-mode port against JAX 9.5e-7 (measured)
YOLO_GRAD_TOL = 1e-4
# eval logits after 3 training steps, whose running stats agree to 1e-3:
# within this share of the largest logit (2.8e-4 measured)
EVAL_TOL = 1e-3


def _np(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _close_to(got, want, rel, what):
    """``got`` within ``rel`` times ``want``'s largest magnitude (or
    ``rel`` where that is below 1)."""
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _jax_state(model):
    return {k: np.array(v.numpy(), copy=True)
            for k, v in model.state_dict().items()}


def _jax_grads(ref, model):
    """``ref``'s parameter gradients in ``model``'s names and layouts."""
    return segdet.port_state_from_jax(model, {
        **{n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()},
        **{n: b.numpy() for n, b in model.named_buffers()}})


def _port_of(ref, ctor):
    """The port's model made by ``ctor(device="cpu")`` with ``ref``'s
    weights."""
    model = ctor(device="cpu")
    segdet.load_jax_state(model, _jax_state(ref))
    return model


# ------------------------------------------------------------- interpolate

INTERP_CASES = {
    "bilinear-up": ((2, 3, 5, 7), dict(size=[10, 14], mode="bilinear")),
    "bilinear-down": ((2, 3, 8, 7), dict(size=[4, 5], mode="bilinear")),
    "bilinear-4to2": ((1, 2, 4, 4), dict(size=[2, 2], mode="bilinear")),
    "bilinear-mixed": ((2, 3, 4, 9), dict(size=[7, 5], mode="bilinear")),
    "bilinear-one-axis": ((2, 3, 6, 5), dict(size=[6, 11], mode="bilinear")),
    "bilinear-from-1x1": ((2, 3, 1, 1), dict(size=[4, 4], mode="bilinear")),
    "bilinear-scale": ((2, 3, 5, 6), dict(scale_factor=1.5,
                                          mode="bilinear")),
    "bilinear-nhwc": ((2, 5, 7, 3), dict(size=[9, 4], mode="bilinear",
                                         data_format="NHWC")),
    "align-up": ((2, 3, 5, 7), dict(size=[9, 12], mode="bilinear",
                                    align_corners=True)),
    "align-down": ((2, 3, 9, 7), dict(size=[4, 3], mode="bilinear",
                                      align_corners=True)),
    "align-same": ((2, 3, 6, 6), dict(size=[6, 6], mode="bilinear",
                                      align_corners=True)),
    "linear-up": ((2, 3, 9), dict(size=[13], mode="linear",
                                  data_format="NCW")),
    "linear-down": ((2, 3, 9), dict(size=[5], mode="linear",
                                    data_format="NCW")),
    "trilinear": ((1, 2, 3, 6, 5), dict(size=[5, 3, 7], mode="trilinear",
                                        data_format="NCDHW")),
    "trilinear-align": ((1, 2, 3, 6, 5), dict(size=[5, 3, 7],
                                              mode="trilinear",
                                              align_corners=True,
                                              data_format="NCDHW")),
    "bicubic-up": ((2, 3, 5, 6), dict(size=[9, 13], mode="bicubic")),
    "bicubic-down": ((2, 3, 11, 9), dict(size=[5, 4], mode="bicubic")),
    "area-down": ((2, 3, 8, 9), dict(size=[3, 4], mode="area")),
    "nearest-up": ((2, 3, 5, 7), dict(size=[11, 9], mode="nearest")),
    "nearest-down": ((2, 3, 9, 7), dict(size=[4, 5], mode="nearest")),
    "nearest-1d": ((2, 3, 7), dict(size=[10], mode="nearest",
                                   data_format="NCW")),
    "nearest-3d": ((1, 2, 3, 4, 5), dict(scale_factor=2, mode="nearest",
                                         data_format="NCDHW")),
}


def _interp_pair(shape, kw, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    want = JF.interpolate(jx, **kw)
    g = rs.randn(*want.shape).astype(np.float32)
    (want * paddle.to_tensor(g)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    got = F.interpolate(tx, **kw)
    (got * torch.from_numpy(g)).sum().backward()
    return x, (want, jx.grad), (got, tx.grad)


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_matches_jax(case):
    shape, kw = INTERP_CASES[case]
    _, (want, jgrad), (got, tgrad) = _interp_pair(shape, kw)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), _np(jgrad), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("case", ["bilinear-down", "bilinear-4to2",
                                  "bicubic-up"])
def test_torch_interpolate_misses_jax_where_the_port_does_not(case):
    """torch's bilinear does not antialias when it shrinks, and its
    bicubic kernel has a = -0.75 where ``jax.image``'s has -0.5."""
    shape, kw = INTERP_CASES[case]
    x, (want, _), (got, _) = _interp_pair(shape, kw)
    plain = TF.interpolate(torch.from_numpy(x), size=kw["size"],
                           mode=kw["mode"], align_corners=False)
    assert np.abs(plain.numpy() - _np(want)).max() > 0.05
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("isz,osz", [(1, 16), (2, 16), (4, 16), (16, 32),
                                     (32, 64), (64, 512), (4, 2), (7, 5),
                                     (5, 7), (16, 5), (10, 3)])
@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_resize_weights_are_jax_weight_matrices(isz, osz, method):
    kernel = {"linear": jax_scale._fill_triangle_kernel,
              "cubic": jax_scale._fill_keys_cubic_kernel}[method]
    want = np.asarray(jax.jit(lambda: jax_scale.compute_weight_mat(
        isz, osz, jnp.float32(osz / isz), jnp.float32(0.0), kernel,
        True))())
    got = resize_weights(isz, osz, method).numpy()
    if osz % isz == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-7)


@pytest.mark.parametrize("case", sorted(INTERP_CASES))
def test_interpolate_bf16_is_jax_bit_for_bit(case):
    """In bf16 each axis's product rounds to bf16, so the order of the axes
    shows in the bits: the port contracts them in the order JAX's einsum
    path takes (``bilinear-mixed``: the cheaper one first) and matches JAX
    bit for bit, where the other order differs in about a third of the
    elements."""
    shape, kw = INTERP_CASES[case]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = _np(JF.interpolate(paddle.to_tensor(x).astype("bfloat16"), **kw))
    got = F.interpolate(torch.from_numpy(x).bfloat16(), **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_interpolate_backward_is_a_product_repeatable_bit_for_bit():
    x = torch.randn(2, 19, 16, 16, requires_grad=True)
    g = torch.randn(2, 19, 128, 128)
    grads = []
    for _ in range(2):
        x.grad = None
        F.interpolate(x, size=[128, 128], mode="bilinear").backward(g)
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])


# ------------------------------------------------------------------- pools

ADAPTIVE_CASES = {
    "avg1d-even": ("adaptive_avg_pool1d", (2, 3, 12), 4, {}),
    "avg1d-uneven": ("adaptive_avg_pool1d", (2, 3, 10), 4, {}),
    "avg2d-uneven": ("adaptive_avg_pool2d", (2, 3, 7, 9), (3, 4), {}),
    "avg2d-nhwc": ("adaptive_avg_pool2d", (2, 6, 8, 3), (3, 4),
                   dict(data_format="NHWC")),
    "avg3d-mixed": ("adaptive_avg_pool3d", (1, 2, 4, 6, 5), (2, 3, 2), {}),
    "max1d-even": ("adaptive_max_pool1d", (2, 3, 12), 4, {}),
    "max1d-uneven": ("adaptive_max_pool1d", (2, 3, 10), 4, {}),
    "max2d-even": ("adaptive_max_pool2d", (2, 3, 8, 6), (4, 3), {}),
    "max2d-uneven": ("adaptive_max_pool2d", (2, 3, 7, 9), (3, 4), {}),
    "max2d-mask": ("adaptive_max_pool2d", (2, 3, 8, 6), (2, 3),
                   dict(return_mask=True)),
    "max3d-mixed": ("adaptive_max_pool3d", (1, 2, 4, 6, 5), (2, 3, 2), {}),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE_CASES))
def test_adaptive_pool_matches_jax(case):
    fn, shape, size, kw = ADAPTIVE_CASES[case]
    rs = np.random.RandomState(2)
    # few distinct values, so the max windows hold ties
    x = rs.randint(-3, 4, shape).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    want = getattr(jax_pooling, fn)(jx, size, **kw)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = getattr(F, fn)(tx, size, **kw)
    if kw.get("return_mask"):
        assert want[1] is None and got[1] is None
        want, got = want[0], got[0]
    g = rs.randn(*want.shape).astype(np.float32)
    (want * paddle.to_tensor(g)).sum().backward()
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-6,
                               atol=1e-6)


def test_adaptive_pool_layers():
    x = torch.randn(2, 3, 8, 6)
    out, mask = nn.AdaptiveMaxPool2D((2, 3), return_mask=True)(x)
    assert mask is None
    assert torch.equal(out, F.adaptive_max_pool2d(x, (2, 3)))
    assert torch.equal(nn.AdaptiveAvgPool1D(3)(x[:, :, 0]),
                       F.adaptive_avg_pool1d(x[:, :, 0], 3))


# ------------------------------------------------------------ ops and loss

def test_max_splits_a_tie_gradient_evenly_and_mean_matches_jax():
    x = np.array([[1.0, 1.0, 1.0, 1.0], [0.0, 2.0, 2.0, -1.0]], np.float32)
    for fn_j, fn_t, want in ((jmath.max, pmath.max,
                              [[0.25] * 4, [0.0, 0.5, 0.5, 0.0]]),
                             (jmath.mean, pmath.mean, [[0.25] * 4] * 2)):
        jx = paddle.to_tensor(x, stop_gradient=False)
        fn_j(jx, axis=1, keepdim=True).sum().backward()
        tx = torch.from_numpy(x).requires_grad_(True)
        out = fn_t(tx, axis=1, keepdim=True)
        assert tuple(out.shape) == (2, 1)
        out.sum().backward()
        np.testing.assert_array_equal(_np(jx.grad), np.array(want, np.float32))
        np.testing.assert_array_equal(tx.grad.numpy(), _np(jx.grad))
    # torch.max(dim) would send the whole gradient to one index
    tx = torch.from_numpy(x).requires_grad_(True)
    tx.max(dim=1).values.sum().backward()
    assert tx.grad[0].tolist() == [1.0, 0.0, 0.0, 0.0]
    # all axes, and a list of axes
    y = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    for axis, keep in ((None, False), (None, True), ([0, 2], False)):
        for fn_j, fn_t in ((jmath.max, pmath.max), (jmath.mean, pmath.mean)):
            want = _np(fn_j(paddle.to_tensor(y), axis=axis, keepdim=keep))
            got = fn_t(torch.from_numpy(y), axis=axis, keepdim=keep).numpy()
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_o2_op_classes_of_the_manipulations_and_reductions():
    f = torch.randn(2, 3, 4)
    h = f.bfloat16()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        assert pman.concat([f, h], 1).dtype == torch.bfloat16
        assert pman.stack([f, f], 0).dtype == torch.bfloat16
        assert pman.reshape(f, [6, 4]).dtype == torch.bfloat16
        assert pman.transpose(f, [2, 0, 1]).dtype == torch.bfloat16
        assert pmath.mean(h, axis=1).dtype == torch.float32
        assert pmath.max(f, axis=1).dtype == torch.bfloat16
        assert pmath.subtract(1, h).dtype == torch.bfloat16
        assert pmath.multiply(f, h).dtype == torch.bfloat16
    assert pman.concat([f, h], 1).dtype == torch.float32  # torch's promotion
    assert pman.transpose(f, [2, 0, 1]).shape == (4, 2, 3)
    x = np.random.RandomState(4).randn(2, 3, 4).astype(np.float32)
    for axis in (0, 1, -1):
        want = _np(jman.concat([paddle.to_tensor(x)] * 2, axis))
        got = pman.concat([torch.from_numpy(x)] * 2, axis).numpy()
        np.testing.assert_array_equal(got, want)
        want = _np(jman.stack([paddle.to_tensor(x)] * 2, axis))
        got = pman.stack([torch.from_numpy(x)] * 2, axis).numpy()
        np.testing.assert_array_equal(got, want)


ACT_CASES = {
    "sigmoid": ("sigmoid", {}),
    "silu": ("silu", {}),
    "softplus": ("softplus", {}),
    "softplus-beta-threshold": ("softplus", dict(beta=2.0, threshold=3.0)),
    "relu6": ("relu6", {}),
}


@pytest.mark.parametrize("case", sorted(ACT_CASES))
def test_activation_matches_jax(case):
    fn, kw = ACT_CASES[case]
    x = np.random.RandomState(5).randn(4, 33).astype(np.float32) * 4
    x[0, :4] = [0.0, 6.0, -6.0, 1.5]  # relu6's corners, softplus's select
    jx = paddle.to_tensor(x, stop_gradient=False)
    want = getattr(JF, fn)(jx, **kw)
    want.sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    got = getattr(F, fn)(tx, **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-6,
                               atol=1e-6)


def test_activation_layers():
    x = torch.randn(3, 5)
    assert torch.equal(nn.Sigmoid()(x), torch.sigmoid(x))
    assert nn.SiLU is nn.Silu and torch.equal(nn.Silu()(x), TF.silu(x))
    assert torch.equal(nn.ReLU6()(x * 10), TF.relu6(x * 10))
    assert torch.equal(nn.Softplus(2.0, 3.0)(x), F.softplus(x, 2.0, 3.0))


BCE_CASES = {
    "mean": {}, "sum": dict(reduction="sum"), "none": dict(reduction="none"),
    "weight": dict(weight=True), "pos_weight": dict(pos_weight=True),
    "both-sum": dict(weight=True, pos_weight=True, reduction="sum"),
}


@pytest.mark.parametrize("case", sorted(BCE_CASES))
def test_bce_with_logits_matches_jax(case):
    kw = dict(BCE_CASES[case])
    rs = np.random.RandomState(6)
    z = rs.randn(4, 7).astype(np.float32) * 3
    z[0, 0] = 0.0
    y = (rs.rand(4, 7) > 0.5).astype(np.float32)
    extra = {}
    for k in ("weight", "pos_weight"):
        if kw.pop(k, False):
            extra[k] = rs.rand(7).astype(np.float32) + 0.5
    jz = paddle.to_tensor(z, stop_gradient=False)
    want = JF.binary_cross_entropy_with_logits(
        jz, paddle.to_tensor(y),
        **{k: paddle.to_tensor(v) for k, v in extra.items()}, **kw)
    want.sum().backward()
    tz = torch.from_numpy(z).requires_grad_(True)
    got = F.binary_cross_entropy_with_logits(
        tz, torch.from_numpy(y),
        **{k: torch.from_numpy(v) for k, v in extra.items()}, **kw)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tz.grad.numpy(), _np(jz.grad), rtol=1e-6,
                               atol=1e-6)


def _boxes(n, seed):
    rs = np.random.RandomState(seed)
    xy = rs.rand(n, 2).astype(np.float32) * 40
    wh = rs.rand(n, 2).astype(np.float32) * 20 + 4
    return (np.concatenate([xy, xy + wh], 1), rs.rand(n).astype(np.float32),
            rs.randint(0, 3, (n,)).astype(np.int64))


@pytest.mark.parametrize("mode", ["scores", "categories", "no-scores",
                                  "top-k"])
def test_nms_matches_jax(mode):
    boxes, scores, cats = _boxes(40, 7)
    kw = dict(iou_threshold=0.3)
    jkw, tkw = {}, {}
    if mode != "no-scores":
        jkw["scores"] = paddle.to_tensor(scores)
        tkw["scores"] = torch.from_numpy(scores)
    if mode in ("categories", "top-k"):
        jkw["category_idxs"] = paddle.to_tensor(cats)
        tkw["category_idxs"] = torch.from_numpy(cats)
        jkw["categories"] = tkw["categories"] = [0, 1, 2]
    if mode == "top-k":
        jkw["top_k"] = tkw["top_k"] = 5
    want = np.asarray(jax_vops.nms(paddle.to_tensor(boxes), **kw,
                                   **jkw).numpy())
    got = vops.nms(torch.from_numpy(boxes), **kw, **tkw)
    assert got.dtype == torch.int64
    assert 1 < len(want) < 40
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------- PP-LiteSeg blocks

BLOCK_CASES = {
    "convbnrelu": (lambda m: m.ConvBNReLU(6, 8, k=3, stride=2),
                   [(2, 6, 12, 12)]),
    "convbn-depthwise": (lambda m: m.ConvBNReLU(8, 8, k=3, stride=2,
                                                groups=8, act=False),
                         [(2, 8, 12, 12)]),
    "stdc-stride1": (lambda m: m.STDCBlock(8, 16, stride=1),
                     [(2, 8, 10, 10)]),
    "stdc-stride2": (lambda m: m.STDCBlock(8, 16, stride=2),
                     [(2, 8, 12, 12)]),
    "stdcnet": (lambda m: m.STDCNet(8), [(2, 3, 64, 64)]),
    "sppm": (lambda m: m.SPPM(32, 16, 16), [(2, 32, 8, 8)]),
    "uafm": (lambda m: m.UAFM(12, 10, 8), [(2, 12, 16, 16),
                                            (2, 10, 8, 8)]),
}


class _OnCPU:
    """``segdet`` with every block built on the CPU."""

    def __getattr__(self, name):
        cls = getattr(segdet, name)
        return lambda *a, **k: cls(*a, device="cpu", **k)


def _block_pair(case):
    make, shapes = BLOCK_CASES[case]
    paddle.seed(0)
    ref = make(jax_segdet)
    model = make(_OnCPU())
    segdet.load_jax_state(model, _jax_state(ref))
    return ref, model, shapes


def _flat_outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_liteseg_block_matches_jax(case):
    ref, model, shapes = _block_pair(case)
    rs = np.random.RandomState(8)
    xs = [rs.randn(*s).astype(np.float32) for s in shapes]
    jxs = [paddle.to_tensor(x, stop_gradient=False) for x in xs]
    txs = [torch.from_numpy(x).requires_grad_(True) for x in xs]
    want = _flat_outputs(ref(*jxs))
    got = _flat_outputs(model(*txs))
    gs = [rs.randn(*w.shape).astype(np.float32) for w in want]
    sum((w * paddle.to_tensor(g)).sum() for w, g in zip(want, gs)).backward()
    sum((t * torch.from_numpy(g)).sum() for t, g in zip(got, gs)).backward()
    for w, t in zip(want, got):
        _close_to(t.detach().numpy(), _np(w), 1e-5, f"{case} output")
    for jx, tx in zip(jxs, txs):
        _close_to(tx.grad.numpy(), _np(jx.grad), BLOCK_GRAD_TOL,
                  f"{case} input gradient")
    jgrads = segdet.port_state_from_jax(model, {
        **{n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()},
        **{n: b.numpy() for n, b in model.named_buffers()}})
    for name, p in model.named_parameters():
        _close_to(p.grad.numpy(), jgrads[name].numpy(), BLOCK_GRAD_TOL,
                  f"{case} {name}")
    # the running stats after the one training call
    want_state = _jax_state(ref)
    for name, buf in model.named_buffers():
        _close_to(buf.numpy(), want_state[name], 1e-6, f"{case} {name}")


# -------------------------------------------------------------- PP-LiteSeg

def _liteseg_pair():
    paddle.seed(0)
    ref = jax_segdet.pp_liteseg(num_classes=CLASSES, base=BASE)
    model = _port_of(ref, lambda **k: segdet.pp_liteseg(
        num_classes=CLASSES, base=BASE, **k))
    return ref, model


def _batch(seed=0):
    """One batch drawn as ``bench.py:1452-1456`` draws it."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 3, HW, HW).astype(np.float32)
    y = rs.randint(0, CLASSES, (B, HW, HW)).astype(np.int64)
    return x, y


def _jax_loss(logits, y):
    flat = jman.reshape(jman.transpose(logits, [0, 2, 3, 1]), [-1, CLASSES])
    return paddle.nn.CrossEntropyLoss()(flat, jman.reshape(y, [-1]))


def _port_loss(logits, y):
    flat = pman.reshape(pman.transpose(logits, [0, 2, 3, 1]), [-1, CLASSES])
    return nn.CrossEntropyLoss()(flat, pman.reshape(y, [-1]))


def _forward_backward(ref, model, x, y):
    jlogits = ref(paddle.to_tensor(x))
    jloss = _jax_loss(jlogits, paddle.to_tensor(y))
    jloss.backward()
    logits = model(torch.from_numpy(x))
    loss = _port_loss(logits, torch.from_numpy(y))
    loss.backward()
    return (_np(jlogits), float(_np(jloss)), _jax_grads(ref, model)), (
        logits.detach().numpy(), float(loss.detach()))


def test_pp_liteseg_logits_loss_and_gradients_match_jax():
    """The train-mode backward is ill-conditioned in f32 in both packages
    (see ``GRAD64_TOL``): each gradient is held within ``GRAD64_TOL`` of
    the float64 gradient; in eval mode (BatchNorm an affine map) within
    1e-4 of JAX's."""
    x, y = _batch()
    ref, model = _liteseg_pair()
    exact = segdet.pp_liteseg(num_classes=CLASSES, base=BASE, device="cpu")
    exact.load_state_dict(model.state_dict())
    exact.to(torch.float64)
    _port_loss(exact(torch.from_numpy(x).double()),
               torch.from_numpy(y)).backward()
    g64 = {n: p.grad.float().numpy() for n, p in exact.named_parameters()}
    (jlogits, jloss, jgrads), (logits, loss) = _forward_backward(
        ref, model, x, y)
    _close_to(logits, jlogits, DEEP_TOL, "logits")
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    for name, p in model.named_parameters():
        _close_to(p.grad.numpy(), g64[name], GRAD64_TOL, name)
        _close_to(jgrads[name].numpy(), g64[name], GRAD64_TOL, name)
    ref.eval()
    model.eval()
    for p in ref.parameters():
        p.clear_grad()
    model.zero_grad()
    (jlogits, jloss, jgrads), (logits, loss) = _forward_backward(
        ref, model, x, y)
    _close_to(logits, jlogits, 1e-5, "eval logits")
    for name, p in model.named_parameters():
        _close_to(p.grad.numpy(), jgrads[name].numpy(), 1e-4, name)


def test_pp_liteseg_momentum_train_steps_and_eval_match_jax():
    x, y = _batch(1)
    ref, model = _liteseg_pair()
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=ref.parameters())
    jstep = JaxTrainStep(model=ref, optimizer=jopt,
                         loss_fn=lambda a, b: _jax_loss(ref(a), b))
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters(), device="cpu")
    step = TrainStep(model=model, optimizer=opt,
                     loss_fn=lambda a, b: _port_loss(model(a), b),
                     device="cpu")
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    want = [float(_np(jstep(jx, jy))) for _ in range(3)]
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    jstate = _jax_state(ref)
    for name, t in segdet.jax_state_dict(model).items():
        _close_to(t.numpy(), jstate[name], 1e-3, name)
    ref.eval()
    model.eval()
    xe, _ = _batch(2)
    with torch.no_grad():
        logits = model(torch.from_numpy(xe)).numpy()
    _close_to(logits, _np(ref(paddle.to_tensor(xe))), EVAL_TOL,
              "eval logits")


def test_state_dict_keys_and_layouts_line_up_with_jax():
    ref, model = _liteseg_pair()
    jstate = ref.state_dict()
    assert sorted(model.state_dict()) == sorted(jstate)
    assert len(jstate) == 131
    assert "sppm.reduces.2.bn._variance" in jstate
    assert tuple(model.backbone.stage3.down.conv.weight.shape) == (
        BASE * 2, 1, 3, 3)  # depthwise
    back = segdet.jax_state_dict(model)
    for k, v in jstate.items():
        np.testing.assert_array_equal(back[k].numpy(), _np(v), err_msg=k)
    with pytest.raises(NotImplementedError, match="LayerList"):
        model.sppm.reduces(torch.zeros(1))


# ------------------------------------------------------------------- O2

def _dtype(t):
    return str(t.dtype).split(".")[-1]


def _o2_dtypes(blk, uafm, x, skip, deep, ops):
    """The dtype after each stage of an STDC block's depthwise ``down``
    and its ``concat``, and of UAFM, under O2."""
    concat, pmean, pmax, interp, sigmoid, mul, sub, add = ops
    seq = []

    def rec(t):
        seq.append(_dtype(t))
        return t

    x1 = rec(blk.conv1(x))
    x1d = rec(blk.down(x1))
    x2 = rec(blk.conv2(x1d))
    rec(concat([x1d, x2, rec(blk.conv3(x2))], 1))
    s = rec(uafm.proj_skip(skip))
    d = rec(uafm.proj_up(deep))
    d = rec(interp(d, size=[s.shape[2], s.shape[3]], mode="bilinear",
                   align_corners=False))
    feats = []
    for t in (s, d):
        feats.append(rec(pmean(t, axis=1, keepdim=True)))
        feats.append(rec(pmax(t, axis=1, keepdim=True)))
    alpha = rec(sigmoid(uafm.attn(rec(concat(feats, 1)))))
    rec(add(mul(s, alpha), mul(d, rec(sub(1, alpha)))))
    return seq


def test_o2_bf16_dtypes_buffers_and_step_match_jax():
    x, y = _batch(5)
    paddle.seed(0)
    ref = jax_segdet.pp_liteseg(num_classes=CLASSES, base=BASE)
    state = _jax_state(ref)
    paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
    model = segdet.pp_liteseg(num_classes=CLASSES, base=BASE, device="cpu")
    segdet.load_jax_state(model, state)
    amp.decorate(model, level="O2", dtype="bfloat16", device="cpu")
    ref.eval()
    model.eval()
    rs = np.random.RandomState(9)
    inputs = [rs.randn(*s).astype(np.float32) for s in
              ((2, BASE, 16, 16), (2, BASE * 4, 16, 16), (2, 64, 8, 8))]
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        want = _o2_dtypes(
            ref.backbone.stage3, ref.fuse8,
            *[paddle.to_tensor(a) for a in inputs],
            (jman.concat, jmath.mean, jmath.max, JF.interpolate, JF.sigmoid,
             lambda a, b: a * b, lambda a, b: a - b, lambda a, b: a + b))
    with amp.auto_cast(level="O2", dtype="bfloat16"), torch.no_grad():
        got = _o2_dtypes(
            model.backbone.stage3, model.fuse8,
            *[torch.from_numpy(a) for a in inputs],
            (pman.concat, pmath.mean, pmath.max, F.interpolate, F.sigmoid,
             pmath.multiply, pmath.subtract, pmath.add))
    assert want[1] == "float32" and want[4] == "bfloat16"  # down, concat
    assert want[7] == "bfloat16"  # the resize
    assert want[8:12] == ["float32", "bfloat16"] * 2  # mean f32, max bf16
    assert got == want
    # one training step: the buffers come back f32 in both
    ref.train()
    model.train()
    jopt = paddle.optimizer.Momentum(learning_rate=0.01, momentum=0.9,
                                     parameters=ref.parameters())
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jlogits = ref(paddle.to_tensor(x))
    jloss = _jax_loss(jlogits, paddle.to_tensor(y))
    jloss.backward()
    jopt.step()
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters(), device="cpu")

    def loss_fn(a, b):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(a)
        return _port_loss(logits, b)

    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     device="cpu")
    loss = float(step(torch.from_numpy(x), torch.from_numpy(y)))
    want_loss = float(_np(jloss))
    assert abs(loss - want_loss) <= 2.0 ** -7 * abs(want_loss)
    jstate = _jax_state(ref)
    for name, buf in model.named_buffers():
        assert _dtype(buf) == str(jstate[name].dtype) == "float32", name
        _close_to(buf.numpy(), jstate[name].astype(np.float32), 2.0 ** -6,
                  name)
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


# ---------------------------------------------------------------- PP-YOLOE

YOLO_SHAPES = [(8, 8), (4, 4), (2, 2)]


def test_pp_yoloe_forward_decode_postprocess_and_loss_match_jax():
    paddle.seed(0)
    ref = jax_segdet.pp_yoloe(num_classes=3, base=8)
    model = _port_of(ref, lambda **k: segdet.pp_yoloe(num_classes=3, base=8,
                                                      **k))
    assert sorted(model.state_dict()) == sorted(ref.state_dict())
    x = np.random.RandomState(10).randn(2, 3, 64, 64).astype(np.float32)
    jouts = ref(paddle.to_tensor(x))
    outs = model(torch.from_numpy(x))
    for (jc, jr), (c, r) in zip(jouts, outs):
        _close_to(c.detach().numpy(), _np(jc), 1e-4, "cls")
        _close_to(r.detach().numpy(), _np(jr), 1e-4, "ltrb")
    jboxes, jscores = ref.decode(jouts, YOLO_SHAPES)
    boxes, scores = model.decode(outs, YOLO_SHAPES)
    _close_to(boxes.detach().numpy(), _np(jboxes), 1e-4, "boxes")
    _close_to(scores.detach().numpy(), _np(jscores), 1e-4, "scores")
    want = ref.postprocess(jboxes, jscores, score_thresh=0.3)
    got = model.postprocess(boxes, scores, score_thresh=0.3)
    assert len(want[0]) > 1
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4 * 64)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    gt_boxes = np.array([[4.0, 6.0, 40.0, 30.0], [20.0, 24.0, 60.0, 62.0]],
                        np.float32)
    gt_classes = np.array([1, 2])
    jloss = ref.loss(jouts, YOLO_SHAPES, gt_boxes, gt_classes)
    jloss.backward()
    loss = model.loss(outs, YOLO_SHAPES, gt_boxes, gt_classes)
    loss.backward()
    assert abs(float(loss.detach()) - float(_np(jloss))) <= 1e-5 * abs(
        float(_np(jloss)))
    exact = segdet.pp_yoloe(num_classes=3, base=8, device="cpu")
    exact.load_state_dict(model.state_dict())
    exact.to(torch.float64)
    outs64 = exact(torch.from_numpy(x).double())
    exact.loss(outs64, YOLO_SHAPES, gt_boxes, gt_classes).backward()
    grads64 = {n: p.grad.float().numpy() for n, p in exact.named_parameters()}
    jgrads = _jax_grads(ref, model)
    for name, p in model.named_parameters():
        _close_to(p.grad.numpy(), jgrads[name].numpy(), YOLO_GRAD_TOL, name)
        _close_to(p.grad.numpy(), grads64[name], YOLO_GRAD_TOL, name)
        _close_to(jgrads[name].numpy(), grads64[name], YOLO_GRAD_TOL, name)
    # eval mode: the BatchNorms an affine map of the running stats
    ref.eval()
    model.eval()
    for p in ref.parameters():
        p.clear_grad()
    model.zero_grad()
    ref.loss(ref(paddle.to_tensor(x)), YOLO_SHAPES, gt_boxes,
             gt_classes).backward()
    model.loss(model(torch.from_numpy(x)), YOLO_SHAPES, gt_boxes,
               gt_classes).backward()
    jgrads = _jax_grads(ref, model)
    for name, p in model.named_parameters():
        _close_to(p.grad.numpy(), jgrads[name].numpy(), YOLO_GRAD_TOL, name)


# ------------------------------------------------------------ no fallback

def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the defaults would not raise")
    for ctor in (segdet.pp_liteseg, segdet.pp_yoloe,
                 lambda: segdet.ConvBNReLU(3, 4),
                 lambda: segdet.UAFM(4, 4, 4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctor()
