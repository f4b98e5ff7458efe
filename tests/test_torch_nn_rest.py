"""The rest of ``nn`` against the JAX package on the CPU (f32 within 1e-5
relative): ``normalize``, ``cosine_similarity``, ``bilinear``, the pixel
and channel shuffles, ``unfold``/``fold``, ``local_response_norm``, the
1-D/2-D/3-D pools and their layers, ``return_mask`` (JAX's placeholder
zeros pinned, the port's indices gathering the pooled values), the pads,
upsamplers and the other new layers. The dropouts draw from other streams
than JAX's, so their keep rate and scaling are held instead: ``axis``,
``downscale_in_infer``, ``dropout2d/3d`` and ``alpha_dropout``."""
import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn.functional as F
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import nn
from paddle_tpu_torch.models.gpt import load_jax_state

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x.numpy())


def _both(name, arrays, *args, **kw):
    got = getattr(F, name)(*[torch.from_numpy(a) for a in arrays], *args,
                           **kw)
    want = getattr(JF, name)(*[jp.to_tensor(a) for a in arrays], *args,
                             **kw)
    return got, want


rs0 = np.random.RandomState(0)
X4 = rs0.randn(2, 8, 6, 6).astype(np.float32)
FUNCS = [
    ("normalize", [X4], dict(p=2, axis=1)),
    ("normalize", [X4], dict(p=1.5, axis=-1, epsilon=1e-3)),
    ("cosine_similarity", [X4, X4[::-1].copy()], dict(axis=1)),
    ("bilinear", [X4[:, :, 0, 0].copy(), X4[:, :4, 1, 1].copy(),
                  rs0.randn(3, 8, 4).astype(np.float32),
                  rs0.randn(3).astype(np.float32)], {}),
    ("pixel_shuffle", [X4], dict(upscale_factor=2)),
    ("pixel_shuffle", [X4.transpose(0, 2, 3, 1).copy()],
     dict(upscale_factor=2, data_format="NHWC")),
    ("pixel_unshuffle", [X4], dict(downscale_factor=3)),
    ("pixel_unshuffle", [X4.transpose(0, 2, 3, 1).copy()],
     dict(downscale_factor=2, data_format="NHWC")),
    ("channel_shuffle", [X4], dict(groups=4)),
    ("channel_shuffle", [X4.transpose(0, 2, 3, 1).copy()],
     dict(groups=2, data_format="NHWC")),
    ("unfold", [X4], dict(kernel_sizes=3, strides=2, paddings=1)),
    ("unfold", [X4], dict(kernel_sizes=[2, 3], strides=1,
                          paddings=[1, 0, 0, 2], dilations=[1, 2])),
    ("fold", [rs0.randn(2, 8 * 4, 25).astype(np.float32)],
     dict(output_sizes=[6, 6], kernel_sizes=2, strides=1)),
    ("fold", [rs0.randn(2, 3 * 9, 9).astype(np.float32)],
     dict(output_sizes=[5, 5], kernel_sizes=3, strides=2, paddings=1)),
    ("local_response_norm", [X4], dict(size=5)),
    ("local_response_norm", [X4.transpose(0, 2, 3, 1).copy()],
     dict(size=4, alpha=1e-2, beta=0.5, k=2.0, data_format="NHWC")),
]


@pytest.mark.parametrize("case", range(len(FUNCS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(FUNCS)])
def test_functions_match_jax(case):
    name, arrays, kw = FUNCS[case]
    got, want = _both(name, arrays, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


POOLS = [
    # name, input shape, args, kwargs
    ("max_pool1d", (2, 3, 11), (3, 2, 1), {}),
    ("max_pool1d", (2, 11, 3), (4,), dict(padding="SAME", data_format="NLC")),
    ("avg_pool1d", (2, 3, 11), (3, 2, 1), {}),
    ("avg_pool1d", (2, 3, 11), (3, 2, 1), dict(exclusive=False,
                                               ceil_mode=True)),
    ("max_pool2d", (2, 3, 9, 8), (3, 2, [0, 2, 1, 0]), dict(ceil_mode=True)),
    ("avg_pool2d", (2, 3, 9, 8), (3, 2, 1), dict(divisor_override=4)),
    ("max_pool3d", (1, 2, 5, 6, 7), (3, 2, 1), {}),
    ("max_pool3d", (1, 5, 6, 7, 2), (2,), dict(data_format="NDHWC")),
    ("avg_pool3d", (1, 2, 5, 6, 7), ((2, 3, 2), 2, 1), {}),
    ("avg_pool3d", (1, 2, 5, 6, 7), (2, 1, "SAME"), dict(exclusive=False)),
]


@pytest.mark.parametrize("case", range(len(POOLS)),
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(POOLS)])
def test_pools_match_jax(case):
    name, shape, args, kw = POOLS[case]
    x = np.random.RandomState(case).randn(*shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    xj = jp.to_tensor(x, stop_gradient=False)
    got = getattr(F, name)(xt, *args, **kw)
    want = getattr(JF, name)(xj, *args, **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    got.sum().backward()
    want.sum().backward()
    np.testing.assert_allclose(_np(xt.grad), _np(xj.grad), **TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_return_mask_indexes_the_maxima(n):
    """JAX returns placeholder zeros; the port's mask is the flat spatial
    index of each window's first maximum in the unpadded input."""
    shape = (2, 3) + (7, 6, 5)[:n]
    x = np.random.RandomState(n).randn(*shape).astype(np.float32)
    x[0, 0].flat[:4] = 9.0  # a tie in the first window: the first wins
    name = f"max_pool{n}d"
    for args in ((3, 2, 1), (2, 2, [1, 0] * n)):
        out, mask = getattr(F, name)(torch.from_numpy(x), *args,
                                     return_mask=True)
        jout, jmask = getattr(JF, name)(jp.to_tensor(x), *args,
                                        return_mask=True)
        np.testing.assert_allclose(_np(out), _np(jout), **TOL)
        assert (_np(jmask) == 0).all()
        assert mask.dtype == torch.int64 and mask.shape == out.shape
        flat = torch.from_numpy(x).flatten(2)
        assert torch.equal(flat.gather(2, mask.flatten(2)).view_as(out), out)
    assert int(mask[0, 0].flatten()[0]) == 0
    layer = getattr(nn, f"MaxPool{n}D")(3, 2, 1, return_mask=True)
    assert torch.equal(layer(torch.from_numpy(x))[1],
                       getattr(F, name)(torch.from_numpy(x), 3, 2, 1,
                                        return_mask=True)[1])


LAYERS = [
    # name, args, kwargs, input
    ("MaxPool1D", (3, 2), {}, (2, 3, 9)),
    ("AvgPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("MaxPool3D", (2,), {}, (1, 2, 4, 4, 4)),
    ("AvgPool3D", (2, 2, 1), {}, (1, 2, 4, 4, 4)),
    ("Pad1D", ([1, 2],), dict(mode="reflect"), (2, 3, 5)),
    ("Pad2D", ([1, 0, 2, 1],), dict(value=0.5), (2, 3, 4, 5)),
    ("Pad3D", ([1, 1, 0, 1, 2, 0],), dict(mode="replicate"), (1, 2, 3, 4, 3)),
    ("ZeroPad2D", ([1, 1, 2, 0],), {}, (2, 3, 4, 5)),
    ("Upsample", (), dict(scale_factor=2, mode="bilinear"), (1, 2, 3, 4)),
    ("UpsamplingNearest2D", (), dict(size=[5, 7]), (1, 2, 3, 4)),
    ("UpsamplingBilinear2D", (), dict(scale_factor=2), (1, 2, 3, 4)),
    ("PixelShuffle", (2,), {}, (1, 8, 3, 3)),
    ("PixelUnshuffle", (2,), {}, (1, 2, 4, 6)),
    ("ChannelShuffle", (2,), {}, (1, 6, 2, 2)),
    ("Unfold", (2,), dict(strides=2), (1, 2, 4, 4)),
    ("LocalResponseNorm", (3,), {}, (2, 5, 3, 3)),
]


@pytest.mark.parametrize("case", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
def test_layers_match_jax(case):
    name, args, kw, shape = LAYERS[case]
    x = np.random.RandomState(case).randn(*shape).astype(np.float32)
    got = getattr(nn, name)(*args, **kw)(torch.from_numpy(x))
    want = getattr(jnn, name)(*args, **kw)(jp.to_tensor(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_parameter_layers_match_jax():
    rs = np.random.RandomState(9)
    a, b = rs.randn(4, 3).astype(np.float32), rs.randn(4, 5).astype(
        np.float32)
    jp.seed(1)
    jl = jnn.Bilinear(3, 5, 2)
    pl = nn.Bilinear(3, 5, 2, device="cpu")
    load_jax_state(pl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    np.testing.assert_allclose(
        _np(pl(torch.from_numpy(a), torch.from_numpy(b))),
        _np(jl(jp.to_tensor(a), jp.to_tensor(b))), **TOL)
    np.testing.assert_allclose(
        _np(nn.CosineSimilarity(axis=1)(torch.from_numpy(a),
                                        torch.from_numpy(a[::-1].copy()))),
        _np(jnn.CosineSimilarity(axis=1)(jp.to_tensor(a),
                                         jp.to_tensor(a[::-1].copy()))),
        **TOL)
    cols = rs.randn(1, 2 * 4, 9).astype(np.float32)
    np.testing.assert_allclose(
        _np(nn.Fold([4, 4], 2, strides=1)(torch.from_numpy(cols))),
        _np(jnn.Fold([4, 4], 2, strides=1)(jp.to_tensor(cols))), **TOL)


def _gen():
    return torch.Generator().manual_seed(0)


def test_dropout_axis_and_modes():
    """The streams differ from JAX's: the keep rate, the scaling and the
    shared mask along the other axes are held."""
    x = torch.ones(64, 32, 8)
    p = 0.25
    up = F.dropout(x, p, generator=_gen())
    assert set(up.unique().tolist()) <= {0.0, float(np.float32(1 / (1 - p)))}
    assert abs(float((up > 0).float().mean()) - (1 - p)) < 0.02
    down = F.dropout(x, p, mode="downscale_in_infer", generator=_gen())
    assert set(down.unique().tolist()) <= {0.0, 1.0}
    assert torch.equal(down > 0, up > 0)  # one generator state, one mask
    # eval: x itself in both modes, as JAX returns it
    for mode in ("upscale_in_train", "downscale_in_infer"):
        assert F.dropout(x, p, training=False, mode=mode) is x
    ax = F.dropout(x, p, axis=[0, 2], generator=_gen())
    assert torch.equal(ax, ax[:, :1].expand_as(ax))  # shared along axis 1
    layer = nn.Dropout(p, axis=1, mode="downscale_in_infer",
                       generator=_gen())
    out = layer(x)
    assert torch.equal(out, out[:1, :, :1].expand_as(out))
    layer.eval()
    assert layer(x) is x
    with pytest.raises(ValueError):
        F.dropout(x, p, mode="other", generator=_gen())


def test_channel_and_alpha_dropout():
    x = torch.randn(16, 12, 5, 4)
    out = F.dropout2d(x, 0.5, generator=_gen())
    dropped = (out == 0).flatten(2).all(-1)
    kept = torch.isclose(out, 2 * x).flatten(2).all(-1)
    assert bool((dropped | kept).all()) and 0.3 < float(
        dropped.float().mean()) < 0.7
    out3 = nn.Dropout3D(0.5, generator=_gen())(x[..., None])
    assert ((out3 == 0).flatten(2).all(-1)
            | torch.isclose(out3, 2 * x[..., None]).flatten(2).all(-1)).all()
    # alpha dropout keeps a SELU activation's mean and variance
    z = torch.randn(200000, generator=_gen())
    out = F.alpha_dropout(z, 0.2, generator=torch.Generator().manual_seed(1))
    assert abs(float(out.mean())) < 0.02 and abs(float(out.std()) - 1) < 0.02
    assert nn.AlphaDropout(0.2).eval()(z) is z
