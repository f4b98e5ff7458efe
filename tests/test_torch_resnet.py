"""The port's ResNet training path against the JAX package's, on the CPU.

The JAX side runs on the CPU as its own tests run it; no function of this
path reaches a Pallas kernel. Inputs come from numpy seeds, the JAX
weights are carried across with ``load_jax_state``, and each check states
its tolerance:

- ``conv2d`` (stride, dilation, groups, ``"SAME"``, asymmetric pairs,
  NHWC, bias), ``max_pool2d`` (padding, ``ceil_mode``, asymmetric pads),
  ``avg_pool2d`` (``exclusive`` or not, ``divisor_override``) and
  ``adaptive_avg_pool2d`` (divisible and not): outputs and gradients within
  1e-5 (f32);
- ``batch_norm`` training and inference: outputs and gradients within
  1e-5, and both running stats after 3 training calls within 1e-6;
- ``resnet18`` (2 × 3 × 64², 10 classes, f32; see ``HW``): logits, loss
  and every parameter's gradient within 1e-4 of the tensor's largest;
  3 ``TrainStep`` steps of ``Momentum(0.1, 0.9)`` against the JAX
  ``TrainStep``: losses within 1e-4 relative, parameters and running
  stats within 1e-3 of each tensor's largest value (LR 0.1 grows the loss
  and the step's differences with it: bench.py's recipe is not tuned to
  converge), then ``eval()`` logits within 1e-3 relative;
- ``resnet50``: logits and loss within 1e-3 (``DEEP_TOL``); its
  train-mode gradients, ill-conditioned in f32 in both packages, each
  within 0.15 of the tensor's largest float64 gradient (``GRAD64_TOL``),
  its eval-mode gradients within 1e-4 of JAX's; one ``TrainStep``: the
  loss within 1e-4, the running stats within 1e-4, the update within
  ``GRAD64_TOL`` of 0.1 times the float64 gradient;
- ``resnext50_32x4d`` and ``wide_resnet50_2`` forward (eval and train)
  within 1e-3 (``DEEP_TOL``);
- the O2 bf16 path: the dtype of every stage of the stem and of a block
  with and without a downsample equal JAX's (conv and fc bf16, BatchNorm
  f32, relu, max-pool, residual sum and average pool bf16), the BatchNorm
  buffers bf16 before the first step and f32 after it in both packages,
  the loss within one bf16 step of JAX's and the running stats within
  2^-6 relative;
- ``Momentum`` with Nesterov, L2 and two groups against the JAX optimizer
  over 3 steps (f32 within 1e-6; bf16 within one bf16 step, since an L2
  ``coeff · p`` rounds its scalar differently, ROADMAP.md divergences),
  and ``momentum_update``'s CPU route bit for bit the per-tensor chain the
  optimizer ran before the multi-tensor kernel;
- ``decorate``, ``TrainStep`` and the ResNet constructors raise on a host
  without CUDA unless asked for the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.vision.models import resnet as jax_resnet
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import math as pmath
from paddle_tpu_torch.ops.cuda import momentum as mom_kernel
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet

# bench.py's CPU smoke runs resnet18 at 2 x 3 x 32^2, where layer4 is 1x1:
# its BatchNorms then normalize 2 values a channel, which amplifies f32
# rounding by up to 1/sqrt(eps) ~ 316 (the two packages' layer4 outputs
# differ by 0.03 there, and a running variance by 6x after 3 steps). At
# 64^2 layer4 is 2x2, 8 values a channel, and the packages agree to 1e-5.
B, HW, CLASSES = 2, 64, 10
# the 50-layer models: 53 train-mode BatchNorms, layer4's over 8 values a
# channel, carry the f32 rounding of each package's convolutions to ~3e-4
# of logits near 2 (measured); resnet18's 20 keep it under 1e-4
DEEP_TOL = 1e-3
# resnet50's train-mode f32 gradients against its float64 ones (see
# test_resnet50_gradients_and_one_train_step_match_jax)
GRAD64_TOL = 0.15


def _np(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _jax_state(model):
    return {k: np.array(v.numpy(), copy=True)
            for k, v in model.state_dict().items()}


def _pair(name, **kw):
    """The JAX model (seed 0) and the port's with its weights, on the
    CPU."""
    paddle.seed(0)
    ref = getattr(jax_resnet, name)(**kw)
    model = getattr(resnet, name)(device="cpu", **kw)
    resnet.load_jax_state(model, _jax_state(ref))
    return ref, model


def _batch(seed=0, classes=CLASSES):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, 3, HW, HW).astype(np.float32)
    y = rs.randint(0, classes, (B,)).astype(np.int64)
    return x, y


def _close_to(got, want, rel, what):
    """``got`` within ``rel`` times ``want``'s largest magnitude (or
    ``rel`` where that is below 1)."""
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


# ------------------------------------------------------------- functionals

CONV_CASES = {
    "stride2": dict(stride=2, padding=1),
    "dilation2": dict(padding=2, dilation=2),
    "groups2-bias": dict(groups=2, padding=1, bias=True),
    "same": dict(stride=2, padding="SAME"),
    "valid": dict(padding="VALID"),
    "asymmetric": dict(padding=[1, 2, 0, 1], bias=True),
    "nhwc": dict(stride=2, padding=1, data_format="NHWC", bias=True),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    kw = dict(CONV_CASES[case])
    bias = kw.pop("bias", False)
    groups = kw.get("groups", 1)
    rs = np.random.RandomState(1)
    x = rs.randn(2, 4, 9, 11).astype(np.float32)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    w = rs.randn(6, 4 // groups, 3, 3).astype(np.float32)
    b = rs.randn(6).astype(np.float32) if bias else None
    jx, jw = (paddle.to_tensor(a, stop_gradient=False) for a in (x, w))
    jb = paddle.to_tensor(b, stop_gradient=False) if bias else None
    want = JF.conv2d(jx, jw, jb, **kw)
    g = rs.randn(*want.shape).astype(np.float32)
    (want * paddle.to_tensor(g)).sum().backward()
    tx, tw = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    tb = torch.from_numpy(b).requires_grad_(True) if bias else None
    got = F.conv2d(tx, tw, tb, **kw)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)
    pairs = [("x", tx, jx), ("w", tw, jw)] + ([("b", tb, jb)] if bias else [])
    for name, t, j in pairs:
        np.testing.assert_allclose(t.grad.numpy(), _np(j.grad), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


POOL_CASES = {
    "max-k3s2p1": ("max_pool2d", (3,), dict(stride=2, padding=1)),
    "max-ceil": ("max_pool2d", (3,), dict(stride=2, ceil_mode=True)),
    "max-asymmetric": ("max_pool2d", (2,), dict(stride=2,
                                                padding=[0, 1, 1, 2])),
    "max-same": ("max_pool2d", (3,), dict(stride=2, padding="SAME")),
    "avg-exclusive": ("avg_pool2d", (3,), dict(stride=2, padding=1)),
    "avg-inclusive": ("avg_pool2d", (3,), dict(stride=2, padding=1,
                                               exclusive=False)),
    "avg-ceil": ("avg_pool2d", (2,), dict(ceil_mode=True)),
    "avg-divisor": ("avg_pool2d", (2,), dict(stride=1, divisor_override=3)),
    "adaptive-divisible": ("adaptive_avg_pool2d", ((3, 1),), {}),
    "adaptive-uneven": ("adaptive_avg_pool2d", ((4, 3),), {}),
    "adaptive-1x1": ("adaptive_avg_pool2d", ((1, 1),), {}),
}


@pytest.fixture
def nan_inf_check_off():
    """The JAX package's ``check_nan_inf`` flag off for the test, as its
    default is: another test file may leave it on (ROADMAP.md), and a
    window wholly in the padding is -inf in both packages."""
    from paddle_tpu.base.flags import get_flags, set_flags

    old = get_flags("check_nan_inf")
    set_flags({"check_nan_inf": False})
    yield
    set_flags(old)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool2d_matches_jax(case, nan_inf_check_off):
    fn, args, kw = POOL_CASES[case]
    rs = np.random.RandomState(2)
    x = rs.randn(2, 3, 9, 11).astype(np.float32)
    if fn == "max_pool2d":
        x[:, :, 2, 3] = x[:, :, 2, 4]  # a tie inside a window
    jx = paddle.to_tensor(x, stop_gradient=False)
    want = getattr(JF, fn)(jx, *args, **kw)
    g = rs.randn(*want.shape).astype(np.float32)
    (want * paddle.to_tensor(g)).sum().backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    got = getattr(F, fn)(tx, *args, **kw)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), _np(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jx.grad), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", ["train", "infer", "global-stats",
                                  "nhwc-train"])
def test_batch_norm_matches_jax(mode):
    rs = np.random.RandomState(3)
    fmt = "NHWC" if mode == "nhwc-train" else "NCHW"
    xs = [rs.randn(4, 5, 6, 7).astype(np.float32) * 2 + 1 for _ in range(3)]
    if fmt == "NHWC":
        xs = [np.ascontiguousarray(x.transpose(0, 2, 3, 1)) for x in xs]
    w = rs.rand(5).astype(np.float32) + 0.5
    b = rs.randn(5).astype(np.float32)
    m0 = rs.randn(5).astype(np.float32)
    v0 = rs.rand(5).astype(np.float32) + 0.5
    kw = dict(training=mode != "infer", data_format=fmt,
              use_global_stats=True if mode == "global-stats" else None)
    jm, jv = paddle.to_tensor(m0), paddle.to_tensor(v0)
    tm, tv = torch.from_numpy(m0.copy()), torch.from_numpy(v0.copy())
    for x in xs:
        g = rs.randn(*x.shape).astype(np.float32)
        jx, jw, jb = (paddle.to_tensor(a, stop_gradient=False)
                      for a in (x, w, b))
        want = JF.batch_norm(jx, jm, jv, jw, jb, **kw)
        (want * paddle.to_tensor(g)).sum().backward()
        tx, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, w, b))
        got = F.batch_norm(tx, tm, tv, tw, tb, **kw)
        (got * torch.from_numpy(g)).sum().backward()
        np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                   rtol=1e-5, atol=1e-5)
        for name, t, j in (("x", tx, jx), ("w", tw, jw), ("b", tb, jb)):
            np.testing.assert_allclose(t.grad.numpy(), _np(j.grad),
                                       rtol=1e-5, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-6, atol=1e-6)
    if mode in ("infer", "global-stats"):
        assert np.array_equal(tm.numpy(), m0) and np.array_equal(tv.numpy(),
                                                                 v0)


def test_batch_norm_promotes_a_bf16_buffer_once_in_place_after():
    """A bf16 running stat with f32 batch stats takes the f32 value (the
    first O2 step); from then on every update writes the same storage."""
    bn = nn.BatchNorm2D(3, device="cpu")
    bn.to(torch.bfloat16)
    buf = bn._mean
    x = torch.randn(2, 3, 4, 4)
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        out = bn(x)
    assert out.dtype == torch.float32
    assert bn._mean is buf and buf.dtype == torch.float32
    assert bn._variance.dtype == torch.float32
    ptr = buf.data_ptr()
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        bn(x)
    assert bn._mean.data_ptr() == ptr


# ----------------------------------------------------------------- models

def _grads_match(ref, model, x, y, tol=1e-4, grad_tol=-1.0):
    """Logits, loss and every parameter's gradient within ``tol`` of the
    tensor's largest (``grad_tol`` for the gradients when given; None:
    unchecked); returns JAX's gradients in the port's layout."""
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    crit = paddle.nn.CrossEntropyLoss()
    want_logits = ref(jx)
    want_loss = crit(want_logits, jy)
    want_loss.backward()
    want = {n: np.asarray(p.grad.numpy()) for n, p in ref.named_parameters()}
    logits = model(torch.from_numpy(x))
    loss = nn.CrossEntropyLoss()(logits, torch.from_numpy(y))
    loss.backward()
    _close_to(logits.detach().numpy(), _np(want_logits), tol, "logits")
    want_loss = float(_np(want_loss))
    assert abs(float(loss.detach()) - want_loss) <= tol * max(abs(want_loss),
                                                        1.0)
    want = resnet.port_state_from_jax(model, {
        **want, **{n: b.numpy() for n, b in model.named_buffers()}})
    if grad_tol is not None:
        for name, p in model.named_parameters():
            _close_to(p.grad.numpy(), want[name].numpy(),
                      tol if grad_tol < 0 else grad_tol, name)
    return want


def _train(name, steps, x, y, classes=CLASSES):
    """``steps`` steps of bench.py's recipe (``Momentum(0.1, 0.9)``, f32)
    through both packages' ``TrainStep``; returns both losses and the
    models."""
    ref, model = _pair(name, num_classes=classes)
    jcrit = paddle.nn.CrossEntropyLoss()
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=ref.parameters())
    jstep = JaxTrainStep(model=ref, optimizer=jopt,
                         loss_fn=lambda a, b: jcrit(ref(a), b))
    crit = nn.CrossEntropyLoss()
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters(), device="cpu")
    step = TrainStep(model=model, optimizer=opt,
                     loss_fn=lambda a, b: crit(model(a), b), device="cpu")
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    want = [float(_np(jstep(jx, jy))) for _ in range(steps)]
    got = [float(step(torch.from_numpy(x), torch.from_numpy(y)))
           for _ in range(steps)]
    return want, got, ref, model


def _state_matches(ref, model, rel):
    want = _jax_state(ref)
    for name, t in resnet.jax_state_dict(model).items():
        _close_to(t.float().numpy(), want[name].astype(np.float32), rel,
                  name)


def test_resnet18_logits_loss_and_gradients_match_jax():
    x, y = _batch()
    ref, model = _pair("resnet18", num_classes=CLASSES)
    _grads_match(ref, model, x, y)


def test_resnet18_momentum_train_steps_and_eval_match_jax():
    x, y = _batch(1)
    want, got, ref, model = _train("resnet18", 3, x, y)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(np.isfinite(got))
    _state_matches(ref, model, 1e-3)
    ref.eval()
    model.eval()
    xe, _ = _batch(2)
    want_logits = _np(ref(paddle.to_tensor(xe)))
    with torch.no_grad():
        logits = model(torch.from_numpy(xe)).numpy()
    _close_to(logits, want_logits, 1e-3, "eval logits")


def test_resnet50_gradients_and_one_train_step_match_jax():
    """resnet50's train-mode backward is ill-conditioned in f32 at these
    sizes (its 53 BatchNorms' backward subtracts near-equal sums): the
    port's f32 gradients sit up to 4.2e-2, JAX's up to 9.5e-2, of each
    tensor's largest from the port's float64 gradient (measured). So the
    train-mode gradients and the step's update are each held within
    ``GRAD64_TOL`` of the float64 gradient, and the eval-mode gradients
    (BatchNorm an affine map) within 1e-4 of JAX's."""
    x, y = _batch(3)
    ref, model = _pair("resnet50", num_classes=CLASSES)
    assert len(list(model.parameters())) == 161
    exact = resnet.resnet50(num_classes=CLASSES, device="cpu")
    exact.load_state_dict(model.state_dict())
    exact.to(torch.float64)
    loss = nn.CrossEntropyLoss()(exact(torch.from_numpy(x).double()),
                                 torch.from_numpy(y))
    loss.backward()
    g64 = {n: p.grad for n, p in exact.named_parameters()}
    want = _grads_match(ref, model, x, y, DEEP_TOL, grad_tol=None)
    for name, p in model.named_parameters():
        ref64 = g64[name].float().numpy()
        _close_to(p.grad.numpy(), ref64, GRAD64_TOL, name)
        _close_to(want[name].numpy(), ref64, GRAD64_TOL, name)
    ref.eval()
    model.eval()
    for p in ref.parameters():
        p.clear_grad()
    model.zero_grad()
    _grads_match(ref, model, x, y, 1e-4)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    want, got, ref, model = _train("resnet50", 1, x, y)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    jstate = _jax_state(ref)
    for name, t in resnet.jax_state_dict(model).items():
        if name.endswith(("._mean", "._variance")):
            _close_to(t.numpy(), jstate[name], 1e-4, name)
    # the first Momentum step moves each parameter by 0.1 times its
    # gradient
    for name, p in model.named_parameters():
        _close_to((init[name] - p.detach()).numpy() / 0.1,
                  g64[name].float().numpy(), GRAD64_TOL, name)


@pytest.mark.parametrize("name", ["resnext50_32x4d", "wide_resnet50_2"])
def test_variant_forward_matches_jax(name):
    x, _ = _batch(4)
    ref, model = _pair(name, num_classes=CLASSES)
    for train in (False, True):
        ref.train() if train else ref.eval()
        model.train(train)
        want = _np(ref(paddle.to_tensor(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=DEEP_TOL, atol=DEEP_TOL,
                                   err_msg=f"{name} train={train}")


def test_state_dict_keys_and_layouts_line_up_with_jax():
    ref, model = _pair("resnet18", num_classes=CLASSES)
    jstate = ref.state_dict()
    assert sorted(model.state_dict()) == sorted(jstate)
    assert len(jstate) == 102
    assert tuple(jstate["fc.weight"].shape) == (512, CLASSES)
    assert tuple(model.fc.weight.shape) == (CLASSES, 512)
    back = resnet.jax_state_dict(model)
    for k, v in jstate.items():
        np.testing.assert_array_equal(back[k].numpy(), _np(v), err_msg=k)
    with pytest.raises(NotImplementedError):
        resnet.resnet18(pretrained=True, device="cpu")


# ------------------------------------------------------------------- O2

def _dtype(t):
    return str(t.dtype).split(".")[-1]


def _o2_dtypes(m, x, add):
    """The dtype after each stage of the stem, of a block without and one
    with a downsample, the pool and fc, under O2."""
    seq = []

    def rec(t):
        seq.append(_dtype(t))
        return t

    y = rec(m.relu(rec(m.bn1(rec(m.conv1(x))))))
    y = rec(m.maxpool(y))
    for blk in (m.layer1[0], m.layer2[0]):
        out = rec(blk.relu(rec(blk.bn1(rec(blk.conv1(y))))))
        out = rec(blk.bn2(rec(blk.conv2(out))))
        ident = y if blk.downsample is None else rec(blk.downsample(y))
        y = rec(blk.relu(rec(add(out, ident))))
    y = m.layer4(m.layer3(m.layer2[1](y)))
    z = rec(m.avgpool(y))
    rec(m.fc(z.reshape([z.shape[0], -1])))
    return seq


def test_o2_bf16_dtypes_buffers_and_step_match_jax():
    x, y = _batch(5)
    paddle.seed(0)
    ref = jax_resnet.resnet18(num_classes=CLASSES)
    state = _jax_state(ref)
    paddle.amp.decorate(ref, level="O2", dtype="bfloat16")
    model = resnet.resnet18(num_classes=CLASSES, device="cpu")
    resnet.load_jax_state(model, state)
    amp.decorate(model, level="O2", dtype="bfloat16", device="cpu")
    assert _dtype(ref.bn1._mean) == "bfloat16"
    assert model.bn1._mean.dtype == torch.bfloat16
    ref.eval()
    model.eval()
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        want = _o2_dtypes(ref, paddle.to_tensor(x), paddle.add)
    with amp.auto_cast(level="O2", dtype="bfloat16"), torch.no_grad():
        got = _o2_dtypes(model, torch.from_numpy(x), pmath.add)
    assert want[:4] == ["bfloat16", "float32", "bfloat16", "bfloat16"]
    assert got == want
    # one training step: the buffers come back f32 in both
    ref.train()
    model.train()
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=ref.parameters())
    jcrit = paddle.nn.CrossEntropyLoss()
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        jlogits = ref(paddle.to_tensor(x))
    jloss = jcrit(jlogits, paddle.to_tensor(y))
    jloss.backward()
    jopt.step()
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters(), device="cpu")
    crit = nn.CrossEntropyLoss()

    def loss_fn(a, b):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(a)
        return crit(logits, b)

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


# ---------------------------------------------------------------- Momentum

SHAPES = [(4, 3), (5,), (2, 3, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_momentum_nesterov_l2_groups_match_jax(dtype):
    rs = np.random.RandomState(6)
    w0 = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(3)]
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]

    def groups(ps):
        return [{"params": ps[:1], "learning_rate": 0.5,
                 "weight_decay": 0.02}, {"params": ps[1:]}]

    jps = [JaxParameter(jnp.asarray(w, jd)) for w in w0]
    jopt = paddle.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                     parameters=groups(jps),
                                     use_nesterov=True, weight_decay=0.01)
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
           for w in w0]
    topt = Momentum(learning_rate=0.1, momentum=0.9, parameters=groups(tps),
                    use_nesterov=True, weight_decay=0.01, device="cpu")
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp._grad = jnp.asarray(g, jd)
            tp.grad = torch.from_numpy(g).to(dtype)
        jopt._lr_override = jnp.asarray(0.1, jnp.float32)
        jopt.step()
        topt.step()
    for jp, tp in zip(jps, tps):
        want = np.asarray(jp._value.astype(jnp.float32))
        got = tp.detach().float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-3)


def _old_chain(params, grads, vels, lr, mu, nesterov, wds, factors):
    """The per-tensor rule ``Momentum._apply_one`` ran before the
    multi-tensor kernel, kept as the reference."""
    for p, g, vel, wd, fs in zip(params, grads, vels, wds, factors):
        lr_t = lr
        for f in fs:
            if f != 1.0:
                lr_t = lr_t * f
        gv = g if wd is None else g + wd * p
        v_new = mu * vel + gv
        vel.copy_(v_new)
        update = gv + mu * v_new if nesterov else v_new
        p.copy_((p.float() - lr_t * update).to(p.dtype))


@pytest.mark.parametrize("pdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float16, torch.float16),
                                     (torch.bfloat16, torch.float32)],
                         ids=["f32", "bf16", "fp16", "bf16-f32grad"])
@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_update_cpu_is_the_old_chain_bit_for_bit(pdt, gdt,
                                                          nesterov):
    gen = torch.Generator().manual_seed(7)
    shapes = [(37, 5), (129,), (3, 3, 3, 2), (1,)]
    params = [torch.randn(s, generator=gen).to(pdt) for s in shapes]
    grads = [torch.randn(s, generator=gen).to(gdt) for s in shapes]
    vels = [torch.randn(s, generator=gen) * 0.1 for s in shapes]
    wds = [0.01, None, 0.05, None]
    factors = [(0.5,), (), (1.0, 2.0), (0.25, 0.5)]
    lr = torch.tensor(0.1)
    got = ([t.clone() for t in params], [t.clone() for t in vels])
    want = ([t.clone() for t in params], [t.clone() for t in vels])
    mom_kernel.momentum_update(got[0], grads, got[1], lr, momentum=0.9,
                               nesterov=nesterov, weight_decay=wds,
                               lr_factors=factors, device="cpu")
    _old_chain(want[0], grads, want[1], lr, 0.9, nesterov, wds, factors)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    # found_inf set: nothing moves; unset: the same update again
    for flag in (True, False):
        before = [t.clone() for t in got[0] + got[1]]
        mom_kernel.momentum_update(got[0], grads, got[1], lr, momentum=0.9,
                                   nesterov=nesterov, weight_decay=wds,
                                   lr_factors=factors,
                                   found_inf=torch.tensor(flag),
                                   device="cpu")
        moved = [not torch.equal(a, b) for a, b in
                 zip(got[0] + got[1], before)]
        assert not any(moved) if flag else any(moved)
    assert mom_kernel.launches == 0


# ------------------------------------------------------------ no fallback

def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the defaults would not raise")
    model = resnet.resnet18(num_classes=CLASSES, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        amp.decorate(model, level="O2", dtype="bfloat16")
    with pytest.raises(RuntimeError, match="CUDA"):
        Momentum(learning_rate=0.1, parameters=model.parameters())
    opt = Momentum(learning_rate=0.1, parameters=model.parameters(),
                   device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainStep(model=model, optimizer=opt, loss_fn=lambda a: a)
    for ctor in (resnet.resnet50, lambda: nn.Conv2D(3, 4, 3),
                 lambda: nn.BatchNorm2D(4)):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctor()
    with pytest.raises(RuntimeError, match="CUDA"):
        nn.SyncBatchNorm(4)
    # on one rank SyncBatchNorm is BatchNorm (over several ranks:
    # tests/test_torch_data_parallel.py)
    x = torch.randn(3, 4, 2, 2)
    torch.testing.assert_close(nn.SyncBatchNorm(4, device="cpu")(x),
                               nn.BatchNorm2D(4, device="cpu")(x), rtol=0,
                               atol=0)
