"""On-card tests of the PP-LiteSeg training path (marker ``cuda``).

They need an NVIDIA GPU (the Momentum kernel needs ``nvcc``) and skip on
hosts without a GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_segdet.py

All comparisons are bit for bit (tolerance 0):

- ``pp_liteseg(num_classes=4, base=16)`` (4 x 3 x 64²) in bf16 O2 with
  ``Momentum(0.01, 0.9)`` and the per-pixel loss outside ``auto_cast``: N
  graphed ``TrainStep`` steps against N eager steps by hand on a twin
  built from the same seed, the losses, every parameter and both running
  stats of every BatchNorm. The convolutions run under
  ``cudnn.deterministic`` so two eager runs agree;
- ``interpolate``'s backward (bilinear up, shrinking, bicubic; f32 and
  bf16) run twice gives the same bits, and its forward agrees with the
  CPU within 1e-5 (f32) of the largest value.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.cuda import momentum
from paddle_tpu_torch.ops.manipulation import reshape, transpose
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import segdet

pytestmark = pytest.mark.cuda

STEPS = 5
CLASSES = 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = False


def _twin():
    model = segdet.pp_liteseg(num_classes=CLASSES, base=16,
                              generator=torch.Generator().manual_seed(0))
    crit = nn.CrossEntropyLoss()
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = Momentum(learning_rate=0.01, momentum=0.9,
                   parameters=model.parameters())

    def loss_fn(x, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(x)
        flat = reshape(transpose(logits, [0, 2, 3, 1]), [-1, CLASSES])
        return crit(flat, reshape(y, [-1]))

    return model, opt, loss_fn


def _state(model):
    return [t.detach().clone() for t in list(model.parameters())
            + list(model.buffers())]


def test_graphed_liteseg_steps_are_the_eager_ones(card, deterministic):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 3, 64, 64).astype(np.float32)).to(card)
    y = torch.from_numpy(rs.randint(0, CLASSES, (4, 64, 64))).to(card)
    model, opt, loss_fn = _twin()
    want = []
    for _ in range(STEPS):
        loss = loss_fn(x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(loss.detach())
    want_state = _state(model)
    model, opt, loss_fn = _twin()
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    got = [step(x, y)]
    stats = model.backbone.stem[0].bn._mean
    assert stats.dtype == torch.float32  # promoted, eagerly
    ptr = stats.data_ptr()
    momentum.launches = 0
    got += [step(x, y) for _ in range(STEPS - 1)]
    torch.cuda.synchronize()
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}
    assert momentum.launches == (STEPS - 1) * math.ceil(
        len(list(model.parameters())) / momentum.MAX_TENSORS)
    assert model.backbone.stem[0].bn._mean.data_ptr() == ptr
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    state = _state(model)
    assert len(state) == len(want_state)
    for a, b in zip(state, want_state):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("shape,size,mode", [
    ((4, 19, 16, 16), (128, 128), "bilinear"),
    ((4, 19, 64, 64), (37, 29), "bilinear"),
    ((4, 8, 16, 16), (32, 32), "bicubic")],
    ids=["up", "shrink", "bicubic"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_interpolate_backward_is_repeatable(card, shape, size, mode, dtype):
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    x.requires_grad_(True)
    out = F.interpolate(x, size=list(size), mode=mode)
    g = torch.randn(out.shape, generator=gen, device=card).to(dtype)
    grads = []
    for _ in range(2):
        x.grad = None
        F.interpolate(x, size=list(size), mode=mode).backward(g)
        grads.append(x.grad.clone())
    assert torch.equal(grads[0], grads[1])
    if dtype == torch.float32:
        want = F.interpolate(x.detach().cpu(), size=list(size), mode=mode)
        scale = max(float(want.abs().max()), 1.0)
        assert float((out.detach().cpu() - want).abs().max()) <= 1e-5 * scale
