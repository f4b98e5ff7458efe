"""On-card tests of the ResNet training path (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_resnet.py

All comparisons are bit for bit (tolerance 0):

- ``resnet18`` (4 x 3 x 64², 10 classes) in bf16 O2 with
  ``Momentum(0.1, 0.9)``: N graphed ``TrainStep`` steps against N eager
  steps by hand on a twin built from the same seed, every parameter and
  both running stats of every BatchNorm (the first step promotes the
  running stats to f32, the replays update them in place). The convolutions
  run under ``cudnn.deterministic`` so two eager runs agree;
- a BatchNorm whose bf16 running stat would be rebound to f32 inside a
  capture raises, and the capture fails;
- the Momentum kernel against ``momentum_reference`` in every mode: f32,
  bf16 and fp16 parameters with gradients of their dtype or f32, Nesterov,
  L2 and LR factors per tensor, ``found_inf`` unset and set, at ragged
  sizes (odd lengths, an unaligned view, more than 64 tensors).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import CompiledFunction, TrainStep
from paddle_tpu_torch.ops.cuda import momentum
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import resnet

pytestmark = pytest.mark.cuda

STEPS = 5


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
    model = resnet.resnet18(num_classes=10,
                            generator=torch.Generator().manual_seed(0))
    crit = nn.CrossEntropyLoss()
    amp.decorate(model, level="O2", dtype="bfloat16")
    opt = Momentum(learning_rate=0.1, momentum=0.9,
                   parameters=model.parameters())

    def loss_fn(x, y):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = model(x)
        return crit(logits, y)

    return model, opt, loss_fn


def _state(model):
    return [t.detach().clone() for t in list(model.parameters())
            + list(model.buffers())]


def test_graphed_running_stats_are_the_eager_ones(card, deterministic):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 3, 64, 64).astype(np.float32)).to(card)
    y = torch.from_numpy(rs.randint(0, 10, (4,))).to(card)
    model, opt, loss_fn = _twin()
    assert model.bn1._mean.dtype == torch.bfloat16
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
    assert model.bn1._mean.dtype == torch.float32  # promoted, eagerly
    ptr = model.bn1._mean.data_ptr()
    momentum.launches = 0
    got += [step(x, y) for _ in range(STEPS - 1)]
    torch.cuda.synchronize()
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}
    assert momentum.launches == (STEPS - 1) * math.ceil(
        len(list(model.parameters())) / momentum.MAX_TENSORS)
    assert model.bn1._mean.data_ptr() == ptr
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    state = _state(model)
    assert len(state) == len(want_state)
    for a, b in zip(state, want_state):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_rebinding_a_running_stat_under_capture_raises(card):
    bn = nn.BatchNorm2D(8).train()
    bn.to(torch.bfloat16)
    x = torch.randn(4, 8, 6, 6, device=card, dtype=torch.bfloat16)
    use_amp = [False]

    def fn(t):
        with amp.auto_cast(enable=use_amp[0], level="O2", dtype="bfloat16"):
            return bn(t)

    compiled = CompiledFunction(fn)
    compiled(x)  # eager: bf16 batch stats, written in place
    assert bn._mean.dtype == torch.bfloat16
    use_amp[0] = True  # the capture would meet f32 batch stats
    with pytest.raises(RuntimeError, match="rebind"):
        compiled(x)
    assert bn._mean.dtype == torch.bfloat16


def _lists(card, pdt, gdt, sizes, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    params = [torch.randn(n, generator=gen, device=card).to(pdt)
              for n in sizes]
    grads = [torch.randn(n, generator=gen, device=card).to(gdt)
             for n in sizes]
    vels = [torch.randn(n, generator=gen, device=card) * 0.1 for n in sizes]
    return params, grads, vels


@pytest.mark.parametrize("pdt,gdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float16, torch.float16),
                                     (torch.bfloat16, torch.float32),
                                     (torch.float16, torch.float32)],
                         ids=["f32", "bf16", "fp16", "bf16-f32g", "fp16-f32g"])
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("found", [None, False, True])
def test_momentum_kernel_is_the_plain_version(card, pdt, gdt, nesterov,
                                              found):
    sizes = [1, 3, 4, 7, 1000, 4099, 65537] + [33] * 60  # 67 tensors
    params, grads, vels = _lists(card, pdt, gdt, sizes, 5)
    wds = [0.01 if i % 3 == 0 else None for i in range(len(sizes))]
    factors = [((0.5,) if i % 2 else ()) + ((2.0,) if i % 5 == 0 else ())
               for i in range(len(sizes))]
    lr = torch.tensor(0.05, device=card)
    flag = None if found is None else torch.tensor(found, device=card)
    kw = dict(momentum=0.9, nesterov=nesterov, weight_decay=wds,
              lr_factors=factors, found_inf=flag)
    got = ([p.clone() for p in params], [v.clone() for v in vels])
    want = ([p.clone() for p in params], [v.clone() for v in vels])
    # an unaligned view, one element into a larger buffer: its tensor takes
    # the element-wise path
    buf = torch.zeros(8, device=card, dtype=pdt)
    buf[1:].copy_(params[3])
    got[0][3] = buf[1:]
    momentum.launches = 0
    momentum.momentum_update(got[0], grads, got[1], lr, **kw)
    assert momentum.launches == 2  # 67 tensors of one dtype pair
    momentum.momentum_reference(want[0], grads, want[1], lr, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)
    if found:
        assert all(torch.equal(a, b) for a, b in zip(got[0], params))


def test_momentum_kernel_raises_on_what_it_does_not_take(card):
    p = torch.randn(8, device=card, dtype=torch.float64)
    with pytest.raises(TypeError):
        momentum.momentum_update([p], [p], [p.float()],
                                 torch.tensor(0.1, device=card),
                                 momentum=0.9)
    p = torch.randn(8, 2, device=card).t()  # [2, 8], not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        momentum.momentum_update([p], [p.contiguous()],
                                 [torch.zeros(2, 8, device=card)],
                                 torch.tensor(0.1, device=card),
                                 momentum=0.9)
