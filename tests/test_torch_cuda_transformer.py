"""The user-written Transformer-base of ``chip_smoke.py`` phase 22
(``transformer_base``) on the card (marker ``cuda``), at a small size (2 +
2 layers of width 128, 2 heads of D = 64, so that K1–K3 take them; vocab
64, 4 × 16): f32 logits and the loss on the card within 1e-4 of the same
weights on the CPU (K1–K3 against their plain versions, TF32 off), and in
bf16 O2 at dropout 0.1 one graphed ``TrainStep`` step (a replay) bit for
bit its eager step, K1–K3 launched 4 times each a step; a layer built on
the CPU and moved to the card draws its dropout from the card's
process-wide generator. Skips on hosts
without a GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_transformer.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.jit import TrainStep

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
SMALL = dict(vocab=64, d_model=128, nhead=2, layers=2, d_ff=256,
             max_len=16)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _batch(device):
    rs = np.random.RandomState(0)
    src = rs.randint(1, 64, (4, 16)).astype(np.int64)
    full = rs.randint(1, 64, (4, 17)).astype(np.int64)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (src, full[:, :-1], full[:, 1:]))


@pytest.fixture
def on_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(device_mod, "_chosen", None)
    yield


def test_recipe_on_the_card_matches_the_cpu(on_card):
    cs = _chip_smoke()
    outs = {}
    for dev in ("cpu", "gpu"):
        paddle.set_device(dev)
        model, _, _, loss_fn = cs.transformer_base(paddle, amp=False,
                                                   dropout=0.0, **SMALL)
        batch = _batch("cpu" if dev == "cpu" else "cuda")
        outs[dev] = (model(*batch[:2]).detach().cpu(),
                     float(loss_fn(*batch).detach()))
    (logits, loss), (clogits, closs) = outs["gpu"], outs["cpu"]
    assert float((logits - clogits).abs().max()) <= 1e-4
    assert abs(loss - closs) <= 1e-4


def test_graphed_step_is_its_eager_step(on_card):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    cs = _chip_smoke()
    paddle.set_device("gpu")
    batch = _batch("cuda")
    kw = dict(SMALL, dropout=0.1)
    model, opt, sched, loss_fn = cs.transformer_base(paddle, **kw)
    eager = []
    for _ in range(3):
        loss = loss_fn(*batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        eager.append(loss.detach().clone())
    want = [p.detach().clone() for p in model.parameters()]
    model, opt, sched, loss_fn = cs.transformer_base(paddle, **kw)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    graphed = []
    for i in range(3):
        if i == 2:
            fa.launches = fa.dq_launches = fa.dkv_launches = 0
        graphed.append(step(*batch).as_subclass(torch.Tensor).clone())
        sched.step()
    torch.cuda.synchronize()
    assert step.stats == {"compiled_steps": 2, "eager_steps": 1}
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == (4, 4, 4)
    assert all(torch.equal(a, b) for a, b in zip(graphed, eager))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), want))


def test_a_layer_moved_to_the_card_draws_from_the_cards_generator(on_card):
    paddle.set_device("cpu")
    net = paddle.nn.Sequential(paddle.nn.Linear(4, 4),
                               paddle.nn.Dropout(0.5))
    assert net[1].generator is paddle.base.global_state.dropout_generator(
        "cpu")
    net.to("gpu")
    gen = paddle.base.global_state.dropout_generator("cuda")
    assert net[1].generator is gen and gen.device.type == "cuda"
    out = net(torch.ones(8, 4, device="cuda"))
    assert out.device.type == "cuda" and torch.isfinite(out).all()
