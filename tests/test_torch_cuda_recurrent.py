"""On-card tests of the recurrent tier and the optimizer operators
(marker ``cuda``). They skip on hosts without a GPU; this file imports no
JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_recurrent.py

- A small LSTM language model (``chip_smoke.py``'s ``ptb_lstm_lm`` at
  vocabulary 64, hidden 32, dropout 0.3) trains through a ``TrainStep``
  (one CUDA graph a step after the first) bit for bit its eager steps:
  losses, the carried state and every parameter.
- A bidirectional GRU with ``sequence_length`` gives on the card what it
  gives on the CPU, within 1e-4 of the outputs' largest magnitude.
- The AdamW and Momentum updates run under an interception slot on the
  card (the parent's pybind launches raised there), are observed as
  ``paddle_tpu_torch::adamw``/``::momentum`` with the tensors they wrote,
  and give the bits they give with no slot set.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import hooks
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.ops.cuda import adamw, momentum

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab=64, hidden=32, layers=2, batch=4, dropout=0.3)


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    paddle.set_device("gpu")
    yield torch.device("cuda")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lstm_lm_graphs_bit_for_bit(card):
    cs = _chip_smoke()
    windows = [tuple(torch.from_numpy(a).to(card) for a in w)
               for w in cs.ptb_windows(SMALL["vocab"], SMALL["batch"], 10, 5)]
    runs = []
    for graphed in (False, True):
        model, opt, _, loss_fn = cs.ptb_lstm_lm(paddle, **SMALL)
        if graphed:
            step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
        else:
            def step(ids, labels):
                loss = loss_fn(ids, labels)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return loss
        losses = [float(step(*w)) for w in windows]
        runs.append((losses, model.h.clone(),
                     [p.detach().clone() for p in model.parameters()]))
    (la, ha, pa), (lb, hb, pb) = runs
    assert la == lb and torch.equal(ha, hb)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


def test_bidirectional_gru_card_matches_cpu(card):
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(3, 17, 8).astype(np.float32))
    lens = torch.tensor([17, 9, 4])
    out = {}
    for dev in ("cpu", "cuda"):
        gru = paddle.nn.GRU(8, 16, num_layers=2, direction="bidirect",
                            device=dev,
                            generator=torch.Generator().manual_seed(1))
        y, h = gru(x.to(dev), None, lens.to(dev))
        out[dev] = (y.cpu(), h.cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def _update(kind, card, observe):
    g = torch.Generator(device=card).manual_seed(3)
    p = [torch.randn(33, 7, device=card, generator=g) for _ in range(3)]
    grads = [torch.randn(33, 7, device=card, generator=g) for _ in p]
    state = [torch.zeros_like(t) for t in p]
    lr = torch.tensor(1e-2, device=card)
    seen = []
    if observe:
        hooks.op_observer = lambda name, outs: seen.append((name, len(outs)))
    try:
        if kind == "adamw":
            adamw.adamw_update(p, grads, state, [torch.zeros_like(t)
                                                 for t in p],
                               lr, torch.tensor(1, device=card), beta1=0.9,
                               beta2=0.999, eps=1e-8, coeff=0.01)
        else:
            momentum.momentum_update(p, grads, state, lr, momentum=0.9)
    finally:
        hooks.op_observer = None
    return p, seen


@pytest.mark.parametrize("kind", ["adamw", "momentum"])
def test_optimizer_operators_run_under_a_slot(card, kind):
    want, _ = _update(kind, card, False)
    got, seen = _update(kind, card, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    written = {"adamw": 3 * 3, "momentum": 2 * 3}[kind]
    assert (f"paddle_tpu_torch::{kind}", written) in seen
