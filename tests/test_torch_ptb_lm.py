"""The PTB LSTM language model of ``chip_smoke.py`` phase 24 (a)
(:func:`ptb_lstm_lm`, the text both packages build) at a small size —
vocabulary 50, hidden 16, 2 layers, 3 x 8 windows, dropout 0 — against
the JAX package on the CPU: 3 SGD steps with the global-norm clip, the
state carried from window to window in place, from the JAX model's
weights carried by ``load_jax_state`` (the carried state is
non-persistable, so it is in neither state dict). The losses within 1e-5
relative, the clip norms and the parameters after the steps within 1e-4
of each tensor's largest magnitude (an SGD step at learning rate 1 moves
a weight by its gradient). Then the port alone: the same steps through a
``TrainStep`` on the CPU give the eager steps' losses bit for bit, and
``reset_state`` zeroes the carried state."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import load_jax_state

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(vocab=50, hidden=16, layers=2, batch=3, dropout=0.0,
             init_scale=0.3, lr=1.0, clip=0.5)
UNROLL, STEPS = 8, 3
RTOL = 1e-5
PARAM = 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def _windows():
    return cs.ptb_windows(SMALL["vocab"], SMALL["batch"], UNROLL, STEPS,
                          seed=3)


def _steps(opt, clip, loss_fn, windows, make):
    losses, norms = [], []
    for ids, labels in windows:
        loss = loss_fn(make(ids), make(labels))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach().numpy()
                            if isinstance(loss, torch.Tensor)
                            else loss.numpy()))
        norms.append(float(np.asarray(clip_norm(clip))))
    return losses, norms


def clip_norm(clip):
    """The global norm of the last clip: the port keeps it
    (``last_norm``); for the JAX clip the test recomputes it from the
    gradients it saw."""
    return clip.last_norm.detach().numpy() if hasattr(clip, "last_norm") \
        else clip.seen


class _SeenNorm:
    """Wraps the JAX clip to keep the global norm of its last call."""

    def __init__(self, clip):
        self.clip, self.seen = clip, None

    def __call__(self, params_grads):
        total = sum(float((np.asarray(g.numpy(), np.float64) ** 2).sum())
                    for _, g in params_grads if g is not None)
        self.seen = np.sqrt(total)
        return self.clip(params_grads)


def test_ptb_lm_trains_as_jax():
    jm, jopt, jclip, jloss = cs.ptb_lstm_lm(jp, **SMALL)
    seen = _SeenNorm(jclip)
    jopt._grad_clip = seen
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert "h" not in state and "lstm._runners.1.cell.weight_hh" in state
    m, opt, clip, loss_fn = cs.ptb_lstm_lm(paddle, **SMALL)
    load_jax_state(m, state)
    windows = _windows()
    want, want_norms = _steps(jopt, seen, jloss, windows, jp.to_tensor)
    got, got_norms = _steps(opt, clip, loss_fn, windows, torch.from_numpy)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    np.testing.assert_allclose(got_norms, want_norms, rtol=PARAM)
    jparams = dict(jm.named_parameters())
    for name, p in m.named_parameters():
        jv = np.asarray(jparams[name].numpy())
        if name == "decoder.weight":
            jv = jv.T  # the JAX Linear weight is [in, out]
        err = float(np.abs(p.detach().numpy() - jv).max())
        assert err <= PARAM * float(np.abs(jv).max()), name
    for buf in ("h", "c"):
        np.testing.assert_allclose(getattr(m, buf).numpy(),
                                   np.asarray(getattr(jm, buf).numpy()),
                                   rtol=PARAM, atol=PARAM)


def test_ptb_lm_train_step_is_the_eager_step():
    windows = _windows()
    m, opt, clip, loss_fn = cs.ptb_lstm_lm(paddle, **SMALL)
    eager, _ = _steps(opt, clip, loss_fn, windows, torch.from_numpy)
    h_eager = m.h.clone()
    m2, opt2, _, loss_fn2 = cs.ptb_lstm_lm(paddle, **SMALL)
    step = TrainStep(model=m2, optimizer=opt2, loss_fn=loss_fn2,
                     device="cpu")
    graphed = [float(step(*(torch.from_numpy(a) for a in w)))
               for w in windows]
    assert graphed == eager
    assert torch.equal(m2.h, h_eager) and m2.h.abs().sum() > 0
    m2.reset_state()
    assert not m2.h.any() and not m2.c.any()
    assert "h" not in m2.state_dict()
