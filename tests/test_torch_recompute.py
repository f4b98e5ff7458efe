"""The port's ``fleet.recompute`` against the JAX package, in one process.

- ``recompute`` of a block (the output and every gradient) against JAX's
  ``fleet.recompute`` on the same weights within 1e-5, and bit for bit the
  port's own plain forward and gradients; ``recompute_sequential`` and
  ``no_recompute`` likewise; a tensor or a tuple comes back as the block
  returns, ``paddle.Tensor`` s or plain tensors;
- dropout 0.1 drawn from the process-wide ``dropout_generator``, from a
  layer's own generator and as the flash-attention hash's seed: the
  gradients with the block recomputed are bit for bit those without, from
  the same generator states. torch's checkpoint with its own
  ``preserve_rng_state`` (which restores torch's default generators only)
  gives other gradients on the same cases, which is what the port's
  recompute must not do;
- ``gpt_tiny`` at hidden and attention dropout 0.1 with every block
  recomputed: the loss and every gradient bit for bit the plain model's.
"""
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as torch_checkpoint

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu.distributed import fleet as jfleet

import paddle_tpu_torch as paddle
import paddle_tpu_torch.nn as nn
from paddle_tpu_torch.base import global_state
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.nn import functional as F


def _block(pkg_nn, act):
    class MLP(pkg_nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = pkg_nn.Linear(8, 16)
            self.fc2 = pkg_nn.Linear(16, 8)

        def forward(self, x):
            return self.fc2(act(self.fc1(x)))

    return MLP


def _pair():
    """The same MLP in both packages, the port's from the JAX weights."""
    jpaddle.seed(3)
    jblock = _block(jnn, lambda v: jpaddle.tanh(v))()
    block = _block(nn, torch.tanh)()
    gpt.load_jax_state(block, {k: np.asarray(v.numpy())
                               for k, v in jblock.state_dict().items()})
    return jblock, block


def _x():
    return np.random.RandomState(4).randn(4, 8).astype(np.float32)


def _port_grads(block, fn):
    x = torch.from_numpy(_x()).requires_grad_()
    y = fn(x)
    (y * y).sum().backward()
    out = [y.detach(), x.grad] + [p.grad for p in block.parameters()]
    block.clear_gradients()
    return out


def _jax_grads(block, fn):
    x = jpaddle.to_tensor(_x(), stop_gradient=False)
    y = fn(x)
    (y * y).sum().backward()
    out = [y.numpy(), x.grad.numpy()] + [
        p.grad.numpy() for p in block.parameters()]
    block.clear_gradients()
    return out


def _layout(block, values):
    """The port's gradients in the JAX layout (Linear weights [in, out])."""
    names = ["y", "x"] + [n for n, _ in block.named_parameters()]
    return [v.t().numpy() if n.endswith("weight") else v.numpy()
            for n, v in zip(names, values)]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    from paddle_tpu_torch import device as device_mod

    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


def test_recompute_matches_jax_and_the_plain_block():
    jblock, block = _pair()
    want = _jax_grads(jblock, lambda v: jfleet.recompute(jblock, v))
    plain = _port_grads(block, block)
    got = _port_grads(block, lambda v: fleet.recompute(block, v))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    for g, w in zip(_layout(block, got), want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_recompute_sequential_and_no_recompute_match_jax():
    jblock, block = _pair()
    jfirst, first = jnn.Tanh(), nn.Tanh()
    want = _jax_grads(jblock, lambda v: jfleet.recompute_sequential(
        None, [jfirst, jblock], v))
    got = _port_grads(block, lambda v: fleet.recompute_sequential(
        None, [first, block], v))
    plain = _port_grads(block, lambda v: block(first(v)))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    for g, w in zip(_layout(block, got), want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    no = _port_grads(block, lambda v: fleet.no_recompute(block, v))
    jno = _jax_grads(jblock, lambda v: jfleet.no_recompute(jblock, v))
    assert all(torch.equal(a, b) for a, b in zip(no, _port_grads(block,
                                                                 block)))
    for g, w in zip(_layout(block, no), jno):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_recompute_returns_a_tensor_or_a_tuple():
    x = paddle.to_tensor(_x(), stop_gradient=False)
    y = fleet.recompute(lambda v: v * 2.0, x)
    assert isinstance(y, paddle.Tensor)
    pair = fleet.recompute(lambda v: [v * 2.0, v + 1.0], x)
    assert isinstance(pair, tuple) and len(pair) == 2
    (pair[0].sum() + pair[1].sum()).backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full((4, 8), 3.0))
    plain = fleet.recompute(lambda v: v * 2.0, torch.from_numpy(_x()))
    assert type(plain) is torch.Tensor
    jy = jfleet.recompute(lambda v: v * 2.0, jpaddle.to_tensor(_x()))
    np.testing.assert_array_equal(jy.numpy(), plain.numpy())


class _Dropping(nn.Layer):
    """A block drawing dropout 0.1 from ``source``: the process-wide
    generator (an ``nn.Dropout`` built without one), its own generator,
    or the flash-attention hash's seed."""

    def __init__(self, source):
        super().__init__()
        self.source = source
        self.fc = nn.Linear(8, 32)
        self.drop = nn.Dropout(0.1)
        self.generator = torch.Generator().manual_seed(5)

    def forward(self, x):
        h = self.fc(x)
        if self.source == "process":
            return self.drop(torch.tanh(h))
        if self.source == "layer":
            return F.dropout(torch.tanh(h), 0.1, generator=self.generator)
        q = h.reshape(1, 4, 4, 8)
        return F.scaled_dot_product_attention(
            q, q * 0.5, q + 1.0, dropout_p=0.1, training=True,
            generator=self.generator).reshape(4, 32)


def _dropped_grads(block, wrap):
    """The block's gradients from fixed generator states."""
    global_state.dropout_generator("cpu").manual_seed(9)
    block.generator.manual_seed(5)
    torch.manual_seed(13)
    return _port_grads(block, wrap)


@pytest.mark.parametrize("source", ["process", "layer", "attention"])
def test_recompute_replays_dropout_bit_for_bit(source):
    block = _Dropping(source)
    block.train()
    plain = _dropped_grads(block, block)
    again = _dropped_grads(block, block)
    assert all(torch.equal(a, b) for a, b in zip(plain, again))
    got = _dropped_grads(block, lambda v: fleet.recompute(block, v))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    # a dropped element is 0 in the output: the masks acted
    assert (got[0] == 0).any() or source == "attention"
    # torch's checkpoint restores only torch's default generators: the
    # port's recompute must not be that
    torch_only = _dropped_grads(block, lambda v: torch_checkpoint.checkpoint(
        block, v, use_reentrant=False, preserve_rng_state=True))
    assert not all(torch.equal(a, b) for a, b in zip(torch_only[1:],
                                                     plain[1:]))


def test_recompute_without_preserved_draws_draws_anew():
    block = _Dropping("layer")
    block.train()
    plain = _dropped_grads(block, block)
    got = _dropped_grads(block, lambda v: fleet.recompute(
        block, v, preserve_rng_state=False))
    assert torch.equal(got[0], plain[0])
    assert not torch.equal(got[1], plain[1])


@pytest.mark.parametrize("o2", [False, True])
def test_recomputed_gpt_at_dropout_is_bit_for_bit_the_plain_gpt(o2):
    """And under bf16 O2: the replay runs in the backward, after
    ``auto_cast`` has ended, under the first run's AMP state."""
    from paddle_tpu_torch import amp

    cfg = gpt.gpt_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 16)))
    got = []
    for recomputed in (False, True):
        model = gpt.GPTForCausalLM(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0),
            dropout_seed=5).train()
        if recomputed:
            for block in model.gpt.h:
                block.forward = (lambda f: lambda x: fleet.recompute(f, x))(
                    block.forward)
        if o2:
            amp.decorate(model, level="O2", dtype="bfloat16", device="cpu")
        with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            logits = model(ids)
        loss = gpt.GPTPretrainingCriterion(cfg)(logits, ids)
        loss.backward()
        got.append([loss.detach()] + [p.grad for p in model.parameters()
                                      if p.grad is not None])
    assert len(got[0]) == len(got[1]) > 20
    assert all(torch.equal(a, b) for a, b in zip(*got))
