"""The port's training step against the JAX package's.

``TrainStep`` + ``AdamW`` + ``GPTPretrainingCriterion`` on ``gpt_tiny``
(dropout 0), with the JAX model's weights carried across by
``load_jax_state``, take 3 steps of ``AdamW(learning_rate=1e-3)`` on one
fixed batch of 4 × 32 ids in both packages. In f32 the losses and the
parameters after the steps match at ``rtol=1e-4, atol=1e-5``, the
tolerance ``tests/test_jit_amp.py`` holds the JAX ``TrainStep`` to against
its own eager path. In bf16 O2 (``amp.decorate`` + ``auto_cast`` around
the model, the criterion outside it, as ``bench.py`` runs it) they match
within 2e-2, relative for the losses: both packages round parameters and
activations to bf16, at places that differ by an ulp.

One carve-out in f32: where a parameter's first gradient is nonzero and
below 100x
Adam's epsilon (1e-8), the update ``g / (|g| + eps)`` turns the f32
summation-order noise of the two packages' gradients into a difference of
the update itself. An element there that misses the tolerance is held to
the size of the steps taken, ``STEPS * lr``; at most 1e-4 of the elements
may (one of 141k does).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_state)
from paddle_tpu_torch.optimizer import Adam, AdamW

STEPS = 3


def _jax_numpy(t):
    return np.asarray(t.numpy()).astype(np.float32)


def _jax_run(tied, o2, ids):
    paddle.seed(0)
    cfg = jax_gpt_tiny(tie_word_embeddings=tied)
    model = JaxGPT(cfg)
    # copies: the JAX step donates (and overwrites) the parameter buffers
    state = {k: np.array(v.numpy(), copy=True)
             for k, v in model.state_dict().items()}
    crit = JaxCriterion(cfg)
    if o2:
        paddle.amp.decorate(model, level="O2", dtype="bfloat16")
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())

    def loss_fn(x):
        if o2:
            with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(x)
        else:
            logits = model(x)
        return crit(logits, x)

    step = JaxTrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    x = paddle.Tensor(ids, stop_gradient=True)
    losses = [float(_jax_numpy(step(x))) for _ in range(STEPS)]
    params = {k: _jax_numpy(v) for k, v in model.state_dict().items()}
    return state, losses, params


def _port_run(tied, o2, ids, state):
    cfg = gpt_tiny(tie_word_embeddings=tied)
    model = GPTForCausalLM(cfg, device="cpu")
    load_jax_state(model, state).train()
    crit = GPTPretrainingCriterion(cfg)
    if o2:
        amp.decorate(model, level="O2", dtype="bfloat16", device="cpu")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                device="cpu")

    def loss_fn(x):
        if o2:
            with amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = model(x)
        else:
            logits = model(x)
        return crit(logits, x)

    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     device="cpu")
    x = torch.from_numpy(ids)
    loss_fn(x).backward()
    first_grads = {n: p.grad.detach().float().clone()
                   for n, p in model.named_parameters()}
    opt.clear_grad()
    losses = [float(step(x).float()) for _ in range(STEPS)]
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    as_jax = {n: (lambda t, n=n: (t.t() if n in linear else t).numpy())
              for n in first_grads}
    params = {n: as_jax[n](p.detach().float())
              for n, p in model.named_parameters()}
    tiny = {n: as_jax[n]((g != 0) & (g.abs() < 100 * 1e-8))
            for n, g in first_grads.items()}
    return losses, params, opt, tiny


@pytest.mark.parametrize("tied,o2", [(True, False), (False, True)])
def test_train_step_matches_jax(tied, o2):
    ids = np.random.RandomState(0).randint(0, 512, (4, 32)).astype(np.int64)
    state, jax_losses, jax_params = _jax_run(tied, o2, ids)
    losses, params, opt, tiny = _port_run(tied, o2, ids, state)
    rtol, atol = (2e-2, 2e-2) if o2 else (1e-4, 1e-5)
    np.testing.assert_allclose(losses, jax_losses, rtol=rtol, atol=0 if o2
                               else atol)
    assert losses[-1] < losses[0]
    assert sorted(params) == sorted(jax_params)
    n_loose = 0
    for name, want in jax_params.items():
        diff = np.abs(params[name] - want)
        loose = diff > atol + rtol * np.abs(want)
        if not o2:
            n_loose += int(loose.sum())
            loose &= ~(tiny[name] & (diff <= STEPS * 1e-3))
        assert not loose.any(), (name, float(diff.max()))
    assert n_loose <= 1e-4 * sum(p.size for p in params.values())
    # the same tensors moved in both (in bf16 the LayerNorm weights, 1.0,
    # cannot take a 1e-3 step: there is no f32 master copy in either), and
    # the optimizer kept f32 moments
    start = {n: v.astype(np.float32) for n, v in state.items()}
    moved = sorted(n for n in params if not np.array_equal(params[n],
                                                           start[n]))
    assert moved == sorted(n for n in jax_params
                           if not np.array_equal(jax_params[n], start[n]))
    assert len(moved) == len(params) if not o2 else len(moved) > 0
    sd = opt.state_dict()
    assert sd["@step"] == STEPS
    assert all(t.dtype == torch.float32 for k, t in sd.items() if k != "@step")


def test_criterion_and_adamw_step_match_jax():
    rs = np.random.RandomState(1)
    logits = rs.randn(2, 9, 512).astype(np.float32) * 3
    ids = rs.randint(0, 512, (2, 9)).astype(np.int64)
    cfg = gpt_tiny()
    want = float(_jax_numpy(JaxCriterion(jax_gpt_tiny())(
        paddle.to_tensor(logits), paddle.to_tensor(ids))))
    crit = GPTPretrainingCriterion(cfg)
    got = crit(torch.from_numpy(logits), torch.from_numpy(ids))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    # under O2 the criterion computes in f32 from bf16 logits
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        got16 = crit(torch.from_numpy(logits).bfloat16(),
                     torch.from_numpy(ids))
    assert got16.dtype == torch.float32
    assert float(got16) == pytest.approx(want, rel=1e-2)

    # two steps of Adam (L2 decay in the gradient) and of AdamW (decoupled
    # decay) on a bf16 parameter, weight decay 0.01, the LR changed between
    # them: both packages round to bf16 at the same places
    w0 = rs.randn(16, 8).astype(np.float32)
    grads = [rs.randn(16, 8).astype(np.float32) for _ in range(2)]
    for jax_cls, cls in ((paddle.optimizer.Adam, Adam),
                         (paddle.optimizer.AdamW, AdamW)):
        jw = Parameter(jnp.asarray(w0, jnp.bfloat16))
        jopt = jax_cls(learning_rate=0.05, weight_decay=0.01,
                       parameters=[jw])
        w = torch.nn.Parameter(torch.from_numpy(w0).bfloat16())
        opt = cls(learning_rate=0.05, weight_decay=0.01, parameters=[w],
                  device="cpu")
        for g, lr in zip(grads, (0.05, 0.02)):
            jopt.set_lr(lr)
            opt.set_lr(lr)
            jw._grad = jnp.asarray(g, jnp.bfloat16)
            w.grad = torch.from_numpy(g).bfloat16()
            jopt.step()
            opt.step()
            assert float(opt._lr_cell) == pytest.approx(lr)
        assert w.dtype == torch.bfloat16
        np.testing.assert_array_equal(w.detach().float().numpy(),
                                      _jax_numpy(jw), err_msg=cls.__name__)


def test_unported_training_options_raise():
    """What the port still refuses: TrainStep's shape bucketing and
    sharding, and float16 in the kernels K4-K7 (RMSNorm, FlashMask). The
    scheduler objects, grad_clip, groups, the other optimizers and their
    options, O1, float16, GradScaler and grad_accum_steps are ported
    (tests/test_torch_optim_api.py, tests/test_torch_amp_o1.py)."""
    from paddle_tpu_torch.ops.cuda import flashmask as fm
    from paddle_tpu_torch.ops.cuda import rms_norm as rms

    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    opt = AdamW(parameters=model.parameters(), device="cpu")
    assert amp.decorate(model, opt, level="O2", dtype="bfloat16",
                        device="cpu") == (model, opt)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    for kwargs, what in ((dict(bucket_axes={0: 1}), "bucketing"),
                         (dict(sharding="zero1"), "sharding")):
        with pytest.raises(NotImplementedError, match=what):
            TrainStep(model=model, optimizer=opt, loss_fn=lambda x: x,
                      device="cpu", **kwargs)
    # grad_accum_steps is accepted and read nowhere, as in the JAX package
    TrainStep(model=model, optimizer=opt, loss_fn=lambda x: x,
              grad_accum_steps=4, device="cpu")
    half = torch.zeros(4, 8, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rms._dtype_codes(half, half[0])
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        with pytest.raises(TypeError, match="float16 K5-K7"):
            fm.kernel_for(name, torch.float16)
    with pytest.raises(ValueError, match="generator"):
        F.dropout(torch.ones(4), 0.5, training=True, generator=None)
