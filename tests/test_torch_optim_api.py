"""The port's training-step API against the JAX package's, on the CPU.

- Every LR scheduler's value stream over 30 steps, and a ``state_dict``
  round trip in the middle of it, exact to 1e-12 (pure host Python in both
  packages).
- Each optimizer's parameters after 3 steps from numpy-seeded parameters
  and gradients. The JAX optimizer gets its LR as an f32 array
  (``_lr_override``), as its ``TrainStep`` traces it, since the port's LR is
  always an f32 device scalar. f32: within 1e-6 relative (torch's and XLA's
  ``pow`` and reductions may differ in the last bit). bf16 (f32 moments, no
  master copy): bit for bit where the rule multiplies no bf16 tensor by a
  Python scalar (SGD, Momentum, Adagrad, Lamb, Adam, AdamW); where it does
  (RMSProp's, Adadelta's and Adamax's ``(1 - rho) · g``), jnp rounds the
  scalar to bf16 first and torch does not, and those are held within two
  bf16 steps (2^-6 of the value) plus 1e-3.
- The three clips (f32 within 1e-6 relative; bf16 and fp16 within one step
  of their dtype), ``need_clip``, parameter groups, ``optimize_attr``,
  ``L1Decay``/``L2Decay`` (both fold ``coeff · p`` into the gradient, as in
  JAX), ``lr_ratio``, ``apply_decay_param_fun``, ``amsgrad``; AdamW reads no
  group ``weight_decay`` in either package.
- ``cross_entropy`` and ``CrossEntropyLoss`` in every reduction, with class
  weights, soft labels, label smoothing, ``ignore_index``, ``axis`` and
  ``use_softmax=False``, within 1e-6.
- ``gpt_tiny`` under ``TrainStep`` with a pretraining recipe (warmup then
  cosine LR, two parameter groups, no decay on biases, norms and
  embeddings, global-norm clipping) against the JAX ``TrainStep`` over 6
  steps: losses and parameters within 1e-5.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Parameter as JaxParameter
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.gpt import GPTPretrainingCriterion as JaxCriterion
from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.regularizer import L1Decay as JaxL1, L2Decay as JaxL2
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny,
                                         load_jax_state)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.regularizer import L1Decay, L2Decay

# ------------------------------------------------------------- schedulers
SCHEDULERS = {
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=1.0),
    "PiecewiseDecay": dict(boundaries=[3, 9], values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.5, gamma=0.1),
    "InverseTimeDecay": dict(learning_rate=0.5, gamma=0.2),
    "PolynomialDecay": dict(learning_rate=0.5, decay_steps=7, end_lr=0.01,
                            power=2.0, cycle=True),
    "LinearWarmup": dict(learning_rate=0.3, warmup_steps=5, start_lr=0.0,
                         end_lr=0.3),
    "ExponentialDecay": dict(learning_rate=0.5, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.5, milestones=[4, 11], gamma=0.3),
    "StepDecay": dict(learning_rate=0.5, step_size=4, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.5, lr_lambda=lambda e: 0.95 ** e),
    "MultiplicativeDecay": dict(learning_rate=0.5,
                                lr_lambda=lambda e: 0.9),
    "ReduceOnPlateau": dict(learning_rate=0.5, patience=2, factor=0.5,
                            cooldown=1),
    "CosineAnnealingDecay": dict(learning_rate=0.5, T_max=12,
                                 eta_min=0.01),
    "OneCycleLR": dict(max_learning_rate=0.5, total_steps=25),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.5,
                     step_size_up=4, step_size_down=6, mode="triangular2"),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.5, T_0=5, T_mult=2,
                                        eta_min=0.01),
    "LinearLR": dict(learning_rate=0.5, total_steps=10),
}
# LinearWarmup around a cosine schedule, as a GPT recipe chains them
NESTED = "LinearWarmup(CosineAnnealingDecay)"
METRICS = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.61, 0.62, 0.63] * 3


def _make_scheduler(mod, name):
    if name == NESTED:
        inner = mod.CosineAnnealingDecay(6e-4, T_max=12, eta_min=6e-5)
        return mod.LinearWarmup(inner, warmup_steps=4, start_lr=0.0,
                                end_lr=6e-4)
    return getattr(mod, name)(**SCHEDULERS[name])


def _stream(sched, name, steps):
    out = []
    for i in range(steps):
        out.append(sched())
        if name == "ReduceOnPlateau":
            sched.step(METRICS[i])
        else:
            sched.step()
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS) + [NESTED])
def test_scheduler_stream_and_state_dict_match_jax(name):
    want = _stream(_make_scheduler(jlr, name), name, 30)
    got = _stream(_make_scheduler(plr, name), name, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # a round trip of the state after 10 steps, then 20 more
    a = _make_scheduler(plr, name)
    _stream(a, name, 10)
    b = _make_scheduler(plr, name)
    b.set_state_dict(a.state_dict())
    ref = _make_scheduler(jlr, name)
    _stream(ref, name, 10)
    assert b() == pytest.approx(ref(), abs=1e-12)
    rest = [b()] + _stream(b, name, 20)[1:]
    np.testing.assert_allclose(
        rest, [ref()] + _stream(ref, name, 20)[1:], rtol=0, atol=1e-12)


def test_scheduler_drives_the_optimizer_lr():
    p = torch.nn.Parameter(torch.ones(3))
    sched = plr.StepDecay(0.5, step_size=2, gamma=0.1)
    opt = optimizer.SGD(learning_rate=sched, parameters=[p], device="cpu")
    seen = []
    for _ in range(4):
        p.grad = torch.ones(3)
        opt.step()
        seen.append(float(opt._lr_cell))
        sched.step()
    np.testing.assert_allclose(seen, [0.5, 0.5, 0.05, 0.05], rtol=1e-6)
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    state = opt.state_dict()
    assert state["LR_Scheduler"]["last_epoch"] == 4
    fresh = optimizer.SGD(learning_rate=plr.StepDecay(0.5, step_size=2,
                                                      gamma=0.1),
                          parameters=[p], device="cpu")
    fresh.set_state_dict(state)
    assert fresh.get_lr() == pytest.approx(sched())
    assert fresh.state_dict()["@step"] == 4


# ------------------------------------------------------------- optimizers
SHAPES = [(6, 4), (5,), (3, 3)]
STEP_LRS = (0.05, 0.02, 0.03)


def _ratio(p):
    return 0.5 if len(tuple(p.shape)) == 1 else 1.0


OPTIMIZERS = {
    "SGD": ("SGD", {}),
    "SGD-L2": ("SGD", dict(weight_decay=0.01)),
    "Momentum": ("Momentum", dict(momentum=0.9)),
    "Momentum-nesterov": ("Momentum", dict(momentum=0.9, use_nesterov=True)),
    "Adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
    "RMSProp": ("RMSProp", dict(rho=0.9)),
    "RMSProp-centered": ("RMSProp", dict(rho=0.9, centered=True,
                                         momentum=0.9)),
    "Adadelta": ("Adadelta", dict(rho=0.9)),
    "Adamax": ("Adamax", {}),
    "Lamb": ("Lamb", dict(lamb_weight_decay=0.01)),
    "Adam-amsgrad": ("Adam", dict(amsgrad=True)),
    "AdamW-lr_ratio-amsgrad": ("AdamW", dict(lr_ratio=_ratio, amsgrad=True,
                                             weight_decay=0.1)),
}
# bf16 rules with a Python scalar times a bf16 tensor (see the docstring)
SCALAR_ROUNDED = {"SGD-L2", "RMSProp", "RMSProp-centered", "Adadelta",
                  "Adamax"}


def _opt_inputs(seed=0):
    rs = np.random.RandomState(seed)
    w0 = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in STEP_LRS]
    return w0, grads


def _jax_steps(cls_name, kw, w0, grads, dtype):
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    params = [JaxParameter(jnp.asarray(w, jd)) for w in w0]
    opt = getattr(paddle.optimizer, cls_name)(
        learning_rate=STEP_LRS[0], parameters=params, **kw)
    for lr, gs in zip(STEP_LRS, grads):
        for p, g in zip(params, gs):
            p._grad = jnp.asarray(g, jd)
        opt._lr_override = jnp.asarray(lr, jnp.float32)
        opt.step()
    return [np.asarray(p._value.astype(jnp.float32)) for p in params]


def _port_steps(cls_name, kw, w0, grads, dtype):
    params = [torch.nn.Parameter(torch.from_numpy(w.copy()).to(dtype))
              for w in w0]
    opt = getattr(optimizer, cls_name)(learning_rate=STEP_LRS[0],
                                       parameters=params, device="cpu", **kw)
    for lr, gs in zip(STEP_LRS, grads):
        for p, g in zip(params, gs):
            p.grad = torch.from_numpy(g).to(dtype)
        opt.set_lr(lr)
        opt.step()
    assert all(p.dtype == dtype for p in params)
    return [p.detach().float().numpy() for p in params]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_three_steps_match_jax(case, dtype):
    cls_name, kw = OPTIMIZERS[case]
    w0, grads = _opt_inputs()
    want = _jax_steps(cls_name, kw, w0, grads, dtype)
    got = _port_steps(cls_name, kw, w0, grads, dtype)
    for g, w in zip(got, want):
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                       err_msg=case)
        elif case in SCALAR_ROUNDED:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -6, atol=1e-3,
                                       err_msg=case)
        else:
            np.testing.assert_array_equal(g, w, err_msg=case)


def test_lbfgs_matches_jax_on_a_quadratic():
    rs = np.random.RandomState(3)
    a = rs.randn(6, 6).astype(np.float32)
    a = a @ a.T / 6 + np.eye(6, dtype=np.float32)
    b = rs.randn(6).astype(np.float32)
    x0 = np.zeros(6, np.float32)

    jx = paddle.Parameter(x0.copy())
    jopt = paddle.optimizer.LBFGS(learning_rate=0.5, max_iter=8,
                                  parameters=[jx])
    ja, jb = paddle.to_tensor(a), paddle.to_tensor(b)

    def jclosure():
        jopt.clear_grad()
        loss = 0.5 * (jx * paddle.matmul(ja, jx)).sum() - (jb * jx).sum()
        loss.backward()
        return loss

    jopt.step(jclosure)
    x = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    opt = optimizer.LBFGS(learning_rate=0.5, max_iter=8, parameters=[x],
                          device="cpu")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)

    def closure():
        opt.clear_grad()
        loss = 0.5 * (x * (ta @ x)).sum() - (tb * x).sum()
        loss.backward()
        return loss

    opt.step(closure)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx.numpy()),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(TypeError, match="closure"):
        TrainStep(optimizer=opt, loss_fn=closure, device="cpu")


# ------------------------------------------------------------------ clips
def _clip_pairs(dtype, seed=1):
    rs = np.random.RandomState(seed)
    gs = [(rs.randn(*s) * 3).astype(np.float32) for s in SHAPES]
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.float16: jnp.float16}[dtype]
    jps = [JaxParameter(jnp.zeros(s, jnp.float32)) for s in SHAPES]
    tps = [torch.nn.Parameter(torch.zeros(s)) for s in SHAPES]
    jps[1].need_clip = tps[1].need_clip = False
    jpairs = [(p, paddle.Tensor(jnp.asarray(g, jd))) for p, g in zip(jps, gs)]
    tpairs = [(p, torch.from_numpy(g).to(dtype)) for p, g in zip(tps, gs)]
    return jpairs, tpairs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "fp16"])
@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_clip_matches_jax(clip, dtype):
    arg = 2.5 if clip == "ClipGradByValue" else 4.0
    jpairs, tpairs = _clip_pairs(dtype)
    want = getattr(jnn, clip)(arg)(jpairs)
    got = getattr(nn, clip)(arg)(tpairs)
    for (_, g), (_, w), (_, g0) in zip(got, want, tpairs):
        wv = np.asarray(w._value).astype(np.float32)
        # each result in the dtype jnp gives it
        assert g.dtype == g0.dtype, clip
        step = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8,
                torch.float16: 2.0 ** -11}[dtype]
        np.testing.assert_allclose(g.float().numpy(), wv, rtol=step,
                                   atol=1e-6, err_msg=clip)
    # need_clip=False passes the gradient itself
    assert got[1][1] is tpairs[1][1]


def test_global_norm_clip_engages_and_keeps_its_norm():
    jpairs, tpairs = _clip_pairs(torch.float32)
    clip = nn.ClipGradByGlobalNorm(1.0)
    clip(tpairs)
    norm = math.sqrt(sum(float((g.double() ** 2).sum())
                         for p, g in tpairs if getattr(p, "need_clip", True)))
    assert float(clip.last_norm) == pytest.approx(norm, rel=1e-6)
    assert nn.GradientClipByGlobalNorm is nn.ClipGradByGlobalNorm


# ------------------------------------------ groups, attributes, decay
def test_groups_optimize_attr_and_regularizers_match_jax():
    w0, grads = _opt_inputs(5)

    def setup(make_param, mod_l1, mod_l2):
        ps = [make_param(w) for w in w0]
        ps[1].optimize_attr = {"learning_rate": 2.0}
        ps[2].regularizer = mod_l1(0.2)
        groups = [{"params": [ps[0]], "learning_rate": 0.5,
                   "weight_decay": mod_l2(0.1)},
                  {"params": ps[1:]}]
        return ps, groups

    jps, jgroups = setup(lambda w: JaxParameter(jnp.asarray(w)), JaxL1,
                         JaxL2)
    jopt = paddle.optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                                     parameters=jgroups,
                                     weight_decay=JaxL2(0.05))
    tps, tgroups = setup(lambda w: torch.nn.Parameter(
        torch.from_numpy(w.copy())),
                         L1Decay, L2Decay)
    topt = optimizer.Momentum(learning_rate=0.05, momentum=0.9,
                              parameters=tgroups, weight_decay=L2Decay(0.05),
                              device="cpu")
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp._grad = jnp.asarray(g)
            tp.grad = torch.from_numpy(g)
        jopt._lr_override = jnp.asarray(0.05, jnp.float32)
        jopt.step()
        topt.step()
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._value),
                                   rtol=1e-6, atol=1e-7)


def test_adamw_decay_fun_and_group_weight_decay():
    """``apply_decay_param_fun`` by name (the port's ``param_name``, JAX's
    generated name mapped to the same key), and AdamW ignoring a group's
    ``weight_decay`` in both packages."""
    w0, grads = _opt_inputs(6)
    keys = ["a.weight", "a.bias", "b.weight"]

    def decays(key):
        return not key.endswith(".bias")

    jps = [JaxParameter(jnp.asarray(w)) for w in w0]
    jkey = {p.name: k for p, k in zip(jps, keys)}
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0]
    for p, k in zip(tps, keys):
        p.param_name = k
    out = []
    for group_wd in (None, 0.7):
        def groups(ps):
            g = [{"params": ps[:2]}, {"params": ps[2:]}]
            if group_wd is not None:
                g[1]["weight_decay"] = group_wd
            return g
        jopt = paddle.optimizer.AdamW(
            learning_rate=0.05, parameters=groups(jps), weight_decay=0.1,
            apply_decay_param_fun=lambda n: decays(jkey[n]))
        topt = optimizer.AdamW(
            learning_rate=0.05, parameters=groups(tps), weight_decay=0.1,
            apply_decay_param_fun=decays, device="cpu")
        for p, w in zip(jps, w0):
            p._replace_value(jnp.asarray(w))
        with torch.no_grad():
            for p, w in zip(tps, w0):
                p.copy_(torch.from_numpy(w))
        for gs in grads:
            for jp, tp, g in zip(jps, tps, gs):
                jp._grad = jnp.asarray(g)
                tp.grad = torch.from_numpy(g)
            jopt._lr_override = jnp.asarray(0.05, jnp.float32)
            jopt.step()
            topt.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp._value), rtol=1e-6,
                                       atol=1e-7)
        out.append([tp.detach().clone() for tp in tps])
    # a group's weight_decay changes nothing
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_clear_grad_and_minimize():
    p = torch.nn.Parameter(torch.ones(3))
    opt = optimizer.SGD(learning_rate=0.5, parameters=[p], device="cpu")
    (p * 2).sum().backward()
    opt.clear_grad(set_to_zero=True)
    assert torch.equal(p.grad, torch.zeros(3))
    opt.clear_grad()
    assert p.grad is None
    _, pairs = opt.minimize((p * 2).sum())
    assert torch.equal(p.detach(), torch.zeros(3))
    assert torch.equal(pairs[0][1], torch.full((3,), 2.0))


# ---------------------------------------------------------- cross entropy
CE_CASES = {
    "hard": {},
    "hard-ignore": dict(ignore=True),
    "hard-weight": dict(weight=True, ignore=True),
    "hard-smooth": dict(label_smoothing=0.1, ignore=True),
    "hard-smooth-weight": dict(label_smoothing=0.1, weight=True),
    "hard-axis1": dict(axis=1),
    "hard-[N,1]": dict(keepdim=True),
    "soft": dict(soft=True),
    "soft-smooth": dict(soft=True, label_smoothing=0.2),
    "probs": dict(use_softmax=False),
}


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case, reduction):
    opts = CE_CASES[case]
    rs = np.random.RandomState(11)
    n, k = 12, 7
    axis = opts.get("axis", -1)
    logits = rs.randn(n, k).astype(np.float32)
    if axis == 1:
        logits = rs.randn(3, k, 4).astype(np.float32)
    kw = dict(reduction=reduction, axis=axis,
              label_smoothing=opts.get("label_smoothing", 0.0),
              use_softmax=opts.get("use_softmax", True))
    if not kw["use_softmax"]:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    if opts.get("soft"):
        label = rs.rand(n, k).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
        kw["soft_label"] = True
    elif axis == 1:
        label = rs.randint(0, k, (3, 4)).astype(np.int64)
    else:
        label = rs.randint(0, k, (n,)).astype(np.int64)
        if opts.get("ignore"):
            label[[1, 5]] = -100
        if opts.get("keepdim"):
            label = label[:, None]
    weight = rs.rand(k).astype(np.float32) + 0.5 if opts.get("weight") \
        else None
    want = np.asarray(JF.cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        weight=None if weight is None else paddle.to_tensor(weight),
        **kw).numpy())
    got = F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                          weight=None if weight is None
                          else torch.from_numpy(weight), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    layer = nn.CrossEntropyLoss(
        weight=None if weight is None else torch.from_numpy(weight), **kw)
    np.testing.assert_array_equal(
        layer(torch.from_numpy(logits), torch.from_numpy(label)).numpy(),
        got.numpy())


def test_softmax_with_cross_entropy_matches_jax():
    rs = np.random.RandomState(12)
    logits = rs.randn(5, 6).astype(np.float32)
    label = rs.randint(0, 6, (5, 1)).astype(np.int64)
    want_loss, want_sm = JF.softmax_with_cross_entropy(
        paddle.to_tensor(logits), paddle.to_tensor(label),
        return_softmax=True)
    loss, sm = F.softmax_with_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(label),
        return_softmax=True)
    assert loss.shape == (5, 1)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss.numpy()),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sm.numpy(), np.asarray(want_sm.numpy()),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="reduction"):
        F.cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                        reduction="batchmean")


# --------------------------------------------- the recipe through TrainStep
RECIPE_STEPS = 6


def _no_decay(key):
    return not (key.endswith(".bias") or ".ln" in key or "norm" in key
                or "embeddings" in key)


def _recipe(mod, params_by_key, key_of):
    """(a)'s recipe at gpt_tiny: warmup then cosine, embeddings in a group
    at half the LR, global-norm clip 1.0, AdamW with no decay on biases,
    norms and embeddings."""
    sched = mod.lr.LinearWarmup(
        mod.lr.CosineAnnealingDecay(6e-4, T_max=RECIPE_STEPS, eta_min=6e-5),
        warmup_steps=2, start_lr=0.0, end_lr=6e-4)
    emb = [p for k, p in params_by_key.items() if "embeddings" in k]
    rest = [p for k, p in params_by_key.items() if "embeddings" not in k]
    groups = [{"params": rest}, {"params": emb, "learning_rate": 0.5}]
    return sched, groups, dict(
        beta2=0.95, weight_decay=0.1,
        apply_decay_param_fun=lambda n: _no_decay(key_of(n)))


def test_pretraining_recipe_train_step_matches_jax():
    ids = np.random.RandomState(0).randint(0, 512, (2, 16)).astype(np.int64)
    paddle.seed(0)
    cfg = jax_gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    jmodel = JaxGPT(cfg)
    state = {k: np.array(v.numpy(), copy=True)
             for k, v in jmodel.state_dict().items()}
    jparams = dict(jmodel.named_parameters())
    jkey = {p.name: k for k, p in jparams.items()}
    sched, groups, kw = _recipe(paddle.optimizer, jparams, jkey.__getitem__)
    jopt = paddle.optimizer.AdamW(learning_rate=sched, parameters=groups,
                                  grad_clip=jnn.ClipGradByGlobalNorm(1.0),
                                  **kw)
    jcrit = JaxCriterion(cfg)
    jstep = JaxTrainStep(model=jmodel, optimizer=jopt,
                         loss_fn=lambda x: jcrit(jmodel(x), x))
    x = paddle.Tensor(ids, stop_gradient=True)
    want = []
    for _ in range(RECIPE_STEPS):
        want.append(float(np.asarray(jstep(x).numpy())))
        sched.step()
    want_params = {k: np.asarray(v.numpy()).astype(np.float32)
                   for k, v in jmodel.state_dict().items()}

    pcfg = gpt_tiny(hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    model = GPTForCausalLM(pcfg, device="cpu")
    load_jax_state(model, state).train()
    params = dict(model.named_parameters())
    assert all(p.param_name == k for k, p in params.items())
    psched, pgroups, pkw = _recipe(optimizer, params, lambda n: n)
    opt = optimizer.AdamW(learning_rate=psched, parameters=pgroups,
                          grad_clip=nn.ClipGradByGlobalNorm(1.0),
                          device="cpu", **pkw)
    crit = GPTPretrainingCriterion(pcfg)
    step = TrainStep(model=model, optimizer=opt,
                     loss_fn=lambda t: crit(model(t), t), grad_accum_steps=4,
                     device="cpu")
    got = []
    t = torch.from_numpy(ids)
    for _ in range(RECIPE_STEPS):
        got.append(float(step(t)))
        psched.step()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for k, p in params.items():
        v = p.detach()
        v = (v.t() if k in linear else v).numpy()
        np.testing.assert_allclose(v, want_params[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_new_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the default device on a host without CUDA")
    from paddle_tpu_torch import amp

    p = torch.nn.Parameter(torch.ones(2))
    for name, kw in (("SGD", {}), ("Momentum", {}), ("Adagrad", {}),
                     ("RMSProp", {}), ("Adadelta", {}), ("Adamax", {}),
                     ("Lamb", {}), ("LBFGS", {}), ("Adam", {}),
                     ("AdamW", {})):
        kw = dict(kw, learning_rate=0.1, parameters=[p])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(optimizer, name)(**kw)
        getattr(optimizer, name)(device="cpu", **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        amp.GradScaler()
    amp.GradScaler(device="cpu")
