"""The port's multi-tensor Adam/AdamW update and the ``CompiledFunction``
graph cache, on the CPU.

The update (``ops/cuda/adamw.py``): ``Optimizer.step()`` hands every
parameter to ``adamw_update`` at once, which runs the plain version for CPU
tensors. Over 3 steps on several parameters (shapes 16×8, 7, 33×5, 1; the
LR changed between steps), from numpy-seeded inputs, it is held bit for bit
(tolerance 0) to the per-tensor rule the optimizer ran before, written out
below, and to the JAX ``Adam``/``AdamW`` bit for bit too, the tolerance of
``test_torch_train.py::test_criterion_and_adamw_step_match_jax``: in f32
and in bf16 (O2: bf16 parameters and gradients, f32 moments), AdamW with
and without decoupled decay, Adam with and without an L2 ``weight_decay``.
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda_train.py``).

``CompiledFunction`` runs eagerly on the CPU; its cache keys, its
``audit_report`` and the launch-counter bookkeeping it does around a
capture are checked here.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter
from paddle_tpu_torch.jit import CompiledFunction, TrainStep
from paddle_tpu_torch.jit import functionalize
from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny)
from paddle_tpu_torch.ops.cuda import adamw
from paddle_tpu_torch.optimizer import Adam, AdamW

SHAPES = [(16, 8), (7,), (33, 5), (1,)]
LRS = (0.05, 0.02, 0.03)
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def _per_tensor_rule(p, g, m, v, lr, step, coeff, weight_decay):
    """The optimizer's update before the multi-tensor path, one tensor at
    a time, as ``AdamW._apply_one`` then ``Adam._apply_one`` ran it."""
    if coeff:
        p.copy_((p.float() * (1 - lr * coeff)).to(p.dtype))
    if weight_decay is not None:
        g = g + float(weight_decay) * p
    gv = g.float()
    t = step.float()
    m.mul_(BETA1).add_((1 - BETA1) * gv)
    v.mul_(BETA2).add_((1 - BETA2) * gv * gv)
    mhat = m / (1 - BETA1 ** t)
    vhat = v / (1 - BETA2 ** t)
    p.copy_((p.float() - lr * mhat / (vhat.sqrt() + EPS)).to(p.dtype))


def _inputs(seed):
    rs = np.random.RandomState(seed)
    w0 = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rs.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in LRS]
    return w0, grads


# optimizer, its weight_decay argument, AdamW's coeff, Adam's L2 decay
CASES = {
    "adamw": (AdamW, paddle.optimizer.AdamW, 0.01, 0.01, None),
    "adamw_no_decay": (AdamW, paddle.optimizer.AdamW, 0.0, 0.0, None),
    "adam_l2": (Adam, paddle.optimizer.Adam, 0.01, 0.0, 0.01),
    "adam": (Adam, paddle.optimizer.Adam, None, 0.0, None),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_tensor_update_matches_per_tensor_rule_and_jax(case, dtype):
    cls, jax_cls, wd_arg, coeff, l2 = CASES[case]
    tdt = getattr(torch, dtype)
    w0, grads = _inputs(3)
    params = [torch.nn.Parameter(torch.tensor(w, dtype=tdt)) for w in w0]
    opt = cls(learning_rate=LRS[0], weight_decay=wd_arg, parameters=params,
              device="cpu")
    rule = [torch.tensor(w, dtype=tdt) for w in w0]
    moments = [(torch.zeros(s), torch.zeros(s)) for s in SHAPES]
    jparams = [Parameter(jnp.asarray(w, getattr(jnp, dtype))) for w in w0]
    jopt = jax_cls(learning_rate=LRS[0], weight_decay=wd_arg,
                   parameters=jparams)
    launched = adamw.launches
    for k, (gs, lr) in enumerate(zip(grads, LRS)):
        opt.set_lr(lr)
        jopt.set_lr(lr)
        for p, jp, g in zip(params, jparams, gs):
            p.grad = torch.from_numpy(g).to(tdt)
            jp._grad = jnp.asarray(g, getattr(jnp, dtype))
        opt.step()
        jopt.step()
        step = torch.tensor(k + 1, dtype=torch.int32)
        lr_cell = torch.tensor(lr, dtype=torch.float32)
        for p, g, (m, v) in zip(rule, gs, moments):
            _per_tensor_rule(p, torch.from_numpy(g).to(tdt), m, v, lr_cell,
                             step, coeff, l2)
    assert adamw.launches == launched  # the CPU runs the plain version
    sd = opt.state_dict()
    assert sd["@step"] == len(LRS)
    for i, (p, want, jp, (m, v)) in enumerate(zip(params, rule, jparams,
                                                  moments)):
        assert p.dtype == tdt
        assert torch.equal(p.detach(), want), (case, dtype, i)
        assert torch.equal(sd[f"{i}_moment1"], m)
        assert torch.equal(sd[f"{i}_moment2"], v)
        np.testing.assert_array_equal(
            p.detach().float().numpy(),
            np.asarray(jp.numpy()).astype(np.float32),
            err_msg=f"{case} {dtype} parameter {i} against JAX")


def test_update_checks_its_lists():
    p = torch.zeros(3)
    lr, step = torch.tensor(0.1), torch.tensor(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="one entry per parameter"):
        adamw.adamw_update([p], [], [], [], lr, step, beta1=BETA1,
                           beta2=BETA2, eps=EPS, device="cpu")
    with pytest.raises(ValueError, match="shapes differ"):
        adamw.adamw_update([p], [torch.zeros(4)], [torch.zeros(3)],
                           [torch.zeros(3)], lr, step, beta1=BETA1,
                           beta2=BETA2, eps=EPS, device="cpu")
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError, match="update was asked for"):
        adamw.adamw_update([meta], [meta], [meta], [meta],
                           lr.to("meta"), step.to("meta"), beta1=BETA1,
                           beta2=BETA2, eps=EPS, device="cpu")
    with pytest.raises(ValueError, match="must lie with the parameters"):
        adamw.adamw_update([p], [p], [p], [p], lr.to("meta"), step,
                           beta1=BETA1, beta2=BETA2, eps=EPS, device="cpu")


def test_cache_key_follows_the_signature():
    mode = ["train"]
    fn = CompiledFunction(lambda x, n=1: x * n, static_key_fn=lambda: mode[0],
                          device="cpu")
    x = torch.zeros(4, 8)
    key = fn._cache_key((x,), {})
    assert fn._cache_key((torch.ones(4, 8),), {}) == key  # values: no
    assert fn._cache_key((torch.zeros(4, 9),), {}) != key  # shape
    assert fn._cache_key((x.double(),), {}) != key  # dtype
    assert fn._cache_key((x,), {"n": 2}) != key  # a static argument
    assert fn._cache_key(([x],), {}) != key  # the tree
    mode[0] = "eval"
    assert fn._cache_key((x,), {}) != key  # train or eval
    with pytest.raises(TypeError, match="hashable"):
        fn._cache_key(({1, 2},), {})


def test_train_step_audit_report_on_the_cpu():
    cfg = gpt_tiny()
    model = GPTForCausalLM(cfg, device="cpu").train()
    crit = GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                device="cpu")
    step = TrainStep(model=model, optimizer=opt,
                     loss_fn=lambda x: crit(model(x), x), device="cpu")
    rs = np.random.RandomState(0)
    a = torch.from_numpy(rs.randint(0, 512, (2, 16)))
    b = torch.from_numpy(rs.randint(0, 512, (2, 8)))
    losses = [float(step(x)) for x in (a, a, b)]
    assert all(np.isfinite(losses))
    model.eval()
    step(a)
    report = step.audit_report()
    assert report["name"] == "train_step"
    assert report["device"] == "cpu"
    assert report["n_cache_keys"] == 3  # (2, 16) train, (2, 8), eval
    assert report["total_captures"] == 0
    assert [k["captures"] for k in report["keys"]] == [0, 0, 0]
    assert [k["replays"] for k in report["keys"]] == [0, 0, 0]
    assert all(k["eager"] for k in report["keys"])
    assert report["stats"] == {"compiled_steps": 0, "eager_steps": 4}
    assert step.stats is step._compiled.stats
    assert opt.state_dict()["@step"] == 4


def test_launch_counters_take_back_and_replay_a_capture():
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    before = functionalize.launch_counters()
    assert (adamw, "launches", None) in before
    assert (fa, "dropout_launches", "fwd") in before
    delta = {(adamw, "launches", None): 3, (fa, "dropout_launches", "fwd"): 2}
    functionalize._add_counters(delta)
    assert adamw.launches == before[(adamw, "launches", None)] + 3
    assert fa.dropout_launches["fwd"] == before[(fa, "dropout_launches",
                                                 "fwd")] + 2
    functionalize._add_counters(delta, -1)
    assert functionalize.launch_counters() == before
