"""The port's context parallelism (``distributed.fleet.context_parallel``)
against the JAX package.

One launch of 4 gloo ranks (``torch_fleet_cases.py``'s
``context_parallel`` suite, started once for the file, in the background
while the JAX side runs) holds:

- ``ring_attention`` (causal and not) and ``ulysses_attention`` (causal
  and not) over ``sep4``, ``[1, 256, 4, 16]`` f32, each rank on its 64
  positions: the output and the gradients of q, k and v for a weighted sum
  of it against JAX's functions on a 4-device ``sep4`` mesh (each compiled
  whole with its gradient), within JAX's own ``rtol 2e-4 / atol 2e-5``;
  the ring's K1 work a rank (rank ``r`` attends to ``r + 1`` blocks
  causally);
- ``ulysses_attention`` with 6 heads over 4 ranks raising ``ValueError``
  naming ``num_heads``, as JAX's does; at dropout 0.5 with every head
  alike, the four head groups' outputs all different (their masks are);
- ``gpt_tiny(context_parallel="ring")`` under ``fleet.distributed_model``
  over ``sep4`` (the gradients summed over the ``sep`` ranks, divided by
  the ``dp`` degree, 1), each rank on its 8 of the 32 positions of every
  row (positions global, labels shifted over the whole sequence): the
  logits within 1e-5 of the JAX GPT with ``context_parallel="ring"`` on
  the same mesh; the loss, the gradients within 1e-4 of each largest
  element and the parameters after one AdamW step against the JAX GPT
  without context parallelism on the same weights (the same function:
  JAX's ring is exact, and the tape through its ``shard_map`` takes about
  a minute on a CPU); two backwards before a step give twice its
  gradients.

Every rank's whole results must equal rank 0's bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.distributed.fleet import context_parallel as jcp
from paddle_tpu import models as jmodels

import torch_dist_cases as dist_cases
import torch_fleet_cases as cases
from test_torch_fleet import _np, jax_mesh

N = 4
FUNCTIONS = ["ring/causal_True", "ring/causal_False", "ulysses/causal_True",
             "ulysses/causal_False"]


def _jax_function(key, inputs):
    """The JAX function over the sep4 mesh, compiled whole with the
    gradient of the weighted sum of its output."""
    name, _, causal = key.partition("/causal_")
    fn = jcp.ring_attention if name == "ring" else jcp.ulysses_attention
    w = jnp.asarray(inputs["cp/w"])

    def loss(q, k, v):
        o = fn(JTensor(q), JTensor(k), JTensor(v),
               causal=causal == "True")._value
        return (o * w).sum(), o

    args = [jnp.asarray(inputs[f"cp/{n}"]) for n in ("q", "k", "v")]
    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2),
                                               has_aux=True))(*args)
    return {"o": np.asarray(o), **{f"{n}_grad": np.asarray(g) for n, g in
                                   zip(("q", "k", "v"), grads)}}


def _jax_model(ring, ids):
    """The JAX ring GPT's logits (its forward, eagerly), then the
    gradients, the loss and one AdamW step of the JAX GPT without context
    parallelism on the same weights, which computes the same function
    (JAX's ring attention is exact); the tape through the JAX ring's
    ``shard_map`` takes about a minute on a CPU, and the ring's gradient
    is held to JAX's in the function cases."""
    x = jpaddle.Tensor(ids, stop_gradient=True)
    with jpaddle.no_grad():
        res = {"logits": _np(ring(x))}
    state = {k: v for k, v in ring.state_dict().items()}
    model = jmodels.GPTForCausalLM(jmodels.gpt_tiny())
    model.set_state_dict(state)
    logits = model(x)
    loss = jmodels.GPTPretrainingCriterion(model.config)(logits, x)
    loss.backward()
    res.update(plain_logits=_np(logits), loss=float(_np(loss)),
               grads={n: _np(p.grad) for n, p in model.named_parameters()})
    jpaddle.optimizer.AdamW(learning_rate=cases.LR,
                            parameters=model.parameters()).step()
    res["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    return res


def _run(out):
    inputs = cases.cp_inputs()
    proc = None
    try:
        with jax_mesh(cases.SEP4):
            jpaddle.seed(1)
            model = jmodels.GPTForCausalLM(jmodels.gpt_tiny(
                context_parallel="ring"))
            for k, v in model.state_dict().items():
                inputs[f"cpgpt/{k}"] = _np(v)
            np.savez(out / "inputs.npz", **inputs)
            proc = cases.start_ranks("context_parallel", out)
            ref = {key: _jax_function(key, inputs) for key in FUNCTIONS}
            ref["model"] = _jax_model(model, cases.cp_model_ids())
            try:
                q = JTensor(jnp.zeros((1, 256, 6, 16), jnp.float32))
                jcp.ulysses_attention(q, q, q)
                ref["ulysses_heads"] = "no error"
            except ValueError as e:
                ref["ulysses_heads"] = str(e)
        return ref, dist_cases.collect(proc)
    finally:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX side's results and the ranks' (``(ref, port)``)."""
    return cases.once_per_run(
        tmp_path_factory, "torch_context_parallel",
        lambda: _run(tmp_path_factory.mktemp("context_parallel")))


@pytest.fixture(scope="module")
def port(setup):
    return setup[1]


def test_attention_matches_jax(port, setup):
    for key in FUNCTIONS:
        want = setup[0][key]
        got = port[0]["functions"][key]
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value, rtol=2e-4,
                                       atol=2e-5, err_msg=f"{key} {name}")
            for r in range(1, N):
                np.testing.assert_array_equal(
                    port[r]["functions"][key][name], got[name])


def test_ulysses_heads_must_divide(port, setup):
    want = setup[0]["ulysses_heads"]
    assert "num_heads 6" in want
    for res in port:
        assert res["functions"]["ulysses_heads"] == want


def test_ulysses_dropout_masks_differ_across_head_groups(port):
    """Every head alike, dropout 0.5 over sep4 (rank r holds head r after
    the all-to-all): no two heads' outputs are equal, though without
    dropout they all are. The ranks' seeds differ by their coordinate."""
    for res in port:
        got = res["functions"]["ulysses_dropout"]
        assert got["plain_equal_heads"] and got["acted"]
        assert got["equal_heads"] == [], got["equal_heads"]


def test_ring_gpt_step_matches_jax(port, setup):
    want = setup[0]["model"]
    got = port[0]["model"]
    assert got["wrapper"] == "DataParallel" and got["divisor"] == 1
    # causal ring: rank r attends to r + 1 blocks, the last rank to all
    assert [res["model"]["ring_blocks"] for res in port] == [1, 2, 3, 4]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(want["plain_logits"], want["logits"], rtol=0,
                               atol=1e-5)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in want["grads"].items():
        top = float(np.abs(g).max())
        err = float(np.abs(got["grads"][name] - g).max())
        assert err <= 1e-4 * top, (name, err, top)
    for name, p in want["params"].items():
        diff = np.abs(got["params"][name] - p)
        g = np.abs(want["grads"][name])
        loose = diff > 1e-5 + 1e-5 * np.abs(p)
        assert (diff[loose] <= 2 * cases.LR).all(), name
        assert (g[loose] <= 1e-3 * max(float(g.max()), 1e-30)).all(), name
    # two backwards before a step: twice one backward's gradients (each
    # summed over the sep ranks once)
    for name, g in want["grads"].items():
        top = 2 * float(np.abs(g).max())
        err = float(np.abs(got["grads_twice"][name] - 2 * g).max())
        assert err <= 1e-4 * top, (name, err, top)
    for res in port[1:]:
        assert res["model"]["loss"] == got["loss"]
        for name in got["params"]:
            np.testing.assert_array_equal(res["model"]["params"][name],
                                          got["params"][name])
            np.testing.assert_array_equal(res["model"]["grads"][name],
                                          got["grads"][name])
