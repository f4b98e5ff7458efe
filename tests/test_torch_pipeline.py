"""The port's pipeline parallelism (``distributed.fleet.pipeline``,
``pipeline_schedules``) against the JAX package.

The pure helpers (``chunk_permutation``, the tick rule of ``_solve_tick``,
``schedule_cost_report``) are held to the JAX functions in this process.
One launch of 4 gloo ranks (``torch_pipeline_cases.py``'s ``pipeline``
suite, started once for the file, in the background while the JAX side
runs) holds, each against the JAX package on 4 of its 8 CPU devices on the
same global state, f32:

- ``PipelinedStack`` of the JAX test's ``Block`` on ``pp4`` and ``pp2 x
  dp2`` under rotation, 1F1B, eager 1F1B, ZB-H1, the interleaved rotation
  and the interleaved 1F1B (v = 2): the output within 1e-5 and every
  gradient (stacked weights, input) within 1e-4 of its largest element,
  against JAX's stack; each rank's units in the order of the tick rules
  and its most held chunk inputs within the schedule's bound (1F1B:
  ``2(p−1−s)``; rotation: ``m·v``);
- ``gpt_tiny(pipeline_parallel, pp_schedule="1f1b")``,
  ``llama_tiny(pipeline_parallel)`` on ``pp2 x dp2`` and
  ``llama_tiny(pipeline_parallel, tensor_parallel)`` on ``pp2 x mp2`` under
  ``fleet.distributed_model``: the logits within 1e-5, the loss, one AdamW
  step's parameters against JAX's pipelined models (which run pp × mp on
  the CPU), the edges bit-equal over ``pp``, the carry bit for bit;
- ``PipelineLayer`` with heterogeneous edges and with a
  ``SharedLayerDesc`` tie, ``PipelineParallel.train_batch``;
- the round trip of an interleaved (permuted) stack's state and its
  ``layer_state_dict`` against JAX's;
- the ``ValueError`` s; dropout 0.5: each unit's masks replayed by its
  recompute, apart across stages and microbatches.

Whole results must be the same on every rank, bit for bit.
"""
import contextlib
import functools

import numpy as np
import pytest

import jax

import paddle_tpu as jpaddle
import paddle_tpu.nn as jnn
from paddle_tpu import models as jmodels
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed import fleet as jfleet
from paddle_tpu.distributed.fleet import pipeline as jpipeline
from paddle_tpu.distributed.fleet import pipeline_schedules as jps
from paddle_tpu.distributed.fleet import topology as jtopology

import torch_dist_cases as dist_cases
import torch_fleet_cases as fleet_cases
import torch_pipeline_cases as cases
from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps

N = 4


@contextlib.contextmanager
def jax_mesh(degrees):
    """``fleet.init`` of the JAX package with ``degrees`` over 4 of its
    devices; the environment and fleet's state are put back after."""
    env = jenv.instance()
    saved = (env.mesh, dict(env.axis_degrees), env.initialized)
    fleet_saved = (jtopology.get_hybrid_communicate_group(),
                   jfleet.fleet._strategy, jfleet.fleet._is_initialized)
    env.build_mesh = functools.partial(type(env).build_mesh, env,
                                       devices=jax.devices()[:N])
    st = jfleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": degrees.get("dp", 1),
                         "mp_degree": degrees.get("mp", 1),
                         "pp_degree": degrees.get("pp", 1)}
    jfleet.init(is_collective=True, strategy=st)
    try:
        yield
    finally:
        del env.build_mesh
        env.mesh, env.axis_degrees, env.initialized = saved
        jtopology.set_hybrid_communicate_group(fleet_saved[0])
        jfleet.fleet._strategy, jfleet.fleet._is_initialized = fleet_saved[1:]


class Block(jnn.Layer):
    """The JAX test's homogeneous residual block."""

    def __init__(self, width=cases.WIDTH):
        super().__init__()
        self.fc = jnn.Linear(width, width)

    def forward(self, x):
        from paddle_tpu.ops import math as om

        return x + om.tanh(self.fc(x))


def _np(t):
    """A JAX ``Tensor`` or array as an f32 numpy array."""
    value = t.numpy() if hasattr(t, "numpy") else t
    return np.array(np.asarray(value), dtype=np.float32, copy=True)


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def _grads(model):
    return {n: _np(p.grad) for n, p in model.named_parameters()
            if p.grad is not None}


# ------------------------------------------------------------ JAX side
def _build(inputs):
    """Every JAX object the ranks' inputs come from, each with a thunk
    computing its oracle (on its mesh) after the ranks have started."""
    thunks = {}
    for mesh, degrees in cases.MESHES.items():
        with jax_mesh(degrees):
            for idx, (name, schedule, v) in enumerate(cases.SCHEDULES):
                jpaddle.seed(7 + idx)
                stack = jps.PipelinedStack(
                    lambda: Block(), cases.LAYERS, num_chunks=v,
                    num_microbatches=cases.micro(degrees), schedule=schedule)
                key = f"stack/{mesh}/{name}"
                for k, val in _state(stack).items():
                    inputs[f"{key}/{k}"] = val
                thunks[key] = (degrees, functools.partial(_stack_oracle,
                                                          stack))
    for name, (degrees, kind, flags) in cases.MODELS.items():
        with jax_mesh(degrees):
            jpaddle.seed(0)
            cfg = cases.config(jmodels, kind, **flags)
            if kind == "gpt":
                pair = (jmodels.GPTForCausalLM(cfg),
                        jmodels.GPTPretrainingCriterion(cfg))
            else:
                pair = (jmodels.LlamaForCausalLM(cfg),
                        jmodels.LlamaPretrainingCriterion(cfg))
            for k, val in _state(pair[0]).items():
                inputs[f"model/{name}/{k}"] = val
            thunks[f"model/{name}"] = (
                degrees, functools.partial(_model_oracle, *pair))
    with jax_mesh({"pp": 4}):
        for name in ("hetero", "shared"):
            jpaddle.seed(9)
            layer = _jax_layer(name)
            for k, val in _state(layer).items():
                inputs[f"layer/{name}/{k}"] = val
            thunks[f"layer/{name}"] = ({"pp": 4}, functools.partial(
                _layer_oracle, name, layer))
    with jax_mesh({"pp": 2, "dp": 2}):
        jpaddle.seed(4)
        cfg = cases.config(jmodels, "llama", pipeline_parallel=True,
                           virtual_pp_degree=2)
        model = jmodels.LlamaForCausalLM(cfg)
        stack = model.llama.layers
        inputs.update({f"carry/{k}": v for k, v in _state(model).items()})
        thunks["carry"] = ({"pp": 2, "dp": 2}, lambda: {
            idx: {n: _np(v) for n, v in stack.layer_state_dict(idx).items()}
            for idx in range(cases.MODEL_LAYERS)})
    return thunks


def _jax_layer(name):
    if name == "hetero":
        descs = ([jpipeline.LayerDesc(jnn.Linear, 8, 16)]
                 + [jpipeline.LayerDesc(Block, cases.WIDTH)
                    for _ in range(4)]
                 + [jpipeline.LayerDesc(jnn.Linear, 16, 8)])
    else:
        descs = ([jpipeline.SharedLayerDesc("tied", jnn.Linear, 16, 16)]
                 + [jpipeline.LayerDesc(Block, cases.WIDTH)
                    for _ in range(4)]
                 + [jpipeline.SharedLayerDesc("tied", jnn.Linear, 16, 16)])
    return jpipeline.PipelineLayer(
        descs, num_stages=4, num_microbatches=4,
        loss_fn=lambda o, t: ((o - t) ** 2).mean())


def _stack_oracle(stack):
    x = jpaddle.to_tensor(cases.stack_x(), stop_gradient=False)
    y = stack(x)
    w = jpaddle.to_tensor(cases.weights(cases.STACK_X))
    (y * w).sum().backward()
    return {"y": _np(y), "x_grad": _np(x.grad), "grads": _grads(stack)}


def _model_oracle(model, crit):
    ids = jpaddle.Tensor(cases.batches(), stop_gradient=True)
    logits = model(ids)
    loss = crit(logits, ids)
    loss.backward()
    res = {"logits": _np(logits), "loss": float(_np(loss)),
           "grads": _grads(model)}
    jpaddle.optimizer.AdamW(learning_rate=cases.LR,
                            parameters=model.parameters()).step()
    res["params"] = _state(model)
    return res


def _layer_oracle(name, layer):
    rs = np.random.RandomState(2)
    x_np = rs.randn(*cases.LAYER_X).astype(np.float32)
    if name == "shared":
        x_np = np.concatenate([x_np, x_np], 1)
    x = jpaddle.to_tensor(x_np, stop_gradient=False)
    y = layer(x)
    w = jpaddle.to_tensor(cases.weights(tuple(y.shape), 1))
    (y * w).sum().backward()
    res = {"y": _np(y), "x_grad": _np(x.grad), "grads": _grads(layer),
           "names": sorted(n for n, _ in layer.named_parameters()),
           "stack_layers": layer._stack.num_layers}
    if name == "hetero":
        layer.clear_gradients()
        pp = jpipeline.PipelineParallel(layer)
        opt = jpaddle.optimizer.SGD(learning_rate=0.1,
                                    parameters=layer.parameters())
        x = jpaddle.to_tensor(x_np)
        target = jpaddle.to_tensor(cases.weights(cases.LAYER_X, 2))
        res["train_batch"] = {
            "loss": float(_np(pp.train_batch((x, target), opt))),
            "params": _state(layer),
            "eval": float(_np(pp.eval_batch((x, target))))}
    return res


def _run(out):
    inputs = {}
    proc = None
    try:
        thunks = _build(inputs)
        np.savez(out / "inputs.npz", **inputs)
        proc = cases.start_ranks(out)
        ref = {}
        for key, (degrees, thunk) in thunks.items():
            with jax_mesh(degrees):
                ref[key] = thunk()
        return {"ref": ref, "port": dist_cases.collect(proc)}
    finally:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return fleet_cases.once_per_run(
        tmp_path_factory, "torch_pipeline",
        lambda: _run(tmp_path_factory.mktemp("pipeline")))


@pytest.fixture(scope="module")
def port(results):
    return results["port"]


@pytest.fixture(scope="module")
def ref(results):
    return results["ref"]


def _close(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, g in want.items():
        top = float(np.abs(g).max())
        err = float(np.abs(got[name] - g).max())
        assert err <= 1e-4 * max(top, 1e-30), (what, name, err, top)


def _same_on_every_rank(port, *keys):
    def pick(res):
        for k in keys:
            res = res[k]
        return res

    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(equal, a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b
    for r in range(1, N):
        assert equal(pick(port[0]), pick(port[r])), (keys, r)


# ------------------------------------------------------------ pure helpers
@pytest.mark.parametrize("p,v,m", [(2, 1, 4), (4, 1, 8), (2, 2, 4)])
def test_tick_rule_permutation_and_cost_report_match_jax(p, v, m):
    layers = 4 * p * v
    assert ps.chunk_permutation(layers, p, v) == jps.chunk_permutation(
        layers, p, v)
    for d in range(p):
        for t in range(m * v + p - 1):
            j, c, i, active = (int(a) for a in jps._solve_tick(
                t, d, p=p, v=v, m=m))
            got = ps.solve_tick(t, d, p=p, v=v, m=m)
            assert got == ((j, c, i) if active else None), (t, d)
    if v == 1:
        for schedule in ("1f1b", "eager_1f1b", "zb"):
            assert ps.schedule_cost_report(p, m, schedule) == \
                jps.schedule_cost_report(p, m, schedule)
    with pytest.raises(ValueError, match="no cost model"):
        ps.schedule_cost_report(p, m, "rotation")


# ------------------------------------------------------------ stacks
def _expected_units(name, schedule, v, p, m, d):
    """Stage ``d``'s units by the JAX package's tick rules."""
    L = v * p

    def f_unit(t):
        j, c, i, active = (int(a) for a in jps._solve_tick(
            t, d, p=p, v=v, m=m))
        return ("F", c, i) if active else None

    fwd = [u for u in map(f_unit, range(m * v + p - 1)) if u]
    if schedule == "rotation":
        return fwd + [("B",) + u[1:] for u in reversed(fwd)]
    units = list(fwd)
    if v > 1:
        for u in range(m * v + v * p + p - 1):
            for jb in range(v):  # B(c, i) at inj(i) + 2L - 1 - c
                c = d + p * jb
                inj = u - (2 * L - 1) + c
                q, r = divmod(inj, L)
                if inj >= 0 and r < p and q * p + r < m:
                    units.append(("B", c, q * p + r))
            f = f_unit(u)
            if f and f[1] < L - 1:
                units.append(f)
        return units
    deferred = []
    for u in range(m + 2 * (p - 1)):
        i_b, i_f = u - 2 * (p - 1) + d, u - d
        if 0 <= i_b < m:
            if schedule == "zb" and u >= m + p - 1:
                units.append(("Bx", d, i_b))
                deferred.append(("W", d, i_b))
            else:
                units.append(("B", d, i_b))
        if 0 <= i_f < m and d < p - 1:
            units.append(("F", d, i_f))
    return units + deferred


@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
@pytest.mark.parametrize("name,schedule,v", cases.SCHEDULES)
def test_pipelined_stack_matches_jax(mesh, name, schedule, v, port, ref):
    key = f"stack/{mesh}/{name}"
    want = ref[key]
    got = port[0]["stacks"][key]
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-5)
    _close({"x": got["x_grad"]}, {"x": want["x_grad"]}, key)
    _close(got["grads"], want["grads"], key)
    for part in ("y", "x_grad", "grads"):
        _same_on_every_rank(port, "stacks", key, part)
    if name == "rotation":
        # remat=False keeps each unit's graph: the same bits
        assert all(port[r]["stacks"][key]["kept_graphs_equal"]
                   for r in range(N))


@pytest.mark.parametrize("mesh", sorted(cases.MESHES))
@pytest.mark.parametrize("name,schedule,v", cases.SCHEDULES)
def test_units_follow_the_tick_rule_within_the_memory_bound(
        mesh, name, schedule, v, port):
    p = cases.MESHES[mesh]["pp"]
    stages = set()
    for r in range(N):
        got = port[r]["stacks"][f"stack/{mesh}/{name}"]
        d, m = got["stage"], got["m"]
        stages.add(d)
        assert got["trace"] == _expected_units(name, schedule, v, p, m, d), \
            (mesh, name, r)
        if schedule == "rotation":
            assert got["peak"] == m * v
        elif v == 1:
            # 1F1B, eager 1F1B, ZB-H1: at most 2(p-1-s) inputs at a
            # tick's end; stage 0 reaches it
            assert got["peak"] <= 2 * (p - 1 - d)
            if d == 0:
                assert got["peak"] == min(m, 2 * (p - 1))
        else:
            assert got["peak"] <= 4 * p * v
            assert got["peak"] < m * v
    assert stages == set(range(p))


# ------------------------------------------------------------ models
@pytest.mark.parametrize("name", sorted(cases.MODELS))
def test_pipelined_model_matches_jax(name, port, ref):
    want = ref[f"model/{name}"]
    got = port[0]["models"][name]
    degrees, kind, _ = cases.MODELS[name]
    assert got["round_trip"]
    # DataParallel over dp; nothing to add over pp and mp
    assert got["wrapper"] == (
        "DataParallel" if degrees.get("dp", 1) > 1 else
        {"gpt": "GPTForCausalLM", "llama": "LlamaForCausalLM"}[kind])
    assert got["edges_equal"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-5)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert sorted(got["params"]) == sorted(want["params"])
    for pname, p in want["params"].items():
        # one AdamW step: an element whose gradient is near zero may move
        # by up to 2 LR by the sign of the packages' summation noise
        diff = np.abs(got["params"][pname] - p)
        g = np.abs(want["grads"].get(pname, np.zeros_like(p)))
        loose = diff > 1e-5 + 1e-5 * np.abs(p)
        assert (diff[loose] <= 2 * cases.LR).all(), pname
        assert (g[loose] <= 1e-3 * max(float(g.max()), 1e-30)).all(), pname
    _same_on_every_rank(port, "models", name)


# ------------------------------------------------------------ PipelineLayer
@pytest.mark.parametrize("name", ["hetero", "shared"])
def test_pipeline_layer_matches_jax(name, port, ref):
    want = ref[f"layer/{name}"]
    got = port[0]["layers"][name]
    assert got["stacked"] and got["stack_layers"] == want["stack_layers"]
    assert got["names"] == want["names"]
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=1e-5)
    _close({"x": got["x_grad"]}, {"x": want["x_grad"]}, name)
    _close(got["grads"], want["grads"], name)
    _same_on_every_rank(port, "layers", name, "grads")


def test_pipeline_parallel_train_batch_matches_jax(port, ref):
    want = ref["layer/hetero"]["train_batch"]
    got = port[0]["layers"]["train_batch"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert got["eval"] == pytest.approx(want["eval"], rel=1e-5)
    assert sorted(got["params"]) == sorted(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _same_on_every_rank(port, "layers", "train_batch")


# ------------------------------------------------------------ carry
def test_stacked_permuted_state_round_trip_and_layers(port, ref):
    for r in range(N):
        got = port[r]["carry"]
        assert got["keys"] and all(got["round_trip"].values()), r
        assert got["layers"].keys() == ref["carry"].keys()
        for idx, want in ref["carry"].items():
            assert sorted(got["layers"][idx]) == sorted(want)
            for n, v in want.items():
                assert np.array_equal(got["layers"][idx][n], v), (r, idx, n)
    # an interleaved stack over 2 stages holds 2 of the 4 stacked layers
    assert port[0]["carry"]["block"] == (0, 2)
    assert ps.chunk_permutation(4, 2, 2) == [0, 2, 1, 3]


def test_stack_errors(port):
    got = port[0]["errors"]
    assert "must divide by num_stages*num_chunks 4" in got["num_layers"]
    assert "ZB-H1 covers num_chunks == 1" in got["zb_chunks"]
    assert "unknown pipeline schedule 'gpipe'" in got["schedule"]
    assert "cannot split into ≥2 microbatches" in got["interleaved_batch"]
    _same_on_every_rank(port, "errors")


# ------------------------------------------------------------ dropout
def test_dropout_masks_differ_by_unit_and_replay_in_the_recompute(port):
    masks = {}
    for r in range(N):
        got = port[r]["dropout"]
        assert got["grads_equal"]
        for schedule in ("rotation", "1f1b"):
            res = got[schedule]
            assert res["seen"] == len(res["units"]) > 4
            # every run of a unit (its forward, the 1F1B backward's F,
            # the recompute) drew the unit's masks
            assert res["replayed"], (r, schedule)
        rot = got["rotation"]["masks"]
        assert got["1f1b"]["masks"].keys() == rot.keys()
        for unit, mask in rot.items():
            assert np.array_equal(got["1f1b"]["masks"][unit], mask)
            masks[unit] = mask
    # 4 stages x 4 microbatches, each its own mask, about half kept
    assert len(masks) == 16
    flat = [m.tobytes() for m in masks.values()]
    assert len(set(flat)) == 16
    kept = np.mean([m.mean() for m in masks.values()])
    assert 0.4 < kept < 0.6
    _same_on_every_rank(port, "dropout", "grads")
