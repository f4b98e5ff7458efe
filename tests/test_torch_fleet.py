"""The port's fleet tier (``distributed.fleet``) against the JAX package.

One launch of 4 gloo ranks (``torch_fleet_cases.py``'s ``fleet`` suite,
started once for the file, in the background while the JAX side runs)
holds:

- ``HybridCommunicateGroup`` on ``dp2 x mp2`` and ``mp2 x sep2``: the
  degrees, the parallel mode, the topology and the groups' sizes those of
  the JAX package's on the same meshes; each group's members the mesh's
  (a rank's coordinates are real here, where the JAX single controller
  says 0);
- each ``mpu`` layer over ``mp4`` — ``ColumnParallelLinear`` with and
  without ``gather_output``, the Megatron column → row pair,
  ``RowParallelLinear`` on a whole input, the sequence-parallel pair,
  ``VocabParallelEmbedding``, ``ParallelCrossEntropy`` with an ignored
  label — forward and the gradients of a weighted sum of the output,
  against the JAX layers on a 4-device ``mp4`` mesh, f32, within 1e-5;
- ``gpt_tiny`` and ``llama_tiny`` with ``tensor_parallel`` +
  ``sequence_parallel`` and ``bert_tiny`` (``BertForPretraining``) with
  ``tensor_parallel``, under ``fleet.distributed_model`` on ``dp2 x mp2``
  (``DataParallel`` over ``dp``, the sequence-parallel hooks over ``mp``),
  each rank on its 2 of the 4 rows, from the JAX TP model's global state
  (``load_jax_state`` cuts each rank's part): the logits within 1e-5, the
  loss, every gradient within 1e-4 of its largest element, and the
  parameters after one AdamW step against the JAX TP models on the same
  mesh of 4 devices (JAX's tape and eager AdamW: a ``TrainStep`` of a TP
  model compiles for 15-25 s on a CPU); ``jax_state_dict`` gives the
  loaded state back bit for bit (Llama's packed ``[q|k|v]`` and
  ``[gate|up]`` cut block by block); two backwards before a step (both
  reduced, the first under ``no_sync``, or the SP hooks at
  ``accumulation_steps=2``) give twice the JAX gradients;
- at hidden and attention dropout 0.1, the replicated residual streams of
  a tensor-parallel GPT equal bit for bit on the ranks of an ``mp`` group;
- ``DistributedBatchSampler``'s default under ``mp2``: the ``dp`` degree
  and coordinate, the same rows on both ranks of an ``mp`` group.

Every rank's whole results must equal rank 0's bit for bit.
"""
import contextlib
import functools

import numpy as np
import pytest

import jax

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.fleet import mpu as jmpu
from paddle_tpu.distributed.fleet import sequence_parallel as jsp
from paddle_tpu.distributed.fleet import topology as jtopology
from paddle_tpu import models as jmodels

import torch_dist_cases as dist_cases
import torch_fleet_cases as cases

N = 4


@contextlib.contextmanager
def jax_mesh(degrees):
    """The JAX package's mesh over 4 of its devices with ``degrees``
    (meshes rebuilt inside stay on those 4); the environment is put back
    after."""
    env = jenv.instance()
    saved = (env.mesh, dict(env.axis_degrees), env.initialized)
    env.build_mesh = functools.partial(type(env).build_mesh, env,
                                       devices=jax.devices()[:N])
    env.build_mesh(degrees)
    try:
        yield
    finally:
        del env.build_mesh
        env.mesh, env.axis_degrees, env.initialized = saved


def _np(t):
    return np.array(np.asarray(t.numpy()), dtype=np.float32, copy=True)


def _jax_model(kind):
    cfg = cases._config(jmodels, kind)
    jpaddle.seed(0)
    if kind == "gpt":
        return (jmodels.GPTForCausalLM(cfg),
                jmodels.GPTPretrainingCriterion(cfg))
    if kind == "llama":
        return (jmodels.LlamaForCausalLM(cfg),
                jmodels.LlamaPretrainingCriterion(cfg))
    return jmodels.BertForPretraining(cfg), None


def _loss(kind, model, crit, ids):
    if kind == "bert":
        out = model(ids)
        return out[0], cases.bert_loss(JF, out, ids)
    logits = model(ids)
    return logits, crit(logits, ids)


def _jax_tp_model(kind, model, crit):
    """The JAX TP model on dp2 x mp2 over the whole batch: the logits, the
    loss and the gradients from the tape, then one AdamW step."""
    ids = jpaddle.Tensor(cases.batches(), stop_gradient=True)
    logits, loss = _loss(kind, model, crit, ids)
    loss.backward()
    res = {"logits": _np(logits), "loss": float(_np(loss)),
           "grads": {n: _np(p.grad) for n, p in model.named_parameters()
                     if p.grad is not None}}
    jpaddle.optimizer.AdamW(learning_rate=cases.LR,
                            parameters=model.parameters()).step()
    res["params"] = {k: _np(v) for k, v in model.state_dict().items()}
    return res


def _run(out):
    """The launcher running the ranks, started as soon as their inputs (the
    JAX TP models' global states among them) are written, the JAX side's
    results computed meanwhile, then the ranks' results."""
    inputs = cases.layer_inputs()
    proc = None
    try:
        with jax_mesh(cases.TP_MESH):
            models = {kind: _jax_model(kind) for kind in cases.MODELS}
            for kind, (model, _) in models.items():
                for k, v in model.state_dict().items():
                    inputs[f"{kind}/{k}"] = _np(v)
            np.savez(out / "inputs.npz", **inputs)
            proc = cases.start_ranks("fleet", out)
            ref = {kind: _jax_tp_model(kind, *models[kind])
                   for kind in cases.MODELS}
        ref["hcg"] = {name: _jax_hcg(d) for name, d in
                      cases.HCG_MESHES.items()}
        ref["layers"] = _jax_layers(inputs)
        return {"ref": ref, "port": dist_cases.collect(proc)}
    finally:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            proc.wait(timeout=30)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return cases.once_per_run(
        tmp_path_factory, "torch_fleet",
        lambda: _run(tmp_path_factory.mktemp("fleet")))


def _jax_hcg(degrees):
    with jax_mesh(degrees):
        hcg = jtopology.HybridCommunicateGroup(dict(degrees))
        return {
            "degrees": [hcg.get_data_parallel_world_size(),
                        hcg.get_model_parallel_world_size(),
                        hcg.get_pipe_parallel_world_size(),
                        hcg.get_sharding_parallel_world_size(),
                        hcg.get_sep_parallel_world_size()],
            "sizes": {ax: getattr(hcg, f"get_{name}_parallel_group")().nranks
                      for ax, name in (("dp", "data"), ("mp", "model"),
                                       ("pp", "pipe"),
                                       ("sharding", "sharding"),
                                       ("sep", "sep"))},
            "mode": hcg.get_parallel_mode(), "nranks": hcg.nranks,
            "topology": [hcg.topology.get_dim(n) for n in
                         ("pipe", "data", "sharding", "sep", "model")]}


def _jax_layers(inputs):
    """The JAX mpu layers over mp4, eagerly through the tape."""
    out = {}

    def run(key, layers, fn, x_np, seed, params):
        x = jpaddle.to_tensor(x_np, stop_gradient=False)
        y = fn(x)
        (y * jpaddle.to_tensor(cases.weights(tuple(y.shape), seed))).sum() \
            .backward()
        res = {"y": _np(y), "x_grad": _np(x.grad)}
        for name, p in params.items():
            res[name] = _np(p.grad)
        out[key] = res

    def set_(layer, w, b):
        layer.weight.set_value(inputs[w])
        layer.bias.set_value(inputs[b])
        return layer

    x = inputs["layer/x"]
    with jax_mesh(cases.MP4):
        for gather in (True, False):
            col = set_(jmpu.ColumnParallelLinear(
                cases.IN, cases.OUT, gather_output=gather), "layer/w_col",
                "layer/b_col")
            run(f"column/gather_{gather}", [col], col, x, 0,
                {"col.weight": col.weight, "col.bias": col.bias})
        col = set_(jmpu.ColumnParallelLinear(cases.IN, cases.OUT,
                                             gather_output=False),
                   "layer/w_col", "layer/b_col")
        row = set_(jmpu.RowParallelLinear(cases.OUT, cases.IN,
                                          input_is_parallel=True),
                   "layer/w_row", "layer/b_row")
        run("pair", [col, row], lambda v: row(col(v)), x, 1,
            {"col.weight": col.weight, "col.bias": col.bias,
             "row.weight": row.weight, "row.bias": row.bias})
        row = set_(jmpu.RowParallelLinear(cases.OUT, cases.IN,
                                          input_is_parallel=False),
                   "layer/w_row", "layer/b_row")
        run("row/input_whole", [row], row,
            np.tile(x, (1, 1, cases.OUT // cases.IN)), 2,
            {"row.weight": row.weight, "row.bias": row.bias})
        col = set_(jsp.ColumnSequenceParallelLinear(
            cases.IN, cases.OUT, gather_output=False), "layer/w_col",
            "layer/b_col")
        row = set_(jsp.RowSequenceParallelLinear(
            cases.OUT, cases.IN, input_is_parallel=True), "layer/w_row",
            "layer/b_row")
        run("sequence_pair", [col, row], lambda v: row(col(v)), x, 3,
            {"col.weight": col.weight, "col.bias": col.bias,
             "row.weight": row.weight, "row.bias": row.bias})
        emb = jmpu.VocabParallelEmbedding(cases.VOCAB, cases.IN)
        emb.weight.set_value(inputs["layer/w_emb"])
        y = emb(jpaddle.to_tensor(inputs["layer/ids"]))
        (y * jpaddle.to_tensor(cases.weights(tuple(y.shape), 4))).sum() \
            .backward()
        out["embedding"] = {"y": _np(y), "emb.weight": _np(emb.weight.grad)}
        logits = jpaddle.to_tensor(inputs["layer/logits"],
                                   stop_gradient=False)
        loss = jmpu.ParallelCrossEntropy()(
            logits, jpaddle.to_tensor(inputs["layer/labels"]))
        (loss * jpaddle.to_tensor(cases.weights(tuple(loss.shape), 5))) \
            .sum().backward()
        out["parallel_cross_entropy"] = {"loss": _np(loss),
                                         "grad": _np(logits.grad)}
    return out


@pytest.fixture(scope="module")
def jax_ref(results):
    return results["ref"]


@pytest.fixture(scope="module")
def port(results):
    return results["port"]


def _same_on_every_rank(port, key):
    def equal(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(equal, a, b))
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b
    for r in range(1, N):
        assert equal(port[0][key], port[r][key]), (key, r)


@pytest.mark.parametrize("mesh", sorted(cases.HCG_MESHES))
def test_hybrid_communicate_group_matches_jax(mesh, port, jax_ref):
    want = jax_ref["hcg"][mesh]
    degrees = cases.HCG_MESHES[mesh]
    shape = [degrees.get(ax, 1) for ax in ("pp", "dp", "sharding", "sep",
                                           "mp")]
    grid = np.arange(N).reshape(shape)
    axes = ("pp", "dp", "sharding", "sep", "mp")
    for r, res in enumerate(port):
        got = res["hcg"][mesh]
        assert got["degrees"] == want["degrees"]
        assert got["mode"] == want["mode"] and got["nranks"] == want["nranks"]
        assert got["topology"] == want["topology"]
        assert {ax: len(m) for ax, m in got["groups"].items()} == \
            want["sizes"]
        # this process's real coordinates (the JAX controller says 0)
        at = dict(zip(axes, (int(i) for i in np.argwhere(grid == r)[0])))
        assert got["ranks"] == [at["dp"], at["mp"], at["pp"],
                                at["sharding"], at["sep"]]
        for ax, members in got["groups"].items():
            index = tuple(slice(None) if a == ax else at[a] for a in axes)
            assert members == [int(x) for x in grid[index].reshape(-1)]
        assert got["src"] == [got["groups"]["dp"][0], got["groups"]["mp"][0]]


LAYER_CASES = ["column/gather_True", "column/gather_False", "pair",
               "row/input_whole", "sequence_pair", "embedding",
               "parallel_cross_entropy"]


def test_mpu_layers_match_jax(port, jax_ref):
    for case in LAYER_CASES:
        want = jax_ref["layers"][case]
        got = port[0]["layers"][case]
        for name, value in want.items():
            np.testing.assert_allclose(got[name], value, rtol=1e-5,
                                       atol=1e-5, err_msg=f"{case} {name}")
    assert port[0]["layers"]["sequence_pair"]["row_bias_marked"]
    calls = port[0]["layers"]["op_calls"]
    for op in ("copy", "reduce", "scatter", "gather", "all_gather_seq",
               "reduce_scatter_seq", "parallel_cross_entropy"):
        assert calls[op] > 0, (op, calls)
    _same_on_every_rank(port, "layers")


@pytest.mark.parametrize("kind", cases.MODELS)
def test_tensor_parallel_model_matches_jax(kind, port, jax_ref):
    want = jax_ref[kind]
    got = port[0][kind]
    # under dp2 x mp2 the model is DataParallel over dp; GPT and Llama
    # carry the sequence-parallel hooks over mp
    assert got["wrapper"] == "DataParallel"
    assert got["sp_reducer"] == (kind != "bert")
    assert got["round_trip"]
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=0,
                               atol=1e-5)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for name, g in want["grads"].items():
        top = float(np.abs(g).max())
        err = float(np.abs(got["grads"][name] - g).max())
        assert err <= 1e-4 * top, (name, err, top)
    # one AdamW step: |update| is about the LR wherever the gradient is not
    # near zero; where it is, the sign of the packages' summation noise
    # decides, and the element may move by up to 2 LR
    assert sorted(got["params"]) == sorted(want["params"])
    for name, p in want["params"].items():
        diff = np.abs(got["params"][name] - p)
        g = np.abs(want["grads"].get(name, np.zeros_like(p)))
        loose = diff > 1e-5 + 1e-5 * np.abs(p)
        assert (diff[loose] <= 2 * cases.LR).all(), name
        assert (g[loose] <= 1e-3 * max(float(g.max()), 1e-30)).all(), name
    _same_on_every_rank(port, kind)


@pytest.mark.parametrize("kind", cases.MODELS)
def test_two_backwards_before_a_step_add_their_gradients(kind, port,
                                                         jax_ref):
    """Two backwards of the same rows before a step, both reduced, the
    first under ``no_sync``, or the sequence-parallel hooks reducing on
    every second backward: every gradient is twice JAX's one backward's.
    Each backward's part is summed over ``mp`` (the sequence-parallel
    parameters) and averaged over ``dp`` once, not its sum again."""
    want = jax_ref[kind]["grads"]
    accumulated = port[0][kind]["accumulated"]
    assert sorted(accumulated) == ["accumulation_2", "no_sync_first",
                                   "twice"]
    for variant, got in accumulated.items():
        assert sorted(got) == sorted(want)
        for name, g in want.items():
            top = 2 * float(np.abs(g).max())
            err = float(np.abs(got[name] - 2 * g).max())
            assert err <= 1e-4 * top, (variant, name, err, top)


def test_replicated_streams_equal_across_mp_ranks_under_dropout(port):
    for res in port:
        assert res["dropout"]["acted"]
        assert all(res["dropout"]["equal"]), res["dropout"]["equal"]


def test_sampler_defaults_to_the_data_parallel_ranks(port):
    for r, res in enumerate(port):
        got = res["sampler"]
        assert got["nranks"] == cases.TP_MESH["dp"]
        assert got["local_rank"] == got["dp_rank"] == r // 2
    # the two ranks of an mp group read the same rows; the dp groups differ
    assert port[0]["sampler"]["batches"] == port[1]["sampler"]["batches"]
    assert port[0]["sampler"]["batches"] != port[2]["sampler"]["batches"]
