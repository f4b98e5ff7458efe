"""The ranks' side of the port's pipeline tests (``test_torch_pipeline.py``):
run under the launcher, every rank runs the ``pipeline`` suite and writes
what it saw to ``<out_dir>/rank<r>.pkl``:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        tests/torch_pipeline_cases.py pipeline <out_dir>

4 gloo ranks; the inputs, the JAX stacks' and models' global states among
them, come from ``<out_dir>/inputs.npz``:

- ``PipelinedStack`` of the JAX test's ``Block`` (8 layers, width 16) on
  ``pp4`` and ``pp2 x dp2`` under each schedule (rotation, 1F1B, eager
  1F1B, ZB-H1, interleaved rotation and interleaved 1F1B at v = 2): the
  output, every stacked gradient and the input gradient of a weighted sum
  of the output, whole (gathered over ``pp`` and ``dp``), each rank's
  units in order and the most chunk inputs it held;
- ``gpt_tiny(pipeline_parallel, pp_schedule="1f1b")`` and
  ``llama_tiny(pipeline_parallel)`` on ``pp2 x dp2``, and
  ``llama_tiny(pipeline_parallel, tensor_parallel)`` on ``pp2 x mp2``,
  under ``fleet.distributed_model``: the logits, the loss, the parameters
  after one AdamW step in the JAX layout (``jax_state_dict``), the loaded
  state given back bit for bit, the edges bit-equal over ``pp``;
- ``PipelineLayer`` with heterogeneous edges and with a ``SharedLayerDesc``
  tie on ``pp4``, and ``PipelineParallel.train_batch`` on it;
- an interleaved llama_tiny's ``jax_state_dict`` round trip (stacked and
  permuted weights) and ``layer_state_dict``;
- the ``ValueError`` s of a stack: a non-dividing ``num_layers``, ZB with
  ``num_chunks > 1``, an interleaved batch that cannot split;
- dropout 0.5 inside a stack on ``pp4``: each unit's masks, in its forward
  and in its recompute.

Every whole result is the same on every rank; each rank's own are its
units. This file imports no JAX.
"""
import os
import pickle
import sys

import numpy as np

import torch_dist_cases as dist_cases

HERE = os.path.abspath(__file__)
WIDTH, LAYERS = 16, 8
STACK_X = (16, WIDTH)
MESHES = {"pp4": {"pp": 4}, "pp2dp2": {"pp": 2, "dp": 2}}
# (name, schedule, num_chunks): "interleave" is the rotation at v = 2,
# as forward_backward_pipeline_interleave runs it
SCHEDULES = (("rotation", "rotation", 1), ("1f1b", "1f1b", 1),
             ("eager_1f1b", "eager_1f1b", 1), ("zb", "zb", 1),
             ("interleave", "rotation", 2), ("interleave_1f1b", "1f1b", 2))
MODEL_LAYERS = 4
MODELS = {"gpt_1f1b": ({"pp": 2, "dp": 2}, "gpt",
                       dict(pipeline_parallel=True, pp_schedule="1f1b")),
          "llama": ({"pp": 2, "dp": 2}, "llama",
                    dict(pipeline_parallel=True)),
          "llama_tp": ({"pp": 2, "mp": 2}, "llama",
                       dict(pipeline_parallel=True, tensor_parallel=True))}
BATCH, SEQ = 4, 16
LR = 1e-3
LAYER_X = (8, 8)  # PipelineLayer: 8 rows of 8
DROP_P = 0.5


def micro(degrees) -> int:
    """The stacks' ``num_microbatches``: 8 over 4 stages, 4 over 2."""
    return 2 * degrees["pp"]


def stack_x():
    return np.random.RandomState(0).randn(*STACK_X).astype(np.float32)


def weights(shape, seed=0):
    """The weights of an output in a summed loss."""
    return np.random.RandomState(100 + seed).randn(*shape).astype(np.float32)


def batches(vocab=512):
    return np.random.RandomState(3).randint(0, vocab, (BATCH, SEQ)).astype(
        np.int64)


def config(models, kind, **flags):
    """The tiny config of ``kind`` with ``MODEL_LAYERS`` layers (both
    packages name the presets and the flags alike)."""
    fn = models.gpt.gpt_tiny if kind == "gpt" else models.llama.llama_tiny
    return fn(num_hidden_layers=MODEL_LAYERS, **flags)


def start_ranks(out_dir, nproc=4, timeout=240.0):
    return dist_cases.start_ranks("pipeline", nproc, out_dir, timeout,
                                  script=HERE)


# ------------------------------------------------------------ helpers
def _init(fleet, degrees):
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": degrees.get("dp", 1),
                         "mp_degree": degrees.get("mp", 1),
                         "pp_degree": degrees.get("pp", 1)}
    fleet.init(is_collective=True, strategy=st)
    return fleet.get_hybrid_communicate_group()


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _gather(dist, t, axis, dim=0):
    """``t``'s parts over the ``axis`` group concatenated along ``dim``."""
    import torch

    from paddle_tpu_torch.core.tensor import plain

    parts = plain(dist.all_gather(None, plain(t).detach().contiguous(),
                                  group=dist.new_group(axes=(axis,))))
    return torch.cat(list(parts.unbind(0)), dim)


def _sum(dist, t, axis):
    t = t.detach().clone()
    dist.all_reduce(t, group=dist.new_group(axes=(axis,)))
    return t


def _block_cls(nn, torch):
    class Block(nn.Layer):
        """The JAX test's homogeneous residual block."""

        def __init__(self, width=WIDTH):
            super().__init__()
            self.fc = nn.Linear(width, width)

        def forward(self, x):
            return x + torch.tanh(self.fc(x))

    return Block


def _state(inputs, prefix):
    head = prefix + "/"
    return {k[len(head):]: v for k, v in inputs.items()
            if k.startswith(head)}


def _edges_equal(dist, model, names) -> bool:
    """Every parameter of ``model`` outside its stack bit-equal to pp rank
    0's."""
    import torch

    ok = True
    for name, p in model.named_parameters():
        if name in names:
            continue
        theirs = p.detach().clone()
        dist.broadcast(theirs, src=0, group=dist.new_group(axes=("pp",)))
        ok &= torch.equal(theirs, p.detach())
    return bool(ok)


# ------------------------------------------------------------ the suite
def _stacks(paddle, nn, dist, fleet, inputs):
    import torch

    from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps
    from paddle_tpu_torch.models.gpt import load_jax_state

    Block = _block_cls(nn, torch)
    out = {}
    x_all = torch.from_numpy(stack_x())
    w_all = torch.from_numpy(weights(STACK_X))
    for mesh, degrees in MESHES.items():
        hcg = _init(fleet, degrees)
        for name, schedule, v in SCHEDULES:
            key = f"stack/{mesh}/{name}"
            stack = ps.PipelinedStack(
                lambda: Block(), LAYERS, num_chunks=v,
                num_microbatches=micro(degrees), schedule=schedule)
            load_jax_state(stack, _state(inputs, key))
            x = dist.shard_batch(x_all.clone()).requires_grad_()
            w = dist.shard_batch(w_all.clone())
            y = stack(x)
            (y * w).sum().backward()
            grads = {}
            for sn, p in stack.named_parameters():
                if p.grad is None:
                    continue
                g = _sum(dist, _gather(dist, p.grad, "pp"), "dp")
                grads[sn] = _np(g.transpose(-1, -2) if sn.endswith(
                    "fc__weight") else g)
            out[key] = {
                "y": _np(_gather(dist, y, "dp")),
                "x_grad": _np(_gather(dist, x.grad, "dp")),
                "grads": grads, "trace": list(stack.trace),
                "peak": stack.peak_saved, "stage": stack.stage,
                "m": stack._micro_count(x.shape[0]),
                "dp": hcg.get_data_parallel_world_size()}
            if name == "rotation":
                out[key]["kept_graphs_equal"] = _kept_graphs_equal(
                    ps, Block, degrees, inputs, key, x, w, y, stack)
    return out


def _kept_graphs_equal(ps, Block, degrees, inputs, key, x, w, y, stack):
    """The rotation with ``remat=False`` (each unit's graph kept from the
    forward, no recompute) on the same state: the output and every
    gradient bit for bit the recomputing stack's."""
    import torch

    from paddle_tpu_torch.models.gpt import load_jax_state

    kept = ps.PipelinedStack(lambda: Block(), LAYERS, remat=False,
                             num_microbatches=micro(degrees))
    load_jax_state(kept, _state(inputs, key))
    xk = x.detach().clone().requires_grad_()
    yk = kept(xk)
    (yk * w).sum().backward()
    return bool(torch.equal(yk, y) and torch.equal(xk.grad, x.grad) and all(
        torch.equal(a.grad, b.grad) for a, b in zip(kept.parameters(),
                                                    stack.parameters())
        if b.grad is not None))


def _models(paddle, dist, fleet, inputs):
    import torch

    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import gpt, llama
    from paddle_tpu_torch.optimizer import AdamW

    out = {}
    ids_all = torch.from_numpy(batches())
    for name, (degrees, kind, flags) in MODELS.items():
        _init(fleet, degrees)
        cfg = config(models, kind, **flags)
        if kind == "gpt":
            model = gpt.GPTForCausalLM(cfg, device="cpu")
            crit = gpt.GPTPretrainingCriterion(cfg)
        else:
            model = llama.LlamaForCausalLM(cfg, device="cpu")
            crit = llama.LlamaPretrainingCriterion(cfg)
        state = _state(inputs, f"model/{name}")
        gpt.load_jax_state(model, state)
        res = {"round_trip": all(
            np.array_equal(_np(v), np.asarray(state[k], np.float32))
            for k, v in gpt.jax_state_dict(model).items())}
        stack_names = {n for n, _ in model.named_parameters()
                       if ".stack_" in n or ".template." in n}
        wrapped = fleet.distributed_model(model.train())
        res["wrapper"] = type(wrapped).__name__
        ids = dist.shard_batch(ids_all.clone())
        logits = wrapped(ids)
        loss = crit(logits, ids)
        loss.backward()
        res["logits"] = _np(_gather(dist, logits, "dp"))
        mean = loss.detach().clone()
        dist.all_reduce(mean, op=dist.ReduceOp.AVG,
                        group=dist.new_group(axes=("dp",)))
        res["loss"] = float(mean)
        opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                    device="cpu")
        opt.step()
        opt.clear_grad()
        res["params"] = {k: _np(v)
                         for k, v in gpt.jax_state_dict(model).items()}
        res["edges_equal"] = _edges_equal(dist, model, stack_names)
        out[name] = res
    return out


def _pipeline_layers(paddle, nn, dist, fleet, inputs):
    """``PipelineLayer`` on pp4: heterogeneous edges (8 -> 16, the stack of
    4 ``Block`` s, 16 -> 8) and a ``SharedLayerDesc`` tie (16 -> 16 at both
    ends); the output and gradients of a weighted sum, then
    ``PipelineParallel.train_batch`` with SGD on the first."""
    import torch

    from paddle_tpu_torch.distributed.fleet import pipeline as pl
    from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps
    from paddle_tpu_torch.models.gpt import (_linear_weights, jax_state_dict,
                                             load_jax_state)
    from paddle_tpu_torch.optimizer import SGD

    Block = _block_cls(nn, torch)
    _init(fleet, {"pp": 4})
    out = {}
    rs = np.random.RandomState(2)
    x_np = rs.randn(*LAYER_X).astype(np.float32)
    for name in ("hetero", "shared"):
        if name == "hetero":
            descs = ([pl.LayerDesc(nn.Linear, 8, 16)]
                     + [pl.LayerDesc(Block, WIDTH) for _ in range(4)]
                     + [pl.LayerDesc(nn.Linear, 16, 8)])
            x = torch.from_numpy(x_np)
        else:
            descs = ([pl.SharedLayerDesc("tied", nn.Linear, 16, 16)]
                     + [pl.LayerDesc(Block, WIDTH) for _ in range(4)]
                     + [pl.SharedLayerDesc("tied", nn.Linear, 16, 16)])
            x = torch.from_numpy(np.concatenate([x_np, x_np], 1))
        layer = pl.PipelineLayer(descs, num_stages=4, num_microbatches=4,
                                 loss_fn=lambda o, t: ((o - t) ** 2).mean())
        load_jax_state(layer, _state(inputs, f"layer/{name}"))
        x = x.clone().requires_grad_()
        y = layer(x)
        w = torch.from_numpy(weights(tuple(y.shape), 1))
        (y * w).sum().backward()
        grads = {}
        linear = _linear_weights(layer)
        for pn, p in layer.named_parameters():
            if p.grad is None:
                continue
            g = _gather(dist, p.grad, "pp") if ".stack_" in pn else p.grad
            grads[pn] = _np(g.transpose(-1, -2) if pn in linear else g)
        out[name] = {"stacked": isinstance(layer._stack, ps.PipelinedStack),
                     "stack_layers": layer._stack.num_layers,
                     "names": sorted(n for n, _ in layer.named_parameters()),
                     "y": _np(y), "x_grad": _np(x.grad), "grads": grads}
        if name == "hetero":
            pp = pl.PipelineParallel(layer)
            opt = SGD(learning_rate=0.1, parameters=layer.parameters(),
                      device="cpu")
            target = torch.from_numpy(weights(LAYER_X, 2))
            layer.clear_gradients()
            loss = pp.train_batch((torch.from_numpy(x_np), target), opt)
            out["train_batch"] = {
                "loss": float(loss),  # noqa: TS107 (case compares the batch loss once, after the step)
                "params": {k: _np(v)
                           for k, v in jax_state_dict(layer).items()},
                "eval": float(pp.eval_batch((torch.from_numpy(x_np),
                                             target)))}
    return out


def _carry(dist, fleet, inputs):
    """An interleaved llama_tiny (4 layers over pp2 x 2 chunks, so the
    stack is permuted): the JAX-layout state given back bit for bit, and
    each original layer's weights (``layer_state_dict``) in the JAX
    layout."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.models import gpt, llama

    _init(fleet, {"pp": 2, "dp": 2})
    cfg = config(models, "llama", pipeline_parallel=True,
                 virtual_pp_degree=2)
    model = llama.LlamaForCausalLM(cfg, device="cpu")
    state = _state(inputs, "carry")
    gpt.load_jax_state(model, state)
    back = gpt.jax_state_dict(model)
    stack = model.llama.layers
    layers = {}
    for idx in range(MODEL_LAYERS):
        sd = stack.layer_state_dict(idx)
        layers[idx] = {n: _np(v.t() if n.endswith("proj.weight") else v)
                       for n, v in sd.items()}
    return {"round_trip": {k: bool(np.array_equal(
                _np(v), np.asarray(state[k], np.float32)))
                for k, v in back.items()},
            "keys": sorted(back) == sorted(state),
            "block": stack.block, "layers": layers}


def _errors(nn, dist, fleet):
    """The stack's refusals, each message."""
    import torch

    from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps

    Block = _block_cls(nn, torch)
    _init(fleet, {"pp": 2, "dp": 2})
    out = {}
    cases = {
        "num_layers": lambda: ps.PipelinedStack(lambda: Block(), 6,
                                                num_chunks=2),
        "zb_chunks": lambda: ps.PipelinedStack(lambda: Block(), 8,
                                               num_chunks=2, schedule="zb"),
        "schedule": lambda: ps.PipelinedStack(lambda: Block(), 8,
                                              schedule="gpipe"),
        "interleaved_batch": lambda: ps.PipelinedStack(
            lambda: Block(), 8, num_chunks=2)(torch.ones(3, WIDTH)),
    }
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def _dropout(nn, dist, fleet):
    """A stack of 4 layers adding ``dropout(ones, 0.5)`` on pp4, m = 4,
    rotation: each unit's keep mask in its forward and its recompute;
    then 1F1B from the same generator state, whose gradient must equal
    the rotation's (same units, same masks)."""
    import torch

    from paddle_tpu_torch.distributed.fleet import pipeline_schedules as ps
    from paddle_tpu_torch.nn import functional as F

    _init(fleet, {"pp": 4})
    gen = torch.Generator().manual_seed(11)

    class DropBlock(nn.Layer):
        seen = []

        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(WIDTH, WIDTH)
            self.generator = gen

        def forward(self, x):
            drop = F.dropout(torch.ones_like(x), DROP_P, training=True,
                             generator=self.generator)
            DropBlock.seen.append(drop.detach() != 0)
            return x + torch.tanh(self.fc(x)) * drop

    out = {}
    x = torch.from_numpy(stack_x()[:8])
    grads = {}
    for schedule in ("rotation", "1f1b"):
        gen.manual_seed(11)
        stack = ps.PipelinedStack(lambda: DropBlock(), 4, num_stages=4,
                                  num_microbatches=4, schedule=schedule,
                                  generator=torch.Generator().manual_seed(0))
        DropBlock.seen.clear()
        xl = x.clone().requires_grad_()
        y = stack(xl)
        y.sum().backward()
        units = list(stack.trace)
        runs = {}
        for unit, mask in zip(units, DropBlock.seen):
            runs.setdefault(unit[1:], []).append(mask.numpy())
        grads[schedule] = [_np(xl.grad), _np(_gather(
            dist, stack.stack_fc__weight.grad, "pp"))]
        out[schedule] = {
            "units": units, "seen": len(DropBlock.seen),
            "replayed": all(all(np.array_equal(m, ms[0]) for m in ms)
                            for ms in runs.values()),
            "masks": {k: ms[0] for k, ms in runs.items()}}
    out["grads_equal"] = all(np.allclose(a, b, rtol=1e-6, atol=1e-6)
                             for a, b in zip(grads["rotation"],
                                             grads["1f1b"]))
    out["grads"] = grads
    return out


def _pipeline(paddle, dist, r, inputs):
    import paddle_tpu_torch.nn as nn
    from paddle_tpu_torch.distributed import fleet

    out = {"stacks": _stacks(paddle, nn, dist, fleet, inputs),
           "models": _models(paddle, dist, fleet, inputs),
           "layers": _pipeline_layers(paddle, nn, dist, fleet, inputs),
           "carry": _carry(dist, fleet, inputs),
           "errors": _errors(nn, dist, fleet),
           "dropout": _dropout(nn, dist, fleet)}
    dist.barrier()
    return out


def main(argv):
    suite, out_dir = argv[1], argv[2]
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    paddle.set_device("cpu")
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    dist.init_parallel_env()
    r = dist.get_rank()
    result = {"pipeline": _pipeline}[suite](paddle, dist, r, inputs)
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    main(sys.argv)
