"""Cases of the port's distributed tests, and the script their ranks run.

``collective_cases`` builds its cases from the package it is handed, so the
same text runs in the JAX package (one process, a 4-device CPU mesh) and in
the port (4 gloo ranks): both have ``paddle.to_tensor``, ``dist.spmd``,
``dist.new_group(axes=...)`` and the collectives under the same names.

Run as a script under the launcher, every rank runs one suite and writes
what it saw to ``<out_dir>/rank<r>.pkl``:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        tests/torch_dist_cases.py collectives <out_dir>

Suites: ``collectives`` (4 ranks), ``data_parallel`` (2 ranks; reads the
JAX models' weights from ``<out_dir>/inputs.npz``). This file imports no
JAX: the ranks run the port only.
"""
import os
import pickle
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the two meshes of 4 ranks the collectives run over
MESHES = {"dp4": {"dp": 4}, "dp2mp2": {"dp": 2, "mp": 2}}
DP_STEPS = 5
DP_LR = 1e-3
DP_BATCH, DP_SEQ = 4, 16
SBN_SHAPE = (4, 3, 5, 5)  # the global batch of the SyncBatchNorm case


def _weights(out):
    """The weights of an output in the summed loss: 1, 2, 3, ..."""
    n = int(np.prod(out.shape))
    return np.arange(1, n + 1, dtype=np.float32).reshape(tuple(out.shape))


# the collectives, in bodies that each run as one spmd region: the JAX side
# compiles a region's forward and its gradient once a body
BODIES = {
    "sharded": ("all_reduce_sum", "all_reduce_avg", "reduce", "broadcast",
                "replicated_out", "unreduced_out", "all_gather",
                "gather_list", "all_to_all_single", "alltoall", "shift",
                "shift_back"),
    "scatters": ("reduce_scatter_sum", "reduce_scatter_list", "scatter"),
    # no gradient: JAX has no derivative of pmax/pmin; p2p writes a buffer
    "forward_only": ("all_reduce_max", "all_reduce_min",
                     "reduce_scatter_max", "batch_isend_irecv"),
}


def _groups(mesh_name):
    """The groups a mesh's cases run over: ``dp`` (4 ranks on ``dp4``, 2 on
    ``dp2mp2``, where ``mp`` is the axis the specs leave out) and, on
    ``dp2mp2``, both axes (4 ranks)."""
    return ["dp"] + (["dpmp"] if mesh_name == "dp2mp2" else [])


def case_names(mesh_name):
    """The cases ``collective_cases`` builds on ``mesh_name``."""
    return [f"{g}/{b}" for g in _groups(mesh_name) for b in BODIES] + [
        "core/all_reduce_spmd", "core/spmd_collective_grad"]


def collective_cases(paddle, dist, P, mesh_name, runner=None):
    """name -> thunk returning a tuple of arrays: a body's outputs (in the
    order of ``BODIES``), then the input's gradient for a weighted sum of
    them (none for ``forward_only``), over the installed mesh
    ``mesh_name``. ``runner(body, x, in_specs, out_specs, axes, grad)``
    replaces the eager run (the tape's ``backward``) of the bodies;
    ``test_distributed_core.py``'s two cases always run eagerly."""
    cases = {}

    def eager(body, x, ins, outs, axes, grad=True):
        x = paddle.to_tensor(x, stop_gradient=not grad)
        out = dist.spmd(in_specs=ins, out_specs=outs, axes=axes)(body)(x)
        if not grad:
            return tuple(o.numpy() for o in out)
        loss = None
        for o in out:
            term = (o * paddle.to_tensor(_weights(o))).sum()
            loss = term if loss is None else loss + term
        loss.backward()
        return tuple(o.numpy() for o in out) + (x.grad.numpy(),)

    run = runner or eager

    def add(gname, g, axes):
        n = 1
        for ax in axes:
            n *= dist.get_mesh().shape[ax]
        name = axes if len(axes) > 1 else axes[0]
        spec, nested = P(name), P(None, name)
        x8 = np.arange(8, dtype=np.float32) - 2.0
        x16 = np.arange(4 * n * n, dtype=np.float32) - 5.0

        def sharded(v):
            outs = []
            for op in (dist.ReduceOp.SUM, dist.ReduceOp.AVG):
                y = v * v
                dist.all_reduce(y, op=op, group=g)
                outs.append(y)
            y = v + 1.0
            dist.reduce(y, dst=0, group=g)
            outs.append(y)
            y = v * v
            dist.broadcast(y, src=1, group=g)
            outs.append(y)
            y = v * v
            dist.all_reduce(y, group=g)
            outs.append(y.sum())
            outs.append((v * v).sum())  # differs by rank: rank 0's is out
            parts = []
            dist.gather(v * 2.0, parts, dst=0, group=g)
            moved = []
            dist.alltoall(list(paddle.unbind(v.reshape([n, -1]) * 3.0, 0)),
                          moved, group=g)
            # a shift over two axes is the port's ring over the group's
            # ranks; the JAX package shifts over one axis only
            return tuple(outs) + (
                dist.all_gather(None, v * v, group=g),
                paddle.concat(parts, 0),
                dist.all_to_all_single(None, v * v, group=g),
                paddle.concat(moved, 0),
                dist.shift(v * v, offset=1, group=g),
                dist.shift(v * 2.0, offset=-1, group=g))
        cases[f"{gname}/sharded"] = lambda: run(
            sharded, x16, spec,
            (spec,) * 4 + (P(), P(), nested) + (spec,) * 5, axes)

        def scatters(v):
            out = paddle.zeros([v.shape[0] // n])
            dist.reduce_scatter(out, v * v, group=g)
            scaled = [v[2 * i:2 * i + 2] * float(i + 1) for i in range(n)]
            listed = paddle.zeros([2])
            dist.reduce_scatter(listed, scaled, group=g)
            picked = paddle.zeros([2])
            dist.scatter(picked, scaled, src=0, group=g)
            return out, listed, picked
        cases[f"{gname}/scatters"] = lambda: run(
            scatters, x8, P(None), (spec,) * 3, axes)

        def forward_only(v):
            outs = []
            for op in (dist.ReduceOp.MAX, dist.ReduceOp.MIN):
                y = v * v
                dist.all_reduce(y, op=op, group=g)
                outs.append(y)
            y = paddle.zeros([v.shape[0] // n])
            dist.reduce_scatter(y, v * v, op=dist.ReduceOp.MAX, group=g)
            outs.append(y)
            got = paddle.zeros(v.shape)
            dist.batch_isend_irecv([
                dist.P2POp("isend", v * 1.0, group=g, offset=1),
                dist.P2POp("irecv", got, group=g, offset=1)])
            outs.append(got)
            return tuple(outs)
        cases[f"{gname}/forward_only"] = lambda: run(
            forward_only, x16, spec, (spec,) * 4, axes, grad=False)

    groups = {"dp": (dist.new_group(axes=("dp",)), ("dp",))}
    if mesh_name == "dp2mp2":
        groups["dpmp"] = (dist.new_group(axes=("dp", "mp")), ("dp", "mp"))
    for gname, (g, axes) in groups.items():
        add(gname, g, axes)

    # test_distributed_core.py's cases, as that file writes them
    g = groups["dp"][0]

    def core_all_reduce():
        @dist.spmd(in_specs=P("dp"), out_specs=P("dp"), axes=("dp",))
        def fn(x):
            dist.all_reduce(x, group=g)
            return x
        return (fn(paddle.to_tensor(np.arange(8, dtype=np.float32))).numpy(),)

    def core_grad():
        def loss_fn(x):
            @dist.spmd(in_specs=P("dp"), out_specs=P(), axes=("dp",))
            def inner(v):
                y = v * v
                dist.all_reduce(y, group=g)
                return y.sum()
            return inner(x)
        x = paddle.to_tensor(np.arange(4, dtype=np.float32),
                             stop_gradient=False)
        loss = loss_fn(x)
        loss.backward()
        return loss.numpy(), x.grad.numpy()

    cases["core/all_reduce_spmd"] = core_all_reduce
    cases["core/spmd_collective_grad"] = core_grad
    assert list(cases) == case_names(mesh_name)
    return cases


# ------------------------------------------------------------ rank suites
def _collectives(paddle, dist, P, r):
    """Every case on both meshes, then the process-level collectives
    against numpy (integers and floats, each rank's own values)."""
    import torch

    seen = {}
    for mesh_name, degrees in MESHES.items():
        dist.init_parallel_env(degrees)
        for name, case in collective_cases(paddle, dist, P,
                                           mesh_name).items():
            seen[f"{mesh_name}/{name}"] = tuple(np.asarray(a)
                                                for a in case())
    dist.init_parallel_env({"dp": 4})
    n = dist.get_world_size()
    proc = {}
    for dtype in (torch.int64, torch.int32, torch.float32):
        t = torch.arange(6, dtype=dtype).reshape(2, 3) * (r + 1)
        dist.all_reduce(t)
        proc[f"all_reduce_sum_{dtype}"] = t.numpy()
        t = torch.arange(6, dtype=dtype) + r
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        proc[f"all_reduce_max_{dtype}"] = t.numpy()
        t = torch.full((3,), r + 1, dtype=dtype)
        dist.all_reduce(t, op=dist.ReduceOp.PROD)
        proc[f"all_reduce_prod_{dtype}"] = t.numpy()
        proc[f"all_gather_{dtype}"] = dist.all_gather(
            None, torch.full((2,), r, dtype=dtype)).numpy()
        out = torch.zeros(2, dtype=dtype)
        dist.reduce_scatter(out, torch.arange(2 * n, dtype=dtype) * (r + 1))
        proc[f"reduce_scatter_{dtype}"] = out.numpy()
        t = torch.full((3,), r * 10, dtype=dtype)
        dist.broadcast(t, src=2)
        proc[f"broadcast_{dtype}"] = t.numpy()
        proc[f"all_to_all_single_{dtype}"] = dist.all_to_all_single(
            None, torch.arange(n, dtype=dtype) + 10 * r).numpy()
    t = torch.tensor([True, r == 0, False])
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    proc["all_reduce_bool"] = t.numpy()
    t = torch.arange(6.0).reshape(2, 3).t() * (r + 1)  # not contiguous
    dist.all_reduce(t)
    proc["all_reduce_strided"] = t.numpy()
    proc["shift_bool"] = dist.shift(torch.tensor([r % 2 == 0, True])).numpy()
    t = torch.zeros(3)
    dist.scatter(t, [torch.full((3,), float(i)) for i in range(n)]
                 if r == 1 else None, src=1)
    proc["scatter"] = t.numpy()
    if r < 2:
        t = torch.full((2,), float(r) + 5.0)
        if r == 0:
            dist.send(t, dst=1)
        else:
            dist.recv(t, src=0)
        proc["send_recv"] = t.numpy()
    else:
        proc["send_recv"] = np.zeros(0)
    got = torch.zeros(2)
    dist.batch_isend_irecv([
        dist.P2POp(dist.isend, torch.full((2,), float(r)),
                   peer=(r + 1) % n),
        dist.P2POp(dist.irecv, got, peer=(r - 1) % n)])
    proc["batch_isend_irecv"] = got.numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": r, "pair": (r, r * r)})
    proc["all_gather_object"] = objs
    x = torch.arange(4.0, requires_grad=True)
    y = x * (r + 1)
    dist.all_reduce(y)
    (y * torch.arange(1.0, 5.0)).sum().backward()
    proc["process_level_grad"] = x.grad.numpy()
    try:
        dist.new_group(ranks=[1, 3])
        proc["subgroup"] = "made"
    except NotImplementedError as e:
        proc["subgroup"] = str(e)
    dist.init_parallel_env({"dp": 2, "mp": 2})
    mp = dist.new_group(axes=("mp",))
    proc["group_ranks"] = (dist.get_group(0).rank, dist.get_group(0).nranks,
                           mp.rank, mp.nranks)
    proc["backend"] = dist.get_backend()
    dist.barrier()
    return {"cases": seen, "process": proc}


def _port_model(kind, state):
    from paddle_tpu_torch.models import gpt, llama

    if kind == "gpt":
        cfg = gpt.gpt_tiny()
        model = gpt.GPTForCausalLM(cfg, device="cpu")
        crit = gpt.GPTPretrainingCriterion(cfg)
    else:
        cfg = llama.llama_tiny()
        model = llama.LlamaForCausalLM(cfg, device="cpu")
        crit = llama.LlamaPretrainingCriterion(cfg)
    gpt.load_jax_state(model, state)
    return model.train(), crit


def dp_batches(vocab: int = 512):
    rs = np.random.RandomState(0)
    return [rs.randint(0, vocab, (DP_BATCH, DP_SEQ)).astype(np.int64)
            for _ in range(DP_STEPS)]


def _as_jax_layout(model) -> dict:
    """The parameters by JAX name and in JAX layout (Linear weights
    [in, out])."""
    import torch

    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    return {n: (p.detach().t() if n in linear else p.detach()).numpy().copy()
            for n, p in model.named_parameters()}


def _data_parallel(paddle, dist, P, r, inputs):
    import torch

    from paddle_tpu_torch import io, nn
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    dist.init_parallel_env()
    out = {}
    # 5 AdamW steps of DataParallel + TrainStep on each rank's rows
    for kind in ("gpt", "llama"):
        state = {k[len(kind) + 1:]: v for k, v in inputs.items()
                 if k.startswith(kind + "/")}
        model, crit = _port_model(kind, state)
        dp = paddle.DataParallel(model)
        opt = AdamW(learning_rate=DP_LR, parameters=dp.parameters(),
                    device="cpu")
        step = TrainStep(model=dp, optimizer=opt,
                         loss_fn=lambda ids: crit(dp(ids), ids), device="cpu")
        losses = []
        for b in dp_batches():
            ids = paddle.to_tensor(b)
            dist.shard_batch(ids)
            loss = step(ids).detach().clone()
            dist.all_reduce(loss, op=dist.ReduceOp.AVG)
            losses.append(float(loss))  # noqa: TS107 (case compares per-step losses on purpose)
        out[f"{kind}/losses"] = np.array(losses)
        out[f"{kind}/params"] = _as_jax_layout(model)
        out[f"{kind}/stats"] = dict(step.stats)
        out[f"{kind}/names"] = list(dp.state_dict()) == list(
            model.state_dict())
    # the loss's reduction: a mean loss and a sum loss on one Linear
    for loss_kind in ("mean", "sum"):
        lin = nn.Linear(4, 3)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(inputs["linear/weight"]).t())
            lin.bias.copy_(torch.from_numpy(inputs["linear/bias"]))
        dp = paddle.DataParallel(lin)
        x = dist.shard_batch(torch.from_numpy(inputs["linear/x"]))
        y = dp(x)
        (y.mean() if loss_kind == "mean" else y.sum()).backward()
        out[f"linear/{loss_kind}/weight_grad"] = lin.weight.grad.t().numpy()
        out[f"linear/{loss_kind}/bias_grad"] = lin.bias.grad.numpy()
    # SyncBatchNorm over the ranks' rows, converted from a BatchNorm2D
    bn = nn.BatchNorm2D(SBN_SHAPE[1], device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["sbn/weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["sbn/bias"]))
    net = nn.Sequential(bn)
    net = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    out["sbn/converted"] = type(net[0]).__name__
    dp = paddle.DataParallel(net)
    x = dist.shard_batch(torch.from_numpy(inputs["sbn/x"])).requires_grad_()
    w = dist.shard_batch(torch.from_numpy(inputs["sbn/w"]))
    y = dp(x)
    (y * w).mean().backward()
    out["sbn/y"] = dist.all_gather(None, y.detach()).numpy()
    out["sbn/x_grad"] = dist.all_gather(None, x.grad).numpy()
    out["sbn/weight_grad"] = net[0].weight.grad.numpy()
    out["sbn/bias_grad"] = net[0].bias.grad.numpy()
    out["sbn/mean"] = net[0]._mean.numpy()
    out["sbn/variance"] = net[0]._variance.numpy()
    net.eval()
    out["sbn/eval_y"] = dp(x.detach()).detach().numpy()
    # no_sync: two local backwards, then one that reduces all three
    torch.manual_seed(r)
    lin = nn.Linear(4, 2)
    twin = nn.Linear(4, 2)
    dp = paddle.DataParallel(lin)
    twin.load_state_dict(lin.state_dict())
    xs = [torch.from_numpy(inputs["nosync/x"][i]) for i in range(3)]
    mine = [dist.shard_batch(x) for x in xs]
    with dp.no_sync():
        dp(mine[0]).sum().backward()
        out["nosync/inside"] = lin.weight.grad.clone().numpy()
        dp(mine[1]).sum().backward()
    dp(mine[2]).sum().backward()
    out["nosync/after"] = lin.weight.grad.numpy()
    for x in mine:
        twin(x).sum().backward()
    out["nosync/local"] = twin.weight.grad.numpy()
    out["nosync/replicated"] = lin.bias.detach().numpy()
    # find_unused_parameters: rank 0 alone uses the second layer
    torch.manual_seed(0)
    first, second = nn.Linear(4, 4), nn.Linear(4, 4)
    both = nn.Sequential(first, second)
    twins = nn.Sequential(nn.Linear(4, 4), nn.Linear(4, 4))
    twins.load_state_dict(both.state_dict())
    dp = paddle.DataParallel(both, find_unused_parameters=True)
    x = dist.shard_batch(torch.from_numpy(inputs["nosync/x"][0]))
    for layers, head in ((twins, twins[1]), (both, dp)):
        h = layers[0](x)
        if r == 0:
            h = layers[1](h)
        h.sum().backward()
    out["unused/second_grad"] = second.weight.grad.numpy()
    out["unused/first_grad"] = first.weight.grad.numpy()
    out["unused/local_second"] = (twins[1].weight.grad.numpy()
                                  if r == 0 else np.zeros((4, 4), "f4"))
    out["unused/local_first"] = twins[0].weight.grad.numpy()
    strict = paddle.DataParallel(nn.Sequential(nn.Linear(4, 4),
                                               nn.Linear(4, 4)))
    try:
        strict._layers[0](x).sum().backward()
        out["unused/strict"] = "no error"
    except RuntimeError as e:
        out["unused/strict"] = str(e)
    # DistributedBatchSampler and DeviceLoader from the environment
    sampler = io.DistributedBatchSampler(io.TensorDataset(
        [np.arange(11)]), batch_size=2, shuffle=True)
    epochs = []
    for epoch in (0, 3):
        sampler.set_epoch(epoch)
        epochs.append(list(sampler))
    out["sampler"] = (sampler.nranks, sampler.local_rank, epochs)
    batches = [(np.arange(8).reshape(4, 2) + 100 * i, np.arange(3))
               for i in range(2)]
    loaded = list(io.DeviceLoader(batches, device="cpu"))
    out["loader"] = [[t.numpy() for t in b] for b in loaded]
    out["shard_numpy"] = dist.shard_batch(np.arange(6).reshape(6, 1))
    dist.barrier()
    return out


def start_ranks(suite: str, nproc: int, out_dir, timeout: float = 240.0,
                script=None):
    """The launcher running ``suite`` of ``script`` (default: this file)
    on ``nproc`` gloo ranks, in the background; ``collect`` waits for it
    and reads the ranks' results."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, os.path.dirname(os.path.abspath(__file__))]),
        OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--log_dir",
           os.path.join(str(out_dir), "logs"),
           script or os.path.abspath(__file__), suite, str(out_dir)]
    proc = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.paddle_args = (suite, nproc, str(out_dir), timeout)
    return proc


def collect(proc) -> list:
    """Each rank's results, once the launcher exits 0; its output and the
    ranks' logs in the error otherwise. The launcher is stopped (with its
    ranks) if it outlasts its time."""
    suite, nproc, out_dir, timeout = proc.paddle_args
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    if proc.returncode != 0:
        logs = []
        log_dir = os.path.join(out_dir, "logs")
        for name in sorted(os.listdir(log_dir)) if os.path.isdir(
                log_dir) else []:
            with open(os.path.join(log_dir, name), errors="replace") as f:
                logs.append(f"--- {name}\n{f.read()[-3000:]}")
        raise AssertionError(f"launcher exit {proc.returncode} running "
                             f"{suite}:\n{out[-2000:]}\n" + "\n".join(logs))
    results = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def main(argv):
    suite, out_dir = argv[1], argv[2]
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    paddle.set_device("cpu")
    inputs = {}
    path = os.path.join(out_dir, "inputs.npz")
    if os.path.exists(path):
        with np.load(path) as f:
            inputs = {k: f[k] for k in f.files}
    dist.init_parallel_env()
    r = dist.get_rank()
    run = {"collectives": _collectives, "data_parallel": _data_parallel}
    if suite == "collectives":
        result = run[suite](paddle, dist, dist.P, r)
    else:
        result = run[suite](paddle, dist, dist.P, r, inputs)
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def spawned_sum(out_dir):
    """A ``distributed.spawn`` target: each rank sums its rank over the
    world and writes what it saw."""
    import torch

    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    paddle.set_device("cpu")
    dist.init_parallel_env()
    r = dist.get_rank()
    t = torch.tensor([float(r + 1)])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"spawn{r}.txt"), "w") as f:
        f.write(f"{r} {dist.get_world_size()} {float(t)} "
                f"{os.environ['PADDLE_TRAINERS_NUM']}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
