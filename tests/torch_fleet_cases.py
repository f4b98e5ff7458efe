"""The ranks' side of the port's fleet tests (``test_torch_fleet.py``,
``test_torch_context_parallel.py``): run under the launcher, every rank
runs one suite and writes what it saw to ``<out_dir>/rank<r>.pkl``:

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        tests/torch_fleet_cases.py fleet <out_dir>

Suites (4 gloo ranks each; the inputs, the JAX models' global states
among them, come from ``<out_dir>/inputs.npz``):

- ``fleet``: ``HybridCommunicateGroup`` on ``dp2 x mp2`` and ``mp2 x
  sep2``; each ``mpu`` layer, the sequence-parallel pair and
  ``ParallelCrossEntropy`` on ``mp4``; ``gpt_tiny``/``llama_tiny`` with
  ``tensor_parallel`` + ``sequence_parallel`` and BERT with
  ``tensor_parallel`` under ``fleet.distributed_model`` on ``dp2 x mp2``
  (logits, loss, gradients, one AdamW step); the replicated residual
  streams at hidden dropout 0.1; the sampler's data-parallel default;
  the shard/gather round trip of the JAX-layout state.
- ``context_parallel``: ``ring_attention`` (causal and not) and
  ``ulysses_attention`` over ``sep4`` with their gradients, the Ulysses
  head-divisibility error, ``gpt_tiny(context_parallel="ring")`` under
  ``fleet.distributed_model``.

Every result is whole (the ranks gather their parts), so the test process
holds rank 0's to the JAX package's and the others' to rank 0's bit for
bit. This file imports no JAX.
"""
import contextlib
import os
import pickle
import sys

import numpy as np

import torch_dist_cases as dist_cases

HERE = os.path.abspath(__file__)
TP_MESH = {"dp": 2, "mp": 2}
HCG_MESHES = {"dp2mp2": {"dp": 2, "mp": 2}, "mp2sep2": {"mp": 2, "sep": 2}}
MP4 = {"mp": 4}
SEP4 = {"sep": 4}
BATCH, SEQ = 4, 16  # the TP models' global batch, 2 rows a dp rank
LR = 1e-3
IN, OUT, VOCAB = 16, 32, 64  # the mpu layers' sizes (mp4)
LAYER_X = (2, 8, IN)
CP_SHAPE = (1, 256, 4, 16)  # ring/Ulysses: [B, S, H, D], S over 4 ranks
CP_MODEL_BATCH, CP_MODEL_SEQ = 2, 32
MODELS = ("gpt", "llama", "bert")


def start_ranks(suite, out_dir, nproc=4, timeout=240.0):
    return dist_cases.start_ranks(suite, nproc, out_dir, timeout,
                                  script=HERE)


def once_per_run(tmp_path_factory, name, compute):
    """``compute()``, run once for the whole test run: under pytest-xdist
    the workers that get tests of one file share the run's base temp
    directory, and the first to take the lock computes and pickles the
    result while the others wait and read it (the ranks and the JAX side
    cost tens of seconds). Without xdist it just computes."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return compute()
    import fcntl

    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not path.exists():
                result = compute()
                with open(path, "wb") as f:
                    pickle.dump(result, f)
                return result
            with open(path, "rb") as f:
                return pickle.load(f)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def tp_config(kind, **overrides):
    """The tiny config of ``kind`` in its tensor-parallel layout (both
    packages name the presets and the flags alike)."""
    import paddle_tpu_torch.models as port_models

    return _config(port_models, kind, **overrides)


def _config(models, kind, **overrides):
    if kind == "gpt":
        return models.gpt.gpt_tiny(tensor_parallel=True,
                                   sequence_parallel=True, **overrides)
    if kind == "llama":
        return models.llama.llama_tiny(tensor_parallel=True,
                                       sequence_parallel=True, **overrides)
    return models.bert.bert_tiny(tensor_parallel=True, **overrides)


def batches(vocab=512):
    rs = np.random.RandomState(3)
    return rs.randint(0, vocab, (BATCH, SEQ)).astype(np.int64)


def weights(shape, seed=0):
    """The weights of an output in the summed loss of a layer case."""
    return np.random.RandomState(100 + seed).randn(*shape).astype(np.float32)


def layer_inputs():
    rs = np.random.RandomState(5)
    f = np.float32
    labels = rs.randint(0, VOCAB, (16,)).astype(np.int64)
    labels[3] = -100
    return {
        "layer/x": rs.randn(*LAYER_X).astype(f),
        "layer/w_col": (rs.randn(IN, OUT) * 0.2).astype(f),
        "layer/b_col": rs.randn(OUT).astype(f),
        "layer/w_row": (rs.randn(OUT, IN) * 0.2).astype(f),
        "layer/b_row": rs.randn(IN).astype(f),
        "layer/w_emb": rs.randn(VOCAB, IN).astype(f),
        "layer/ids": rs.randint(0, VOCAB, LAYER_X[:2]).astype(np.int64),
        "layer/logits": (rs.randn(16, VOCAB) * 3).astype(f),
        "layer/labels": labels,
    }


def cp_inputs():
    rs = np.random.RandomState(9)
    return {f"cp/{n}": rs.randn(*CP_SHAPE).astype(np.float32)
            for n in ("q", "k", "v", "w")}


def cp_model_ids(vocab=512):
    rs = np.random.RandomState(11)
    return rs.randint(0, vocab, (CP_MODEL_BATCH, CP_MODEL_SEQ)).astype(
        np.int64)


# ------------------------------------------------------------ helpers
def _init(fleet, degrees):
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": degrees.get("dp", 1),
                         "mp_degree": degrees.get("mp", 1),
                         "sep_degree": degrees.get("sep", 1)}
    fleet.init(is_collective=True, strategy=st)
    return fleet.get_hybrid_communicate_group()


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _gather_dim(dist, t, dim, axis):
    """``t``'s parts over the ``axis`` group concatenated along ``dim``."""
    import torch

    from paddle_tpu_torch.core.tensor import plain

    parts = plain(dist.all_gather(None, t.detach().contiguous(),
                                  group=dist.new_group(axes=(axis,))))
    return torch.cat(list(parts.unbind(0)), dim)


def _jax_layout(model, name, t):
    """A tensor named ``name`` of ``model`` in the JAX layout (a Linear
    weight transposed)."""
    import torch

    mods = dict(model.named_modules())
    owner = mods.get(name.rpartition(".")[0])
    if isinstance(owner, torch.nn.Linear) and name.rpartition(".")[2] == "weight":
        return t.t()
    return t


def _grads(model):
    """Every parameter's gradient, whole (gathered over ``mp`` where the
    parameter is cut) and in the JAX layout, by name."""
    from paddle_tpu_torch.distributed.fleet import mpu

    cut = mpu.sharded_params(model)
    out = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.detach()
        if name in cut:
            g = mpu.gather_param(g, cut[name])
        out[name] = _np(_jax_layout(model, name, g))
    return out


# ------------------------------------------------------------ fleet suite
def _hcg(fleet, dist, degrees):
    hcg = _init(fleet, degrees)
    groups = {ax: getattr(hcg, f"get_{name}_parallel_group")().process_ids
              for ax, name in (("dp", "data"), ("mp", "model"),
                               ("pp", "pipe"), ("sharding", "sharding"),
                               ("sep", "sep"))}
    return {
        "degrees": [hcg.get_data_parallel_world_size(),
                    hcg.get_model_parallel_world_size(),
                    hcg.get_pipe_parallel_world_size(),
                    hcg.get_sharding_parallel_world_size(),
                    hcg.get_sep_parallel_world_size()],
        "ranks": [hcg.get_data_parallel_rank(),
                  hcg.get_model_parallel_rank(), hcg.get_stage_id(),
                  hcg.get_sharding_parallel_rank(),
                  hcg.get_sep_parallel_rank()],
        "groups": groups,
        "mode": hcg.get_parallel_mode(),
        "nranks": hcg.nranks,
        "topology": [hcg.topology.get_dim(n) for n in
                     ("pipe", "data", "sharding", "sep", "model")],
        "src": [hcg.get_data_parallel_group_src_rank(),
                hcg.get_model_parallel_group_src_rank()],
    }


def _layers(fleet, dist, inputs):
    """Each mpu layer over mp4, its output and gradients whole."""
    import torch

    from paddle_tpu_torch.distributed.fleet import mpu, sequence_parallel

    _init(fleet, MP4)
    out = {}

    def load(layer, name, full):
        spec = layer._shard_specs.get(name)
        value = torch.from_numpy(full)
        with torch.no_grad():
            getattr(layer, name).copy_(mpu.shard_of(value, spec)
                                       if spec is not None else value)

    def run(key, fn, x_np, layers, seed):
        x = torch.from_numpy(x_np).requires_grad_()
        y = fn(x)
        (y * torch.from_numpy(weights(tuple(y.shape), seed))).sum().backward()
        res = {"y": _np(y), "x_grad": _np(x.grad)}
        for lname, layer in layers.items():
            res.update({f"{lname}.{k}": v for k, v in _grads(layer).items()})
        out[key] = res

    x = inputs["layer/x"]
    w_col = inputs["layer/w_col"].T.copy()  # torch [out, in]
    w_row = inputs["layer/w_row"].T.copy()
    for gather in (True, False):
        col = mpu.ColumnParallelLinear(IN, OUT, gather_output=gather,
                                       device="cpu")
        load(col, "weight", w_col)
        load(col, "bias", inputs["layer/b_col"])
        fn = (col if gather else
              (lambda v, col=col: mpu.gather_from_model_parallel(col(v))))
        run(f"column/gather_{gather}", fn, x, {"col": col}, 0)
    col = mpu.ColumnParallelLinear(IN, OUT, gather_output=False,
                                   device="cpu")
    row = mpu.RowParallelLinear(OUT, IN, input_is_parallel=True,
                                device="cpu")
    for layer, w, b in ((col, w_col, "layer/b_col"),
                        (row, w_row, "layer/b_row")):
        load(layer, "weight", w)
        load(layer, "bias", inputs[b])
    run("pair", lambda v: row(col(v)), x, {"col": col, "row": row}, 1)
    row = mpu.RowParallelLinear(OUT, IN, input_is_parallel=False,
                                device="cpu")
    load(row, "weight", w_row)
    load(row, "bias", inputs["layer/b_row"])
    xo = np.tile(x, (1, 1, OUT // IN))
    run("row/input_whole", row, xo, {"row": row}, 2)
    # the sequence-parallel pair: the input and output cut along the
    # sequence over mp (gathered whole here)
    col = sequence_parallel.ColumnSequenceParallelLinear(
        IN, OUT, gather_output=False, device="cpu")
    row = sequence_parallel.RowSequenceParallelLinear(
        OUT, IN, input_is_parallel=True, device="cpu")
    for layer, w, b in ((col, w_col, "layer/b_col"),
                        (row, w_row, "layer/b_row")):
        load(layer, "weight", w)
        load(layer, "bias", inputs[b])
    sequence_parallel.register_sequence_parallel_allreduce_hooks(row)

    def sp_pair(v):
        part = sequence_parallel.ScatterOp.apply(v)
        return sequence_parallel.GatherOp.apply(row(col(part)))
    run("sequence_pair", sp_pair, x, {"col": col, "row": row}, 3)
    out["sequence_pair"]["row_bias_marked"] = \
        sequence_parallel.is_sequence_parallel_parameter(row.bias)
    emb = mpu.VocabParallelEmbedding(VOCAB, IN, device="cpu")
    load(emb, "weight", inputs["layer/w_emb"])
    ids = torch.from_numpy(inputs["layer/ids"])
    y = emb(ids)
    (y * torch.from_numpy(weights(tuple(y.shape), 4))).sum().backward()
    out["embedding"] = {"y": _np(y), **_grads(torch.nn.ModuleDict(
        {"emb": emb}))}
    # ParallelCrossEntropy on this rank's classes of the logits
    logits = torch.from_numpy(inputs["layer/logits"])
    mine = mpu.scatter_to_model_parallel(logits).detach().requires_grad_()
    labels = torch.from_numpy(inputs["layer/labels"])
    loss = mpu.ParallelCrossEntropy()(mine, labels)
    (loss * torch.from_numpy(weights(tuple(loss.shape), 5))).sum().backward()
    out["parallel_cross_entropy"] = {
        "loss": _np(loss),
        "grad": _np(mpu.gather_from_model_parallel(mine.grad))}
    out["op_calls"] = dict(mpu.op_calls)
    return out


def _port_model(kind, state, **overrides):
    from paddle_tpu_torch.models import bert, gpt, llama

    cfg = tp_config(kind, **overrides)
    if kind == "gpt":
        model = gpt.GPTForCausalLM(cfg, device="cpu")
        crit = gpt.GPTPretrainingCriterion(cfg)
    elif kind == "llama":
        model = llama.LlamaForCausalLM(cfg, device="cpu")
        crit = llama.LlamaPretrainingCriterion(cfg)
    else:
        model = bert.BertForPretraining(cfg, device="cpu")
        crit = None
    gpt.load_jax_state(model, state)
    return model.train(), crit


def bert_loss(F, out, ids):
    """The BERT cases' loss: cross entropy of the MLM logits against the
    ids themselves plus that of the NSP logits against the first id's
    parity (both packages' ``F`` alike)."""
    logits, nsp = out
    mlm = F.cross_entropy(logits.reshape([-1, logits.shape[-1]]),
                          ids.reshape([-1]))
    return mlm + F.cross_entropy(nsp, ids[:, 0] % 2)


def _logits_whole(dist, kind, logits):
    """The rank's logits whole over mp (GPT's are vocab parts) and over
    dp (each dp rank has its rows)."""
    from paddle_tpu_torch.distributed.fleet import mpu

    logits = logits.detach()
    if kind == "gpt":
        logits = mpu.gather_from_model_parallel(logits)
    rows = dist.all_gather(None, logits.contiguous(),
                           group=dist.new_group(axes=("dp",)))
    return _np(rows.reshape((-1,) + tuple(logits.shape[1:])))


def _forward(kind, model, crit, ids):
    """The logits and the loss of ``model`` on ``ids``."""
    from paddle_tpu_torch.nn import functional as F

    if kind == "bert":
        out = model(ids)
        return out[0], bert_loss(F, out, ids)
    logits = model(ids)
    return logits, crit(logits, ids)


def _accumulated(fleet, dist, kind, state):
    """A fresh model's gradients after two backwards of the same rows
    before a step, both reduced (``twice``), the first under
    ``DataParallel.no_sync`` (``no_sync_first``), or the sequence-parallel
    hooks registered with ``accumulation_steps=2`` (``accumulation_2``):
    each backward's part is reduced once, so each is twice one backward's
    gradients."""
    import torch

    from paddle_tpu_torch.distributed.fleet import sequence_parallel

    out = {}
    mine = dist.shard_batch(torch.from_numpy(batches()))
    for variant in ("twice", "no_sync_first", "accumulation_2"):
        model, crit = _port_model(kind, state)
        if variant == "accumulation_2":
            sequence_parallel.register_sequence_parallel_allreduce_hooks(
                model, accumulation_steps=2, fuse=True)
        wrapped = fleet.distributed_model(model)
        with (wrapped.no_sync() if variant == "no_sync_first"
              else contextlib.nullcontext()):
            _forward(kind, wrapped, crit, mine)[1].backward()
        _forward(kind, wrapped, crit, mine)[1].backward()
        out[variant] = _grads(model)
    return out


def _tp_model(fleet, dist, inputs, kind):
    import torch

    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    _init(fleet, TP_MESH)
    state = {k[len(kind) + 1:]: v for k, v in inputs.items()
             if k.startswith(kind + "/")}
    model, crit = _port_model(kind, state)
    res = {"round_trip": all(
        np.array_equal(_np(v), np.asarray(state[k], np.float32))
        for k, v in gpt.jax_state_dict(model).items())}
    wrapped = fleet.distributed_model(model)
    res["wrapper"] = type(wrapped).__name__
    res["sp_reducer"] = getattr(model, "_sp_grad_reducer", None) is not None
    mine = dist.shard_batch(torch.from_numpy(batches()))
    logits, loss = _forward(kind, wrapped, crit, mine)
    res["logits"] = _logits_whole(dist, kind, logits)
    loss.backward()
    mean = loss.detach().clone()
    dist.all_reduce(mean, op=dist.ReduceOp.AVG,
                    group=dist.new_group(axes=("dp",)))
    res["loss"] = float(mean)
    res["grads"] = _grads(model)
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                device="cpu")
    opt.step()
    opt.clear_grad()
    res["params"] = {k: _np(v) for k, v in gpt.jax_state_dict(model).items()}
    res["accumulated"] = _accumulated(fleet, dist, kind, state)
    return res


def _dropout_streams(fleet, dist, inputs):
    """gpt_tiny tensor-parallel (no SP) at hidden and attention dropout
    0.1 over dp2 x mp2: each block's output (the replicated residual
    stream) and the loss equal on the two ranks of an mp group."""
    import torch

    from paddle_tpu_torch.distributed.fleet import mpu
    from paddle_tpu_torch.models import gpt

    _init(fleet, TP_MESH)
    cfg = gpt.gpt_tiny(tensor_parallel=True, hidden_dropout_prob=0.1,
                       attention_dropout_prob=0.1)
    model = gpt.GPTForCausalLM(cfg, device="cpu",
                               generator=torch.Generator().manual_seed(1),
                               dropout_seed=4).train()
    seen = []
    for block in model.gpt.h:
        block.register_forward_hook(
            lambda m, a, y: seen.append(y.detach().clone()))
    mine = dist.shard_batch(torch.from_numpy(batches()))
    loss = gpt.GPTPretrainingCriterion(cfg)(model(mine), mine)
    loss.backward()
    c = mpu.group_comm()
    equal = []
    for t in seen + [loss.detach().reshape(1)]:
        both = dist.all_gather(None, t.contiguous(),
                               group=dist.new_group(axes=("mp",)))
        equal.append(bool(torch.equal(both[0], both[c.n - 1])))
    trained = list(seen)
    seen.clear()
    model.eval()
    with torch.no_grad():
        model(mine)
    # dropout acted: the training streams are not the eval ones
    return {"equal": equal, "acted": not any(
        torch.equal(a, b) for a, b in zip(trained, seen))}


def _sampler(fleet, dist):
    from paddle_tpu_torch import io

    hcg = _init(fleet, TP_MESH)
    sampler = io.DistributedBatchSampler(io.TensorDataset(
        [np.arange(11)]), batch_size=2, shuffle=True)
    sampler.set_epoch(2)
    return {"nranks": sampler.nranks, "local_rank": sampler.local_rank,
            "dp_rank": hcg.get_data_parallel_rank(),
            "batches": list(sampler)}


def _fleet(paddle, dist, r, inputs):
    from paddle_tpu_torch.distributed import fleet

    out = {"hcg": {name: _hcg(fleet, dist, d)
                   for name, d in HCG_MESHES.items()}}
    out["layers"] = _layers(fleet, dist, inputs)
    for kind in MODELS:
        out[kind] = _tp_model(fleet, dist, inputs, kind)
    out["dropout"] = _dropout_streams(fleet, dist, inputs)
    out["sampler"] = _sampler(fleet, dist)
    dist.barrier()
    return out


# --------------------------------------------------- context-parallel suite
def _cp_functions(fleet, dist, inputs):
    import torch

    from paddle_tpu_torch.distributed.fleet import context_parallel as cp

    hcg = _init(fleet, SEP4)
    r = hcg.get_sep_parallel_rank()
    out = {}
    part = CP_SHAPE[1] // 4

    def mine(name):
        full = torch.from_numpy(inputs[f"cp/{name}"])
        return full[:, r * part:(r + 1) * part].contiguous()

    for fn_name, causal in (("ring", True), ("ring", False),
                            ("ulysses", True), ("ulysses", False)):
        fn = cp.ring_attention if fn_name == "ring" else cp.ulysses_attention
        q, k, v = (mine(n).requires_grad_() for n in ("q", "k", "v"))
        o = fn(q, k, v, causal=causal)
        (o * mine("w")).sum().backward()
        res = {"o": o, "q_grad": q.grad, "k_grad": k.grad, "v_grad": v.grad}
        out[f"{fn_name}/causal_{causal}"] = {
            key: _np(_gather_dim(dist, t, 1, "sep")) for key, t in
            res.items()}
    # dropout with every head alike: the head groups' outputs differ only
    # by their masks, which must differ (each rank holds head r)
    same = [mine(n)[:, :, :1].expand(-1, -1, CP_SHAPE[2], -1).contiguous()
            for n in ("q", "k", "v")]
    whole = [_gather_dim(dist, cp.ulysses_attention(
        *same, causal=False, dropout=p), 1, "sep") for p in (0.0, 0.5)]
    heads = range(CP_SHAPE[2])
    out["ulysses_dropout"] = {
        "acted": not torch.equal(*whole),
        "equal_heads": [(i, j) for i in heads for j in heads
                        if i < j and torch.equal(whole[1][:, :, i],
                                                 whole[1][:, :, j])],
        "plain_equal_heads": all(torch.equal(whole[0][:, :, 0],
                                             whole[0][:, :, j])
                                 for j in heads)}
    try:
        q = torch.zeros(1, part, 6, 16)
        cp.ulysses_attention(q, q, q)
        out["ulysses_heads"] = "no error"
    except ValueError as e:
        out["ulysses_heads"] = str(e)
    return out


def _cp_model(fleet, dist, inputs):
    import torch

    from paddle_tpu_torch.distributed.fleet import mpu
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.optimizer import AdamW

    _init(fleet, SEP4)
    state = {k[len("cpgpt/"):]: v for k, v in inputs.items()
             if k.startswith("cpgpt/")}
    cfg = gpt.gpt_tiny(context_parallel="ring")
    model = gpt.GPTForCausalLM(cfg, device="cpu")
    gpt.load_jax_state(model, state)
    model.train()
    wrapped = fleet.distributed_model(model)
    ids = torch.from_numpy(cp_model_ids())
    logits = wrapped(ids)
    loss = gpt.GPTPretrainingCriterion(cfg)(logits, ids)
    loss.backward()
    res = {"logits": _np(_gather_dim(dist, logits, 1, "sep")),
           "loss": float(loss.detach()), "grads": _grads(model),
           "wrapper": type(wrapped).__name__,
           "divisor": wrapped._reducer.divisor,
           "sep_rank": mpu.group_comm("sep").me}
    opt = AdamW(learning_rate=LR, parameters=model.parameters(),
                device="cpu")
    opt.step()
    res["params"] = {k: _np(v) for k, v in gpt.jax_state_dict(model).items()}
    res["ring_blocks"] = len(fleet.context_parallel.ring_blocks(
        res["sep_rank"], 4, True))
    # a fresh model, two backwards before a step: each summed over sep once
    model = gpt.GPTForCausalLM(cfg, device="cpu")
    gpt.load_jax_state(model, state)
    wrapped = fleet.distributed_model(model.train())
    crit = gpt.GPTPretrainingCriterion(cfg)
    for _ in range(2):
        crit(wrapped(ids), ids).backward()
    res["grads_twice"] = _grads(model)
    return res


def _context_parallel(paddle, dist, r, inputs):
    from paddle_tpu_torch.distributed import fleet

    out = {"functions": _cp_functions(fleet, dist, inputs),
           "model": _cp_model(fleet, dist, inputs)}
    dist.barrier()
    return out


SUITES = {"fleet": _fleet, "context_parallel": _context_parallel}


def main(argv):
    suite, out_dir = argv[1], argv[2]
    import paddle_tpu_torch as paddle
    import paddle_tpu_torch.distributed as dist

    paddle.set_device("cpu")
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    dist.init_parallel_env()
    r = dist.get_rank()
    result = SUITES[suite](paddle, dist, r, inputs)
    with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(HERE))
    main(sys.argv)
