"""On-card tests of the data-parallel tier (marker ``cuda``).

They need an NVIDIA GPU and skip on hosts without one. This file imports
no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_distributed.py

A world of one over NCCL (``init_parallel_env()`` in the test process, its
own store on a free port, destroyed after the module), tolerance 0:

- ``DataParallel(llama_tiny)`` bf16 O2 under ``TrainStep``: the graphed
  steps (the bucketed NCCL all-reduce inside the CUDA graph) bit for bit
  its eager steps, which are bit for bit the bare model's; one all-reduce
  a bucket a replayed step;
- ``sync_batch_norm`` over the world's group captured by
  ``CompiledFunction`` (forward, gradients, running stats), its replays
  bit for bit the eager calls, two all-reduces a call;
- the collectives of ``distributed.communication`` on CUDA tensors, and
  a gloo collective refusing to be captured (a separate gloo group over
  the same rank).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import DataParallel, amp
from paddle_tpu_torch.jit import CompiledFunction, TrainStep
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.nn.functional.norm import sync_batch_norm
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

STEPS = 5


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env()
    try:
        yield dist
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _llama(wrap: bool):
    cfg = llama.llama_tiny()
    model = llama.LlamaForCausalLM(
        cfg, generator=torch.Generator().manual_seed(0)).train()
    crit = llama.LlamaPretrainingCriterion(cfg)
    amp.decorate(model, level="O2", dtype="bfloat16")
    net = DataParallel(model, comm_buffer_size=0.05,
                       last_comm_buffer_size=0.01) if wrap else model
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())

    def loss_fn(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(ids)
        return crit(logits, ids)

    return cfg, net, opt, loss_fn


def _eager(wrap, ids):
    _, net, opt, loss_fn = _llama(wrap)
    losses = []
    for _ in range(STEPS):
        loss = loss_fn(ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, [p.detach().clone() for p in net.parameters()]


def test_data_parallel_step_graphed_with_nccl_inside(world):
    from paddle_tpu_torch.distributed import communication

    cfg = llama.llama_tiny()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int64)).cuda()
    assert world.get_backend() == "nccl"
    bare = _eager(False, ids)
    eager = _eager(True, ids)
    assert eager[0] == bare[0]
    assert all(torch.equal(a, b) for a, b in zip(eager[1], bare[1]))
    _, net, opt, loss_fn = _llama(True)
    assert len(net.bucket_sizes) > 1
    step = TrainStep(model=net, optimizer=opt, loss_fn=loss_fn)
    losses = [float(step(ids)) for _ in range(2)]
    for key in communication.launches:
        communication.launches[key] = 0
    losses += [float(step(ids)) for _ in range(STEPS - 2)]
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}
    assert communication.launches["all_reduce"] == \
        len(net.bucket_sizes) * (STEPS - 2)
    assert losses == eager[0]
    assert all(torch.equal(p.detach(), q)
               for p, q in zip(net.parameters(), eager[1]))


def test_sync_batch_norm_captures_on_nccl(world):
    from paddle_tpu_torch.distributed import communication
    from paddle_tpu_torch.distributed.communication import Group

    group = Group(world.get_mesh().axis_names)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 16, 12, 12, generator=gen).cuda()
    g = torch.randn(8, 16, 12, 12, generator=gen).cuda()

    def make():
        w = torch.nn.Parameter((torch.rand(16, generator=torch.Generator()
                                           .manual_seed(4)) + 0.5).cuda())
        b = torch.nn.Parameter(torch.zeros(16, device="cuda"))
        stats = (torch.zeros(16, device="cuda"), torch.ones(16, device="cuda"))

        def fn(x, g):
            out = sync_batch_norm(x, *stats, w, b, group=group)
            grads = torch.autograd.grad((out * g).sum(), [w, b])
            # detached: a graph kept alive past the call would hold the
            # leaves' gradient accumulators on the stream they met first
            return (out.detach(),) + grads
        return fn, stats

    fn, stats = make()
    want = [[t.clone() for t in fn(x, g)] for _ in range(3)]
    compiled_fn, compiled_stats = make()
    compiled = CompiledFunction(compiled_fn)
    got = [[t.clone() for t in compiled(x, g)] for _ in range(2)]
    for key in communication.launches:
        communication.launches[key] = 0
    got.append([t.clone() for t in compiled(x, g)])
    assert compiled.graph_counts()["replays"] == 2
    assert communication.launches["all_reduce"] == 2
    for a, b in zip(got, want):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert all(torch.equal(u, v) for u, v in zip(compiled_stats, stats))


def test_collectives_on_cuda_tensors(world):
    dev = torch.device("cuda")
    x = torch.tensor([1.0, 2.0], device=dev)
    world.all_reduce(x)
    assert x.tolist() == [1.0, 2.0]
    out = world.all_gather(None, x)
    assert list(out.shape) == [1, 2]
    dst = torch.zeros(2, device=dev)
    world.reduce_scatter(dst, torch.tensor([3.0, 4.0], device=dev))
    assert dst.tolist() == [3.0, 4.0]
    got = world.all_to_all_single(None, torch.arange(3.0, device=dev))
    assert got.tolist() == [0.0, 1.0, 2.0]
    with pytest.raises(ValueError, match="send to self"):
        world.send(x, 0)
    gloo = torch.distributed.new_group([0], backend="gloo")
    from paddle_tpu_torch.distributed.communication import _Comm, _all_reduce_

    c = _Comm(gloo, [0])
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="gloo"):
        with torch.cuda.graph(graph):
            _all_reduce_(x, 0, c)
