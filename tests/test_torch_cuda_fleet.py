"""On-card tests of the fleet tier (marker ``cuda``).

They need an NVIDIA GPU and skip on hosts without one. This file imports
no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_fleet.py

A world of one over NCCL (``fleet.init`` with every degree 1 in the test
process, its own store on a free port, destroyed after the module),
tolerance 0:

- ``fleet.distributed_model(LlamaForCausalLM(llama_tiny(tensor_parallel,
  sequence_parallel)))`` bf16 O2 under ``TrainStep``: the graphed steps
  (the mpu autograd ops inside the CUDA graph) bit for bit its eager
  steps, which are bit for bit the bare model's from the same weights;
  K1-K4 launch the bare model's counts;
- ``ring_attention`` and ``ulysses_attention`` over one ``sep`` rank, and
  ``gpt_tiny(context_parallel="ring")``: the output and the gradients bit
  for bit plain K1-K3 (``flash_attention_value``) and the bare GPT.
"""
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt, llama
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import rms_norm as rms
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

STEPS = 5


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    try:
        yield fleet
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _llama(fleet, parallel: bool):
    flags = dict(tensor_parallel=True, sequence_parallel=True) \
        if parallel else {}
    cfg = llama.llama_tiny(**flags)
    model = llama.LlamaForCausalLM(
        cfg, generator=torch.Generator().manual_seed(0)).train()
    crit = llama.LlamaPretrainingCriterion(cfg)
    amp.decorate(model, level="O2", dtype="bfloat16")
    net = fleet.distributed_model(model) if parallel else model
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())

    def loss_fn(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(ids)
        return crit(logits, ids)

    return net, opt, loss_fn


def _eager(fleet, parallel, ids):
    net, opt, loss_fn = _llama(fleet, parallel)
    losses = []
    for _ in range(STEPS):
        loss = loss_fn(ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, [p.detach().clone() for p in net.parameters()]


def test_tensor_parallel_llama_graphed_bit_for_bit(world):
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator()
                        .manual_seed(1)).cuda()
    bare = _eager(world, False, ids)
    eager = _eager(world, True, ids)
    assert eager[0] == bare[0]
    assert all(torch.equal(a, b) for a, b in zip(eager[1], bare[1]))
    net, opt, loss_fn = _llama(world, True)
    step = TrainStep(model=net, optimizer=opt, loss_fn=loss_fn)
    losses = [float(step(ids)) for _ in range(2)]
    fa.launches = rms.launches = 0
    losses += [float(step(ids)) for _ in range(STEPS - 2)]
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}
    assert losses == eager[0]
    assert all(torch.equal(p.detach(), q)
               for p, q in zip(net.parameters(), eager[1]))
    layers = llama.llama_tiny().num_hidden_layers
    assert fa.launches == layers * (STEPS - 2)
    assert rms.launches == (2 * layers + 1) * (STEPS - 2)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_context_parallel_over_one_rank_is_plain_k1_k3(kind, world):
    from paddle_tpu_torch.distributed.fleet import context_parallel as cp

    gen = torch.Generator().manual_seed(2)
    q, k, v, w = (torch.randn(2, 256, 4, 64, generator=gen).cuda()
                  .bfloat16() for _ in range(4))
    fn = cp.ring_attention if kind == "ring" else cp.ulysses_attention
    outs = []
    for attend in (lambda a, b, c: fn(a, b, c, causal=True),
                   lambda a, b, c: fa.flash_attention_value(
                       a, b, c, True, 0.125, device="cuda")):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = attend(*leaves).as_subclass(torch.Tensor)
        (o.float() * w.float()).sum().backward()
        outs.append([o.detach()] + [t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_ring_gpt_over_one_rank_is_the_bare_gpt(world):
    ids = torch.randint(0, 512, (2, 128), generator=torch.Generator()
                        .manual_seed(3)).cuda()
    got = []
    for flags in ({}, {"context_parallel": "ring"}):
        cfg = gpt.gpt_tiny(**flags)
        model = gpt.GPTForCausalLM(
            cfg, generator=torch.Generator().manual_seed(0)).train()
        loss = gpt.GPTPretrainingCriterion(cfg)(model(ids), ids)
        loss.backward()
        got.append([loss.detach()] + [p.grad for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*got))
