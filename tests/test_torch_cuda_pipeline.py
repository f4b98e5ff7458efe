"""On-card tests of pipeline parallelism and recompute (marker ``cuda``).

They need an NVIDIA GPU and skip on hosts without one. This file imports
no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_pipeline.py

Tolerance 0:

- a world of one over NCCL (``fleet.init`` with every degree 1 in the test
  process, destroyed after the module): ``llama_tiny(pipeline_parallel)``
  bf16 O2 under ``fleet.distributed_model`` and ``TrainStep``, the graphed
  steps bit for bit its eager steps, which are bit for bit the bare
  model's from the same weights; K1 and K4 launch the bare model's counts;
- a gpt_tiny block at hidden and attention dropout 0.1 under
  ``fleet.recompute`` in a graphed ``TrainStep``: the steps bit for bit
  its eager steps and the plain model's graphed steps from the same
  generator states; K1 launches twice a layer, K2 once.
"""
import pytest
import torch

from paddle_tpu_torch import amp
from paddle_tpu_torch.distributed import fleet
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
    try:
        yield fleet
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()


def _o2(model, crit, wrap=None):
    amp.decorate(model, level="O2", dtype="bfloat16")
    net = wrap(model) if wrap is not None else model
    opt = AdamW(learning_rate=1e-3, parameters=[
        p for p in net.parameters() if p.requires_grad])

    def loss_fn(ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            logits = net(ids)
        return crit(logits, ids)

    return net, opt, loss_fn


def _llama(pipelined: bool):
    cfg = llama.llama_tiny(pipeline_parallel=pipelined)
    model = llama.LlamaForCausalLM(
        cfg, generator=torch.Generator().manual_seed(0)).train()
    return _o2(model, llama.LlamaPretrainingCriterion(cfg),
               fleet.distributed_model if pipelined else None)


def _eager(build, ids):
    net, opt, loss_fn = build()
    losses = []
    for _ in range(STEPS):
        loss = loss_fn(ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, [p.detach().clone() for p in net.parameters()]


def _graphed(build, ids):
    net, opt, loss_fn = build()
    step = TrainStep(model=net, optimizer=opt, loss_fn=loss_fn)
    losses = [float(step(ids)) for _ in range(2)]
    fa.launches = fa.dq_launches = rms.launches = 0
    losses += [float(step(ids)) for _ in range(STEPS - 2)]
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}
    return losses, [p.detach().clone() for p in net.parameters()]


def _same(a, b):
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_pipelined_llama_world_of_one_graphed_bit_for_bit(world):
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator()
                        .manual_seed(1)).cuda()
    bare = _eager(lambda: _llama(False), ids)
    eager = _eager(lambda: _llama(True), ids)
    # the stacked parameters hold the bare model's, layer after layer
    assert eager[0] == bare[0]
    graphed = _graphed(lambda: _llama(True), ids)
    assert _same(graphed, eager)
    layers = llama.llama_tiny().num_hidden_layers
    assert fa.launches == layers * (STEPS - 2)
    assert rms.launches == (2 * layers + 1) * (STEPS - 2)


def _gpt(recomputed: bool):
    cfg = gpt.gpt_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    model = gpt.GPTForCausalLM(
        cfg, generator=torch.Generator().manual_seed(0),
        dropout_seed=7).train()
    if recomputed:
        for block in model.gpt.h:
            block.forward = (lambda f: lambda x: fleet.recompute(f, x))(
                block.forward)
    return _o2(model, gpt.GPTPretrainingCriterion(cfg))


def test_recompute_at_dropout_graphed_bit_for_bit(world):
    ids = torch.randint(0, 512, (2, 64), generator=torch.Generator()
                        .manual_seed(2)).cuda()
    eager = _eager(lambda: _gpt(True), ids)
    assert _same(eager, _eager(lambda: _gpt(False), ids))
    graphed = _graphed(lambda: _gpt(True), ids)
    assert _same(graphed, eager)
    layers = gpt.gpt_tiny().num_hidden_layers
    assert fa.launches == 2 * layers * (STEPS - 2)
    assert fa.dq_launches == layers * (STEPS - 2)
    assert _same(_graphed(lambda: _gpt(False), ids), graphed)
