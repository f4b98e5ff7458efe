"""On-card tests of BERT fine-tuning through the graphed ``TrainStep``
(marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_bert.py

All comparisons are bit for bit (tolerance 0), against the same sequence
of steps run eagerly by hand (``loss_fn``, ``backward``, ``step``,
``clear_grad``) on a twin built from the same seed:

- ``bert_tiny`` classification without a mask, f32 and bf16 O2: every
  step after the first is one replay of one graph, which launches K1, K2
  and K3 (non-causal) once a layer;
- under ``TrainStep(bucket_axes={0: 1, 1: 1})`` with keep-masks, bf16 O2,
  over batches whose lengths hit the rungs 32, 64 and 128 three times or
  more: one capture a rung, every later call of a rung a replay with no
  host sync (``torch.cuda.set_sync_debug_mode("error")``), and no launch
  of K1–K3 (a masked call takes the composition route).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.bucketing import bucket_for, pad_to_bucket
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

STEPS = 5
LENGTHS = (20, 37, 64, 100, 30, 50, 120, 25, 60, 90)
LADDER = (16, 32, 64, 128)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _build(o2):
    model = bert.BertForSequenceClassification(
        bert.bert_tiny(), generator=torch.Generator().manual_seed(0)).train()
    crit = nn.CrossEntropyLoss()
    if o2:
        amp.decorate(model, level="O2", dtype="bfloat16")
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters())

    def loss_fn(ids, mask, labels):
        with amp.auto_cast(enable=o2, level="O2", dtype="bfloat16"):
            logits = model(ids, attention_mask=mask)
        return crit(logits, labels)

    return model, opt, loss_fn


def _eager(loss_fn, opt, batch):
    loss = loss_fn(*batch)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss.detach()


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("o2", [False, True])
def test_graphed_bert_step_is_the_eager_sequence(card, o2):
    rs = np.random.RandomState(0)
    ids = torch.from_numpy(rs.randint(0, 512, (4, 128))).to(card)
    labels = torch.from_numpy(rs.randint(0, 2, (4,))).to(card)
    batch = (ids, None, labels)
    model, opt, loss_fn = _build(o2)
    want = [float(_eager(loss_fn, opt, batch)) for _ in range(STEPS)]
    want_params = _params(model)

    model, opt, loss_fn = _build(o2)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn)
    losses = [step(*batch), step(*batch)]  # eager, then the capture
    fa.launches = fa.dq_launches = fa.dkv_launches = fa.tma_copies = 0
    losses += [step(*batch) for _ in range(STEPS - 2)]
    torch.cuda.synchronize()
    layers = model.config.num_hidden_layers
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == \
        (layers * (STEPS - 2),) * 3
    assert fa.tma_copies == 0
    assert [float(x) for x in losses] == want
    assert all(torch.equal(a, b) for a, b in zip(_params(model), want_params))
    assert step.stats == {"compiled_steps": STEPS - 1, "eager_steps": 1}


def _masked_batches(card):
    rs = np.random.RandomState(1)
    out = []
    for n in LENGTHS:
        ids = rs.randint(1, 512, (4, n))
        ends = np.concatenate([[n], rs.randint(1, n + 1, 3)])
        mask = (np.arange(n)[None] < ends[:, None]).astype(np.int64)
        labels = rs.randint(0, 2, (4,))
        out.append(tuple(torch.from_numpy(a).to(card)
                         for a in (ids, mask, labels)))
    return out


def test_bucketed_bert_steps_are_the_eager_sequence(card):
    batches = _masked_batches(card)
    model, opt, loss_fn = _build(True)
    want = []
    for ids, mask, labels in batches:
        rung = bucket_for(ids.shape[1], LADDER)
        padded = (pad_to_bucket(ids, 1, rung), pad_to_bucket(mask, 1, rung),
                  labels)
        want.append(float(_eager(loss_fn, opt, padded)))
    want_params = _params(model)

    model, opt, loss_fn = _build(True)
    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     bucket_axes={0: 1, 1: 1}, bucket_range=(16, 128),
                     bucket_pad_values={0: 0, 1: 0})
    seen = {}
    losses = []
    fa.launches = 0
    for batch in batches:
        rung = bucket_for(batch[0].shape[1], LADDER)
        replay = seen.get(rung, 0) >= 2
        seen[rung] = seen.get(rung, 0) + 1
        if replay:
            torch.cuda.set_sync_debug_mode("error")
        try:
            losses.append(step(*batch))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert [float(x) for x in losses] == want
    assert all(torch.equal(a, b) for a, b in zip(_params(model), want_params))
    assert fa.launches == 0
    counts = step._compiled.graph_counts()
    assert counts["signatures"] == counts["captures"] == 3
    assert step.stats == {"compiled_steps": len(LENGTHS) - 3,
                          "eager_steps": 3}
    assert step.audit_report()["buckets"] == list(LADDER)
