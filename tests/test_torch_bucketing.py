"""The port's shape bucketing for training against the JAX package's, on
the CPU.

- ``pad_to_bucket``: the same padded arrays as the JAX function (ints and
  floats, each axis, its fill), the value itself at the bucket's size, a
  ``ValueError`` past it;
- ``BucketedFunction``: the same padded arguments reach the function, the
  same rungs are met (``num_compiled``) and ``audit_report()["buckets"]``
  is the same ladder;
- a bucketed ``TrainStep`` (``bucket_axes={0: 1, 1: 1}``, ids and keep-mask
  padded with 0) on ``bert_tiny`` in f32 over batches of lengths 20, 37,
  64 and 100 with ``AdamW(1e-3)``: the losses within 1e-4 relative of the
  JAX bucketed ``TrainStep``'s from the same weights, and the same three
  rungs (32, 64, 128) compiled in both packages; the padded batch's loss
  equals the batch's at its true length within 1e-5 (the mask hides the
  padding).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.api import TrainStep as JaxTrainStep
from paddle_tpu.jit.bucketing import BucketedFunction as JaxBucketed
from paddle_tpu.jit.bucketing import pad_to_bucket as jax_pad_to_bucket
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JaxClassifier
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.jit.bucketing import BucketedFunction, pad_to_bucket
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.optimizer import AdamW

LENGTHS = (20, 37, 64, 100)
BATCH = 3


@pytest.mark.parametrize("dtype,axis,bucket,fill", [
    (np.int64, 1, 32, 0), (np.int64, 1, 16, -100), (np.float32, 0, 8, 0.5),
    (np.float32, 1, 11, 0)])
def test_pad_to_bucket_matches_jax(dtype, axis, bucket, fill):
    a = (np.random.RandomState(0).randn(5, 11) * 10).astype(dtype)
    want = np.asarray(jax_pad_to_bucket(a, axis, bucket, fill))
    got = pad_to_bucket(torch.from_numpy(a), axis, bucket, fill)
    assert got.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_pad_to_bucket_edges():
    t = torch.arange(6).view(2, 3)
    assert pad_to_bucket(t, 1, 3) is t
    with pytest.raises(ValueError, match="larger than bucket"):
        pad_to_bucket(t, 1, 2)
    # a value that is not a tensor becomes one
    np.testing.assert_array_equal(
        pad_to_bucket(np.ones((1, 2), np.float32), 1, 4).numpy(),
        [[1, 1, 0, 0]])


def test_bucketed_function_matches_jax():
    calls = []

    def port_fn(ids, labels):
        calls.append((tuple(ids.shape), tuple(labels.shape)))
        return ids, labels

    def jax_fn(ids, labels):
        return ids + 0, labels + 0

    kw = dict(bucket_axes={0: 1, 1: 1}, min_len=4, max_len=16,
              pad_values={1: -100})
    port = BucketedFunction(port_fn, device="cpu", **kw)
    ref = JaxBucketed(jax_fn, **kw)
    rs = np.random.RandomState(1)
    for n in (5, 9, 12, 16, 3):
        ids = rs.randint(1, 50, (2, n)).astype(np.int64)
        labels = rs.randint(1, 50, (2, n)).astype(np.int64)
        want = ref(paddle.to_tensor(ids), paddle.to_tensor(labels))
        got = port(torch.from_numpy(ids), torch.from_numpy(labels))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w.numpy()))
    assert [c[0][1] for c in calls] == [8, 16, 16, 16, 4]
    assert port.num_compiled == ref.num_compiled == 3
    report = port.audit_report()
    assert report["buckets"] == ref.audit_report()["buckets"] == [4, 8, 16]
    assert report["n_cache_keys"] == 3
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        port(torch.zeros(1, 17, dtype=torch.int64),
             torch.zeros(1, 17, dtype=torch.int64))


def _batches():
    rs = np.random.RandomState(2)
    out = []
    for n in LENGTHS:
        ids = rs.randint(1, 512, (BATCH, n)).astype(np.int64)
        # rows end at their own lengths; the longest row fills the batch
        ends = np.array([n, rs.randint(n // 2, n + 1), rs.randint(1, n + 1)])
        mask = (np.arange(n)[None] < ends[:, None]).astype(np.int64)
        labels = rs.randint(0, 2, (BATCH,)).astype(np.int64)
        out.append((ids, mask, labels))
    return out


_BUCKETS = dict(bucket_axes={0: 1, 1: 1}, bucket_range=(16, 128),
                bucket_pad_values={0: 0, 1: 0})


def _jax_run(batches):
    paddle.seed(0)
    model = JaxClassifier(jax_bert_tiny())
    state = {k: np.array(v.numpy(), copy=True)
             for k, v in model.state_dict().items()}
    crit = paddle.nn.CrossEntropyLoss()
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    step = JaxTrainStep(model=model, optimizer=opt,
                        loss_fn=lambda x, m, y: crit(
                            model(x, attention_mask=m), y), **_BUCKETS)
    losses = [float(np.asarray(step(*(paddle.to_tensor(a) for a in b))
                               .numpy())) for b in batches]
    return state, losses, step._compiled.num_compiled


def test_bucketed_train_step_matches_jax():
    batches = _batches()
    state, want, want_compiled = _jax_run(batches)
    model = bert.BertForSequenceClassification(bert.bert_tiny(), device="cpu")
    bert.load_jax_state(model, state).train()
    crit = nn.CrossEntropyLoss()
    opt = AdamW(learning_rate=1e-3, parameters=model.parameters(),
                device="cpu")

    def loss_fn(x, m, y):
        return crit(model(x, attention_mask=m), y)

    step = TrainStep(model=model, optimizer=opt, loss_fn=loss_fn,
                     device="cpu", **_BUCKETS)
    # the first batch's loss, padded and at its true length, before a step
    x, m, y = (torch.from_numpy(a) for a in batches[0])
    with torch.no_grad():
        padded = loss_fn(pad_to_bucket(x, 1, 32), pad_to_bucket(m, 1, 32), y)
        np.testing.assert_allclose(float(padded), float(loss_fn(x, m, y)),
                                   rtol=1e-5, atol=1e-5)
    got = [float(step(*(torch.from_numpy(a) for a in b))) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert step._compiled.num_compiled == want_compiled == 3
    report = step.audit_report()
    assert report["buckets"] == [16, 32, 64, 128]
    assert report["stats"] == {"compiled_steps": 0, "eager_steps": 4}
