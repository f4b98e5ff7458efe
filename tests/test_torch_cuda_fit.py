"""On-card tests of the training loop (marker ``cuda``): ``Model.fit``
over the ``DeviceLoader``'s side-stream prefetch and worker processes,
and snapshot restores into a step already captured as a CUDA graph.

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_fit.py

All comparisons are bit for bit (tolerance 0), on ``llama_tiny`` in bf16
O2 (the forward under ``auto_cast``, the criterion outside) with
``AdamW(1e-3)``, every step after the second a graph replay:

- 30 steps whose batches were copied on the prefetch's side stream
  (``device_prefetch=2``, 2 worker processes) against the same 30 batches
  moved to the card by ``train_batch`` on the loop's stream: the loss
  streams and the final parameters. A batch read by the replay's input
  copy before its own copy landed, or its memory reused while the copy
  was queued, would change a loss;
- a fit whose step is captured, trained on, then resumed from its own
  snapshot: the restore copies into the parameters and optimizer cells the
  graph holds, and the stream from there on equals the uninterrupted
  run's.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import amp, hapi, io
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny)
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

EPOCHS, BATCHES, BATCH, SEQ = 3, 10, 4, 128


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


class O2(torch.nn.Module):
    def __init__(self, inner):
        super().__init__()
        self.inner = inner

    def forward(self, ids):
        with amp.auto_cast(level="O2", dtype="bfloat16"):
            return self.inner(ids)


class Recording(hapi.Model):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.stream = []

    def train_batch(self, inputs, labels=None, update=True, sync=True):
        out = super().train_batch(inputs, labels, update, sync)
        self.stream.append(out[0])
        return out


def _model():
    cfg = llama_tiny()
    inner = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(0))
    amp.decorate(inner, level="O2", dtype="bfloat16")
    net = O2(inner).train()
    m = Recording(net)
    m.prepare(AdamW(learning_rate=1e-3, parameters=net.parameters()),
              LlamaPretrainingCriterion(cfg))
    return m


def _data():
    rows = np.random.RandomState(4).randint(
        0, llama_tiny().vocab_size, (BATCHES * BATCH, SEQ)).astype(np.int64)
    return io.TensorDataset([rows, rows])


def _result(m):
    return ([float(x) for x in m.stream],
            [p.detach().clone() for p in m.network.parameters()])


def _equal(a, b):
    return a[0] == b[0] and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def test_prefetched_steps_equal_unprefetched(card, tmp_path):
    ds = _data()
    runs = {}
    for name, kw in (("prefetch", dict(device_prefetch=2, num_workers=2)),
                     ("plain", dict(device_prefetch=0, num_workers=0))):
        m = _model()
        m.fit(ds, batch_size=BATCH, epochs=EPOCHS, shuffle=True, verbose=0,
              log_freq=5, snapshot_dir=str(tmp_path / name), **kw)
        assert m._train_step.stats == {"compiled_steps": EPOCHS * BATCHES - 1,
                                       "eager_steps": 1}
        runs[name] = _result(m)
    assert len(runs["plain"][0]) == EPOCHS * BATCHES
    assert _equal(runs["prefetch"], runs["plain"])


def test_resume_restores_into_the_captured_step(card, tmp_path):
    ds = _data()
    ref = _model()
    ref.fit(ds, batch_size=BATCH, epochs=2, shuffle=True, verbose=0,
            device_prefetch=2, snapshot_dir=str(tmp_path / "ref"))
    want = _result(ref)
    m = _model()
    # epoch 0, snapshots at steps 5 and 10; then another pass that moves
    # the parameters and the moments on, through the same graph
    m.fit(ds, batch_size=BATCH, epochs=1, shuffle=True, verbose=0,
          device_prefetch=2, snapshot_dir=str(tmp_path / "run"),
          snapshot_every=5)
    m.fit(ds, batch_size=BATCH, epochs=1, shuffle=True, verbose=0,
          device_prefetch=2)
    graph = m._train_step._compiled
    m.stream.clear()
    m.fit(ds, batch_size=BATCH, epochs=2, shuffle=True, verbose=0,
          device_prefetch=2, snapshot_dir=str(tmp_path / "run"), resume=True)
    assert m._train_step._compiled is graph  # the same captured step
    assert graph.graph_counts()["captures"] == 1
    got = _result(m)
    assert got[0] == want[0][BATCHES:]
    assert all(torch.equal(x, y) for x, y in zip(got[1], want[1]))
