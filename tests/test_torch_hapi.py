"""The port's ``hapi`` (``Model``, its callbacks, ``MetricBuffer``,
``summary``, ``flops``) and ``metric`` against the JAX package's, on the
CPU.

- ``Accuracy`` (top-1 and top-2, numpy and tensor scores, one-hot
  labels), ``Precision``, ``Recall`` and ``Auc`` equal JAX's within 1e-6.
- ``Model.fit`` on ``llama_tiny`` with JAX's weights carried across
  (``load_jax_state``), ``AdamW`` and ``LlamaPretrainingCriterion`` in f32,
  2 epochs over one token ``Dataset`` with snapshots armed, so that
  ``set_epoch`` pins both shuffles: the loss streams agree within the
  tolerance ``tests/test_torch_llama.py`` states for its f32 training
  steps (``rtol=1e-4, atol=1e-5``); ``evaluate`` (loss and ``Accuracy``)
  and ``predict`` on the same weights agree within 1e-5.
- The classifier of ``tests/test_vision_metric_hapi.py:110`` in both
  packages from the same weights, unshuffled: its ``evaluate`` logs within
  1e-5 of JAX's, ``predict``'s shape, ``save``/``load`` round trip bit for
  bit; ``EarlyStopping`` (``:140``) stops both after the same epochs;
  ``ModelCheckpoint`` writes the same files; the ``LRScheduler`` callback
  steps both schedules alike.
- ``MetricBuffer`` materializes the exact floats with one counted host
  sync a boundary; ``summary`` and ``flops`` count as JAX's do.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as jax_io
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import Callback as JaxCallback
from paddle_tpu.hapi import EarlyStopping as JaxEarlyStopping
from paddle_tpu.metric import Accuracy as JaxAccuracy
from paddle_tpu.metric import Auc as JaxAuc
from paddle_tpu.metric import Precision as JaxPrecision
from paddle_tpu.metric import Recall as JaxRecall
from paddle_tpu.models import llama as jax_llama
from paddle_tpu_torch import hapi, io, metric, nn
from paddle_tpu_torch.distributed.checkpoint.sharded import load_sharded
from paddle_tpu_torch.models.gpt import load_jax_state
from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny)
from paddle_tpu_torch.optimizer import SGD, Adam, AdamW
from paddle_tpu_torch.optimizer.lr import StepDecay
from paddle_tpu_torch.profiler.pipeline import pipeline_stats

LR = 1e-3


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


# ------------------------------------------------------------------ metrics
def test_accuracy_matches_jax():
    rs = np.random.RandomState(0)
    pred = rs.randn(50, 7).astype(np.float32)
    label = rs.randint(0, 7, 50).astype(np.int64)
    for topk in ((1,), (1, 2)):
        for as_tensor in (False, True):
            got, want = metric.Accuracy(topk=topk), JaxAccuracy(topk=topk)
            p = torch.from_numpy(pred) if as_tensor else pred
            y = torch.from_numpy(label) if as_tensor else label
            for lo, hi in ((0, 20), (20, 50)):
                g = got.update(got.compute(p[lo:hi], y[lo:hi]))
                w = want.update(want.compute(pred[lo:hi], label[lo:hi]))
                np.testing.assert_allclose(g, w, atol=1e-6)
            np.testing.assert_allclose(got.accumulate(), want.accumulate(),
                                       atol=1e-6)
            assert got.name() == want.name()
    onehot = np.eye(7, dtype=np.float32)[label]
    got, want = metric.Accuracy(), JaxAccuracy()
    got.update(got.compute(torch.from_numpy(pred), torch.from_numpy(onehot)))
    want.update(want.compute(pred, onehot))
    assert abs(got.accumulate() - want.accumulate()) <= 1e-6


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_accuracy_ties_match_jax(dtype):
    """Tied scores rank as the JAX package ranks them: ``np.argsort(-pred)``
    on the host array in its own dtype (bf16 through ``ml_dtypes`` on the
    JAX side), so the top 5 agree exactly, batch by batch, at 1000 classes
    (bf16 2·N(0, 1) scores tie often there) and at 10. Each label is the
    JAX ranking's entry at a random place among the first six, so a tie
    inside the top 5 shows in the result."""
    import ml_dtypes

    host = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
            "float32": np.float32}[dtype]
    rs = np.random.RandomState(0)
    for classes in (1000, 10):
        got, want = metric.Accuracy(topk=(1, 5)), JaxAccuracy(topk=(1, 5))
        for _ in range(4):
            scores = (2 * rs.randn(256, classes)).astype(host)
            place = rs.randint(0, 6, 256)
            label = np.argsort(-scores, axis=-1)[np.arange(256), place]
            pred = torch.from_numpy(scores.astype(np.float32)).to(
                getattr(torch, dtype))
            g = got.compute(pred, torch.from_numpy(label))
            w = want.compute(scores, label)
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(got.update(g), want.update(w))
        assert got.accumulate() == want.accumulate()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_accuracy_top_order_is_numpys_full_argsort(dtype):
    """``metric.metrics._top_order`` (``torch.topk`` where the top scores
    are distinct, numpy's sort only on the rows with a tie, a NaN or a
    signed zero near the top) gives the first k of ``np.argsort(-x)``
    over the whole array in its own dtype (bf16 through ``ml_dtypes``)."""
    import ml_dtypes

    from paddle_tpu_torch.metric.metrics import _top_order

    host = {"bfloat16": ml_dtypes.bfloat16, "float16": np.float16,
            "float32": np.float32}[dtype]
    rs = np.random.RandomState(3)
    x = (rs.randn(3, 40, 64) * 0.5).astype(host)
    x[0, 0, :4] = np.nan
    x[0, 1, :] = 0
    x[0, 1, ::3] = -0.0
    x[1, 2, 5:9] = x[1, 2].max()  # a four-way tie at the top
    t = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    for k in (1, 5, 64):
        want = np.argsort(-x, axis=-1)[..., :k]
        np.testing.assert_array_equal(_top_order(t, k), want)


def test_precision_recall_auc_match_jax():
    rs = np.random.RandomState(1)
    for cls_got, cls_want in ((metric.Precision, JaxPrecision),
                              (metric.Recall, JaxRecall),
                              (metric.Auc, JaxAuc)):
        got, want = cls_got(), cls_want()
        for _ in range(3):
            preds = rs.uniform(0, 1, 40).astype(np.float32)
            labels = rs.randint(0, 2, 40).astype(np.int64)
            got.update(torch.from_numpy(preds), torch.from_numpy(labels))
            want.update(preds, labels)
        assert abs(got.accumulate() - want.accumulate()) <= 1e-6
        assert got.name() == want.name()
        got.reset()
        assert got.accumulate() == 0.0
    two = np.stack([1 - preds, preds], 1)
    got, want = metric.Auc(), JaxAuc()
    got.update(torch.from_numpy(two), labels)
    want.update(two, labels)
    assert abs(got.accumulate() - want.accumulate()) <= 1e-6


# ----------------------------------------------------------- Model on Llama
class LossRec(hapi.Callback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


class JaxLossRec(JaxCallback):
    def __init__(self):
        super().__init__()
        self.losses = []

    def on_train_batch_end(self, step, logs=None):
        self.losses.append(float(logs["loss"]))


class Tokens(io.Dataset):
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i], self.rows[i]


class JaxTokens(jax_io.Dataset):
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i], self.rows[i]


@pytest.fixture(scope="module")
def llama_runs(tmp_path_factory):
    """Both packages' ``Model`` on llama_tiny from the same weights:
    evaluate and predict, then fit 2 epochs."""
    tmp = tmp_path_factory.mktemp("fit")
    rows = np.random.RandomState(0).randint(0, 512, (12, 32)).astype(
        np.int64)
    paddle.seed(0)
    cfg = jax_llama.llama_tiny()
    jnet = jax_llama.LlamaForCausalLM(cfg)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    jmodel = paddle.Model(jnet)
    jmodel.prepare(paddle.optimizer.AdamW(learning_rate=LR,
                                          parameters=jnet.parameters()),
                   jax_llama.LlamaPretrainingCriterion(cfg),
                   metrics=JaxAccuracy())
    net = load_jax_state(LlamaForCausalLM(llama_tiny(), device="cpu"), state)
    model = hapi.Model(net, device="cpu")
    model.prepare(AdamW(learning_rate=LR, parameters=net.parameters(),
                        device="cpu"),
                  LlamaPretrainingCriterion(llama_tiny()),
                  metrics=metric.Accuracy())
    out = {}
    for name, m, ds in (("jax", jmodel, JaxTokens(rows)),
                        ("port", model, Tokens(rows))):
        rec = JaxLossRec() if name == "jax" else LossRec()
        ev = m.evaluate(ds, batch_size=4, verbose=0)
        pred = m.predict(ds, batch_size=4, stack_outputs=True)
        m.fit(ds, batch_size=4, epochs=2, shuffle=True, verbose=0,
              sync_every=1, snapshot_dir=str(tmp / name), callbacks=[rec])
        out[name] = {"eval": ev, "pred": pred, "losses": rec.losses}
    return out


def test_fit_loss_stream_matches_jax(llama_runs):
    got, want = llama_runs["port"]["losses"], llama_runs["jax"]["losses"]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert got[-1] < got[0]


def test_evaluate_and_predict_match_jax(llama_runs):
    got, want = llama_runs["port"], llama_runs["jax"]
    assert sorted(got["eval"]) == sorted(want["eval"]) == ["acc", "loss"]
    for k in ("acc", "loss"):
        assert abs(got["eval"][k] - want["eval"][k]) <= 1e-5, k
    assert got["pred"][0].shape == want["pred"][0].shape == (12, 32, 512)
    np.testing.assert_allclose(got["pred"][0], want["pred"][0], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------- the classifier cases
def _classifier_data():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 4).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)
    return x, y


def _classifiers(jax_opt, port_opt, sizes=(4, 16, 2)):
    """The JAX MLP and the port's from its weights, each prepared with
    ``*_opt(parameters)``, cross entropy and ``Accuracy``."""
    paddle.seed(1)
    a, h, c = sizes
    jnet = jnn.Sequential(jnn.Linear(a, h), jnn.ReLU(), jnn.Linear(h, c))
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net = load_jax_state(nn.Sequential(nn.Linear(a, h, device="cpu"),
                                       nn.ReLU(),
                                       nn.Linear(h, c, device="cpu")), state)
    jmodel = paddle.Model(jnet)
    jmodel.prepare(jax_opt(jnet.parameters()), jnn.CrossEntropyLoss(),
                   JaxAccuracy())
    model = hapi.Model(net, device="cpu")
    model.prepare(port_opt(net.parameters()), nn.CrossEntropyLoss(),
                  metric.Accuracy())
    return jmodel, model


def test_classifier_fit_evaluate_predict_save_load_as_jax(tmp_path):
    x, y = _classifier_data()
    jmodel, model = _classifiers(
        lambda p: paddle.optimizer.Adam(learning_rate=0.05, parameters=p),
        lambda p: Adam(learning_rate=0.05, parameters=p, device="cpu"))
    jmodel.fit(jax_io.TensorDataset([x, y]), epochs=6, batch_size=16,
               shuffle=False, verbose=0)
    ds = io.TensorDataset([x, y])
    model.fit(ds, epochs=6, batch_size=16, shuffle=False, verbose=0)
    want = jmodel.evaluate(jax_io.TensorDataset([x, y]), batch_size=16,
                           verbose=0)
    logs = model.evaluate(ds, batch_size=16, verbose=0)
    assert logs["acc"] > 0.8 and logs["loss"] < 0.7
    for k in ("acc", "loss"):
        assert abs(logs[k] - want[k]) <= 1e-5, (k, logs, want)
    preds = model.predict(ds, batch_size=16, stack_outputs=True)
    assert preds[0].shape == (64, 2)
    path = str(tmp_path / "ckpt")
    model.save(path)
    assert os.path.exists(path + ".pdparams") and os.path.exists(
        path + ".pdopt")
    _, model2 = _classifiers(
        lambda p: paddle.optimizer.Adam(parameters=p),
        lambda p: Adam(parameters=p, device="cpu"))
    model2.load(path)
    assert model2.evaluate(ds, batch_size=16, verbose=0) == logs
    assert model.summary()["total_params"] == 4 * 16 + 16 + 16 * 2 + 2
    # save_sharded: the reference's names and [in, out] Linear layout
    report = model.save_sharded(str(tmp_path / "sharded"))
    assert report["n_tensors"] == 4
    pieces = load_sharded(str(tmp_path / "sharded"), device="cpu")
    jstate = jmodel.network.state_dict()
    assert sorted(pieces) == sorted(jstate)
    for name, t in model.network.state_dict().items():
        want = t.t() if name.endswith("weight") else t
        assert torch.equal(pieces[name], want), name
        assert tuple(pieces[name].shape) == tuple(jstate[name].shape)


def test_early_stopping_stops_both_after_the_same_epochs():
    rs = np.random.RandomState(0)
    x = rs.randn(32, 4).astype(np.float32)
    y = rs.randint(0, 2, (32,)).astype(np.int64)  # unlearnable noise
    jmodel, model = _classifiers(
        lambda p: paddle.optimizer.SGD(learning_rate=0.0, parameters=p),
        lambda p: SGD(learning_rate=0.0, parameters=p, device="cpu"),
        sizes=(4, 8, 2))
    runs = {}
    for name, m, ds, stop_cls, cb_cls in (
            ("jax", jmodel, jax_io.TensorDataset([x, y]), JaxEarlyStopping,
             JaxCallback),
            ("port", model, io.TensorDataset([x, y]), hapi.EarlyStopping,
             hapi.Callback)):
        epochs = []

        class Epochs(cb_cls):
            def on_epoch_end(self, epoch, logs=None):
                epochs.append(epoch)

        m.fit(ds, eval_data=ds, epochs=10, batch_size=16, verbose=0,
              callbacks=[stop_cls(monitor="loss", patience=1, verbose=0),
                         Epochs()])
        runs[name] = (m.stop_training, epochs)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0] and len(runs["port"][1]) < 10


def test_model_checkpoint_and_lr_scheduler_callbacks_as_jax(tmp_path):
    x, y = _classifier_data()
    jsched = paddle.optimizer.lr.StepDecay(0.1, step_size=3, gamma=0.5)
    sched = StepDecay(0.1, step_size=3, gamma=0.5)
    jmodel, model = _classifiers(
        lambda p: paddle.optimizer.SGD(learning_rate=jsched, parameters=p),
        lambda p: SGD(learning_rate=sched, parameters=p, device="cpu"))
    jmodel.fit(jax_io.TensorDataset([x, y]), epochs=2, batch_size=16,
               shuffle=False, verbose=0, save_dir=str(tmp_path / "jax"))
    model.fit(io.TensorDataset([x, y]), epochs=2, batch_size=16,
              shuffle=False, verbose=0, save_dir=str(tmp_path / "port"))
    # the default LRScheduler callback stepped both schedules once a batch
    assert model._optimizer.get_lr() == jmodel._optimizer.get_lr() == 0.025
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax"))
    assert names == ["0.pdopt", "0.pdparams", "1.pdopt", "1.pdparams",
                     "final.pdopt", "final.pdparams"]


# ------------------------------------------------------------ the plumbing
def test_metric_buffer_reads_exact_floats_at_one_sync_a_boundary():
    vals = [torch.tensor(v, dtype=torch.float32)
            for v in (1 / 3, 2 / 7, 0.1, 5.5)]
    buf = hapi.MetricBuffer(sync_every=2)
    assert [buf.should_sync(s) for s in range(4)] == [True, False, True,
                                                      False]
    before = pipeline_stats.summary()["host_syncs"]
    for v in vals[:3]:
        buf.append("loss", v)
    assert buf.last_float("loss") is None and buf.latest("loss") is vals[2]
    assert buf.materialize() == {"loss": float(vals[2])}
    buf.append("loss", vals[3])
    report = buf.flush()
    assert pipeline_stats.summary()["host_syncs"] == before + 2
    assert report["loss"]["values"] == [float(v) for v in vals]
    assert report["loss"]["mean"] == float(np.mean([float(v) for v in vals]))
    assert hapi.to_float(torch.tensor([2.5])) == 2.5


def test_train_batch_sync_and_the_cuda_default():
    _, model = _classifiers(
        lambda p: paddle.optimizer.SGD(parameters=p),
        lambda p: SGD(learning_rate=0.1, parameters=p, device="cpu"))
    x, y = _classifier_data()
    got = model.train_batch([torch.from_numpy(x[:8])],
                            [torch.from_numpy(y[:8])])
    assert isinstance(got[0], float)
    got = model.train_batch([x[:8]], [y[:8]], sync=False)
    assert isinstance(got[0], torch.Tensor) and got[0].dim() == 0
    if torch.cuda.is_available():
        return  # the default resolves on a card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hapi.Model(torch.nn.Linear(2, 2))


def test_summary_and_flops_count_as_jax():
    jnet = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    net = nn.Sequential(nn.Linear(4, 8, device="cpu"), nn.ReLU(),
                        nn.Linear(8, 2, device="cpu"))
    assert hapi.summary(net, (2, 4)) == paddle.summary(jnet, (2, 4))
    net[0].weight.requires_grad_(False)
    jnet[0].weight.stop_gradient = True
    assert hapi.summary(net, (2, 4)) == paddle.summary(jnet, (2, 4))
    conv = nn.Sequential(nn.Conv2D(3, 8, 3, padding=1, device="cpu"),
                         nn.ReLU(), nn.MaxPool2D(2), nn.Flatten(),
                         nn.Linear(8 * 16 * 16, 10, device="cpu"))
    jconv = jnn.Sequential(jnn.Conv2D(3, 8, 3, padding=1), jnn.ReLU(),
                           jnn.MaxPool2D(2), jnn.Flatten(),
                           jnn.Linear(8 * 16 * 16, 10))
    want = paddle.flops(jconv, [1, 3, 32, 32])
    assert hapi.flops(conv, [1, 3, 32, 32]) == want
    assert want == (32 * 32 * 8 * 3 * 9 + 32 * 32 * 8 + 32 * 32 * 8
                    + 16 * 16 * 8 * 4 + 10 * 8 * 16 * 16 + 10)
