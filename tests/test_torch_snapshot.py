"""The port's train-state snapshots (``reliability.TrainSnapshotter``) and
``Model.fit``'s preemption safety, the cases of
``tests/test_reliability.py:270-488`` run on the port, on the CPU.

- Snapshots roll (the newest ``keep`` survive); a torn write (an injected
  ``ckpt.write`` fault) leaves the previous snapshot the latest; a restore
  with nothing committed raises; a restore copies into the live
  parameters, optimizer cells and generators in place, bit for bit.
- ``fit`` over a tiny MLP from the JAX model's weights (Adam, mean squared
  error, f32): the uninterrupted loss stream agrees with JAX's within
  ``rtol=1e-5, atol=1e-6`` (f32 sums in another order); a crash mid-epoch
  and a SIGTERM each resume bit for bit the uninterrupted run, losses and
  parameters, the replay bounded by the snapshot cadence; so does a user
  layer with ``nn.Dropout(0.1)``, whose process-wide dropout generator
  the snapshot saves and the resume restores; the SIGTERM
  snapshot lands at the same step and cursor as JAX's; a shuffled
  ``Dataset`` resumes at the exact batch (the epoch pins the order); a
  resume into an empty directory starts fresh; ``resume=True`` without a
  directory raises; a relaunched worker (``PADDLE_RESTART_GEN > 0``)
  resumes by itself; a fault in the prefetch thread reaches ``fit``.
"""
import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.hapi import Callback as JaxCallback
from paddle_tpu.hapi import Model as JaxModel
from paddle_tpu.reliability.snapshot import TrainSnapshotter as JaxSnapshotter
from paddle_tpu_torch import hapi, io, nn
from paddle_tpu_torch import reliability as rel
from paddle_tpu_torch.models.gpt import load_jax_state
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.reliability import TrainSnapshotter


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


def _mse(out, y):
    return ((out - y) ** 2).mean()


def _jax_model(seed=7):
    paddle.seed(seed)
    net = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 1))
    m = JaxModel(net)
    m.prepare(optimizer=paddle.optimizer.Adam(
        learning_rate=0.01, parameters=net.parameters()),
        loss=jnn.MSELoss())
    return m


def _tiny_model(seed=7):
    """The port's twin of ``_jax_model(seed)``: the same weights."""
    jnet = _jax_model(seed).network
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    net = load_jax_state(nn.Sequential(nn.Linear(4, 8, device="cpu"),
                                       nn.ReLU(),
                                       nn.Linear(8, 1, device="cpu")), state)
    m = hapi.Model(net, device="cpu")
    m.prepare(optimizer=Adam(learning_rate=0.01, parameters=net.parameters(),
                             device="cpu"), loss=_mse)
    return m


def _tiny_data(n=10, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(4, 4).astype(np.float32),
             rs.randn(4, 1).astype(np.float32)) for _ in range(n)]


def _params(model):
    return [p.detach().clone() for p in model.network.parameters()]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted 2-epoch run in both packages."""
    data = _tiny_data(10)
    ref, jref = LossRec(), JaxLossRec()
    m = _tiny_model()
    m.fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
          callbacks=[ref])
    _jax_model().fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
                     callbacks=[jref])
    return {"losses": ref.losses, "params": _params(m),
            "jax_losses": jref.losses}


def test_uninterrupted_stream_matches_jax(reference):
    assert len(reference["losses"]) == 20
    np.testing.assert_allclose(reference["losses"], reference["jax_losses"],
                               rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ snapshotter
def test_rolling_prune_keeps_newest(tmp_path):
    snap = TrainSnapshotter(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        snap.save(step=step, epoch=0, next_batch=step)
    assert [s for s, _ in snap.snapshots()] == [3, 4]


def test_torn_write_leaves_previous_snapshot_intact(tmp_path):
    snap = TrainSnapshotter(str(tmp_path), keep=3)
    first = snap.save(step=1, epoch=0, next_batch=1)
    rel.arm(rel.FaultInjector(seed=0).plan("ckpt.write", rate=1.0,
                                           max_fires=1))
    try:
        second = snap.save(step=2, epoch=0, next_batch=2)
    finally:
        rel.disarm()
    assert snap.latest() == second  # the retry landed it
    rel.arm(rel.FaultInjector(seed=0).plan("ckpt.write", rate=1.0))
    try:
        with pytest.raises(rel.FaultInjection):
            snap.save(step=3, epoch=0, next_batch=3)
    finally:
        rel.disarm()
    assert snap.latest() == second  # the previous one stays committed
    assert first != second
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]


def test_restore_without_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TrainSnapshotter(str(tmp_path)).restore(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TrainSnapshotter(str(tmp_path)).restore()


def test_restore_copies_in_place_bit_for_bit(tmp_path):
    m = _tiny_model(seed=5)
    m.fit(_tiny_data(3), epochs=1, verbose=0, sync_every=1)
    gen = torch.Generator().manual_seed(3)
    torch.rand(5, generator=gen)  # advance the stream
    torch.rand(3)  # and torch's default one
    snap = TrainSnapshotter(str(tmp_path), keep=2)
    snap.save(m.network, m._optimizer, step=3, epoch=1, next_batch=2,
              generators=[gen])
    want_params = _params(m)
    want_opt = m._optimizer.state_dict()
    want_gen = torch.rand(4, generator=gen)
    want_default = torch.rand(4)

    twin = _tiny_model(seed=6)  # another init on purpose
    twin_gen = torch.Generator().manual_seed(9)
    ptrs = [p.data_ptr() for p in twin.network.parameters()]
    state = snap.restore(twin.network, twin._optimizer,
                         generators=[twin_gen], device="cpu")
    assert (state["step"], state["epoch"], state["next_batch"]) == (3, 1, 2)
    assert _same(_params(twin), want_params)
    assert [p.data_ptr() for p in twin.network.parameters()] == ptrs
    got_opt = twin._optimizer.state_dict()
    assert sorted(got_opt) == sorted(want_opt)
    for k, v in want_opt.items():
        assert (torch.equal(got_opt[k], v) if isinstance(v, torch.Tensor)
                else got_opt[k] == v), k
    assert torch.equal(torch.rand(4, generator=twin_gen), want_gen)
    assert torch.equal(torch.rand(4), want_default)
    with pytest.raises(ValueError, match="generator"):
        snap.restore(twin.network, generators=[], device="cpu")


def test_restore_sets_or_refuses_every_saved_default_state(tmp_path):
    """A snapshot holding more default generator states (CUDA ones) than
    the restoring host can set raises, where the states used to be dropped
    without a word when CUDA was not yet initialized."""
    from paddle_tpu_torch.framework.io import load as fw_load
    from paddle_tpu_torch.framework.io import save as fw_save

    snap = TrainSnapshotter(str(tmp_path))
    path = snap.save(step=1)
    rng_file = os.path.join(path, "rng.pdstate")
    rng = fw_load(rng_file)
    cpu_state = torch.default_generator.get_state()
    # one state more than the CPU generator and every CUDA device's
    rng["default"] = [cpu_state] * (2 + torch.cuda.device_count())
    fw_save(rng, rng_file)
    with pytest.raises(ValueError, match="default generator states"):
        snap.restore(generators=[], device="cpu")
    # the host's own count restores
    rng["default"] = [cpu_state]
    fw_save(rng, rng_file)
    if not torch.cuda.is_available():
        torch.rand(3)
        snap.restore(generators=[], device="cpu")
        assert torch.equal(torch.default_generator.get_state(), cpu_state)


# -------------------------------------------------------- preemption safety
def test_mid_epoch_crash_resume_bit_identical(tmp_path, reference):
    data = _tiny_data(10)
    first = LossRec()

    class Crash(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            if len(first.losses) == 7:
                raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError, match="simulated crash"):
        _tiny_model().fit(data, epochs=2, sync_every=1, verbose=0,
                          shuffle=False, callbacks=[first, Crash()],
                          snapshot_dir=str(tmp_path), snapshot_every=3)
    resumed = LossRec()
    m = _tiny_model()
    m.fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
          callbacks=[resumed], snapshot_dir=str(tmp_path), resume=True)
    cut = len(reference["losses"]) - len(resumed.losses)
    assert 0 < cut <= len(first.losses)
    assert first.losses[:cut] + resumed.losses == reference["losses"]
    # the replay distance is bounded by the snapshot cadence
    assert len(first.losses) - cut <= 3
    assert _same(_params(m), reference["params"])


class _DropNet(nn.Layer):
    """A user-written layer with ``nn.Dropout(0.1)`` and no generator of
    its own: it draws from the process-wide dropout generator."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(4, 16)
        self.drop = nn.Dropout(0.1)
        self.fc2 = nn.Linear(16, 1)

    def forward(self, x):
        return self.fc2(self.drop(nn.functional.relu(self.fc1(x))))


def _drop_model():
    import paddle_tpu_torch as T

    T.seed(11)  # the weights and the dropout generator's stream
    net = _DropNet()
    m = hapi.Model(net, device="cpu")
    m.prepare(optimizer=Adam(learning_rate=0.01, parameters=net.parameters(),
                             device="cpu"), loss=_mse)
    return m


def test_dropout_layer_resumes_bit_identical(tmp_path, monkeypatch):
    """The dropout generator a user layer draws from is saved by the
    snapshot and restored by the resume before the first step: the
    resumed run's masks, losses and parameters are the uninterrupted
    run's bit for bit."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch import device as device_mod
    from paddle_tpu_torch.jit.api import model_generators

    monkeypatch.setattr(device_mod, "_chosen", None)
    T.set_device("cpu")
    data = _tiny_data(10)
    ref = LossRec()
    m = _drop_model()
    assert model_generators(m.network) == [
        T.base.global_state.dropout_generator("cpu")]
    m.fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
          callbacks=[ref])
    want = _params(m)
    first = LossRec()

    class Crash(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            if len(first.losses) == 7:
                raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError, match="simulated crash"):
        _drop_model().fit(data, epochs=2, sync_every=1, verbose=0,
                          shuffle=False, callbacks=[first, Crash()],
                          snapshot_dir=str(tmp_path), snapshot_every=3)
    assert first.losses == ref.losses[:7]
    resumed = LossRec()
    m = _drop_model()  # its seed restarts the dropout stream
    m.fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
          callbacks=[resumed], snapshot_dir=str(tmp_path), resume=True)
    assert len(resumed.losses) == 14  # from the snapshot at step 6
    assert first.losses[:6] + resumed.losses == ref.losses
    assert _same(_params(m), want)


def test_sigterm_snapshots_at_the_boundary_as_jax(tmp_path, reference):
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal delivery needs the main thread")
    data = _tiny_data(10)
    states = {}
    for name, model, rec_cls, cb_cls, snap_cls in (
            ("port", _tiny_model(), LossRec, hapi.Callback,
             TrainSnapshotter),
            ("jax", _jax_model(), JaxLossRec, JaxCallback, JaxSnapshotter)):
        seen = rec_cls()

        class Preempt(cb_cls):
            def on_train_batch_end(self, step, logs=None):
                if len(seen.losses) == 14:
                    signal.raise_signal(signal.SIGTERM)

        prev = signal.getsignal(signal.SIGTERM)
        d = str(tmp_path / name)
        model.fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
                  callbacks=[seen, Preempt()], snapshot_dir=d)
        assert len(seen.losses) == 14  # stopped at the preempted boundary
        assert signal.getsignal(signal.SIGTERM) == prev  # handler restored
        with open(os.path.join(snap_cls(d).latest(), "state.json")) as f:
            state = json.load(f)
        states[name] = (state["step"], state["epoch"], state["next_batch"])
        if name == "port":
            resumed = LossRec()
            m = _tiny_model()
            m.fit(data, epochs=2, sync_every=1, verbose=0, shuffle=False,
                  callbacks=[resumed], snapshot_dir=d, resume=True)
            assert seen.losses + resumed.losses == reference["losses"]
            assert _same(_params(m), reference["params"])
    assert states["port"] == states["jax"] == (14, 1, 4)


def test_shuffled_dataset_resumes_at_the_exact_batch(tmp_path):
    rs = np.random.RandomState(3)
    ds = io.TensorDataset([rs.randn(24, 4).astype(np.float32),
                           rs.randn(24, 1).astype(np.float32)])
    ref = LossRec()
    _tiny_model().fit(ds, batch_size=4, epochs=2, verbose=0, sync_every=1,
                      snapshot_dir=str(tmp_path / "ref"), callbacks=[ref])
    first = LossRec()

    class Crash(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            if len(first.losses) == 9:
                raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError):
        _tiny_model().fit(ds, batch_size=4, epochs=2, verbose=0,
                          sync_every=1, snapshot_dir=str(tmp_path / "run"),
                          snapshot_every=2, callbacks=[first, Crash()])
    resumed = LossRec()
    _tiny_model().fit(ds, batch_size=4, epochs=2, verbose=0, sync_every=1,
                      snapshot_dir=str(tmp_path / "run"), resume=True,
                      callbacks=[resumed])
    cut = len(ref.losses) - len(resumed.losses)
    assert cut == 8  # the snapshot at step 8, epoch 1 batch 2
    assert first.losses[:cut] + resumed.losses == ref.losses


def test_resume_into_empty_dir_starts_fresh(tmp_path):
    rec = LossRec()
    _tiny_model().fit(_tiny_data(4), epochs=1, sync_every=1, verbose=0,
                      shuffle=False, callbacks=[rec],
                      snapshot_dir=str(tmp_path), resume=True)
    assert len(rec.losses) == 4


def test_a_relaunched_worker_resumes_by_itself(tmp_path, monkeypatch,
                                                reference):
    """``PADDLE_RESTART_GEN > 0`` (set by the launcher on a relaunch) with
    ``snapshot_dir`` and ``resume`` unset resumes; ``resume=False`` starts
    fresh."""
    data = _tiny_data(10)
    first = LossRec()

    class Crash(hapi.Callback):
        def on_train_batch_end(self, step, logs=None):
            if len(first.losses) == 12:
                raise RuntimeError("simulated crash")

    with pytest.raises(RuntimeError):
        _tiny_model().fit(data, epochs=2, sync_every=1, verbose=0,
                          shuffle=False, callbacks=[first, Crash()],
                          snapshot_dir=str(tmp_path), snapshot_every=4)
    monkeypatch.setenv("PADDLE_RESTART_GEN", "1")
    resumed = LossRec()
    _tiny_model().fit(data, epochs=2, sync_every=1, verbose=0,
                      shuffle=False, callbacks=[resumed],
                      snapshot_dir=str(tmp_path))
    cut = len(reference["losses"]) - len(resumed.losses)
    assert cut == 8  # the snapshot at step 8; the crash came before 12's
    assert first.losses[:cut] + resumed.losses == reference["losses"]
    fresh = LossRec()
    _tiny_model().fit(data, epochs=2, sync_every=1, verbose=0,
                      shuffle=False, callbacks=[fresh],
                      snapshot_dir=str(tmp_path / "fresh"), resume=False)
    assert fresh.losses == reference["losses"]


def test_resume_true_without_dir_raises():
    with pytest.raises(ValueError):
        _tiny_model().fit(_tiny_data(2), epochs=1, verbose=0, resume=True)


def test_prefetch_thread_fault_reaches_fit():
    m = _tiny_model()
    rel.arm(rel.FaultInjector(seed=0).plan("io.h2d", rate=1.0))
    t0 = time.perf_counter()
    try:
        with pytest.raises(rel.FaultInjection):
            m.fit(io.DeviceLoader(_tiny_data(6), depth=2, device="cpu"),
                  epochs=1, verbose=0, sync_every=1)
    finally:
        rel.disarm()
    assert time.perf_counter() - t0 < 30.0
