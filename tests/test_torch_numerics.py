"""The port's numerics witness, anomaly flight recorder and memory sampler
against the JAX package's, on the CPU.

- ``observability.numerics.watch``: the same arrays (healthy, a range
  collapse, NaN, Inf, a fresh name) give the same verdicts and the same
  per-name state in both packages; dark, a watch records nothing.
- The ``numerics.nonfinite_grad`` fault (a ``corrupt`` plan) makes both
  packages' ``GradScaler`` skip the step: ``found_inf`` set, the parameter
  unchanged, the scale halved by ``update``; a clean step moves the
  parameter alike in both (exactly: 1 − 0.1·0.5 rounds the same in f32).
- The lit witness sees ``GradScaler.unscale_``'s gradients and a CPU
  ``TrainStep``'s loss; the lit monitor sees the step's wall.
- The flight recorder's recipe (``.claude/skills/verify/SKILL.md``): 30
  baseline walls then one 10x outlier give exactly one bundle, in both
  packages; a lock-order inversion reaches the recorder.
- The memory sampler reads nothing from the card on a CPU-only run and
  samples every N-th boundary.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import reliability as jax_rel
from paddle_tpu.observability import numerics as jax_num
from paddle_tpu.observability.anomaly import AnomalyMonitor as JaxMonitor
from paddle_tpu_torch import reliability as rel
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.base.flags import set_flags
from paddle_tpu_torch.observability import locks, numerics
from paddle_tpu_torch.observability.anomaly import AnomalyMonitor, monitor
from paddle_tpu_torch.observability.memory import DeviceMemorySampler
from paddle_tpu_torch.observability.metrics import registry
from paddle_tpu_torch.optimizer import SGD


def _arrays():
    """(name, array): a healthy range, then a collapse below 1e-4 of the
    watermark, NaN, Inf, and a name whose first sample is tiny."""
    seq = [("t.grad", np.full(8, 3.0, np.float32)) for _ in range(4)]
    seq += [("t.grad", np.full(8, 1e-9, np.float32)),
            ("t.loss", np.ones(4, np.float32)),
            ("t.loss", np.asarray([1.0, np.nan, 2.0], np.float32)),
            ("t.loss", np.asarray([np.inf, 1.0], np.float32)),
            ("t.fresh", np.full(8, 1e-9, np.float32)),
            ("t.fresh", np.full(8, 3.0, np.float32))]
    return seq


def _run_witness(mod, as_input):
    mod.witness_reset()
    notify = mod._notify
    mod._notify = lambda verdict: None  # verdicts only, no bundle
    mod.set_witness(True)
    try:
        for name, arr in _arrays():
            mod.watch(name, as_input(arr))
    finally:
        mod.set_witness(False)
        mod._notify = notify
    report = mod.witness_report()
    mod.witness_reset()
    for v in report["violations"]:
        v.pop("thread")
    return report


def test_watch_verdicts_match_jax():
    got = _run_witness(numerics, torch.from_numpy)
    want = _run_witness(jax_num, np.asarray)
    assert [v["code"] for v in got["violations"]] == [
        "NM1105", "NM1104", "NM1104"]
    assert got["violations"] == want["violations"]
    assert got["tensors"] == want["tensors"]


def test_dark_witness_records_nothing():
    numerics.witness_reset()
    assert not numerics.witness_enabled()
    numerics.watch("t.dark", torch.tensor([float("nan")]))
    assert numerics.witness_report()["tensors"] == {}
    # the flag mirrors into the witness
    set_flags({"numerics_witness": True})
    try:
        assert numerics.witness_enabled()
    finally:
        set_flags({"numerics_witness": False})
    assert not numerics.witness_enabled()


def _jax_scaler_step(poison):
    p = paddle.Parameter(np.ones(4, np.float32))
    o = paddle.optimizer.SGD(0.1, parameters=[p])
    scaler = paddle.amp.GradScaler(init_loss_scaling=128.0,
                                   decr_every_n_nan_or_inf=1)
    p._grad = paddle.to_tensor(np.full(4, 0.5 * 128.0, np.float32))
    if poison:
        jax_rel.arm(jax_rel.FaultInjector(seed=0).plan(
            "numerics.nonfinite_grad", kind="corrupt"))
    try:
        scaler.step(o)
    finally:
        jax_rel.disarm()
    scaler.update()
    return (bool(scaler._found_inf.numpy()), np.asarray(p.numpy()),
            float(scaler._scale.numpy()))


def _port_scaler_step(poison):
    p = torch.nn.Parameter(torch.ones(4))
    o = SGD(0.1, parameters=[p], device="cpu")
    scaler = GradScaler(init_loss_scaling=128.0, decr_every_n_nan_or_inf=1,
                        device="cpu")
    p.grad = torch.full((4,), 0.5 * 128.0)
    if poison:
        rel.arm(rel.FaultInjector(seed=0).plan("numerics.nonfinite_grad",
                                               kind="corrupt"))
    try:
        scaler.step(o)
    finally:
        rel.disarm()
    scaler.update()
    return (bool(scaler._found_inf), p.detach().numpy(),
            float(scaler._scale))


@pytest.mark.parametrize("poison", [True, False])
def test_nonfinite_grad_fault_skips_both_scalers(poison):
    found, param, scale = _port_scaler_step(poison)
    want_found, want_param, want_scale = _jax_scaler_step(poison)
    assert (found, scale) == (want_found, want_scale)
    np.testing.assert_array_equal(param, want_param)
    if poison:
        assert found and scale == 64.0
        np.testing.assert_array_equal(param, np.ones(4, np.float32))
    else:
        assert not found and scale == 128.0
        assert not np.array_equal(param, np.ones(4, np.float32))


def test_lit_witness_sees_unscaled_grads_and_the_train_step_loss():
    from paddle_tpu_torch.jit import TrainStep

    numerics.witness_reset()
    p = torch.nn.Parameter(torch.ones(4))
    o = SGD(0.1, parameters=[p], device="cpu")
    scaler = GradScaler(init_loss_scaling=128.0, device="cpu")
    p.grad = torch.full((4,), 128.0)
    net = torch.nn.Linear(4, 1)
    step = TrainStep(model=net, optimizer=SGD(
        0.1, parameters=net.parameters(), device="cpu"),
        loss_fn=lambda x: net(x).pow(2).mean(), device="cpu")
    det = monitor.detectors["step_time"]
    observed = det.observed
    numerics.set_witness(True)
    monitor.enable()
    try:
        scaler.unscale_(o)
        step(torch.ones(2, 4))
    finally:
        numerics.set_witness(False)
        monitor.disable()
    tensors = numerics.witness_report()["tensors"]
    numerics.witness_reset()
    assert tensors["amp.unscaled_grad"]["checks"] == 1
    assert tensors["train.loss"]["checks"] == 1
    assert det.observed == observed + 1


def _bundles(mon_cls, tmp_path):
    mon = mon_cls(enabled=True, dump_dir=str(tmp_path), cooldown_s=60.0)
    walls = [0.010 + 0.0001 * (i % 5) for i in range(30)]
    out = [mon.on_step(w) for w in walls]
    out.append(mon.on_step(0.1))  # 10x the baseline
    out.append(mon.on_step(0.1))  # the cooldown absorbs a repeat
    return [p for p in out if p], sorted(tmp_path.glob("anomaly_*.json"))


def test_ten_x_outlier_gives_one_bundle_in_both(tmp_path):
    got, files = _bundles(AnomalyMonitor, tmp_path / "port")
    want, want_files = _bundles(JaxMonitor, tmp_path / "jax")
    assert len(got) == len(want) == 1
    assert len(files) == len(want_files) == 1
    bundle = json.loads(files[0].read_text())
    want_bundle = json.loads(want_files[0].read_text())
    assert bundle["kind"] == want_bundle["kind"] == "step_time"
    # the window holds the outlier that tripped it
    assert bundle["step_window_s"] == want_bundle["step_window_s"]
    assert len(bundle["step_window_s"]) == 31
    assert bundle["verdict"] == want_bundle["verdict"]


def test_lock_inversion_reaches_the_recorder():
    counter = registry.counter("anomaly.triggered")
    before = counter.value(kind="lock_inversion")
    a, b = locks.named_lock("test.numerics.a"), locks.named_lock(
        "test.numerics.b")
    locks.set_witness(True)
    try:
        with a, b:
            pass
        with b, a:
            pass
    finally:
        locks.set_witness(False)
        locks.witness_reset()
    assert counter.value(kind="lock_inversion") == before + 1


def test_memory_sampler_is_sync_free_and_throttled():
    if torch.cuda.is_initialized():
        pytest.skip("the CPU-only reading needs CUDA uninitialized")
    s = DeviceMemorySampler(sample_every=3)
    got = [s.maybe_sample() for _ in range(7)]
    assert [g is not None for g in got] == [False, False, True, False,
                                             False, True, False]
    assert s.samples == 2
    assert s.last == {"live_bytes": 0, "live_arrays": 0, "devices": {}}
    assert registry.gauge("memory.live_bytes").value() == 0
    assert not torch.cuda.is_initialized()
