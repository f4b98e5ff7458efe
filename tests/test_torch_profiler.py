"""``profiler.Profiler`` of the port (``profiler/profiler.py``): the
scheduler's states against the JAX package's, per-op host events through
the interception mode over a tiny Llama step (K1's and K4's registered
operators counted once a call), ``RecordEvent``, the chrome export and the
``torch.profiler`` device timeline."""
import json

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import profiler
from paddle_tpu_torch.core import hooks


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")


@pytest.mark.parametrize("kw", [
    dict(closed=1, ready=1, record=2), dict(closed=0, ready=0, record=3,
                                            repeat=2, skip_first=2),
    dict(closed=2, ready=1, record=1, repeat=1)])
def test_scheduler_matches_jax(kw):
    from paddle_tpu import profiler as jax_profiler

    ours, theirs = profiler.make_scheduler(**kw), \
        jax_profiler.make_scheduler(**kw)
    assert [ours(s).name for s in range(14)] == \
        [theirs(s).name for s in range(14)]


def test_op_events_over_a_llama_step(tmp_path):
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               LlamaPretrainingCriterion,
                                               llama_tiny)

    model = LlamaForCausalLM(llama_tiny(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 16)))
    crit = LlamaPretrainingCriterion(model.config)
    prof = profiler.Profiler(
        targets=[profiler.ProfilerTarget.CPU, profiler.ProfilerTarget.GPU],
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path)))
    with prof:
        assert hooks.op_profiler is profiler.RecordEvent
        with profiler.RecordEvent("step"):
            crit(model(ids), ids).backward()
    assert hooks.op_profiler is None and not hooks.active()
    agg = prof.summary()
    layers = model.config.num_hidden_layers
    assert agg["paddle_tpu_torch::flash_attention_fwd"]["calls"] == layers
    assert agg["paddle_tpu_torch::rms_norm_fwd"]["calls"] == 2 * layers + 1
    assert agg["paddle_tpu_torch::flash_attention_bwd"]["calls"] == layers
    assert agg["step"]["calls"] == 1
    host = json.load(open(prof._last_export))["traceEvents"]
    assert len(host) == sum(st["calls"] for st in agg.values())
    assert prof.device_profile is not None
    assert any(e.key == "aten::mm"
               for e in prof.device_profile.key_averages())
    assert len(list(tmp_path.iterdir())) == 2


def test_scheduled_steps_and_timer_only():
    prof = profiler.Profiler(scheduler=(1, 3))
    prof.start()
    states = [prof.current_state]
    for _ in range(4):
        torch.ones(1) + 1
        prof.step()
        states.append(prof.current_state)
    prof.stop()
    assert [s.name for s in states] == ["READY", "RECORD", "RECORD_AND_RETURN",
                                        "CLOSED", "CLOSED"]
    assert prof.benchmark()["steps"] == 4
    with profiler.Profiler(timer_only=True):
        assert hooks.op_profiler is None


def test_device_trace_warms_up_in_the_ready_step():
    """With a ``READY`` step before the record window, the device trace is
    prepared there and records only the window's ops."""
    x = torch.ones(8, 8)
    with profiler.Profiler(targets=[profiler.ProfilerTarget.GPU],
                           scheduler=(1, 2)) as prof:
        torch.sin(x)  # READY: traced, not kept
        prof.step()
        assert prof._device is not None and prof._device_recording
        torch.cos(x)
        prof.step()
        assert prof._device is None
    keys = {e.key for e in prof.device_profile.key_averages()}
    assert "aten::cos" in keys and "aten::sin" not in keys
