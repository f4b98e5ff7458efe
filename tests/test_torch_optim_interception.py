"""The optimizer kernels as registered operators (``paddle_tpu_torch::adamw``
and ``paddle_tpu_torch::momentum``), on the CPU: an AdamW step and a
Momentum step under the tensor checker (and its operator stats),
``FLAGS_check_nan_inf`` and a recording ``profiler.Profiler`` each run,
give the bits of the same step without interception, and show the
operator by name. The parent's CPU step ran as a chain of aten ops, which
the mode saw one by one; on the card its pybind launch raised under any
slot."""
import json
import logging

import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch import optimizer, profiler
from paddle_tpu_torch.amp import debugging as dbg
from paddle_tpu_torch.base import flags
from paddle_tpu_torch.core import hooks

SHAPES = [(8, 6), (6,), (3, 4, 5)]
OPS = {"AdamW": "paddle_tpu_torch::adamw",
       "Momentum": "paddle_tpu_torch::momentum"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")
    yield
    dbg.disable_tensor_checker()
    if dbg._op_stats is not None:
        dbg.disable_operator_stats_collection()
    flags.set_flags({"check_nan_inf_level": 0})
    flags.disable_check_nan_inf()
    assert not hooks.active()


def _step(kind, nan=False, steps=2):
    """Parameters after ``steps`` steps of ``kind`` from seeded values and
    gradients (a NaN in the first gradient with ``nan``)."""
    rs = np.random.RandomState(3)
    params = [torch.nn.Parameter(torch.from_numpy(
        rs.randn(*s).astype(np.float32))) for s in SHAPES]
    if kind == "AdamW":
        opt = optimizer.AdamW(1e-2, parameters=params, weight_decay=0.1,
                              device="cpu")
    else:
        opt = optimizer.Momentum(1e-2, momentum=0.9, parameters=params,
                                 use_nesterov=True, weight_decay=1e-3,
                                 device="cpu")
    for _ in range(steps):
        for p in params:
            p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        if nan:
            params[0].grad[0, 0] = float("nan")
        opt.step()
    return [p.detach().clone() for p in params]


def _same_bits(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


@pytest.mark.parametrize("kind", sorted(OPS))
def test_step_under_the_tensor_checker_and_stats(kind, tmp_path):
    plain = _step(kind)
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(
        enable=True, debug_mode=dbg.DebugMode.DUMP_ALL,
        output_dir=str(tmp_path)))
    with dbg.collect_operator_stats():
        got = _step(kind)
        stats = dbg.get_operator_stats()
    dbg.disable_tensor_checker()
    assert _same_bits(got, plain)
    assert stats[OPS[kind]] == {"fp32": 2}
    rows = [json.loads(line)
            for line in open(tmp_path / "tensor_stats.jsonl")]
    mine = [r for r in rows if r["op"] == OPS[kind]]
    # the written tensors, the parameters first: every one finite
    assert len(mine) >= 2 * len(SHAPES)
    assert [r["shape"] for r in mine[:len(SHAPES)]] == \
        [list(s) for s in SHAPES]
    assert not any(r["num_nan"] or r["num_inf"] for r in mine)


@pytest.mark.parametrize("kind", sorted(OPS))
def test_step_under_check_nan_inf(kind, caplog):
    plain = _step(kind)
    flags.enable_check_nan_inf()
    assert _same_bits(_step(kind), plain)
    flags.set_flags({"check_nan_inf_level": 1})
    with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
        _step(kind, nan=True, steps=1)
    assert f"op '{OPS[kind]}' produced NaN/Inf output" in caplog.text


@pytest.mark.parametrize("kind", sorted(OPS))
def test_step_under_a_recording_profiler(kind):
    plain = _step(kind)
    prof = profiler.Profiler(targets=[profiler.ProfilerTarget.CPU])
    with prof:
        assert hooks.op_profiler is profiler.RecordEvent
        got = _step(kind)
    assert _same_bits(got, plain)
    assert prof.summary()[OPS[kind]]["calls"] == 2
