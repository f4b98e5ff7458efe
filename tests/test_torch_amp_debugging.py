"""The port's op-interception tier on the CPU: copies of
``tests/test_amp_debugging.py``'s five tests with the op names the port's
(schema names: ``aten::log``, ``aten::mm``), ``FLAGS_check_nan_inf``, the
operator stats of a tiny Llama step against its registered kernels, the
first NaN op of a step by position under the checker and under the flag,
and the pybind launch sites refusing to launch unseen."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.amp import debugging as dbg
from paddle_tpu_torch.base import flags
from paddle_tpu_torch.base.enforce import PreconditionNotMetError
from paddle_tpu_torch.core import hooks


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")
    yield
    dbg.disable_tensor_checker()
    if dbg._op_stats is not None:
        dbg.disable_operator_stats_collection()
    flags.disable_check_nan_inf()


def test_tensor_checker_aborts_on_nan():
    cfg = dbg.TensorCheckerConfig(enable=True)
    dbg.enable_tensor_checker(cfg)
    x = paddle.to_tensor(np.array([1.0, -1.0], np.float32))
    with pytest.raises(PreconditionNotMetError, match="log"):
        paddle.log(x)  # log(-1) = nan


def test_tensor_checker_warn_mode_records():
    cfg = dbg.TensorCheckerConfig(enable=True,
                                  debug_mode=dbg.DebugMode.CHECK_NAN_INF)
    dbg.enable_tensor_checker(cfg)
    x = paddle.to_tensor(np.array([0.0, 2.0], np.float32))
    out = paddle.log(x)  # log(0) = -inf: recorded, not raised
    assert not np.isfinite(out.numpy()).all()
    found = dbg.tensor_checker_results()
    assert found and found[0]["op"] == "aten::log" \
        and found[0]["num_inf"] == 1


def test_tensor_checker_op_lists_and_step_window():
    cfg = dbg.TensorCheckerConfig(enable=True, skipped_op_list=["aten::log"])
    dbg.enable_tensor_checker(cfg)
    x = paddle.to_tensor(np.array([-1.0], np.float32))
    paddle.log(x)  # skipped: no raise
    dbg.disable_tensor_checker()

    cfg = dbg.TensorCheckerConfig(enable=True, debug_step=(5, 9))
    dbg.enable_tensor_checker(cfg)
    paddle.log(x)  # step 0, outside window: no raise
    dbg.advance_step(7)
    with pytest.raises(PreconditionNotMetError):
        paddle.log(x)


def test_operator_stats_buckets_by_dtype():
    with dbg.collect_operator_stats():
        a32 = paddle.to_tensor(np.ones((4, 4), np.float32))
        paddle.matmul(a32, a32)
        with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
            paddle.matmul(a32, a32)
        stats = dbg.get_operator_stats()
    assert stats["aten::mm"]["fp32"] == 1
    assert stats["aten::mm"]["bf16"] == 1


def test_compare_accuracy_localizes_bf16_divergence(tmp_path):
    """The two-run compare pins an injected bf16-vs-fp32 divergence on the
    op that produced it."""

    def run(cast_dtype, out_dir):
        cfg = dbg.TensorCheckerConfig(
            enable=True, debug_mode=dbg.DebugMode.DUMP_ALL,
            output_dir=str(out_dir))
        dbg.enable_tensor_checker(cfg)
        try:
            paddle.seed(0)
            x = paddle.to_tensor(np.linspace(1, 2, 64, dtype=np.float32)
                                 .reshape(8, 8))
            w = paddle.to_tensor((np.eye(8) * 1e4).astype(np.float32))
            ref = paddle.to_tensor(
                np.linspace(1, 2, 64, dtype=np.float32).reshape(8, 8) * 1e4)
            if cast_dtype:
                x, w, ref = (t.astype(cast_dtype) for t in (x, w, ref))
            h = paddle.matmul(x, w)  # values ~1e4, small RELATIVE error
            # catastrophic cancellation: bf16 keeps 2-3 digits of 1e4·x
            d = h - ref
            paddle.tanh(d * 1e-2)
        finally:
            dbg.disable_tensor_checker()

    run(None, tmp_path / "fp32")
    run("bfloat16", tmp_path / "bf16")

    out = tmp_path / "cmp.csv"
    rows = dbg.compare_accuracy(str(tmp_path / "fp32"), str(tmp_path / "bf16"),
                                str(out))
    assert out.exists()
    by_op = {}
    for r in rows:
        if r["divergence"] != float("inf"):
            by_op.setdefault(r["op"], 0.0)
            by_op[r["op"]] = max(by_op[r["op"]], r["divergence"])
    sub_ops = [op for op in by_op if "sub" in op or "elementwise" in op]
    assert sub_ops, by_op
    worst = max(by_op.values())
    assert max(by_op[o] for o in sub_ops) == worst, by_op
    assert by_op.get("aten::mm", 0.0) < 0.1 * worst, by_op
    assert rows[0]["divergence"] >= worst


# ---- FLAGS_check_nan_inf and the mode ---------------------------------------

def test_check_nan_inf_flag_raises_and_logs_by_level():
    x = paddle.to_tensor(np.array([-1.0], np.float32))
    flags.enable_check_nan_inf()
    with pytest.raises(PreconditionNotMetError, match="aten::log"):
        paddle.log(x)
    flags.set_flags({"check_nan_inf_level": 1})
    try:
        paddle.log(x)  # logged, not raised
    finally:
        flags.set_flags({"check_nan_inf_level": 0})
    flags.disable_check_nan_inf()
    paddle.log(x)
    assert not hooks.active()


def test_slots_push_and_pop_the_mode():
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    assert not any(isinstance(m, hooks.InterceptionMode)
                   for m in _get_current_dispatch_mode_stack())
    seen = []
    hooks.op_observer = lambda name, outs: seen.append(name)
    try:
        torch.ones(2) + 1
    finally:
        hooks.op_observer = None
    assert seen == ["aten::ones", "aten::add"]
    assert not any(isinstance(m, hooks.InterceptionMode)
                   for m in _get_current_dispatch_mode_stack())


def _tiny_llama(dtype=torch.float32):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(), device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return model.to(dtype)


def _step(model, ids):
    from paddle_tpu_torch.models.llama import LlamaPretrainingCriterion

    loss = LlamaPretrainingCriterion(model.config)(model(ids), ids)
    loss.backward()
    return loss


def test_operator_stats_count_the_registered_kernels():
    """Over one bf16 tiny-Llama step, forward and backward, the stats count
    K1's and K4's forward and K2/K3's and K4's backward operators once a
    call, under their registered names."""
    model = _tiny_llama(torch.bfloat16)
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 512, (2, 16)))
    with dbg.collect_operator_stats():
        _step(model, ids)
        stats = dbg.get_operator_stats()
    layers = model.config.num_hidden_layers
    assert stats["paddle_tpu_torch::flash_attention_fwd"] == {"bf16": layers}
    assert stats["paddle_tpu_torch::rms_norm_fwd"] == {"bf16": 2 * layers + 1}
    assert stats["paddle_tpu_torch::flash_attention_bwd"] == {"bf16": layers}
    assert stats["paddle_tpu_torch::rms_norm_bwd"] == {"bf16": 2 * layers + 1}


def _first_nan_op(model, ids, arm):
    """The observed op names of one step up to the op whose output first
    holds a NaN, and the error raised there, under ``arm`` (the checker or
    the flag)."""
    names = []
    arm()
    inner = hooks.op_observer

    def observe(name, outs):
        names.append(name)
        if inner is not None:
            inner(name, outs)

    hooks.op_observer = observe
    try:
        with pytest.raises(PreconditionNotMetError) as err:
            _step(model, ids)
    finally:
        hooks.op_observer = None
    return names, str(err.value)


def test_first_nan_op_is_the_same_under_checker_and_flag():
    """A NaN written into one parameter: abort mode and FLAGS_check_nan_inf
    raise at the same op, the first whose output holds it (the transpose
    of layer 0's qkv weight, inside ``linear``), at the same position of
    the step's op sequence."""
    model = _tiny_llama()
    with torch.no_grad():
        model.llama.layers[0].self_attn.qkv_proj.weight[3, 5] = float("nan")
    ids = torch.from_numpy(np.random.RandomState(1).randint(0, 512, (2, 16)))

    def checker():
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))

    names_c, msg_c = _first_nan_op(model, ids, checker)
    dbg.disable_tensor_checker()
    names_f, msg_f = _first_nan_op(model, ids, flags.enable_check_nan_inf)
    flags.disable_check_nan_inf()
    assert names_c == ["aten::embedding", "paddle_tpu_torch::rms_norm_fwd",
                       "aten::t"]
    assert "'aten::t'" in msg_c and "'aten::t'" in msg_f
    # the flag's scan runs before the observer, which never sees its op
    assert names_f == names_c[:-1]


# ---- the pybind launch sites ------------------------------------------------

@torch.library.custom_op("paddle_tpu_torch_test::launch_probe",
                         mutates_args=())
def _launch_probe(x: torch.Tensor, site: str) -> torch.Tensor:
    """A registered operator whose kernel reaches a launch site's check,
    as the port's kernels' operators do."""
    hooks.check_launch(site)
    return x.clone()


@_launch_probe.register_fake
def _launch_probe_fake(x, site):
    return torch.empty_like(x)


def _sites():
    from paddle_tpu_torch.ops.cuda import (adamw, flash_attention, flashmask,
                                           momentum, rms_norm)

    x = torch.zeros(4, 64)
    return {
        "rms_norm_fwd": (rms_norm, "_library",
                         lambda: rms_norm._launch(x, x[0], 1e-6)),
        "rms_norm_bwd": (rms_norm, "_library",
                         lambda: rms_norm._launch_bwd(x, x[0], x, 1e-6)),
        "flash_attention_fwd": (
            flash_attention, "_kernel",
            lambda: flash_attention._launch_fwd(
                *[torch.zeros(1, 8, 1, 64)] * 3, True, 1.0, 0.0, None, 256,
                512)),
        "flash_attention bwd_dq": (
            flash_attention, "_kernel",
            lambda: flash_attention.run_bwd_pass("bwd_dq", {}, "cpu")),
        "flashmask_fwd": (
            flashmask, "_kernel",
            lambda: flashmask._run_fwd(*[torch.zeros(1, 8, 1, 64)] * 3, x,
                                       True, 1.0)),
        "flashmask bwd_dkv": (
            flashmask, "_kernel",
            lambda: flashmask.run_bwd_pass("bwd_dkv", {}, "cpu")),
        "adamw": (adamw, "_kernel",
                  lambda: adamw._launch(None, [], None, 0, 0, None)),
        "momentum": (momentum, "_kernel",
                     lambda: momentum._launch(None, [], None, 0, 0, None)),
    }


@pytest.mark.parametrize("site", sorted(_sites()))
def test_pybind_launch_site_raises_under_a_slot(site, monkeypatch):
    """Reached other than through a registered operator while a slot is
    set, each launch site raises naming ROADMAP.md before it loads or
    launches anything (the loader is mocked and must not be called)."""
    module, loader, call = _sites()[site]
    calls = []
    monkeypatch.setattr(module, loader, lambda *a: calls.append(a))
    hooks.op_observer = lambda name, outs: None
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
            call()
    finally:
        hooks.op_observer = None
    assert site in str(err.value) and not calls
    # inside a registered operator's kernel the same site passes the check:
    # the mode saw the operator, and torch stashed it while the kernel runs
    seen, x = [], torch.zeros(2)
    hooks.op_observer = lambda name, outs: seen.append(name)
    try:
        _launch_probe(x, site)
    finally:
        hooks.op_observer = None
    assert seen == ["paddle_tpu_torch_test::launch_probe"]
