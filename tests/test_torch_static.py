"""The port's static-graph Program/Executor (``paddle_tpu_torch/static``)
on the CPU: copies of ``tests/test_static_program.py``'s twelve tests with
the import renamed, then the port against the JAX package on one tiny
Llama recorded in static mode in both."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.core import hooks
from paddle_tpu_torch.static import program as prog_mod


@pytest.fixture(autouse=True)
def _static_mode(monkeypatch):
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("cpu")
    paddle.enable_static()
    # fresh default programs per test
    prog_mod._default_main = prog_mod.Program()
    prog_mod._default_startup = prog_mod.Program()
    hooks.static_capture = prog_mod._default_main
    yield
    paddle.disable_static()


def test_canonical_static_flow():
    x = paddle.static.data(name="x", shape=[None, 8], dtype="float32")
    hidden = paddle.static.nn.fc(x, size=4)
    loss = paddle.mean(hidden)

    main = paddle.static.default_main_program()
    assert len(main.ops) >= 3  # matmul, add, mean
    assert "x" in main.feeds

    exe = paddle.static.Executor(paddle.CPUPlace())
    exe.run(paddle.static.default_startup_program())
    rs = np.random.RandomState(0)
    feed_x = rs.randn(16, 8).astype(np.float32)
    out, hid = exe.run(main, feed={"x": feed_x}, fetch_list=[loss, hidden])
    assert hid.shape == (16, 4)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, hid.mean(), rtol=3e-5)

    # feed shape differs from the declared placeholder (None batch)
    out32, _ = exe.run(main, feed={"x": rs.randn(32, 8).astype(np.float32)},
                       fetch_list=[loss, hidden])
    assert np.isfinite(out32).all()


def test_executor_reflects_parameter_updates():
    """Parameters replay by reference: mutating the weight between runs
    changes the result (the reference's scope semantics)."""
    x = paddle.static.data(name="x", shape=[4, 4], dtype="float32")
    y = paddle.static.nn.fc(x, size=2)
    main = paddle.static.default_main_program()
    exe = paddle.static.Executor()
    feed = {"x": np.ones((4, 4), np.float32)}
    (a,) = exe.run(main, feed=feed, fetch_list=[y])
    # the weight: a by-reference constant of the matmul node
    w = next(t for t in main.constants().values()
             if tuple(t.shape) == (4, 2))
    w.set_value(np.zeros((4, 2), np.float32))
    (b,) = exe.run(main, feed=feed, fetch_list=[y])
    assert np.abs(a).max() >= 0  # first run produced something
    np.testing.assert_allclose(b, np.zeros_like(b), atol=1e-6)


def test_program_guard_routes_recording():
    from paddle_tpu_torch.static import Program, program_guard

    main, startup = Program(), Program()
    with program_guard(main, startup):
        x = paddle.static.data(name="inp", shape=[2, 3], dtype="float32")
        out = paddle.tanh(x)
    assert "inp" in main.feeds and len(main.ops) >= 1
    exe = paddle.static.Executor()
    (o,) = exe.run(main, feed={"inp": np.zeros((2, 3), np.float32)},
                   fetch_list=[out])
    np.testing.assert_allclose(o, np.zeros((2, 3)), atol=1e-6)


def test_save_load_inference_model(tmp_path):
    x = paddle.static.data(name="x", shape=[None, 6], dtype="float32")
    out = paddle.static.nn.fc(x, size=3, activation="tanh")
    main = paddle.static.default_main_program()
    exe = paddle.static.Executor()
    rs = np.random.RandomState(1)
    feed_x = rs.randn(5, 6).astype(np.float32)
    (want,) = exe.run(main, feed={"x": feed_x}, fetch_list=[out])

    prefix = str(tmp_path / "infer")
    paddle.static.save_inference_model(prefix, [x], [out], exe, program=main)
    prog, feed_names, _ = paddle.static.load_inference_model(prefix, exe)
    assert feed_names == ["x"]
    (got,) = exe.run(prog, feed={"x": feed_x})
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_eager_mode_unaffected():
    paddle.disable_static()
    t = paddle.to_tensor(np.ones((2, 2), np.float32))
    out = paddle.tanh(t)
    from paddle_tpu_torch.static import default_main_program

    n_ops = len(default_main_program().ops)
    _ = paddle.tanh(t)
    assert len(default_main_program().ops) == n_ops  # nothing recorded
    assert np.isfinite(out.numpy()).all()


# ---- static control flow (reference static/nn/control_flow.py:943 cond,
# :1126 while_loop, :1372 case, :1436 switch_case) ---------------------------

def test_static_while_loop_data_dependent():
    """A data-dependent loop records as ONE while_loop node, and its trip
    count follows the FEED value."""
    x = paddle.static.data(name="x", shape=[1], dtype="float32")
    i = paddle.static.data(name="i", shape=[1], dtype="float32")

    out_i, out_x = paddle.static.nn.while_loop(
        cond=lambda i, x: paddle.sum(i) < 5.0,
        body=lambda i, x: [i + 1.0, x * 2.0],
        loop_vars=[i, x])

    main = paddle.static.default_main_program()
    assert "while_loop" in main.op_types()
    exe = paddle.static.Executor()
    # i starts at 0: 5 iterations, x doubles 5 times
    got_i, got_x = exe.run(main, feed={"x": np.ones(1, np.float32),
                                       "i": np.zeros(1, np.float32)},
                           fetch_list=[out_i, out_x])
    assert got_i[0] == 5.0 and got_x[0] == 32.0
    # i starts at 3: 2 iterations — same program, different feed
    got_i, got_x = exe.run(main, feed={"x": np.ones(1, np.float32),
                                       "i": np.full(1, 3.0, np.float32)},
                           fetch_list=[out_i, out_x])
    assert got_i[0] == 5.0 and got_x[0] == 4.0


def test_static_while_loop_clone_for_test():
    """clone(for_test=True) keeps the recorded loop replayable."""
    x = paddle.static.data(name="x", shape=[1], dtype="float32")
    (out,) = paddle.static.nn.while_loop(
        cond=lambda x: paddle.sum(x) < 10.0,
        body=lambda x: [x + 3.0],
        loop_vars=[x])
    test_prog = paddle.static.default_main_program().clone(for_test=True)
    exe = paddle.static.Executor()
    (got,) = exe.run(test_prog, feed={"x": np.zeros(1, np.float32)},
                     fetch_list=[out])
    assert got[0] == 12.0


def test_static_cond_and_case():
    x = paddle.static.data(name="x", shape=[1], dtype="float32")
    pred = paddle.sum(x) > 0.0
    out = paddle.static.nn.cond(pred,
                                lambda: paddle.sum(x) * 2.0,
                                lambda: paddle.sum(x) - 1.0)
    exe = paddle.static.Executor()
    main = paddle.static.default_main_program()
    (got,) = exe.run(main, feed={"x": np.full(1, 3.0, np.float32)},
                     fetch_list=[out])
    assert got == 6.0
    (got,) = exe.run(main, feed={"x": np.full(1, -3.0, np.float32)},
                     fetch_list=[out])
    assert got == -4.0


def test_static_case_chain():
    x = paddle.static.data(name="x", shape=[1], dtype="float32")
    s = paddle.sum(x)
    out = paddle.static.nn.case(
        [(s < 0.0, lambda: s * 0.0),
         (s < 10.0, lambda: s + 100.0)],
        default=lambda: s - 100.0)
    exe = paddle.static.Executor()
    main = paddle.static.default_main_program()
    for feed, want in ((-5.0, 0.0), (5.0, 105.0), (50.0, -50.0)):
        (got,) = exe.run(main, feed={"x": np.full(1, feed, np.float32)},
                         fetch_list=[out])
        assert got == want, (feed, got, want)


def test_static_switch_case():
    idx = paddle.static.data(name="idx", shape=[1], dtype="int32")
    x = paddle.static.data(name="x", shape=[1], dtype="float32")
    s = paddle.sum(x)
    out = paddle.static.nn.switch_case(
        paddle.sum(idx), {1: lambda: s + 1.0, 3: lambda: s + 3.0},
        default=lambda: s)
    exe = paddle.static.Executor()
    main = paddle.static.default_main_program()
    for i, want in ((1, 3.0), (3, 5.0), (7, 2.0)):
        (got,) = exe.run(main,
                         feed={"idx": np.full(1, i, np.int32),
                               "x": np.full(1, 2.0, np.float32)},
                         fetch_list=[out])
        assert got == want, (i, got, want)


def test_static_dygraph_control_flow_fallback():
    """Outside static mode the constructs run plain python control flow."""
    paddle.disable_static()
    try:
        i = paddle.to_tensor(np.zeros(1, np.float32))
        x = paddle.to_tensor(np.ones(1, np.float32))
        i2, x2 = paddle.static.nn.while_loop(
            lambda i, x: paddle.sum(i) < 3.0,
            lambda i, x: [i + 1.0, x * 2.0], [i, x])
        assert float(x2.numpy()[0]) == 8.0
        got = paddle.static.nn.cond(
            paddle.sum(x2) > 0, lambda: 1, lambda: 2)
        assert got == 1
    finally:
        paddle.enable_static()


def test_static_nn_new_builders():
    """The widened static.nn builder set records and replays."""
    img = paddle.static.data(name="img", shape=[2, 4, 8, 8], dtype="float32")
    h = paddle.static.nn.conv2d_transpose(img, num_filters=3, filter_size=3)
    h = paddle.static.nn.group_norm(h, groups=3)
    h = paddle.static.nn.prelu(h, mode="channel")
    h = paddle.static.nn.instance_norm(h)
    out = paddle.mean(h)
    vol = paddle.static.data(name="vol", shape=[1, 2, 4, 4, 4],
                             dtype="float32")
    v = paddle.static.nn.conv3d(vol, num_filters=2, filter_size=3, padding=1)
    vout = paddle.mean(v)
    seq = paddle.static.data(name="seq", shape=[2, 6], dtype="float32")
    ln = paddle.static.nn.layer_norm(seq)
    lout = paddle.mean(ln)

    exe = paddle.static.Executor()
    rs = np.random.RandomState(0)
    o1, o2, o3 = exe.run(
        paddle.static.default_main_program(),
        feed={"img": rs.randn(2, 4, 8, 8).astype(np.float32),
              "vol": rs.randn(1, 2, 4, 4, 4).astype(np.float32),
              "seq": rs.randn(2, 6).astype(np.float32)},
        fetch_list=[out, vout, lout])
    for o in (o1, o2, o3):
        assert np.isfinite(o).all()


def test_static_conv2d_transpose_output_size_only():
    img = paddle.static.data(name="im2", shape=[1, 2, 8, 8], dtype="float32")
    out = paddle.static.nn.conv2d_transpose(img, num_filters=3,
                                            output_size=[10, 10])
    exe = paddle.static.Executor()
    (got,) = exe.run(paddle.static.default_main_program(),
                     feed={"im2": np.zeros((1, 2, 8, 8), np.float32)},
                     fetch_list=[out])
    assert got.shape == (1, 3, 10, 10)


def test_static_while_loop_with_nan_check_enabled():
    """FLAGS_check_nan_inf must not break recording."""
    from paddle_tpu_torch.base import flags

    flags.enable_check_nan_inf()
    try:
        x = paddle.static.data(name="xn", shape=[1], dtype="float32")
        (out,) = paddle.static.nn.while_loop(
            lambda x: paddle.sum(x) < 4.0, lambda x: [x + 1.0], [x])
        exe = paddle.static.Executor()
        (got,) = exe.run(paddle.static.default_main_program(),
                         feed={"xn": np.zeros(1, np.float32)},
                         fetch_list=[out])
        assert got[0] == 4.0
    finally:
        flags.disable_check_nan_inf()


# ---- the port against the JAX package ---------------------------------------

def _jax_llama_runs(feeds):
    """The JAX tiny Llama on its own CPU route: its eager logits on each
    feed and on the zero placeholder, the logits its static Executor gives
    on each feed, and its weights."""
    import paddle_tpu as jp
    from paddle_tpu.models import llama as jax_llama

    jp.seed(0)
    ref = jax_llama.LlamaForCausalLM(jax_llama.llama_tiny())
    ref.eval()
    state = {k: np.array(v.numpy(), copy=True)
             for k, v in ref.state_dict().items()}
    eager = [np.asarray(ref(jp.to_tensor(ids)).numpy())
             for ids in feeds + [np.zeros_like(feeds[0])]]
    main = jp.static.Program()
    with jp.static.program_guard(main):
        x = jp.static.data("ids", list(feeds[0].shape), "int64")
        logits = ref(x)
    exe = jp.static.Executor()
    static = [exe.run(main, feed={"ids": ids}, fetch_list=[logits])[0]
              for ids in feeds]
    return eager, static, state


def test_tiny_llama_static_program_matches_jax():
    """llama_tiny (2 layers, hidden 64, 4 heads over 2 KV heads) recorded in
    static mode in both packages, the JAX weights carried across. The
    port's Executor gives the JAX model's logits on two feeds within 1e-5,
    and the second feed's logits are not the first's. The JAX package's
    own static program replays its placeholder's ids instead (its
    ``F.embedding`` closes over the ids, so the recorded node does not read
    the feed), which this test pins so that the divergence stays known."""
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM, llama_tiny,
                                               load_jax_state)

    rs = np.random.RandomState(3)
    feeds = [rs.randint(1, 512, (2, 16)).astype(np.int64) for _ in range(2)]
    want, jax_static, state = _jax_llama_runs(feeds)
    model = LlamaForCausalLM(llama_tiny(), device="cpu")
    load_jax_state(model, state).eval()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("ids", [2, 16], "int64")
        logits = model(x)
    names = main.op_types()
    assert names.count("paddle_tpu_torch::flash_attention_fwd") == 2
    assert names.count("paddle_tpu_torch::rms_norm_fwd") == 5
    exe = paddle.static.Executor()
    got = [exe.run(main, feed={"ids": ids}, fetch_list=[logits])[0]
           for ids in feeds]
    for g, w in zip(got, want):
        assert g.shape == (2, 16, 512)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    assert np.abs(got[0] - got[1]).max() > 1e-3
    with torch.no_grad():
        eager = model(torch.from_numpy(feeds[1])).numpy()
    np.testing.assert_array_equal(got[1], eager)
    assert exe.replay_counts() == {"graph": 0, "eager": 2}
    # the JAX static program: the placeholder's (all-zero) ids' logits
    for js in jax_static:
        np.testing.assert_allclose(js, want[2], rtol=1e-5, atol=1e-5)


def test_fc_static_program_matches_jax_executor():
    """Two fc layers (tanh between) recorded in both packages with the same
    weights: the two Executors agree within 1e-5 on a [None, 8] feed fed 16
    rows, then 32."""
    import paddle_tpu as jp

    progs, outs = [], []
    for pkg in (jp, paddle):
        main = pkg.static.Program()
        with pkg.static.program_guard(main):
            x = pkg.static.data("x", [None, 8], "float32")
            h = pkg.static.nn.fc(x, size=6, activation="tanh")
            y = pkg.static.nn.fc(h, size=3)
        progs.append(main)
        outs.append(y)
    jconsts = [t for n in progs[0].ops for s in n.arg_specs
               if s[0] == "v" and s[1] not in {i for m in progs[0].ops
                                                for i in m.out_ids}
               and s[1] not in progs[0].feeds.values() for t in [s[2]]]
    pconsts = list(progs[1].constants().values())
    assert [tuple(t.shape) for t in jconsts] == \
        [tuple(t.shape) for t in pconsts]
    rs = np.random.RandomState(5)
    for jt, pt in zip(jconsts, pconsts):
        value = rs.randn(*pt.shape).astype(np.float32)
        jt.set_value(value)
        pt.set_value(value)
    for rows in (16, 32):
        feed = {"x": rs.randn(rows, 8).astype(np.float32)}
        (want,) = jp.static.Executor().run(progs[0], feed=feed,
                                           fetch_list=[outs[0]])
        (got,) = paddle.static.Executor().run(progs[1], feed=feed,
                                              fetch_list=[outs[1]])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_folded_constant_written_by_a_recorded_op_starts_fresh():
    """A buffer made at build time and written in place by a recorded op
    starts from its build-time value at every run: replays do not
    compound."""
    x = paddle.static.data(name="x", shape=[3], dtype="float32")
    buf = paddle.zeros([3])  # a paddle.Tensor: an alias of the op's output
    buf.add_(x)
    out = buf * 2.0
    exe = paddle.static.Executor()
    main = paddle.static.default_main_program()
    for _ in range(3):
        (got,) = exe.run(main, feed={"x": np.arange(3, dtype=np.float32)},
                         fetch_list=[out])
        np.testing.assert_array_equal(got, [0.0, 2.0, 4.0])


def test_rebound_parameter_view_raises():
    """A constant that is a view of a parameter later rebound to new
    storage (``p.data = ...``) raises instead of replaying stale values."""
    x = paddle.static.data(name="x", shape=[2, 3], dtype="float32")
    lin = paddle.nn.Linear(3, 2)
    y = lin(x)
    exe = paddle.static.Executor()
    main = paddle.static.default_main_program()
    exe.run(main, feed={"x": np.ones((2, 3), np.float32)}, fetch_list=[y])
    lin.weight.data = torch.zeros_like(lin.weight)
    with pytest.raises(RuntimeError, match="rebound"):
        exe.run(main, feed={"x": np.ones((2, 3), np.float32)},
                fetch_list=[y])


def test_verify_and_append_backward_raise():
    x = paddle.static.data(name="x", shape=[2], dtype="float32")
    y = paddle.tanh(x)
    main = paddle.static.default_main_program()
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        main.verify()
    with pytest.raises(NotImplementedError, match="TrainStep"):
        paddle.static.append_backward(y)
    from paddle_tpu_torch.base.flags import set_flags

    set_flags({"static_verify_program": True})
    try:
        with pytest.raises(NotImplementedError, match="queue 1 item 9"):
            paddle.static.Executor().run(
                main, feed={"x": np.ones(2, np.float32)}, fetch_list=[y])
    finally:
        set_flags({"static_verify_program": False})


def test_input_spec_helpers_match_jax():
    import paddle_tpu as jp

    arr = np.zeros((3, 4), np.float32)
    for mod in (paddle.static, jp.static):
        spec = mod.InputSpec.from_numpy(arr, "a")
        assert spec.shape == [3, 4] and spec.name == "a"
        assert spec.batch(8).shape == [8, 3, 4]
        assert spec.unbatch().shape == [4]
    with pytest.raises(ValueError):
        paddle.static.InputSpec([], "float32").unbatch()
    with paddle.static.name_scope("block"):
        pass
