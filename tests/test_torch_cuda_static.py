"""On-card tests of the op-interception tier (marker ``cuda``): static
programs replayed as CUDA graphs, K4's and K5's registered forwards, the
pybind launch sites under a slot. They skip on hosts without a GPU; this
file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_static.py

- A recorded program holding K4 (``paddle_tpu_torch::rms_norm_fwd``)
  replays each new feed's values, not the placeholder's: the first run is
  eager, the second captures, the third replays, each bit for bit the
  eager K4 call on that feed, with one K4 launch a run by the counter.
- K4's and K5's registered operators give the bits the pybind launch
  gives on the same inputs.
- A tiny Llama program saved with ``save_inference_model`` and loaded on
  the card launches K1 and K4 (as registered operators) and gives the
  Executor's bits.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch.core import hooks
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flashmask as fm
from paddle_tpu_torch.ops.cuda import rms_norm as rms

pytestmark = pytest.mark.cuda


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    paddle.disable_static()


def test_recorded_k4_replays_the_new_feed(card):
    w = torch.randn(768, device=card)
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [64, 768], "float32")
        y = rms.rms_norm_fwd(x, w, 1e-6)
    assert main.op_types() == ["paddle_tpu_torch::rms_norm_fwd"]
    exe = paddle.static.Executor()
    rs = np.random.RandomState(0)
    for i in range(3):
        feed = rs.randn(64, 768).astype(np.float32)
        before = rms.launches
        (got,) = exe.run(main, feed={"x": feed}, fetch_list=[y],
                         return_numpy=False)
        assert rms.launches - before == 1
        want = rms.rms_norm_fwd(torch.from_numpy(feed).to(card), w, 1e-6)
        assert torch.equal(got, want), i
        assert got.abs().max() > 0  # not the zero placeholder's output
    assert exe.replay_counts() == {"graph": 2, "eager": 1}


def test_registered_forwards_give_the_pybind_bits(card):
    x = torch.randn(4, 2048, 768, device=card, dtype=torch.bfloat16)
    w = torch.randn(768, device=card, dtype=torch.bfloat16)
    assert torch.equal(rms.rms_norm_fwd_op(x, w, 1e-5),
                       rms._launch(x, w, 1e-5))
    q, k, v = (torch.randn(1, 1024, 8, 64, device=card,
                           dtype=torch.bfloat16) for _ in range(3))
    idx = fm.prepare_indices(
        torch.full((1, 1, 1024, 1), 1024, dtype=torch.int32, device=card),
        q, k, True)
    o1, lse1 = fm.flashmask_fwd_op(q, k, v, idx, True, 0.125)
    o2, lse2 = fm._launch_fwd(q, k, v, idx, True, 0.125)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_pybind_site_raises_under_a_slot_on_the_card(card):
    x = torch.randn(8, 768, device=card)
    w = torch.ones(768, device=card)
    hooks.op_observer = lambda name, outs: None
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            rms._launch(x, w, 1e-6)
        got = rms.rms_norm_fwd(x, w, 1e-6)  # the registered operator
    finally:
        hooks.op_observer = None
    want = rms.rms_norm_reference(x, w, 1e-6)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_loaded_inference_program_launches_k1_and_k4(card, tmp_path):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM, llama_tiny

    model = LlamaForCausalLM(llama_tiny(), device=card,
                             generator=torch.Generator().manual_seed(0))
    model.eval()
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        ids = paddle.static.data("ids", [2, 32], "int64")
        logits = model(ids)
    exe = paddle.static.Executor()
    feed = {"ids": np.random.RandomState(1).randint(1, 512, (2, 32))}
    for _ in range(3):
        (want,) = exe.run(main, feed=feed, fetch_list=[logits])
    prefix = str(tmp_path / "llama")
    paddle.static.save_inference_model(prefix, [ids], [logits], exe,
                                       program=main)
    prog, names, _ = paddle.static.load_inference_model(prefix, exe)
    assert names == ["ids"]
    counts = (fa.launches, rms.launches)
    (got,) = exe.run(prog, feed=feed)
    layers = model.config.num_hidden_layers
    assert (fa.launches - counts[0], rms.launches - counts[1]) == \
        (layers, 2 * layers + 1)
    np.testing.assert_array_equal(got, want)


def test_observers_read_nothing_under_capture(card):
    """Under CUDA-graph capture neither an observer nor the NaN scan reads
    a value: the captured K4 call is not observed (the generator-state
    fills ``torch.cuda.graph`` runs before the capture begins may be), and
    the graph replays."""
    from paddle_tpu_torch.base import flags

    x = torch.randn(64, 768, device=card)
    w = torch.ones(768, device=card)
    want = rms.rms_norm_fwd(x, w, 1e-6)
    graph, seen = torch.cuda.CUDAGraph(), []
    hooks.op_observer = lambda name, outs: seen.append(name)
    flags.enable_check_nan_inf()
    try:
        with torch.cuda.graph(graph):
            y = rms.rms_norm_fwd(x, w, 1e-6)
    finally:
        hooks.op_observer = None
        flags.disable_check_nan_inf()
    assert "paddle_tpu_torch::rms_norm_fwd" not in seen, seen
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_a_rebound_parameter_raises_instead_of_a_stale_replay(card):
    main = paddle.static.Program()
    with paddle.static.program_guard(main):
        x = paddle.static.data("x", [8, 16], "float32")
        y = paddle.static.nn.fc(x, size=4)
    exe = paddle.static.Executor()
    feed = {"x": np.ones((8, 16), np.float32)}
    for _ in range(3):  # eager, capture, replay
        exe.run(main, feed=feed, fetch_list=[y])
    w = next(t for t in main.constants().values()
             if tuple(t.shape) == (16, 4))
    w.set_value(np.zeros((16, 4), np.float32))  # in place: seen
    (got,) = exe.run(main, feed=feed, fetch_list=[y])
    assert np.abs(got).max() == 0.0
    w.data = torch.ones_like(w)  # rebound: the graph would miss it
    with pytest.raises(RuntimeError, match="rebound"):
        exe.run(main, feed=feed, fetch_list=[y])
    exe.close()
    (got,) = exe.run(main, feed=feed, fetch_list=[y])
    assert np.allclose(got, 16.0)
