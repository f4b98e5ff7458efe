"""On-card tests of the batch serving tier (marker ``cuda``): a
``jit.save`` export loaded on the card, ``inference.Predictor``'s batch
program with one CUDA graph a (batch, seq) rung, and
``serving.ServingEngine``.

They need an NVIDIA GPU and ``nvcc`` (the program launches the
flash-attention forward kernel through ``paddle_tpu_torch::
flash_attention_fwd``), and skip on hosts without a GPU. This file imports
no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_batch_serving.py

On ``gpt_tiny`` (2 layers, hidden 64, 4 heads of 16, vocab 512), f32:

- the loaded program holds one K1 node a layer and no parameter on the
  CPU; warmup captures every rung of the [1, 2, 4] x [16, 32, 64] grid,
  traffic adds no rung, capture or eager call, and K1 counts 2 launches a
  call through the replays;
- a request's rows equal its batch replayed again at the same rung bit
  for bit, and the program run alone within 1e-4 (argmax equal);
- a swap copies into the captured parameters (their addresses kept):
  replays equal the program run eagerly on the new weights bit for bit,
  and a swap back restores the first outputs bit for bit;
- a call replayed on the same inputs (what a retry does) gives the same
  bits, also read from another stream than the replay's; the CPU load of
  the same files agrees within 1e-4.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.profiler.pipeline import ServingStats
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.static import InputSpec

pytestmark = pytest.mark.cuda

BATCHES, SEQS = [1, 2, 4], [16, 32, 64]
TOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def saved(card, tmp_path_factory):
    model = GPTForCausalLM(gpt_tiny(), generator=torch.Generator()
                           .manual_seed(0)).eval()
    prefix = str(tmp_path_factory.mktemp("batch") / "gpt")
    jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
    return prefix, model


@pytest.fixture()
def pred(saved):
    p = Predictor(Config(saved[0]))
    p.set_batch_ladder(BATCHES)
    p.set_seq_ladder(SEQS)
    p.warmup_ladder()
    return p


def _ids(rs, n, s):
    return rs.randint(0, 512, (n, s)).astype(np.int64)


def test_loaded_program_runs_k1_and_lives_on_the_card(saved):
    layer = jit.load(saved[0])
    ops = [str(n.target) for n in layer._exported.graph.nodes
           if n.op == "call_function"]
    assert sum("paddle_tpu_torch.flash_attention_fwd" in t
               for t in ops) == 2
    assert all(t.device.type == "cuda" for t in layer._params.values())
    for n in layer._exported.graph.nodes:
        dev = n.kwargs.get("device") if n.op == "call_function" else None
        assert dev is None or torch.device(dev).type == "cuda", n
    fa.launches = 0
    out = layer(_ids(np.random.RandomState(0), 2, 20))
    assert out.shape == (2, 20, 512) and fa.launches == 2


def test_every_call_after_warmup_is_a_replay(pred):
    prog = pred._ensure_batch_program()
    warm = prog.graph_report()
    rungs = len(BATCHES) * len(SEQS)
    assert warm == {"signatures": rungs, "captures": rungs,
                    "replays": rungs, "eager": rungs}
    rs = np.random.RandomState(1)
    fa.launches = 0
    shapes = [(1, 5), (3, 40), (4, 64), (2, 17), (1, 33)]
    for n, s in shapes:
        out, = pred.run_many([_ids(rs, n, s)])
        assert out.shape == (n, s, 512)
    now = prog.graph_report()
    assert now["captures"] == rungs and now["eager"] == rungs
    assert now["replays"] - rungs == len(shapes)
    assert fa.launches == 2 * len(shapes)
    assert pred.compile_count == rungs


def test_rows_equal_their_batch_replayed_and_the_program_alone(pred, saved):
    eng = ServingEngine(pred, stats=ServingStats()).warmup()
    rs = np.random.RandomState(2)
    xs = [_ids(rs, n, s) for n, s in ((1, 9), (2, 30), (1, 64), (3, 12))]
    try:
        # one request a batch, so each batch is the request padded alone
        outs = [eng.run("t", x, timeout=60)[0] for x in xs]
    finally:
        eng.shutdown(drain=True)
    prog = pred._ensure_batch_program()
    for x, out in zip(xs, outs):
        n, s = x.shape
        rung = (min(b for b in BATCHES if b >= n),
                min(q for q in SEQS if q >= s))
        padded = np.zeros(rung, np.int64)
        padded[:n, :s] = x
        again = prog([padded], rung)[0][:n, :s].cpu().numpy()
        assert np.array_equal(out, again)
        alone = pred.run([x])[0]
        np.testing.assert_allclose(out, alone, rtol=TOL, atol=TOL)
        assert np.array_equal(out.argmax(-1), alone.argmax(-1))
    assert eng.compiles_after_warmup == 0


def test_swap_copies_into_the_captured_parameters(pred):
    prog = pred._ensure_batch_program()
    live = pred._layer._params
    addresses = {k: t.data_ptr() for k, t in live.items()}
    x = _ids(np.random.RandomState(3), 2, 30)
    padded = np.zeros((2, 32), np.int64)
    padded[:, :30] = x
    first = prog([padded], (2, 32))[0].cpu()
    other = GPTForCausalLM(gpt_tiny(), generator=torch.Generator()
                           .manual_seed(1)).eval()
    old = {k: t.detach().clone() for k, t in live.items()}
    captures = prog.graph_report()["captures"]
    pred.swap_weights(dict(other.state_dict()))
    assert {k: t.data_ptr() for k, t in live.items()} == addresses
    replayed = prog([padded], (2, 32))[0].cpu()
    eager = prog.run_eager([padded])[0].cpu()
    assert torch.equal(replayed, eager) and not torch.equal(replayed, first)
    pred.swap_weights(old)
    assert torch.equal(prog([padded], (2, 32))[0].cpu(), first)
    assert prog.graph_report()["captures"] == captures


def test_outputs_are_ready_on_the_callers_stream(pred):
    prog = pred._ensure_batch_program()
    x = _ids(np.random.RandomState(5), 4, 64)
    want = prog([x], (4, 64))[0].cpu()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        for _ in range(3):
            got = prog([x], (4, 64))[0].cpu()
            assert torch.equal(got, want)


def test_cpu_load_of_the_same_files_agrees(pred, saved):
    cpu = Predictor(Config(saved[0], device="cpu"))
    x = _ids(np.random.RandomState(4), 2, 25)
    np.testing.assert_allclose(pred.run([x])[0], cpu.run([x])[0],
                               rtol=TOL, atol=TOL)
