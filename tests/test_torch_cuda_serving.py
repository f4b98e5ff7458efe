"""On-card tests of the decode engine's CUDA graphs (marker ``cuda``).

They need an NVIDIA GPU and ``nvcc`` (prefill runs the flash-attention
forward kernel), and skip on hosts without a GPU. This file imports no
JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_serving.py

On ``gpt_tiny`` (2 layers, hidden 64, 4 heads of 16, vocab 512), f32:

- ``warmup()`` captures one graph per rung of every family (prefill,
  decode, draft, verify) and runs each rung eagerly once, before; traffic
  (greedy and sampled, speculating) meets no new signature, every program
  call after warmup is a replay, and the flash-attention forward kernel
  counts 2 launches (one a layer) per prefill call through the replays;
- a replayed call of each family equals the same program run eagerly on
  the same inputs and pool state, bit for bit, tokens and pool;
- the families share one graph memory pool and one capture stream, and
  replays of other rungs in between leave a rung's result unchanged;
- a second engine warms (captures) after the first shut down and serves
  the same streams, and one warms while another serves (captures run in
  the thread-local mode, with Python's collector off);
- the card's threefry bits equal the CPU's, and a bf16 pool holds half
  the f32 pool's bytes with the same first tokens.
"""
import gc
import threading

import numpy as np
import pytest
import torch

from paddle_tpu_torch.jit import CompiledFunction
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.serving import DecodeEngine, sampling

pytestmark = pytest.mark.cuda

ENGINE = dict(max_slots=4, max_seq=128, seq_buckets=[32, 64, 128],
              prefill_max_batch=2, page_size=16)
SPEC = dict(speculate_k=2, spec_draft_layers=1, spec_min_accept=0.0)
SIZES = [20, 60, 100, 31, 7]
NEW_TOKENS = 10
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model(card):
    return GPTForCausalLM(gpt_tiny(),
                          generator=torch.Generator().manual_seed(0)).eval()


def _prompts(seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 512, size=n).astype(np.int32) for n in SIZES]


def _serve(eng, **kw):
    futs = [eng.submit("t", p, max_new_tokens=NEW_TOKENS, seed=i, **kw)
            for i, p in enumerate(_prompts())]
    return [f.result(300) for f in futs]


def _serve_alone(eng, **kw):
    """One request after another: every call's rung is fixed by its
    request alone, so two runs on one card are bitwise equal."""
    return [eng.submit("t", p, max_new_tokens=NEW_TOKENS, seed=i,
                       **kw).result(300)
            for i, p in enumerate(_prompts())]


def _calls(report):
    dec = report["decode"]
    return sum(dec.get(f"{kind}_steps", 0)
               for kind in ("prefill", "decode", "draft", "verify"))


def test_warmup_captures_every_rung_and_traffic_replays(model):
    eng = DecodeEngine(model, **ENGINE, **SPEC).warmup()
    try:
        progs = eng.programs
        warm = progs.graph_report()
        for family, row in warm.items():
            n = sum(1 for key in progs.rungs if key[0] == family)
            assert row["signatures"] == row["captures"] == row["eager"] == n
            assert row["replays"] == n  # the capture call's own replay
        fa.launches = 0
        eng.stats.reset()
        greedy = _serve(eng)
        sampled = _serve(eng, **SAMPLED)
        rep = eng.serving_report()
        after = progs.graph_report()
    finally:
        eng.shutdown(drain=True)
    assert rep["compiles_after_warmup"] == 0
    assert rep["compiled_rungs"] == len(progs.rungs)
    for family in warm:
        assert after[family]["captures"] == warm[family]["captures"]
        assert after[family]["eager"] == warm[family]["eager"]
    replays = sum(after[f]["replays"] - warm[f]["replays"] for f in warm)
    assert replays == _calls(rep) > 0
    assert rep["decode"]["spec_rounds"] > 0
    assert fa.launches == 2 * rep["decode"]["prefill_steps"]
    for out in greedy + sampled:
        assert out.shape == (NEW_TOKENS,) and 0 <= out.min() <= out.max() < 512


def _inputs(eng, family, b, width, rs):
    """Host arrays for one call of ``family`` at rung (b, width) naming
    distinct live pages, with mixed sampling arguments."""
    progs, pool = eng.programs, eng.kv_pool
    ps = pool.page_size
    if family == "prefill":
        t = progs.prefill_table_cols(width)
        tokens = rs.randint(0, 512, (b, width))
        lengths = rs.randint(1, width + 1, b)
    else:
        t = width
    tables = rs.permutation(np.arange(1, pool.num_pages + 1))[:b * t]
    tables = tables.reshape(b, t)
    sample = (np.array([0.0, 0.8] * b, np.float32)[:b],
              np.array([0, 50] * b, np.int64)[:b],
              np.array([1.0, 0.9] * b, np.float32)[:b],
              rs.randint(0, 2 ** 31, (b, 2)).astype(np.int64))
    if family == "prefill":
        return (tokens, lengths, tables, *sample)
    k = progs.speculate_k
    positions = rs.randint(0, t * ps - k - 1, b)
    width = (b, k + 1) if family == "verify" else b
    return (rs.randint(0, 512, width), tables, positions, *sample)


def _replay_vs_eager(eng, family, args):
    pool = eng.kv_pool
    k0, v0 = pool.k.clone(), pool.v.clone()
    got = getattr(eng.programs, family)(*args)
    k1, v1 = pool.k.clone(), pool.v.clone()
    pool.k.copy_(k0)
    pool.v.copy_(v0)
    want = eng.programs.run_eager(family, *args)
    return got, want, torch.equal(k1, pool.k) and torch.equal(v1, pool.v)


def test_graphed_calls_equal_eager_calls(model):
    eng = DecodeEngine(model, **ENGINE, **SPEC).warmup()
    try:
        _serve(eng)  # the pages hold real K/V
        rs = np.random.RandomState(0)
        before = eng.programs.graph_report()
        for family, b, width in (("prefill", 2, 64), ("decode", 4, 8),
                                 ("draft", 2, 4), ("verify", 4, 8)):
            got, want, pool_equal = _replay_vs_eager(
                eng, family, _inputs(eng, family, b, width, rs))
            np.testing.assert_array_equal(got, want)
            assert pool_equal, f"{family}: pool differs from the eager call"
        after = eng.programs.graph_report()
        assert all(after[f]["eager"] == before[f]["eager"] for f in after)
    finally:
        eng.shutdown(drain=True)


def test_shared_graph_pool(model):
    eng = DecodeEngine(model, **ENGINE, **SPEC).warmup()
    try:
        progs = eng.programs
        pools = {id(fn.pool) for fn in progs._compiled.values()}
        assert pools == {id(progs.graph_pool)}
        # one capture stream, so one cuBLAS workspace, for the engine
        assert len({fn._stream for fn in progs._compiled.values()}) == 1
        _serve(eng)
        rs = np.random.RandomState(1)
        args = _inputs(eng, "decode", 2, 4, rs)
        pool = eng.kv_pool
        k0, v0 = pool.k.clone(), pool.v.clone()
        first = progs.decode(*args)
        # other rungs replay in the same pool in between
        progs.prefill(*_inputs(eng, "prefill", 2, 128, rs))
        progs.verify(*_inputs(eng, "verify", 4, 8, rs))
        pool.k.copy_(k0)
        pool.v.copy_(v0)
        np.testing.assert_array_equal(progs.decode(*args), first)
    finally:
        eng.shutdown(drain=True)


def test_second_engine_warms_after_first_shut_down(model):
    first = DecodeEngine(model, **ENGINE).warmup()
    try:
        want = _serve_alone(first, **SAMPLED)
    finally:
        first.shutdown(drain=True)
    second = DecodeEngine(model, **ENGINE).warmup()
    try:
        got = _serve_alone(second, **SAMPLED)
        assert second.serving_report()["compiles_after_warmup"] == 0
    finally:
        second.shutdown(drain=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_engine_warms_while_another_serves(model):
    """Captures run in the thread-local mode: a second engine captures its
    rungs while the first one's scheduler thread replays graphs and copies
    tokens out, and both serve their streams."""
    serving = DecodeEngine(model, **ENGINE).warmup()
    prompt = _prompts()[1]
    want = serving.submit("w", prompt, NEW_TOKENS, seed=5,
                          **SAMPLED).result(300)
    stop = threading.Event()
    streams = []

    def pump():
        while not stop.is_set():
            streams.append(serving.submit("w", prompt, NEW_TOKENS, seed=5,
                                          **SAMPLED).result(300))

    worker = threading.Thread(target=pump)
    worker.start()
    try:
        warming = DecodeEngine(model, **ENGINE).warmup()
    finally:
        stop.set()
        worker.join(300)
        serving.shutdown(drain=True)
    try:
        got = warming.submit("w", prompt, NEW_TOKENS, seed=5,
                             **SAMPLED).result(300)
        assert warming.serving_report()["compiles_after_warmup"] == 0
    finally:
        warming.shutdown(drain=True)
    assert not worker.is_alive() and len(streams) > 0
    for out in streams + [got]:
        np.testing.assert_array_equal(out, want)


def test_capture_keeps_the_collector_off(card):
    """A collection during a capture could free a dropped engine's graphs
    (their pool's cudaFree invalidates the capture): the capture runs with
    the collector off and turns it back on."""
    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return x * 2

    step = CompiledFunction(fn, device=card)
    x = torch.ones(4, device=card)
    step(x)          # eager
    y = step(x)      # captured, replayed
    assert seen == [True, False] and gc.isenabled()
    assert torch.equal(y, x * 2)


def test_threefry_on_card_matches_cpu(card):
    keys = torch.from_numpy(np.random.RandomState(2).randint(
        0, 2 ** 32, (8, 2), dtype=np.uint64).astype(np.int64))
    want = sampling.random_bits(keys, 50304)
    got = sampling.random_bits(keys.to(card), 50304).cpu()
    assert torch.equal(got, want)


def test_bf16_pool_is_half_with_the_same_first_tokens(model):
    streams, pools = {}, {}
    for dtype in ("float32", "bfloat16"):
        eng = DecodeEngine(model, kv_dtype=dtype, **ENGINE).warmup()
        try:
            streams[dtype] = _serve_alone(eng)
            pools[dtype] = eng.kv_pool.device_bytes()
        finally:
            eng.shutdown(drain=True)
    assert 2 * pools["bfloat16"] == pools["float32"]
    # prefill reads no pool: the first tokens are the f32 engine's
    assert [s[0] for s in streams["bfloat16"]] == [
        s[0] for s in streams["float32"]]
