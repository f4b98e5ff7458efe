"""The port's paged decode serving against the JAX package's.

The port's ``DecodeEngine`` (on the CPU) emits the JAX paged engine's
greedy tokens on the mixed prompt sizes of
``tests/test_paged_decode.py`` with its ``_tiny_model`` settings (32-token
pages: the 32- and 63-token prompts cross a page boundary while
decoding), the same alone as batched, and frees every page at retire.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.profiler.pipeline import ServingStats as JaxServingStats
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         load_jax_state)
from paddle_tpu_torch.serving import (AdmissionError, DecodeEngine,
                                      DecodeRequest)

TINY = dict(vocab_size=128, num_hidden_layers=1, hidden_size=8,
            num_attention_heads=1, max_position_embeddings=512)
ENGINE = dict(max_slots=4, max_seq=512, seq_buckets=[64, 128, 256, 512],
              prefill_max_batch=2, page_size=32)
MATRIX = [50, 100, 240, 500, 32, 63, 200, 120]
NEW_TOKENS = 8


def _prompts(sizes, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, size=int(n)).astype(np.int32) for n in sizes]


@pytest.fixture(scope="module")
def models():
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

    paddle.seed(0)
    ref = JaxGPT(jax_gpt_tiny(**TINY))
    ref.eval()
    model = GPTForCausalLM(gpt_tiny(**TINY), device="cpu")
    load_jax_state(model, {k: np.asarray(v.numpy())
                           for k, v in ref.state_dict().items()}).eval()
    return ref, model


@pytest.fixture(scope="module")
def jax_streams(models):
    eng = jax_serving.DecodeEngine(models[0], kv_mode="paged",
                                   stats=JaxServingStats(), **ENGINE).warmup()
    try:
        futs = [eng.submit("a" if i % 2 else "b", p,
                           max_new_tokens=NEW_TOKENS)
                for i, p in enumerate(_prompts(MATRIX))]
        return [f.result(120) for f in futs]
    finally:
        eng.shutdown(drain=True)


@pytest.fixture(scope="module")
def engine(models):
    eng = DecodeEngine(models[1], device="cpu", **ENGINE).warmup()
    yield eng
    eng.shutdown(drain=True)


@pytest.fixture(scope="module")
def batched(engine):
    futs = [engine.submit("a" if i % 2 else "b", p,
                          max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(_prompts(MATRIX))]
    return [f.result(120) for f in futs]


def test_greedy_streams_match_jax_engine(batched, jax_streams):
    assert len(batched) == len(jax_streams) == len(MATRIX)
    for got, want in zip(batched, jax_streams):
        assert got.dtype == np.int32 and got.shape == (NEW_TOKENS,)
        np.testing.assert_array_equal(got, want)


def test_streams_same_alone_and_batched(engine, batched):
    for prompt, together in zip(_prompts(MATRIX), batched):
        alone = engine.generate("solo", prompt, NEW_TOKENS)
        np.testing.assert_array_equal(alone, together)


def test_pages_freed_after_retire(engine, batched):
    rep = engine.serving_report()
    assert engine.active_requests() == 0
    assert rep["kv_pages_in_use"] == 0
    assert engine.kv_pool.free_count() == engine.kv_pool.num_pages
    assert rep["kv_pool_bytes_constant"]
    assert rep["decode"]["prefill_steps"] > 0
    assert rep["decode"]["decode_steps"] > 0
    assert rep["requests"] >= len(MATRIX)


def test_full_queue_raises_admission_error(models):
    eng = DecodeEngine(models[1], device="cpu", max_queue=1, **ENGINE)
    first = eng.queue.submit(DecodeRequest("a", [1, 2, 3], 2))
    with pytest.raises(AdmissionError) as err:
        eng.queue.submit(DecodeRequest("a", [4, 5, 6], 2))
    assert err.value.reason == "queue"
    assert eng.stats.summary()["rejected"] == 1
    eng.warmup()  # the admitted request is served once the loop runs
    try:
        assert first.result(60).shape == (2,)
    finally:
        eng.shutdown(drain=True)


def test_unported_features_raise(models, engine):
    # the telemetry server is all the constructor still refuses; slots,
    # speculation, bf16 KV and sampling are held against JAX in
    # test_torch_serving_modes.py and test_torch_sampling.py
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        DecodeEngine(models[1], device="cpu", serve_telemetry_port=0)
    with pytest.raises(ValueError, match="seq bucket"):
        engine.submit("a", np.zeros(513, np.int32))
