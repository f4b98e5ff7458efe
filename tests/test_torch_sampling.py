"""The port's sampled decoding against the JAX package's.

``paddle_tpu_torch.serving.sampling`` computes ``jax.random.categorical``
under a raw ``uint32[2]`` key in torch. Held here on the same numpy
inputs:

- the threefry bits equal ``jax.random.bits`` bit for bit, the uniform
  ``jax.random.uniform(minval=tiny)`` bit for bit, and the Gumbel noise
  within 2 f32 steps of ``max(1, |g|)`` (``log`` on the CPU is XLA's in
  JAX and SLEEF's in torch, which may round differently by a step);
- the draws equal ``jax.random.categorical``'s, and the port's
  ``_choose_tokens`` equals JAX's ``PagedDecodePrograms._choose_tokens``
  on 64 lanes of mixed temperature, top-k and top-p;
- the port's sampled streams equal the JAX paged engine's token for
  token (the two-layer tiny GPT and settings of ``tests/test_spec_decode.py``,
  weights carried across by ``load_jax_state``), are the same for a seed
  run twice, alone or in a batch, and differ between seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.profiler.pipeline import ServingStats as JaxServingStats
from paddle_tpu.serving.decode import PagedDecodePrograms as JaxPrograms
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         load_jax_state)
from paddle_tpu_torch.serving import DecodeEngine, PagedDecodePrograms
from paddle_tpu_torch.serving import sampling

TINY = dict(vocab_size=128, num_hidden_layers=2, hidden_size=8,
            num_attention_heads=1, max_position_embeddings=128)
ENGINE = dict(max_slots=2, max_seq=128, seq_buckets=[32, 128],
              prefill_max_batch=2, page_size=32)
SIZES = [20, 60, 120, 31]
NEW_TOKENS = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _keys(n, seed=0):
    rs = np.random.RandomState(seed)
    keys = rs.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[0] = (0, 0)
    keys[1] = (0xFFFFFFFF, 0xFFFFFFFF)
    keys[2] = (7, 0xFFFFFFFF)  # the counter word at its wrap
    return keys


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _prompts(sizes, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, size=int(n)).astype(np.int32) for n in sizes]


def test_threefry_bits_match_jax():
    keys = _keys(64)
    for n in (1, 128, 1000):
        want = np.stack([np.asarray(jax.random.bits(jnp.asarray(k), (n,),
                                                    jnp.uint32))
                         for k in keys])
        got = sampling.random_bits(_t(keys), n).numpy()
        assert got.min() >= 0 and got.max() < 2 ** 32
        np.testing.assert_array_equal(got.astype(np.uint32), want)


def test_uniform_exact_and_gumbel_within_two_steps():
    keys = _keys(32, seed=1)
    n = 4096
    tiny = np.finfo(np.float32).tiny
    bits = sampling.random_bits(_t(keys), n)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    got_u = torch.clamp_min(floats + tiny, tiny).numpy()
    want_u = np.stack([np.asarray(jax.random.uniform(
        jnp.asarray(k), (n,), jnp.float32, minval=tiny, maxval=1.0))
        for k in keys])
    np.testing.assert_array_equal(got_u, want_u)
    got_g = sampling.gumbel(_t(keys), n).numpy()
    want_g = np.stack([np.asarray(jax.random.gumbel(jnp.asarray(k), (n,),
                                                    jnp.float32))
                       for k in keys])
    # -log(-log(u)) cancels near u = 1/e, so the gate is in f32 steps of
    # max(1, |g|), the size of the inner log's rounding there
    scale = np.finfo(np.float32).eps * np.maximum(1.0, np.abs(want_g))
    assert float((np.abs(got_g - want_g) / scale).max()) <= 2.0


def test_categorical_matches_jax():
    keys = _keys(300, seed=2)
    logits = np.random.RandomState(2).randn(300, 128).astype(np.float32)
    logits[::7, 5:] = -np.inf  # filtered rows, as the programs pass them
    want = np.array([int(jax.random.categorical(jnp.asarray(k),
                                                jnp.asarray(lg)))
                     for k, lg in zip(keys, logits)])
    got = sampling.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)


def test_choose_tokens_matches_jax():
    """64 lanes: greedy (temperature 0), top-k alone, top-p alone, both,
    neither, k = 1, a top-p below the first probability; one key a
    lane. JAX's method reads no instance state, so it runs unbound."""
    rs = np.random.RandomState(4)
    B, V = 64, 128
    head = (rs.randn(B, V) * 3).astype(np.float32)
    temps = rs.choice([0.0, 0.5, 0.8, 1.0, 1.7], B).astype(np.float32)
    top_ks = rs.choice([0, 1, 5, 50, 128, 500], B).astype(np.int32)
    top_ps = rs.choice([1.0, 0.0, 0.3, 0.9, 0.95, 1e-4], B).astype(np.float32)
    keys = _keys(B, seed=5)
    want = np.asarray(JaxPrograms._choose_tokens(
        None, jnp.asarray(head), jnp.asarray(temps), jnp.asarray(top_ks),
        jnp.asarray(top_ps), jnp.asarray(keys)))
    got = PagedDecodePrograms._choose_tokens(
        torch.from_numpy(head), torch.from_numpy(temps), _t(top_ks),
        torch.from_numpy(top_ps), _t(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    greedy = temps == 0
    np.testing.assert_array_equal(got[greedy], head[greedy].argmax(-1))
    assert (got[~greedy] != head[~greedy].argmax(-1)).any()


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


def _submit_all(eng, seeds, **kw):
    futs = [eng.submit("t", p, max_new_tokens=NEW_TOKENS, seed=s, **kw)
            for p, s in zip(_prompts(SIZES), seeds)]
    return [f.result(120) for f in futs]


@pytest.fixture(scope="module")
def jax_sampled(models):
    eng = jax_serving.DecodeEngine(models[0], kv_mode="paged",
                                   stats=JaxServingStats(), **ENGINE).warmup()
    try:
        return _submit_all(eng, range(4), **SAMPLED)
    finally:
        eng.shutdown(drain=True)


@pytest.fixture(scope="module")
def engine(models):
    eng = DecodeEngine(models[1], device="cpu", **ENGINE).warmup()
    yield eng
    eng.shutdown(drain=True)


@pytest.fixture(scope="module")
def sampled(engine):
    return _submit_all(engine, range(4), **SAMPLED)


def test_sampled_streams_match_jax_engine(sampled, jax_sampled):
    for got, want in zip(sampled, jax_sampled):
        assert got.dtype == np.int32 and got.shape == (NEW_TOKENS,)
        np.testing.assert_array_equal(got, want)


def test_same_seed_same_stream_alone_and_batched(engine, sampled):
    for p, s, together in zip(_prompts(SIZES), range(4), sampled):
        alone = engine.submit("solo", p, max_new_tokens=NEW_TOKENS, seed=s,
                              **SAMPLED).result(120)
        np.testing.assert_array_equal(alone, together)
    np.testing.assert_array_equal(_submit_all(engine, range(4), **SAMPLED),
                                  sampled)


def test_seeds_decorrelate(engine, sampled):
    other = _submit_all(engine, range(10, 14), **SAMPLED)
    assert sum(not np.array_equal(a, b)
               for a, b in zip(other, sampled)) >= 3
    greedy = _submit_all(engine, range(4))
    assert any(not np.array_equal(a, b) for a, b in zip(greedy, sampled))
    # a kept set of one is the argmax whatever the seed
    top1 = _submit_all(engine, range(20, 24), temperature=0.8, top_k=1)
    np.testing.assert_array_equal(top1, greedy)
    assert engine.serving_report()["compiles_after_warmup"] == 0
