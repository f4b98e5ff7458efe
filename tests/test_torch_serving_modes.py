"""The port's decode engine modes against the JAX package's: the slot-pool
oracle, self-speculative decoding and a bf16 KV pool.

Same numpy-seeded two-layer tiny GPT and settings as
``tests/test_spec_decode.py`` (``max_slots=2``, ``max_seq=128``,
``seq_buckets=[32, 128]``, 32-token pages; the 120-token prompt decodes
into the ``max_seq`` boundary), weights carried across by
``load_jax_state``, on the CPU. Held token for token:

- the slot engine's greedy streams against JAX's slot engine, and the
  port's paged engine against its slot engine;
- ``speculate_k`` 1 and 4 (one draft layer), greedy and sampled, against
  JAX's speculating engines and the port's plain engine; rounds replace
  plain steps, the acceptance floor turns a lane's speculation off, and
  the refusals are JAX's;
- bf16-KV streams against JAX's ``kv_dtype="bfloat16"`` engine;
- ``rungs`` against the JAX lists, and no signature is met after warmup.

The slot pool's writes equal JAX's ``write_prompt``,
``write_prompt_batch`` and ``append_token``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.profiler.pipeline import ServingStats as JaxServingStats
from paddle_tpu.serving import kv_cache as jax_kvc
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         load_jax_state)
from paddle_tpu_torch.serving import DecodeEngine, KVSlotPool
from paddle_tpu_torch.serving import kv_cache as kvc

TINY = dict(vocab_size=128, num_hidden_layers=2, hidden_size=8,
            num_attention_heads=1, max_position_embeddings=128)
COMMON = dict(max_slots=2, max_seq=128, seq_buckets=[32, 128],
              prefill_max_batch=2)
PAGED = dict(COMMON, page_size=32)
SPEC = dict(spec_draft_layers=1, spec_min_accept=0.0)
SIZES = [20, 60, 120, 31]
NEW_TOKENS = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _prompts(sizes=SIZES, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, size=int(n)).astype(np.int32) for n in sizes]


def _streams(eng, **kw):
    """Every prompt at once (seed i for prompt i), then the first alone."""
    futs = [eng.submit("t", p, max_new_tokens=NEW_TOKENS, seed=i, **kw)
            for i, p in enumerate(_prompts())]
    together = [f.result(120) for f in futs]
    alone = eng.submit("solo", _prompts()[0], max_new_tokens=NEW_TOKENS,
                       seed=0, **kw).result(120)
    return together + [alone]


def _run(eng, sampled):
    """Greedy streams, and sampled ones where the engine samples."""
    try:
        out = {"greedy": _streams(eng)}
        if sampled:
            out["sampled"] = _streams(eng, **SAMPLED)
        return out
    finally:
        eng.shutdown(drain=True)


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


def _jax_engine(models, **kw):
    return jax_serving.DecodeEngine(models[0], stats=JaxServingStats(),
                                    **kw).warmup()


def _port_engine(models, **kw):
    return DecodeEngine(models[1], device="cpu", **kw).warmup()


@pytest.fixture(scope="module")
def plain(models):
    """The port's plain paged engine: the streams speculation must keep."""
    eng = _port_engine(models, **PAGED)
    yield eng
    eng.shutdown(drain=True)


@pytest.fixture(scope="module")
def plain_streams(plain):
    return {"greedy": _streams(plain), "sampled": _streams(plain, **SAMPLED)}


def _assert_streams_equal(got, want):
    assert len(got) == len(want) == len(SIZES) + 1
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (NEW_TOKENS,)
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- rungs
@pytest.mark.parametrize("kw", [
    dict(kv_mode="slots"), dict(PAGED, kv_mode="paged"),
    dict(PAGED, kv_mode="paged", speculate_k=4, **SPEC)],
    ids=["slots", "paged", "paged-spec"])
def test_rungs_match_jax(models, kw):
    kw = dict(COMMON, **kw)
    port = DecodeEngine(models[1], device="cpu", **kw)
    ref = jax_serving.DecodeEngine(models[0], stats=JaxServingStats(), **kw)
    assert port.programs.rungs == ref.programs.rungs
    assert port.kv_pool.k.shape == tuple(ref.kv_pool.k.shape)


# ----------------------------------------------------------- slot pool
def test_slot_writes_match_jax():
    rs = np.random.RandomState(0)
    cache = rs.randn(2, 4, 16, 2, 3).astype(np.float32)
    rows = rs.randn(2, 3, 10, 2, 3).astype(np.float32)
    slots = np.array([2, 0, 3], np.int32)
    want = jax_kvc.write_prompt_batch(jnp.asarray(cache), jnp.asarray(slots),
                                      jnp.asarray(rows))
    got = kvc.write_prompt_batch(torch.from_numpy(cache.copy()),
                                 torch.from_numpy(slots),
                                 torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jax_kvc.write_prompt(jnp.asarray(cache), 1,
                                jnp.asarray(rows[:, 0]))
    got = kvc.write_prompt(torch.from_numpy(cache.copy()), torch.tensor([1]),
                           torch.from_numpy(rows[:, 0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pos = np.array([5, 15, 0], np.int32)
    tok = rs.randn(3, 2, 3).astype(np.float32)
    want = jax_kvc.append_token(jnp.asarray(cache), 1, jnp.asarray(slots),
                                jnp.asarray(pos), jnp.asarray(tok))
    got = kvc.append_token(torch.from_numpy(cache.copy()), 1,
                           torch.from_numpy(slots), torch.from_numpy(pos),
                           torch.from_numpy(tok))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bf16 = kvc.write_prompt_batch(
        torch.zeros(2, 4, 16, 2, 3, dtype=torch.bfloat16),
        torch.from_numpy(slots), torch.from_numpy(rows))
    want = np.asarray(jax_kvc.write_prompt_batch(
        jnp.zeros((2, 4, 16, 2, 3), jnp.bfloat16), jnp.asarray(slots),
        jnp.asarray(rows)).astype(jnp.float32))
    np.testing.assert_array_equal(bf16.float().numpy(), want)


def test_slot_pool_guards():
    pool = KVSlotPool(1, 2, 8, 1, 4, device="cpu")
    assert pool.pad_slot == 2
    assert [pool.alloc(), pool.alloc()] == [0, 1]
    assert pool.in_use() == 2 and pool.free_count() == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc()
    pool.release(0)
    with pytest.raises(ValueError, match="already free"):
        pool.release(0)
    with pytest.raises(ValueError, match="out of range"):
        pool.release(2)
    assert pool.occupancy == 1 and pool.occupancy_peak == 2
    with pytest.raises(ValueError, match="kv_dtype"):
        KVSlotPool(1, 2, 8, 1, 4, dtype="float16", device="cpu")


@pytest.fixture(scope="module")
def slot_streams(models):
    return _run(_port_engine(models, kv_mode="slots", **COMMON), False)


def test_slot_streams_match_jax_slot_engine(models, slot_streams):
    want = _run(_jax_engine(models, kv_mode="slots", **COMMON), False)
    _assert_streams_equal(slot_streams["greedy"], want["greedy"])


def test_paged_and_slot_engines_agree(slot_streams, plain_streams):
    _assert_streams_equal(plain_streams["greedy"], slot_streams["greedy"])


def test_slot_engine_accounting_and_refusals(models):
    eng = _port_engine(models, kv_mode="slots", **COMMON)
    try:
        with pytest.raises(ValueError, match="paged"):
            eng.submit("a", [1, 2, 3], temperature=0.7)
        eng.generate("a", _prompts()[2], NEW_TOKENS)
        rep = eng.serving_report()
        assert rep["kv_mode"] == "slots" and rep["kv_slots_in_use"] == 0
        assert rep["kv_slots_peak"] == 1 and rep["kv_pool_bytes_constant"]
        assert rep["compiled_rungs"] == len(eng.programs.rungs)
        assert rep["compiles_after_warmup"] == 0
    finally:
        eng.shutdown(drain=True)
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(models[1], device="cpu", kv_mode="slots", speculate_k=2,
                     **COMMON)


# --------------------------------------------------------- speculation
@pytest.fixture(scope="module", params=[1, 4], ids=["k1", "k4"])
def spec_k(request):
    return request.param


@pytest.fixture(scope="module")
def jax_spec_streams(models, spec_k):
    return _run(_jax_engine(models, speculate_k=spec_k, **SPEC, **PAGED),
                True)


@pytest.fixture(scope="module")
def spec(models, spec_k):
    eng = _port_engine(models, speculate_k=spec_k, **SPEC, **PAGED)
    yield eng
    eng.shutdown(drain=True)


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_streams_match_jax_and_plain(spec, jax_spec_streams,
                                          plain_streams, mode):
    kw = SAMPLED if mode == "sampled" else {}
    got = _streams(spec, **kw)
    _assert_streams_equal(got, jax_spec_streams[mode])
    _assert_streams_equal(got, plain_streams[mode])
    assert spec.serving_report()["compiles_after_warmup"] == 0


def test_spec_rounds_replace_plain_steps(spec):
    before = dict(spec.stats.summary()["decode"] or {})
    req = spec.submit("net", _prompts([40], seed=5)[0], max_new_tokens=12)
    assert len(req.result(120)) == 12
    after = spec.stats.summary()["decode"]
    assert after.get("decode_steps", 0) == before.get("decode_steps", 0)
    assert after["spec_rounds"] > before.get("spec_rounds", 0)
    assert req.spec_live and req.spec_proposed > 0
    rep = spec.serving_report()
    assert rep["speculate_k"] == spec.speculate_k
    assert rep["spec_draft_layers"] == 1 and rep["spec_enabled"] is True


def test_auto_disable_and_toggle(spec, plain):
    prompt = _prompts([24], seed=6)[0]
    want = plain.generate("ref", prompt, 20)
    sched = spec._scheduler
    old = sched.spec_min_accept
    sched.spec_min_accept = 1.01  # acceptance can never reach this
    try:
        before = dict(spec.stats.summary()["decode"] or {})
        req = spec.submit("dis", prompt, max_new_tokens=20)
        np.testing.assert_array_equal(req.result(120), want)
    finally:
        sched.spec_min_accept = old
    after = spec.stats.summary()["decode"]
    assert req.spec_live is False
    assert req.spec_proposed >= 2 * spec.speculate_k
    assert after["decode_steps"] > before.get("decode_steps", 0)
    assert spec.set_speculation(False) is True
    try:
        np.testing.assert_array_equal(spec.generate("off", prompt, 20), want)
    finally:
        assert spec.set_speculation(True) is False
    opted_out = spec.submit("out", prompt, max_new_tokens=20,
                            speculate=False)
    np.testing.assert_array_equal(opted_out.result(120), want)
    assert opted_out.spec_proposed == 0
    assert spec.serving_report()["compiles_after_warmup"] == 0
    assert spec.kv_pool.in_use() == 0


def test_speculation_refused_on_plain_engine(plain):
    with pytest.raises(ValueError, match="speculate_k"):
        plain.submit("x", _prompts([8])[0], max_new_tokens=2, speculate=True)
    with pytest.raises(ValueError, match="speculate_k == 0"):
        plain.set_speculation(True)
    assert "speculate_k" not in plain.serving_report()


# ------------------------------------------------------------ bf16 KV
def test_bf16_kv_streams_match_jax(models, plain):
    got = _run(_port_engine(models, kv_dtype="bfloat16", **PAGED), True)
    want = _run(_jax_engine(models, kv_dtype="bfloat16", **PAGED), True)
    for mode in ("greedy", "sampled"):
        _assert_streams_equal(got[mode], want[mode])
    half = DecodeEngine(models[1], device="cpu", kv_dtype="bfloat16",
                        **PAGED)
    assert half.kv_pool.k.dtype == torch.bfloat16
    assert 2 * half.kv_pool.device_bytes() == plain.kv_pool.device_bytes()
