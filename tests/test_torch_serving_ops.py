"""The port's decode engine's operational tier against the JAX engine's:
weight ownership, weight hot-swap, retries, fault walls, circuit breakers
and the health payload.

The two-layer tiny GPT of ``tests/test_torch_serving_modes.py`` (numpy
seeded, weights carried across by ``load_jax_state``), on the CPU, paged
(32-token pages, ``max_seq=64``). Held token for token against the JAX
engine:

- the engine owns its weights: changing the model in place after warmup
  (JAX ``set_value``, the port's tensors under ``no_grad``) leaves both
  engines' streams as they were;
- ``swap_weights`` from a checkpoint the JAX package wrote, from one the
  port wrote (``save_sharded(jax_state_dict(model))``) and from a live
  twin gives the JAX engine's streams after the same swap, greedy and
  sampled, with and without speculation (``speculate_k=1``, where the
  draft view flips with the base weights); swapping back gives the
  original streams bit for bit; neither the source nor the constructor's
  model changes; the report's keys and the refusals are JAX's;
- fatal faults on ``serving.decode_step`` lose no request and leak no
  page; transient ones are retried and leave the streams unchanged; a
  tenant whose calls keep failing opens its breaker: ``/healthz`` reads
  ``degraded`` and its submits are refused with ``reason="circuit"``;
  an injected ``kv.page_alloc`` fault sheds exactly its request;
- ``telemetry_health`` has the JAX engine's keys in both KV modes.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.distributed.checkpoint import sharded as jax_sc
from paddle_tpu.profiler.pipeline import ServingStats as JaxServingStats
from paddle_tpu_torch import reliability as rel
from paddle_tpu_torch.base.flags import set_flags
from paddle_tpu_torch.distributed.checkpoint import sharded as sc
from paddle_tpu_torch.models.gpt import (GPTForCausalLM, gpt_tiny,
                                         jax_state_dict, load_jax_state)
from paddle_tpu_torch.serving import AdmissionError, DecodeEngine

TINY = dict(vocab_size=128, num_hidden_layers=2, hidden_size=8,
            num_attention_heads=1, max_position_embeddings=128)
PAGED = dict(max_slots=2, max_seq=64, seq_buckets=[32, 64],
             prefill_max_batch=2, page_size=32)
SPEC = dict(speculate_k=1, spec_draft_layers=1, spec_min_accept=0.0)
SIZES = [20, 50, 9]
NEW_TOKENS = 8
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)


def _prompts(sizes=SIZES, seed=3):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 128, size=int(n)).astype(np.int32) for n in sizes]


def _streams(eng):
    """Every prompt at once, greedy, then sampled (seed i for prompt i)."""
    out = []
    for kw in ({}, SAMPLED):
        futs = [eng.submit("t", p, max_new_tokens=NEW_TOKENS, seed=i, **kw)
                for i, p in enumerate(_prompts())]
        out += [f.result(120) for f in futs]
    return out


def _equal(got, want):
    assert len(got) == len(want) == 2 * len(SIZES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _jax_gpt(seed, **overrides):
    from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
    from paddle_tpu.models.gpt import gpt_tiny as jax_gpt_tiny

    paddle.seed(seed)
    ref = JaxGPT(jax_gpt_tiny(**dict(TINY, **overrides)))
    ref.eval()
    return ref


def _twin(ref, **overrides):
    model = GPTForCausalLM(gpt_tiny(**dict(TINY, **overrides)), device="cpu")
    return load_jax_state(model, {k: np.asarray(v.numpy())
                                  for k, v in ref.state_dict().items()}).eval()


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _unchanged(model, snap):
    return all(torch.equal(v, snap[k]) for k, v in model.state_dict().items())


@pytest.fixture(scope="module")
def models():
    """JAX and port twins of GPT A (seed 0) and GPT B (seed 1)."""
    ref_a, ref_b = _jax_gpt(0), _jax_gpt(1)
    return {"jax": (ref_a, ref_b), "port": (_twin(ref_a), _twin(ref_b))}


@pytest.fixture(scope="module")
def ckpts(models, tmp_path_factory):
    """GPT B's checkpoint as the JAX package writes it and as the port
    writes it."""
    root = tmp_path_factory.mktemp("ckpt")
    jax_sc.save_sharded(models["jax"][1].state_dict(), str(root / "jax_b"))
    sc.save_sharded(jax_state_dict(models["port"][1]), str(root / "port_b"))
    return {"jax": str(root / "jax_b"), "port": str(root / "port_b")}


def _pair(models, **kw):
    jax_eng = jax_serving.DecodeEngine(models["jax"][0],
                                       stats=JaxServingStats(), **kw)
    port_eng = DecodeEngine(models["port"][0], device="cpu", **kw)
    return jax_eng.warmup(), port_eng.warmup()


@pytest.fixture(scope="module")
def plain(models):
    engines = _pair(models, **PAGED)
    yield engines
    for eng in engines:
        eng.shutdown(drain=True)


@pytest.fixture(scope="module")
def base(plain):
    """GPT A's streams, the same in both packages."""
    jax_eng, port_eng = plain
    want = _streams(jax_eng)
    _equal(_streams(port_eng), want)
    return want


# ------------------------------------------------------ weight ownership
def test_engine_owns_its_weights(models, plain, base):
    """Both engines keep the weights they were built with when the model
    changes in place after warmup."""
    ref_a, port_a = models["jax"][0], models["port"][0]
    jax_keep = {k: np.asarray(v.numpy()).copy()
                for k, v in ref_a.state_dict().items()}
    port_keep = _snapshot(port_a)
    try:
        rs = np.random.RandomState(7)
        for k, v in ref_a.state_dict().items():
            v.set_value(rs.randn(*v.shape).astype(np.float32))
        with torch.no_grad():
            for p in port_a.parameters():
                p.add_(torch.randn(p.shape, generator=torch.Generator()
                                   .manual_seed(7)))
        for eng in plain:
            _equal(_streams(eng), base)
    finally:
        for k, v in ref_a.state_dict().items():
            v.set_value(jax_keep[k])
        port_a.load_state_dict(port_keep)


# ---------------------------------------------------------------- swaps
@pytest.mark.parametrize("source", ["jax_ckpt", "port_ckpt", "live_twin"])
def test_swap_matches_jax_and_swaps_back(models, ckpts, plain, base, source):
    jax_eng, port_eng = plain
    (ref_a, ref_b), (port_a, port_b) = models["jax"], models["port"]
    snaps = {"a": _snapshot(port_a), "b": _snapshot(port_b)}
    if source == "live_twin":
        jax_src, port_src = ref_b, port_b
    else:
        jax_src = port_src = ckpts[source.split("_")[0]]
    jax_rep = jax_eng.swap_weights(jax_src)
    port_rep = port_eng.swap_weights(port_src)
    assert set(port_rep) == set(jax_rep)
    assert port_rep["n_leaves"] == jax_rep["n_leaves"] == 4 + 12 * 2
    assert port_rep["compiles_after_warmup"] == 0
    assert port_rep["kv_slots_in_use"] == 0
    got = _streams(port_eng)
    _equal(got, _streams(jax_eng))
    assert any(not np.array_equal(g, b) for g, b in zip(got, base))
    # back to A from the live model: the original streams, bit for bit
    jax_eng.swap_weights(ref_a)
    port_eng.swap_weights(port_a)
    _equal(_streams(port_eng), base)
    _equal(_streams(jax_eng), base)
    assert _unchanged(port_a, snaps["a"]) and _unchanged(port_b, snaps["b"])
    assert port_eng.compiles_after_warmup == 0


def test_speculating_swap_flips_both_tiers(models, base):
    """Under speculation (k = 1, one draft layer) the draft view shares
    the swapped storage; the streams follow JAX's speculating engine."""
    jax_eng, port_eng = _pair(models, **PAGED, **SPEC)
    try:
        (ref_a, ref_b), (port_a, port_b) = models["jax"], models["port"]
        _equal(_streams(port_eng), base)
        futs = [port_eng.submit("sw", p, max_new_tokens=16)
                for p in _prompts([40, 20], seed=7)]
        port_eng.swap_weights(port_b)  # lands between rounds, lanes live
        assert [len(f.result(60)) for f in futs] == [16, 16]
        jax_eng.swap_weights(ref_b)
        _equal(_streams(port_eng), _streams(jax_eng))
        progs = port_eng.programs
        base_leaves = [t for blk in progs.params["blocks"][:1]
                       for t in blk.values()]
        draft_leaves = [t for blk in progs.draft_params["blocks"]
                        for t in blk.values()]
        assert len(draft_leaves) == len(base_leaves) > 0
        assert all(b is d for b, d in zip(base_leaves, draft_leaves))
        assert progs.draft_params["wte"] is progs.params["wte"]
        assert port_eng.serving_report()["compiles_after_warmup"] == 0
        port_eng.swap_weights(port_a)
        jax_eng.swap_weights(ref_a)
        _equal(_streams(port_eng), base)
        _equal(_streams(jax_eng), base)
    finally:
        for eng in (jax_eng, port_eng):
            eng.shutdown(drain=True)


def test_swap_refusals_match_jax(models, tmp_path):
    """The same refusals as JAX's: a checkpoint missing tensors
    (``KeyError``), one of another width and a twin of another depth or
    dtype (``ValueError``). Neither engine is warmed: they refuse first."""
    jax_eng = jax_serving.DecodeEngine(models["jax"][0],
                                       stats=JaxServingStats(), **PAGED)
    port_eng = DecodeEngine(models["port"][0], device="cpu", **PAGED)
    wide = _jax_gpt(3, hidden_size=16)
    deep = _jax_gpt(4, num_hidden_layers=3)
    partial = {k: v for k, v in models["jax"][1].state_dict().items()
               if not k.endswith("bias")}
    jax_sc.save_sharded(partial, str(tmp_path / "partial"))
    jax_sc.save_sharded(wide.state_dict(), str(tmp_path / "wide"))
    cases = [
        (KeyError, "missing", str(tmp_path / "partial"),
         str(tmp_path / "partial")),
        (ValueError, "shape|expects", str(tmp_path / "wide"),
         str(tmp_path / "wide")),
        (ValueError, "structurally", deep, _twin(deep, num_hidden_layers=3)),
        (ValueError, "leaf", _jax_gpt(1).bfloat16(),
         _twin(models["jax"][1]).to(torch.bfloat16)),
    ]
    for exc, match, jax_src, port_src in cases:
        with pytest.raises(exc, match=match):
            jax_eng.swap_weights(jax_src)
        with pytest.raises(exc, match=match):
            port_eng.swap_weights(port_src)
    snap = _snapshot(models["port"][0])
    assert _unchanged(models["port"][0], snap)


# ------------------------------------------------------------------ chaos
def _port_engine(models, **kw):
    return DecodeEngine(models["port"][0], device="cpu", **PAGED,
                        **kw).warmup()


def test_decode_step_crash_releases_every_kv_page(models):
    """Fatal faults (not retried) hit the fault wall: every future
    resolves, none is lost, no page leaks, nothing recompiles."""
    engine = _port_engine(models)
    rs = np.random.RandomState(0)
    inj = rel.FaultInjector(seed=0)
    inj.plan("serving.decode_step", rate=0.3, transient=False)
    rel.arm(inj)
    resolved = failed = 0
    try:
        reqs = [engine.submit(t, rs.randint(0, 128, size=n), 3)
                for t, n in (("a", 4), ("b", 6), ("a", 3), ("b", 5))]
        for r in reqs:
            try:
                r.result(60)
                resolved += 1
            except rel.FaultInjection:
                failed += 1
    finally:
        rel.disarm()
        engine.shutdown(drain=True)
    assert inj.summary()["total_injected"] > 0
    assert failed > 0
    assert resolved + failed == 4
    assert engine.kv_pool.in_use() == 0
    assert engine.active_requests() == 0
    assert engine.compiles_after_warmup == 0


def test_transient_faults_are_retried_with_equal_streams(models, base):
    set_flags({"retry_max_attempts": 6, "retry_base_delay_ms": 1.0})
    try:
        engine = _port_engine(models)
    finally:
        set_flags({"retry_max_attempts": 3, "retry_base_delay_ms": 20.0})
    inj = rel.arm(rel.FaultInjector(seed=1).plan("serving.decode_step",
                                                 rate=0.3))
    try:
        got = _streams(engine)
    finally:
        rel.disarm()
        engine.shutdown(drain=True)
    assert inj.summary()["total_injected"] > 0
    _equal(got, base)
    assert engine.compiles_after_warmup == 0


def test_breaker_degrades_healthz_and_sheds_admission(models):
    engine = _port_engine(models)
    engine.breakers._failure_threshold = 2
    engine.breakers._cooldown_s = 60.0
    rs = np.random.RandomState(0)
    inj = rel.FaultInjector(seed=0)
    inj.plan("serving.decode_step", rate=1.0, transient=False)
    rel.arm(inj)
    try:
        for _ in range(2):
            with pytest.raises(rel.FaultInjection):
                engine.submit("victim", rs.randint(0, 128, 5),
                              2).result(60)
    finally:
        rel.disarm()
    try:
        health = engine.telemetry_health()
        assert health["health"] == "degraded"
        assert health["open_circuits"] == ["victim"]
        assert health["ok"] is True and health["kv_pages_in_use"] == 0
        with pytest.raises(AdmissionError) as exc:
            engine.submit("victim", rs.randint(0, 128, 5), 2)
        assert exc.value.reason == "circuit"
        out = engine.submit("healthy", rs.randint(0, 128, 5), 2).result(60)
        assert out.shape == (2,)
    finally:
        engine.shutdown(drain=True)


def test_injected_page_alloc_fault_sheds_its_request(models):
    engine = _port_engine(models)
    inj = rel.arm(rel.FaultInjector(seed=0).plan("kv.page_alloc", rate=1.0,
                                                 max_fires=1))
    try:
        shed = engine.submit("a", _prompts()[0], 4)
        with pytest.raises(AdmissionError) as exc:
            shed.result(60)
        assert exc.value.reason == "kv_pages"
        ok = engine.submit("a", _prompts()[1], 4).result(60)
    finally:
        rel.disarm()
        engine.shutdown(drain=True)
    assert inj.summary()["total_injected"] == 1
    assert ok.shape == (4,) and engine.kv_pool.in_use() == 0


# -------------------------------------------------------------- health
@pytest.mark.parametrize("kv_mode", ["paged", "slots"])
def test_telemetry_health_has_jax_keys(models, kv_mode):
    kw = dict(PAGED, kv_mode=kv_mode)
    ref = jax_serving.DecodeEngine(models["jax"][0], stats=JaxServingStats(),
                                   **kw)
    port = DecodeEngine(models["port"][0], device="cpu", **kw)
    want, got = ref.telemetry_health(), port.telemetry_health()
    assert set(got) == set(want)
    for key in ("ok", "health", "open_circuits", "worker_alive", "started",
                "queue_depth_requests", "compiles_after_warmup", "kv_mode",
                "kv_slots"):
        assert got[key] == want[key], key
