"""The port's batch serving tier against the JAX package's
(``tests/test_serving.py``, ``tests/test_decode_serving.py``
``TestTwoAxisLadder``): batch assembly (``jit.bucketing.assemble_bucket``
beside JAX's), stacking and scattering, ``RequestQueue.take_batch``,
``serving.ServingEngine`` — batched against sequential, tenant isolation
under ``clone``, admission, oversized requests, shutdown, no rung after
warmup, the two-axis GPT grid, swaps under traffic, the
``serving.execute`` fault point with retries and breakers — and
``ServingStats``' batch accounting.

On the CPU torch's GEMM does not give a row the same bits in every batch
size (one row runs as a matrix-vector product), where XLA's does: batched
results are held to ``Predictor.run`` within ``CPU_TOL`` here, where JAX
asserts bit equality (``ROADMAP.md`` queue 3). On the card the gate is
bit for bit (``tests/test_torch_cuda_batch_serving.py``).
"""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.jit.bucketing import assemble_bucket as jax_assemble
from paddle_tpu_torch import jit, reliability as rel, serving
from paddle_tpu_torch.base.flags import set_flags
from paddle_tpu_torch.inference import Config, Predictor
from paddle_tpu_torch.jit.bucketing import (assemble_bucket, bucket_grid,
                                            bucket_pair_for)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.profiler.pipeline import ServingStats
from paddle_tpu_torch.serving.request_queue import (AdmissionController,
                                                    AdmissionError, Request,
                                                    RequestQueue)
from paddle_tpu_torch.static import InputSpec

# batched rows against the same rows run alone, f32 on the CPU
CPU_TOL = 1e-6


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(),
                              torch.nn.Linear(32, 8)).eval()
    prefix = str(tmp_path_factory.mktemp("mlp") / "model")
    jit.save(net, prefix, input_spec=[InputSpec([None, 16], "float32")])
    return prefix


@pytest.fixture(scope="module")
def gpt(tmp_path_factory):
    model = GPTForCausalLM(
        gpt_tiny(num_hidden_layers=1, hidden_size=32, num_attention_heads=2,
                 max_position_embeddings=64), device="cpu").eval()
    prefix = str(tmp_path_factory.mktemp("gpt") / "gpt")
    jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
    return prefix, model


def _engine(prefix, **kw):
    kw.setdefault("buckets", [1, 2, 4, 8])
    kw.setdefault("stats", ServingStats())
    return serving.ServingEngine(prefix, device="cpu", **kw)


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=CPU_TOL, atol=CPU_TOL)


# ---------------------------------------------------------------- assembly
@pytest.mark.parametrize("counts,max_total,want", [
    ([4], None, (1, 4)),            # one request, exact rung
    ([3, 2, 3], None, (3, 8)),      # greedy fill, then the pad top-up
    ([5, 4, 1], None, (1, 8)),      # FIFO: nothing jumps the 4
    ([6, 2], None, (2, 8)),         # the 2 rides the pad
    ([3, 3, 3], 4, (1, 4)),         # the caller's cap
    ([5, 2], 5, (1, 8)),            # the top-up keeps to the cap
    ([], None, (0, None)),          # empty queue
])
def test_assemble_bucket_matches_jax(counts, max_total, want):
    ladder = [1, 2, 4, 8]
    assert assemble_bucket(counts, ladder, max_total) == want
    assert jax_assemble(counts, ladder, max_total) == want


def test_assemble_bucket_refuses_an_oversized_head():
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        assemble_bucket([9], [1, 2, 4, 8])


def test_bucket_grid_and_pairs():
    assert bucket_grid([1, 2], [8, 16]) == [(1, 8), (1, 16), (2, 8), (2, 16)]
    assert bucket_pair_for(3, 9, [1, 2, 4], [8, 16]) == (4, 16)


def test_stack_scatter_round_trip():
    rs = np.random.RandomState(0)
    reqs = [Request("t", [rs.randn(n, 3).astype(np.float32)], n)
            for n in (2, 1, 3)]
    stacked = serving.stack_requests(reqs, bucket=8, dynamic_axes={0: 0},
                                     n_inputs=1)
    assert stacked[0].shape == (8, 3)
    np.testing.assert_array_equal(stacked[0][:2], reqs[0].inputs[0])
    np.testing.assert_array_equal(stacked[0][6:], 0.0)
    for r, out in zip(reqs, serving.scatter_outputs([stacked[0]], reqs)):
        np.testing.assert_array_equal(out[0], r.inputs[0])


def test_stack_scatter_two_axis_slices_the_seq_pad():
    reqs = [Request("t", [np.full((1, n), n, np.int64)], 1, seq=n)
            for n in (5, 11)]
    stacked = serving.stack_requests(reqs, 4, {0: 0}, 1, seq_axes={0: 1},
                                     seq_bucket=16)
    assert stacked[0].shape == (4, 16)
    rows = serving.scatter_outputs(stacked, reqs, seq_bucket=16,
                                   out_seq_axes={0: 1})
    assert [r[0].shape for r in rows] == [(1, 5), (1, 11)]


def test_fetch_outputs_leaves_the_pad_on_the_device():
    out = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    host, = serving.fetch_outputs([out], rows=3, seq=5, out_seq_axes={0: 1})
    np.testing.assert_array_equal(host, out[:3, :5].numpy())
    full, = serving.fetch_outputs([out])
    np.testing.assert_array_equal(full, out.numpy())


def test_replay_outputs_are_freed_without_the_collector():
    """A replay's outputs are rebuilt by ``functionalize._unflatten``; no
    reference cycle may keep them (a batch's logits clone, up to 1.65 GB
    at gpt2_small's (8, 1024) rung) alive until Python's collector runs."""
    import gc
    import weakref

    from paddle_tpu_torch.jit import functionalize

    leaves = []
    spec = functionalize._flatten(((torch.zeros(2),), {"a": [torch.zeros(2)]}),
                                  leaves)
    enabled = gc.isenabled()
    gc.disable()
    try:
        out = functionalize._unflatten(spec, [torch.ones(2), torch.ones(3)])
        assert out[1]["a"][0].shape == (3,)
        refs = [weakref.ref(out[0][0]), weakref.ref(out[1]["a"][0])]
        del out
        assert [r() for r in refs] == [None, None]
    finally:
        if enabled:
            gc.enable()


def test_static_side_input_mismatch_fails_loud():
    a, b = np.ones(4, np.float32), np.zeros(4, np.float32)
    reqs = [Request("a", [np.ones((2, 3), np.float32), a], 2),
            Request("b", [np.ones((1, 3), np.float32), b], 1)]
    with pytest.raises(ValueError, match="static input 1 differs"):
        serving.stack_requests(reqs, 4, {0: 0}, 2)
    reqs[1].inputs = [reqs[1].inputs[0], a.copy()]
    assert serving.stack_requests(reqs, 4, {0: 0}, 2)[1].shape == (4,)


# ---------------------------------------------------------------- take_batch
def _queue(**kw):
    return RequestQueue(AdmissionController(max_queue=0, tenant_quota=0,
                                            **kw), ServingStats())


def test_take_batch_resolves_a_callable_ladder_after_the_wait():
    q = _queue()
    ladder = [1, 2]

    def late():
        time.sleep(0.05)
        ladder.extend([4, 8])
        q.submit(Request("t", [np.zeros((3, 1))], 3))

    threading.Thread(target=late).start()
    taken, bucket = q.take_batch(lambda: list(ladder), timeout=5.0)
    assert [r.n for r in taken] == [3] and bucket == 4


def test_take_batch_lingers_for_fill_and_expires_overdue():
    q = _queue()
    q.submit(Request("t", [np.zeros((1, 1))], 1))
    threading.Timer(0.02, lambda: q.submit(
        Request("t", [np.zeros((3, 1))], 3))).start()
    taken, bucket = q.take_batch([1, 2, 4], timeout=1.0, linger=2.0)
    assert [r.n for r in taken] == [1, 3] and bucket == 4
    q = _queue(request_ttl_ms=1.0)
    req = q.submit(Request("t", [np.zeros((1, 1))], 1))
    time.sleep(0.01)
    assert q.take_batch([1, 2], timeout=0.01) == ([], None)
    with pytest.raises(AdmissionError) as e:
        req.result(0)
    assert e.value.reason == "ttl"


def test_bulk_tier_yields_queue_headroom():
    ctrl = AdmissionController(max_queue=4, tenant_quota=0)
    ctrl.set_tier("bulk", "bulk")
    assert ctrl.try_admit("bulk", 2) is None
    assert ctrl.try_admit("bulk", 1) == "priority"
    assert ctrl.try_admit("live", 2) is None


# ------------------------------------------------------------------- engine
def test_batched_vs_sequential(mlp):
    eng = _engine(mlp).warmup()
    try:
        rs = np.random.RandomState(1)
        feeds = [rs.randn(n, 16).astype(np.float32)
                 for n in (1, 3, 2, 5, 8, 4, 7, 1)]
        reqs = [eng.submit("t0", x) for x in feeds]
        got = [r.result(30.0)[0] for r in reqs]
        single = eng.tenant("t0")
        for x, out in zip(feeds, got):
            _close(out, single.run([x])[0])
        assert eng.stats.summary()["batches"] < len(feeds)
    finally:
        eng.shutdown(drain=True)


def test_tenant_isolation_under_clone(mlp):
    eng = _engine(mlp).warmup()
    try:
        preds = [eng.tenant(f"t{i}") for i in range(3)]
        base = eng.predictor
        assert all(p._layer is base._layer for p in preds)
        assert all(p._batch_program is base._batch_program for p in preds)
        results = {}

        def client(i):
            x = np.full((2, 16), float(i + 1), np.float32)
            results[i] = (x, eng.run(f"t{i}", x, timeout=30.0)[0])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert set(results) == {0, 1, 2}
        for i, (x, out) in results.items():
            _close(out, preds[i].run([x])[0])
        assert eng.tenants == ["t0", "t1", "t2"]
        assert eng.drop_tenant("t1") and eng.tenants == ["t0", "t2"]
    finally:
        eng.shutdown(drain=True)


def test_admission_rejects_over_queue_cap(mlp):
    eng = _engine(mlp, max_queue=4, tenant_quota=0).warmup()
    try:
        eng.shutdown(drain=True)  # no consumer: the queue backs up
        eng.queue.closed = False
        eng._started = True
        x = np.zeros((2, 16), np.float32)
        eng.submit("a", x)
        eng.submit("a", x)
        with pytest.raises(serving.AdmissionError) as ei:
            eng.submit("a", x)
        assert ei.value.reason == "queue"
        assert eng.stats.rejected == 1
    finally:
        eng.queue.fail_pending(serving.RejectedError("test over"))


def test_admission_tenant_quota_isolates_and_releases(mlp):
    eng = _engine(mlp, max_queue=0, tenant_quota=4).warmup()
    try:
        ctrl = eng.queue.admission
        assert ctrl.try_admit("a", 4) is None
        assert ctrl.try_admit("a", 1) == "tenant"
        assert ctrl.try_admit("b", 4) is None
        ctrl.on_dispatch("a", 4)
        ctrl.on_complete("a", 4)
        assert ctrl.try_admit("a", 1) is None
        with pytest.raises(serving.AdmissionError):
            eng.submit("c", np.zeros((5, 16), np.float32))
        eng.queue.admission.tenant_quota = 256
        out, = eng.run("c", np.zeros((5, 16), np.float32), timeout=30.0)
        assert out.shape == (5, 8)
    finally:
        eng.shutdown(drain=True)


def test_oversized_requests_refused_at_submit(mlp, gpt):
    eng = _engine(mlp).warmup()
    try:
        with pytest.raises(ValueError, match="exceeds the largest bucket"):
            eng.submit("t", np.zeros((9, 16), np.float32))
    finally:
        eng.shutdown(drain=True)
    eng = _engine(gpt[0], buckets=[1, 2], seq_buckets=[8, 16]).warmup()
    try:
        with pytest.raises(ValueError, match="seq"):
            eng.submit("a", np.zeros((1, 17), np.int64))
    finally:
        eng.shutdown(drain=True)


def test_queue_drains_on_shutdown(mlp):
    eng = _engine(mlp, linger_ms=0.0).warmup()
    rs = np.random.RandomState(2)
    reqs = [eng.submit("t", rs.randn(n, 16).astype(np.float32))
            for n in (3, 1, 2, 4, 2, 1)]
    eng.shutdown(drain=True)
    assert all(r.done() for r in reqs)
    for r in reqs:
        assert r.result(0.0)[0].shape == (r.n, 8)
    with pytest.raises(RuntimeError, match="closed"):
        eng.queue.submit(Request("t", [np.zeros((1, 16), np.float32)], 1))


def test_non_drain_shutdown_fails_pending(mlp):
    eng = _engine(mlp).warmup()
    eng.shutdown(drain=True)
    eng.queue.closed = False
    req = eng.queue.submit(Request("t", [np.zeros((1, 16), np.float32)], 1))
    eng.queue.close()
    assert eng.queue.fail_pending(serving.RejectedError("shutdown")) == 1
    with pytest.raises(serving.RejectedError):
        req.result(0.0)
    eng = _engine(mlp).warmup()
    eng.shutdown(drain=False)
    assert not eng._scheduler.alive()


def test_zero_new_rungs_after_warmup(mlp):
    eng = _engine(mlp).warmup()
    try:
        assert eng.compile_count == 4 and eng.compiles_after_warmup == 0
        rs = np.random.RandomState(3)
        for i in range(30):
            eng.run(f"t{i % 3}", rs.randn(int(rs.randint(1, 9)), 16).astype(
                np.float32), timeout=30.0)
        assert eng.compiles_after_warmup == 0
        health = eng.telemetry_health()
        assert health["ok"] and health["compiles_after_warmup"] == 0
        report = eng.serving_report()
        assert report["compiled_rungs"] == 4 and report["requests"] == 30
        assert 0 < report["batch_fill"] <= 1
    finally:
        eng.shutdown(drain=True)


def test_fixed_shape_export_serves_one_rung(tmp_path):
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(16, 8)).eval()
    jit.save(net, str(tmp_path / "f"),
             input_spec=[InputSpec([4, 16], "float32")])
    eng = serving.ServingEngine(str(tmp_path / "f"), device="cpu",
                                stats=ServingStats()).warmup()
    try:
        assert eng.predictor.batch_ladder == [4] and eng.compile_count == 1
        x = np.random.RandomState(4).randn(3, 16).astype(np.float32)
        out, = eng.run("t", x)
        want = eng.predictor.run([np.pad(x, [(0, 1), (0, 0)])])[0][:3]
        np.testing.assert_array_equal(out, want)
        assert eng.compiles_after_warmup == 0
    finally:
        eng.shutdown(drain=True)


def test_gpt_two_axis_grid_serves_mixed_lengths(gpt):
    prefix, model = gpt
    eng = _engine(prefix, buckets=[1, 2, 4], seq_buckets=[8, 16]).warmup()
    try:
        assert eng.compile_count == 6
        rs = np.random.RandomState(1)
        xs = [rs.randint(0, 512, size=(k, n)).astype(np.int64)
              for k, n in ((1, 5), (2, 11), (1, 8), (1, 16), (3, 3))]
        outs = [r.result(60) for r in [eng.submit("a", x) for x in xs]]
        single = Predictor(Config(prefix, device="cpu"))
        for x, (out,) in zip(xs, outs):
            assert out.shape == x.shape + (512,)
            _close(out, single.run([x])[0])
            with torch.no_grad():
                _close(out, model(torch.from_numpy(x)).numpy())
        assert eng.compiles_after_warmup == 0
    finally:
        eng.shutdown(drain=True)


def test_swap_under_traffic_fails_nothing(gpt):
    prefix, model = gpt
    other = GPTForCausalLM(model.config, device="cpu",
                           generator=torch.Generator().manual_seed(1)).eval()
    eng = _engine(prefix, buckets=[1, 2], seq_buckets=[8, 16]).warmup()
    ids = np.random.RandomState(6).randint(0, 512, (2, 9))
    failures, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            try:
                eng.run("c", ids, timeout=30)
            except Exception as e:  # noqa: BLE001 — the zero-drop gate
                failures.append(e)
                return

    t = threading.Thread(target=client)
    t.start()
    try:
        before, = eng.run("a", ids)
        rep = eng.swap_weights(dict(other.state_dict()))
        after, = eng.run("a", ids)
        eng.swap_weights(dict(model.state_dict()))
        back, = eng.run("a", ids)
    finally:
        stop.set()
        t.join(30)
        eng.shutdown(drain=True)
    assert failures == [] and rep["compiles_after_warmup"] == 0
    with torch.no_grad():
        _close(after, other(torch.from_numpy(ids)).numpy())
    np.testing.assert_array_equal(back, before)
    assert eng.compiles_after_warmup == 0


# ------------------------------------------------------------------- faults
def _alone(eng, feeds):
    return [eng.run("t", x, timeout=30.0)[0] for x in feeds]


def _feeds():
    rs = np.random.RandomState(7)
    return [rs.randn(n, 16).astype(np.float32) for n in (1, 3, 2, 5, 8, 4)]


def test_transient_execute_faults_are_retried_to_equal_outputs(mlp):
    eng = _engine(mlp).warmup()
    try:
        base = _alone(eng, _feeds())
    finally:
        eng.shutdown(drain=True)
    set_flags({"retry_max_attempts": 6, "retry_base_delay_ms": 1.0})
    try:
        eng = _engine(mlp).warmup()
    finally:
        set_flags({"retry_max_attempts": 3, "retry_base_delay_ms": 20.0})
    inj = rel.arm(rel.FaultInjector(seed=1).plan("serving.execute",
                                                 rate=0.3))
    try:
        got = _alone(eng, _feeds())
    finally:
        rel.disarm()
        eng.shutdown(drain=True)
    assert inj.summary()["total_injected"] > 0
    for a, b in zip(got, base):
        np.testing.assert_array_equal(a, b)
    assert eng.compiles_after_warmup == 0


def test_fatal_execute_faults_fail_only_their_batch(mlp):
    eng = _engine(mlp, linger_ms=0.0).warmup()
    inj = rel.FaultInjector(seed=0)
    inj.plan("serving.execute", rate=0.3, transient=False)
    rel.arm(inj)
    served = failed = 0
    try:
        for x in _feeds() * 2:
            try:
                eng.run("t", x, timeout=30.0)
                served += 1
            except rel.FaultInjection:
                failed += 1
    finally:
        rel.disarm()
    try:
        assert failed > 0 and served > 0 and served + failed == 12
        assert eng.queue.admission.inflight("t") == 0
        out, = eng.run("t", np.zeros((2, 16), np.float32))
        assert out.shape == (2, 8)
        assert eng.compiles_after_warmup == 0
    finally:
        eng.shutdown(drain=True)


def test_open_breaker_sheds_its_tenant(mlp):
    eng = _engine(mlp).warmup()
    eng.breakers._failure_threshold = 2
    eng.breakers._cooldown_s = 60.0
    inj = rel.FaultInjector(seed=0)
    inj.plan("serving.execute", rate=1.0, transient=False)
    rel.arm(inj)
    try:
        for _ in range(2):
            with pytest.raises(rel.FaultInjection):
                eng.run("victim", np.zeros((1, 16), np.float32))
    finally:
        rel.disarm()
    try:
        health = eng.telemetry_health()
        assert health["health"] == "degraded"
        assert health["open_circuits"] == ["victim"]
        with pytest.raises(AdmissionError) as exc:
            eng.submit("victim", np.zeros((1, 16), np.float32))
        assert exc.value.reason == "circuit"
        assert eng.run("healthy", np.zeros((1, 16), np.float32))[0].shape \
            == (1, 8)
    finally:
        eng.shutdown(drain=True)


# ------------------------------------------------------------------ stats
def test_serving_stats_percentiles_and_slo():
    stats = ServingStats()
    t0 = 100.0
    for i in range(98):
        stats.record_request(t0 + i, t0 + i, t0 + i + 0.004, t0 + i + 0.010)
    for i in (98, 99):
        stats.record_request(t0 + i, t0 + i, t0 + i + 0.05, t0 + i + 0.1)
    stats.record_batch(3, 4)
    stats.record_queue_depth(2)
    stats.record_queue_depth(6)
    s = stats.summary(slo_ms=50.0)
    assert s["requests"] == 100 and s["samples"] == 100
    assert s["p50_ms"] == pytest.approx(10.0)
    assert s["p99_ms"] == pytest.approx(100.0)
    assert s["in_slo_fraction"] == 0.98
    assert s["batch_fill"] == 0.75 and s["padded_slots"] == 1
    assert s["queue_depth_peak"] == 6 and s["queue_depth_mean"] == 4.0
    assert s["requests_per_sec_in_slo"] == pytest.approx(
        s["requests_per_sec"] * 0.98)


def test_request_phase_timestamps_recorded(mlp):
    eng = _engine(mlp).warmup()
    try:
        req = eng.submit("t", np.zeros((2, 16), np.float32))
        req.result(30.0)
        assert (req.t_enqueue <= req.t_admit <= req.t_dispatch
                <= req.t_complete)
        s = eng.stats.summary()
        assert s["requests"] == 1 and s["batches"] == 1
        assert s["p50_ms"] is not None and s["p50_ms"] >= 0
    finally:
        eng.shutdown(drain=True)


def test_token_fill_counts_the_sequence_padding(gpt):
    """One request a batch (one blocking client): the row fill counts
    only padded rows, the token fill the seq pad as well."""
    prefix, _ = gpt
    eng = _engine(prefix, buckets=[1, 2, 4], seq_buckets=[8, 16]).warmup()
    try:
        rs = np.random.RandomState(2)
        # (rows, seq) -> rung (1, 8), (2, 16), (4, 8)
        for k, n in ((1, 5), (2, 11), (3, 3)):
            eng.run("a", rs.randint(0, 512, size=(k, n)).astype(np.int64),
                    timeout=60.0)
        s = eng.serving_report()
        assert s["batches"] == 3 and s["padded_slots"] == 1
        assert s["token_slots"] == 8 + 32 + 32
        assert s["padded_tokens"] == 72 - (5 + 22 + 9)
        assert s["token_fill"] == pytest.approx(36 / 72)
        assert s["batch_fill"] == pytest.approx(6 / 7)
    finally:
        eng.shutdown(drain=True)


def test_one_axis_export_reports_no_token_fill(mlp):
    eng = _engine(mlp).warmup()
    try:
        eng.run("a", np.zeros((3, 16), np.float32), timeout=30.0)
        s = eng.serving_report()
        assert s["token_fill"] is None and s["token_slots"] == 0
    finally:
        eng.shutdown(drain=True)
