"""The port's reliability layer (``paddle_tpu_torch.reliability``) against
the JAX package's.

- For each seed and plan, the port's ``FaultInjector`` fires at the same
  visits as JAX's (both draw from ``random.Random(f"{seed}/{site}")``),
  site streams are independent, and ``corrupt_bytes`` flips the same
  bytes.
- The cases of ``tests/test_reliability.py`` (injector, retry policy,
  circuit breaker, breaker board, admission, first result wins), run on
  the port: kinds and budgets, the flag grammar, retry on transient
  faults, fatal faults on the first attempt, exhausted attempts, the
  deadline, breaker open, cooldown and probe, ``open_keys``, the
  ``"circuit"`` gate.
"""
import time

import pytest

from paddle_tpu import reliability as jax_rel
from paddle_tpu_torch import reliability as rel
from paddle_tpu_torch.base.flags import set_flags

PLANS = [
    [("serving.decode_step", 0.3, "raise")],
    [("serving.decode_step", 0.5, "raise"), ("kv.commit", 0.25, "corrupt")],
    [("kv.page_alloc", 0.9, "raise"), ("ckpt.write", 0.1, "raise")],
]


def _pattern(mod, seed, plan, visits=64):
    """Which visit of which site fired, and with what: the schedule."""
    inj = mod.FaultInjector(seed=seed)
    for site, rate, kind in plan:
        inj.plan(site, rate=rate, kind=kind, delay_s=0.0)
    out = []
    for i in range(visits):
        site = plan[i % len(plan)][0]
        try:
            out.append((site, inj.fire(site)))
        except mod.FaultInjection as e:
            out.append((e.site, "raise"))
    return out, inj.summary()


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
@pytest.mark.parametrize("plan", range(len(PLANS)))
def test_injector_fires_at_the_same_calls_as_jax(seed, plan):
    got, got_summary = _pattern(rel, seed, PLANS[plan])
    want, want_summary = _pattern(jax_rel, seed, PLANS[plan])
    assert got == want
    assert got_summary == want_summary
    assert any(kind is not None for _, kind in got)


def test_flag_spec_fires_as_jax():
    spec = "serving.decode_step:0.4:raise,kv.commit:0.5:latency:0"
    got = rel.FaultInjector.from_spec(spec, seed=3)
    want = jax_rel.FaultInjector.from_spec(spec, seed=3)
    for inj in (got, want):
        assert set(inj.plans) == {"serving.decode_step", "kv.commit"}
    fired = []
    for inj, mod in ((got, rel), (want, jax_rel)):
        row = []
        for _ in range(40):
            try:
                row.append(inj.fire("serving.decode_step"))
            except mod.FaultInjection:
                row.append("raise")
            row.append(inj.fire("kv.commit"))
        fired.append(row)
    assert fired[0] == fired[1]


def test_corrupt_bytes_matches_jax():
    data = bytes(range(256)) * 9
    for seed in (0, 1, 5):
        got = rel.corrupt_bytes(data, "ckpt.write", seed=seed)
        assert got == jax_rel.corrupt_bytes(data, "ckpt.write", seed=seed)
        assert got != data and len(got) == len(data)


# ---------------------------------------------------------------- injector
class TestFaultInjector:
    def test_deterministic_schedule_per_seed(self):
        def run(seed):
            inj = rel.FaultInjector(seed=seed).plan("kv.commit", rate=0.5)
            fired = []
            for _ in range(32):
                try:
                    inj.fire("kv.commit")
                    fired.append(0)
                except rel.FaultInjection:
                    fired.append(1)
            return fired

        assert run(0) == run(0)
        assert run(0) != run(1)

    def test_sites_roll_independent_streams(self):
        def pattern(extra_site):
            inj = rel.FaultInjector(seed=3).plan("kv.page_alloc", rate=0.5)
            if extra_site:
                inj.plan("kv.commit", rate=0.5)
            out = []
            for _ in range(16):
                if extra_site:
                    try:
                        inj.fire("kv.commit")
                    except rel.FaultInjection:
                        pass
                try:
                    inj.fire("kv.page_alloc")
                    out.append(0)
                except rel.FaultInjection:
                    out.append(1)
            return out

        assert pattern(False) == pattern(True)

    def test_kinds_latency_and_corrupt_and_max_fires(self):
        inj = rel.FaultInjector(seed=0)
        inj.plan("kv.page_alloc", rate=1.0, kind="latency", delay_s=0.01)
        t0 = time.perf_counter()
        assert inj.fire("kv.page_alloc") == "latency"
        assert time.perf_counter() - t0 >= 0.01
        inj.plan("kv.commit", rate=1.0, kind="corrupt")
        assert inj.fire("kv.commit") == "corrupt"
        bounded = rel.FaultInjector(seed=0).plan("ckpt.write", rate=1.0,
                                                 max_fires=1)
        with pytest.raises(rel.FaultInjection):
            bounded.fire("ckpt.write")
        assert bounded.fire("ckpt.write") is None
        with pytest.raises(ValueError):
            rel.FaultPlan("x", kind="explode")

    def test_flag_spec_arms_and_disarms(self):
        set_flags({"fault_inject":
                   "kv.page_alloc:1:raise,kv.commit:0.5:latency:20"})
        try:
            inj = rel.active()
            assert inj is not None
            assert set(inj.plans) == {"kv.page_alloc", "kv.commit"}
            assert inj.plans["kv.commit"][0].kind == "latency"
            assert inj.plans["kv.commit"][0].delay_s == pytest.approx(0.02)
        finally:
            set_flags({"fault_inject": ""})
        assert rel.active() is None
        assert rel.fault_point("kv.page_alloc") is None

    def test_every_port_site_has_a_cleanup_story(self):
        assert set(rel.SITES) == {"serving.execute", "serving.decode_step",
                                  "kv.commit", "kv.page_alloc",
                                  "ckpt.write", "io.h2d",
                                  "numerics.nonfinite_grad", "collective",
                                  "comm.watchdog"}
        for site in rel.SITES:
            assert site in jax_rel.SITES


# ------------------------------------------------------------ retry policy
class TestRetryPolicy:
    def test_transient_retries_then_succeeds(self):
        calls = [0]

        def flaky():
            calls[0] += 1
            if calls[0] < 3:
                raise OSError("transient")
            return "ok"

        policy = rel.RetryPolicy("t", max_attempts=4, base_delay_s=0.001,
                                 deadline_s=5.0)
        assert policy.run(flaky) == "ok"
        assert calls[0] == 3

    def test_fatal_propagates_on_first_attempt(self):
        calls = [0]

        def buggy():
            calls[0] += 1
            raise ValueError("logic bug")

        policy = rel.RetryPolicy("t", max_attempts=5, base_delay_s=0.001,
                                 deadline_s=5.0)
        with pytest.raises(ValueError):
            policy.run(buggy)
        assert calls[0] == 1

    def test_attempts_exhausted_reraises(self):
        policy = rel.RetryPolicy("t", max_attempts=2, base_delay_s=0.001,
                                 deadline_s=5.0)
        calls = [0]

        def always():
            calls[0] += 1
            raise TimeoutError("down")

        with pytest.raises(TimeoutError):
            policy.run(always)
        assert calls[0] == 2

    def test_deadline_budget_bounds_the_loop(self):
        policy = rel.RetryPolicy("t", max_attempts=1000, base_delay_s=0.05,
                                 max_delay_s=0.05, deadline_s=0.12)
        t0 = time.monotonic()
        with pytest.raises(OSError):
            policy.run(lambda: (_ for _ in ()).throw(OSError("x")))
        assert time.monotonic() - t0 < 2.0

    def test_positive_deadline_required(self):
        with pytest.raises(ValueError):
            rel.RetryPolicy("t", deadline_s=0)

    def test_flag_defaults_are_jax(self):
        got, want = rel.RetryPolicy("t"), jax_rel.RetryPolicy("t")
        for attr in ("max_attempts", "base_delay_s", "max_delay_s",
                     "deadline_s"):
            assert getattr(got, attr) == getattr(want, attr), attr
        got, want = rel.CircuitBreaker("k"), jax_rel.CircuitBreaker("k")
        assert got.failure_threshold == want.failure_threshold
        assert got.cooldown_s == want.cooldown_s

    def test_injected_fault_transient_flag_controls_classification(self):
        assert rel.default_classify(rel.FaultInjection("s")) is True
        assert rel.default_classify(
            rel.FaultInjection("s", transient=False)) is False
        assert rel.default_classify(KeyboardInterrupt()) is False


# --------------------------------------------------------- circuit breaker
class TestCircuitBreaker:
    def test_consecutive_failures_open_then_cooldown_probe_closes(self):
        b = rel.CircuitBreaker("k", failure_threshold=2, cooldown_s=0.05)
        b.on_failure()
        assert b.state == "closed" and b.allow()
        b.on_failure()
        assert b.state == "open" and not b.allow()
        time.sleep(0.06)
        assert b.allow()
        assert b.state == "half_open"
        b.on_success()
        assert b.state == "closed" and b.health == "ok"

    def test_half_open_probe_failure_reopens(self):
        b = rel.CircuitBreaker("k", failure_threshold=1, cooldown_s=0.02)
        b.on_failure()
        time.sleep(0.03)
        assert b.allow() and b.state == "half_open"
        b.on_failure()
        assert b.state == "open" and not b.allow()

    def test_success_resets_the_streak(self):
        b = rel.CircuitBreaker("k", failure_threshold=3, cooldown_s=60)
        for _ in range(2):
            b.on_failure()
        b.on_success()
        for _ in range(2):
            b.on_failure()
        assert b.state == "closed"

    def test_board_open_keys_and_health(self):
        board = rel.BreakerBoard(failure_threshold=1, cooldown_s=60)
        assert board.health() == "ok" and not board.is_open("t")
        board.record_failure("t")
        assert board.is_open("t")
        assert board.open_keys() == ["t"] and board.health() == "degraded"
        assert board.states() == {"t": "open"}

    def test_admission_sheds_open_circuit_tenant(self):
        from paddle_tpu_torch.serving.request_queue import AdmissionController

        board = rel.BreakerBoard(failure_threshold=1, cooldown_s=60)
        adm = AdmissionController(max_queue=100, tenant_quota=100,
                                  breaker_board=board)
        assert adm.try_admit("good", 1) is None
        board.record_failure("bad")
        assert adm.try_admit("bad", 1) == "circuit"
        assert adm.try_admit("good", 1) is None


def test_request_resolution_is_first_result_wins():
    import numpy as np

    from paddle_tpu_torch.observability import registry
    from paddle_tpu_torch.serving.request_queue import Request

    dup = registry.counter("serving.duplicate_resolution")
    before = dup.value()
    r = Request("t", [np.zeros((1, 4), np.float32)], 1)
    r._complete(["first"])
    r._fail(RuntimeError("late failure must not clobber the result"))
    r._complete(["second"])
    assert r.result(1) == ["first"]
    assert dup.value() == before + 2
