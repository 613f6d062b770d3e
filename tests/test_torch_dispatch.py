"""The port's dispatch supervisor, retry policy and dispatch faults
(galah_tpu_torch/resilience/{dispatch,policy,faults}.py) against
galah_tpu's: tests/test_resilience.py's policy, injector and supervisor
cases, less the demotion ones (the port raises where galah_tpu falls
back), on the same specs and seeds.

Tolerance: none. Backoff delays are compared as floats for equality,
fault schedules and parsed specs element for element.
"""

import threading
import time

import pytest

from galah_tpu.resilience import faults as jfaults
from galah_tpu.resilience import policy as jpolicy
from galah_tpu_torch.kernels.build import KernelLaunchError
from galah_tpu_torch.resilience import dispatch as tdispatch
from galah_tpu_torch.resilience import faults as tfaults
from galah_tpu_torch.resilience import policy as tpolicy
from galah_tpu_torch.resilience.dispatch import (DispatchSupervisor,
                                                 expect_ani_values,
                                                 expect_len)
from galah_tpu_torch.resilience.faults import FaultInjector, FaultSpec
from galah_tpu_torch.resilience.policy import (DeadlineExceeded,
                                               DeviceLostError,
                                               GarbageResultError,
                                               RetryPolicy,
                                               TransientDispatchError,
                                               call_with_retry,
                                               is_retryable,
                                               run_with_deadline)

pytestmark = pytest.mark.fault_injection

FAULTS = {"jax": jfaults, "port": tfaults}
POLICY = {"jax": jpolicy, "port": tpolicy}
NO_WAIT = RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0)


@pytest.fixture(autouse=True)
def _clean_state():
    tfaults.reset()
    jfaults.reset()
    tdispatch.reset(NO_WAIT)
    tdispatch.reset_counts()
    yield
    tfaults.reset()
    jfaults.reset()
    tdispatch.reset()


# -- RetryPolicy ------------------------------------------------------


def test_delay_schedule_exponential_capped():
    for mod in POLICY.values():
        p = mod.RetryPolicy(max_attempts=5, base_delay=0.1, max_delay=0.5,
                            jitter=0.0)
        assert [p.delay(a) for a in (0, 1, 2, 3, 10)] == \
            pytest.approx([0.1, 0.2, 0.4, 0.5, 0.5])


@pytest.mark.parametrize("seed", [0, 3, 7, 12345])
def test_seeded_backoff_schedule_equals_galah_tpus(seed):
    """Under a seed the jittered delays are galah_tpu's to the float,
    for every (site, attempt)."""
    kw = dict(max_attempts=8, base_delay=0.05, max_delay=2.0, jitter=0.5,
              seed=seed)
    t, j = tpolicy.RetryPolicy(**kw), jpolicy.RetryPolicy(**kw)
    for site in ("dispatch.ani", "dispatch.fragment-ani",
                 "dispatch.sketch-minhash", "dispatch.sketch-hll",
                 "collective.host-rows", ""):
        got = [t.delay(a, site) for a in range(8)]
        assert got == [j.delay(a, site) for a in range(8)]
        assert all(0.025 <= d <= 3.0 for d in got)


def test_policy_validation():
    for mod in POLICY.values():
        with pytest.raises(ValueError):
            mod.RetryPolicy(max_attempts=0)
        with pytest.raises(ValueError):
            mod.RetryPolicy(jitter=1.5)


def test_from_env_reads_galah_retrys_seven_knobs(monkeypatch):
    env = {"MAX_ATTEMPTS": "7", "BASE_DELAY": "0.25", "MAX_DELAY": "3",
           "JITTER": "0.1", "ATTEMPT_DEADLINE": "2.5",
           "TOTAL_BUDGET": "40", "SEED": "3"}
    for key, value in env.items():
        monkeypatch.setenv(f"GALAH_RETRY_{key}", value)
    got = tpolicy.RetryPolicy.from_env()
    assert got == tpolicy.RetryPolicy(
        **vars(jpolicy.RetryPolicy.from_env()))
    assert (got.max_attempts, got.attempt_deadline, got.seed) == (7, 2.5, 3)
    # an explicit keyword wins over the environment
    assert tpolicy.RetryPolicy.from_env(max_attempts=2).max_attempts == 2
    # the supervisor without a policy reads the environment at each call
    tdispatch.reset()
    assert tdispatch.GLOBAL.policy == got
    monkeypatch.setenv("GALAH_RETRY_MAX_ATTEMPTS", "4")
    assert tdispatch.GLOBAL.policy.max_attempts == 4


# -- the retry classification ------------------------------------------


def test_is_retryable_taxonomy():
    for mod in POLICY.values():
        assert mod.is_retryable(mod.TransientDispatchError("x"))
        assert mod.is_retryable(mod.DeviceLostError("x"))
        assert mod.is_retryable(mod.GarbageResultError("x"))
        assert mod.is_retryable(OSError("flake"))
        assert mod.is_retryable(mod.DeadlineExceeded("slow"))
        assert not mod.is_retryable(FileNotFoundError("gone"))
        assert not mod.is_retryable(ValueError("deterministic"))
        assert not mod.is_retryable(RuntimeError("a bug"))

    class OutOfMemoryError(RuntimeError):  # matched by NAME, as torch's
        pass

    assert is_retryable(OutOfMemoryError("CUDA out of memory"))
    assert tpolicy.frees_device_memory(OutOfMemoryError("x"))
    # a deadline that struck after the dispatch began is not retried
    assert not is_retryable(DeadlineExceeded("late", dispatched=True))


@pytest.mark.parametrize("code,retryable", [(2, True), (700, False),
                                            (719, False), (1, False)])
def test_kernel_launch_error_codes(code, retryable):
    err = KernelLaunchError("window_hits", code)
    assert isinstance(err, RuntimeError) and err.cuda_error == code
    assert f"cudaError_t {code}" in str(err)
    assert tpolicy.cuda_error_code(err) == code
    assert is_retryable(err) is retryable
    assert tpolicy.frees_device_memory(err) is retryable


@pytest.mark.parametrize("code", [2, 700, None])
def test_torch_cuda_errors_match_by_name(code):
    """torch's CUDA error class follows the launch rule by its
    error_code; one without a code is no allocation failure."""

    class AcceleratorError(RuntimeError):
        pass

    err = AcceleratorError("CUDA error")
    if code is not None:
        err.error_code = code
    assert is_retryable(err) is (code == 2)


@pytest.mark.parametrize("code", [700, 719, 1])
def test_sticky_and_other_cuda_errors_raise_at_once(code):
    calls = []

    def primary():
        calls.append(1)
        raise KernelLaunchError("tile_stats", code)

    with pytest.raises(KernelLaunchError):
        DispatchSupervisor(NO_WAIT).run("s", primary)
    assert len(calls) == 1
    assert tdispatch.retry_counts() == {}


def test_allocation_failure_is_retried():
    calls = []

    def primary():
        calls.append(1)
        if len(calls) == 1:
            raise KernelLaunchError("pairlist", 2)
        return [0.5]

    assert DispatchSupervisor(NO_WAIT).run("s", primary) == [0.5]
    assert len(calls) == 2
    assert tdispatch.retry_counts()["s"] == 1


# -- call_with_retry ---------------------------------------------------


def test_retry_recovers_after_transients():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TransientDispatchError("flaky")
        return "ok"

    assert call_with_retry(fn, NO_WAIT, sleep=lambda _d: None) == "ok"
    assert calls["n"] == 3


def test_retry_exhaustion_reraises_last():
    pol = RetryPolicy(max_attempts=2, base_delay=0.0, jitter=0.0)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise TransientDispatchError(f"attempt {calls['n']}")

    with pytest.raises(TransientDispatchError, match="attempt 2"):
        call_with_retry(fn, pol, sleep=lambda _d: None)


def test_non_retryable_propagates_immediately():
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise ValueError("deterministic bug")

    with pytest.raises(ValueError):
        call_with_retry(fn, RetryPolicy(max_attempts=5, base_delay=0.0),
                        sleep=lambda _d: None)
    assert calls["n"] == 1


def test_total_budget_stops_retry_loop():
    pol = RetryPolicy(max_attempts=10, base_delay=10.0, jitter=0.0,
                      total_budget=0.5)
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        raise TransientDispatchError("flaky")

    with pytest.raises(TransientDispatchError):
        call_with_retry(fn, pol, sleep=lambda _d: None)
    assert calls["n"] == 1  # the first delay already exceeds the budget


def test_on_retry_fires_per_backoff_with_galah_tpus_sleeps():
    """The same failures give the same on_retry attempts and the same
    seeded sleeps in both packages."""
    seen = {}
    for side, mod in POLICY.items():
        calls = {"n": 0}
        log = []

        def fn():
            calls["n"] += 1
            if calls["n"] < 4:
                raise mod.TransientDispatchError("flaky")
            return 1

        pol = mod.RetryPolicy(max_attempts=5, base_delay=0.05, seed=9)
        mod.call_with_retry(fn, pol, site="dispatch.ani",
                            on_retry=lambda a, e: log.append(("retry", a)),
                            sleep=lambda d: log.append(("sleep", d)))
        seen[side] = log
    assert seen["port"] == seen["jax"]
    assert [e for e in seen["port"] if e[0] == "retry"] == [
        ("retry", 0), ("retry", 1), ("retry", 2)]


def test_attempt_deadline_abandons_hang():
    t0 = time.monotonic()
    with pytest.raises(DeadlineExceeded) as info:
        run_with_deadline(lambda: time.sleep(5.0), deadline=0.05)
    assert time.monotonic() - t0 < 2.0
    # no dispatch was marked begun: galah_tpu's rule, retried
    assert not info.value.dispatched and is_retryable(info.value)


def test_deadline_passthrough_value_and_error():
    assert run_with_deadline(lambda: 42, deadline=1.0) == 42
    with pytest.raises(KeyError):
        run_with_deadline(lambda: {}["x"], deadline=1.0)


# -- the two deadline cases --------------------------------------------


def test_attempt_abandoned_before_primary_never_dispatches():
    """An injected hang holds the first attempt before its dispatch: the
    deadline abandons it, the retry dispatches once, and when the
    abandoned attempt wakes it returns without calling primary."""
    woke = threading.Event()

    def sleep(seconds):
        time.sleep(seconds)
        woke.set()

    tfaults.install(FaultInjector([FaultSpec(site="s", kind="hang",
                                             hang_seconds=1.2,
                                             max_faults=1)], sleep=sleep))
    calls = []
    sup = DispatchSupervisor(RetryPolicy(max_attempts=3, base_delay=0.0,
                                         jitter=0.0, attempt_deadline=0.5))
    assert sup.run("s", lambda: calls.append(1) or [0.5],
                   validate=expect_ani_values(1)) == [0.5]
    assert len(calls) == 1
    assert woke.wait(5.0)
    time.sleep(0.2)  # the abandoned attempt's return
    assert len(calls) == 1
    assert tdispatch.retry_counts() == {"s": 1}


def test_attempt_abandoned_after_primary_raises_without_retry():
    """A primary still running at the deadline may still be working on
    the card: DeadlineExceeded(dispatched=True) raises at once."""
    calls = []

    def primary():
        calls.append(1)
        time.sleep(0.5)
        return [0.5]

    sup = DispatchSupervisor(RetryPolicy(max_attempts=3, base_delay=0.0,
                                         jitter=0.0, attempt_deadline=0.1))
    with pytest.raises(DeadlineExceeded) as info:
        sup.run("s", primary)
    assert info.value.dispatched
    assert len(calls) == 1
    assert tdispatch.retry_counts() == {}
    time.sleep(0.6)
    assert len(calls) == 1


def _policy(deadline):
    return RetryPolicy(max_attempts=3, base_delay=0.0, jitter=0.0,
                       attempt_deadline=deadline)


def test_nested_hang_retries_the_enclosing_attempt_and_never_dispatches():
    """dispatch.ani's attempt holds dispatch.fragment-ani, whose first
    attempt hangs before its dispatch. The enclosing attempt's deadline
    strikes first: it had not begun a dispatch (its nested call had
    not), so it is retried, as galah_tpu retries it. The abandoned
    thread then neither retries its nested call nor calls its primary,
    before or after the hang ends."""
    woke = threading.Event()

    def sleep(seconds):
        time.sleep(seconds)
        woke.set()

    tfaults.install(FaultInjector([FaultSpec(
        site="dispatch.fragment-ani", kind="hang", hang_seconds=1.5,
        max_faults=1)], sleep=sleep))
    inner_calls = []
    sup = DispatchSupervisor(NO_WAIT)

    def outer():
        return sup.run("dispatch.fragment-ani",
                       lambda: inner_calls.append(1) or [0.5],
                       policy=_policy(0.8))

    assert sup.run("dispatch.ani", outer, policy=_policy(0.4)) == [0.5]
    assert len(inner_calls) == 1
    assert woke.wait(5.0)
    time.sleep(0.3)  # the abandoned attempts' ends
    assert len(inner_calls) == 1
    assert tdispatch.retry_counts() == {"dispatch.ani": 1}


def test_nested_dispatch_begun_makes_the_enclosing_attempt_dispatched():
    """The nested call's primary is running when the enclosing deadline
    strikes: its work may be on the card, so the enclosing attempt
    raises DeadlineExceeded(dispatched=True) without a retry."""
    inner_calls = []
    sup = DispatchSupervisor(NO_WAIT)

    def inner():
        inner_calls.append(1)
        time.sleep(0.6)
        return [0.5]

    with pytest.raises(DeadlineExceeded) as info:
        sup.run("dispatch.ani",
                lambda: sup.run("dispatch.fragment-ani", inner,
                                policy=_policy(5.0)),
                policy=_policy(0.2))
    assert info.value.dispatched
    time.sleep(0.6)
    assert len(inner_calls) == 1
    assert tdispatch.retry_counts() == {}


def test_begin_dispatch_is_refused_under_an_abandoned_enclosing_attempt():
    """A nested call with no deadline of its own runs inline under the
    enclosing attempt: once that was abandoned, the nested primary is
    refused too (AttemptAbandoned, not retried)."""
    gate = threading.Event()
    seen = []
    sup = DispatchSupervisor(NO_WAIT)

    def outer():
        gate.wait(5.0)
        try:
            sup.run("dispatch.fragment-ani", lambda: seen.append(1))
        except tpolicy.AttemptAbandoned as e:
            seen.append(e)
            raise

    with pytest.raises(DeadlineExceeded):
        # the enclosing attempt began before it waited, so it is not
        # retried: its thread is then released into the nested call
        sup.run("dispatch.ani", outer,
                policy=RetryPolicy(max_attempts=1, attempt_deadline=0.2))
    gate.set()
    time.sleep(0.3)
    assert len(seen) == 1 and isinstance(seen[0], tpolicy.AttemptAbandoned)
    assert tdispatch.retry_counts() == {}


# -- the fault injector -------------------------------------------------


def test_parse_spec_matches_galah_tpu():
    text = ("site=dispatch.ani;kind=raise;prob=0.5;seed=7;max=2"
            "|site=collective.;kind=hang;hang=1.5"
            "|site=dispatch.sketch-hll;kind=device-lost;max=1"
            "|kind=garbage;prob=0.25|site=;kind=kill;prob=0.15;seed=4;max=1"
            "|site=io.atomic;kind=torn-write;prob=0.5;seed=2;max=1"
            "|site=io.ingest;kind=slow-io;hang=0.1|kind=enospc|kind=eio")
    got = [vars(s) for s in tfaults.parse_spec(text)]
    assert got == [vars(s) for s in jfaults.parse_spec(text)]
    assert {s["kind"] for s in got} == set(tfaults.FAULT_KINDS)
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.FaultSpec() == tfaults.FaultSpec(kind="raise")


def test_parse_spec_rejects_garbage():
    with pytest.raises(ValueError):
        tfaults.parse_spec("site=x;frequency=9")
    with pytest.raises(ValueError):
        tfaults.parse_spec("kind=explode")
    with pytest.raises(ValueError):
        FaultSpec(prob=1.5)


def _fire_log(inj, site="dispatch.ani", n=20):
    log = []
    for _ in range(n):
        try:
            inj.before_dispatch(site)
            log.append(0)
        except RuntimeError:
            log.append(1)
    return log


def test_injector_deterministic_and_capped():
    spec = dict(site="dispatch.ani", kind="raise", prob=0.4, seed=11)
    a = _fire_log(FaultInjector([FaultSpec(**spec)]))
    assert a == _fire_log(FaultInjector([FaultSpec(**spec)]))
    assert a == _fire_log(jfaults.FaultInjector([jfaults.FaultSpec(**spec)]))
    assert sum(a) > 0
    capped = FaultInjector([FaultSpec(site="dispatch.ani", prob=1.0,
                                      max_faults=3)])
    assert sum(_fire_log(capped)) == 3
    assert capped.fired() == 3


MIXED_SITES = (["dispatch.ani", "io.atomic.append[ckpt.greedy]",
                "dispatch.sketch-minhash", "io.ingest[/g/a.fna]",
                "collective.host-rows", "io.atomic.write[ckpt.distances]",
                "dispatch.fragment-ani"] * 12)


def _schedule(mod, text):
    """Each site's outcome under `text`, as the dispatch supervisor and
    io/atomic.py consult the injector: 'x' for an exception, 'kill' for
    a kill, 'garbage' for a corrupted result, the hang's sleep, a torn
    write, else '-'."""
    slept = []
    inj = mod.FaultInjector(mod.parse_spec(text), sleep=slept.append)

    def kill(site):
        raise SystemExit(f"kill at {site}")

    inj._kill = kill
    out = []
    for site in MIXED_SITES:
        n_slept = len(slept)
        try:
            if site.startswith("io."):
                got = inj.filesystem(site)
                out.append(got or "-")
            else:
                inj.before_dispatch(site)
                res = inj.corrupt(site, [1, 2, 3])
                out.append("garbage" if res != [1, 2, 3] else "-")
        except SystemExit:
            out.append("kill")
        except (RuntimeError, OSError) as e:
            out.append(f"x:{type(e).__name__}")
        if len(slept) > n_slept:
            out[-1] += f"+sleep{slept[-1]}"
    return out, inj.fired()


@pytest.mark.parametrize("kind", list(tfaults.FAULT_KINDS))
def test_fault_schedule_over_mixed_sites_equals_galah_tpus(kind):
    """A spec of each kind fires on the same calls of a mixed list of
    dispatch and filesystem sites in both packages: other kinds' specs
    and ineligible sites never advance its RNG."""
    text = (f"site=;kind={kind};prob=0.3;seed=5;hang=0.5"
            f"|site=dispatch.;kind=garbage;prob=0.2;seed=8;max=4"
            f"|site=io.atomic;kind=slow-io;prob=0.4;seed=2;hang=0")
    got, fired = _schedule(tfaults, text)
    want, jfired = _schedule(jfaults, text)
    assert got == want and fired == jfired
    assert fired > 0


def test_injector_site_prefix_match():
    inj = FaultInjector([FaultSpec(site="dispatch.", prob=1.0)])
    with pytest.raises(TransientDispatchError):
        inj.before_dispatch("dispatch.sketch-minhash")
    inj.before_dispatch("collective.host-rows")  # no fault


def test_injector_kinds():
    with pytest.raises(DeviceLostError):
        FaultInjector([FaultSpec(kind="device-lost")]).before_dispatch("x")
    slept = []
    inj = FaultInjector([FaultSpec(kind="hang", hang_seconds=7.0)],
                        sleep=slept.append)
    inj.before_dispatch("x")
    assert slept == [7.0]
    garb = FaultInjector([FaultSpec(kind="garbage")])
    garb.before_dispatch("x")  # garbage never raises before the dispatch
    assert garb.corrupt("x", [1, 2, 3]) == [1, 2]
    assert FaultInjector([FaultSpec(kind="garbage")]).corrupt("x", 5) is None
    # a dispatch kind never fires at a durable write, nor an fs kind at
    # a dispatch
    assert FaultInjector([FaultSpec(kind="raise")]).filesystem("x") is None
    FaultInjector([FaultSpec(kind="eio")]).before_dispatch("x")


def test_env_discovery(monkeypatch):
    monkeypatch.setenv("GALAH_FI", "site=dispatch.ani;kind=raise")
    tfaults.reset()
    inj = tfaults.get_injector()
    assert inj is not None
    with pytest.raises(TransientDispatchError):
        inj.before_dispatch("dispatch.ani")
    tfaults.reset()
    monkeypatch.delenv("GALAH_FI")
    assert tfaults.get_injector() is None


# -- the dispatch supervisor --------------------------------------------


def test_supervisor_transient_fault_retried_to_success():
    tfaults.install(FaultInjector(
        [FaultSpec(site="s", kind="raise", prob=1.0, max_faults=2)]))
    sup = DispatchSupervisor(NO_WAIT)
    assert sup.run("s", lambda: [0.5],
                   validate=expect_ani_values(1)) == [0.5]
    assert sup.demotions() == [] and tdispatch.demotions() == []
    assert tdispatch.retry_counts() == {"s": 2}


def test_supervisor_persistent_fault_raises_naming_the_site():
    """Where galah_tpu demotes to a fallback, the port raises the last
    error, noted with the site and the attempt count; the primary never
    ran and nothing else did."""
    tfaults.install(FaultInjector(
        [FaultSpec(site="s", kind="raise", prob=1.0)]))
    primary_calls = []
    sup = DispatchSupervisor(RetryPolicy(max_attempts=2, base_delay=0.0,
                                         jitter=0.0))
    with pytest.raises(TransientDispatchError) as info:
        sup.run("s", lambda: primary_calls.append(1) or [0.5])
    assert "s: gave up after 2 attempt(s)" in info.value.__notes__
    assert primary_calls == []
    assert sup.demotions() == []
    assert tdispatch.retry_counts() == {"s": 1}


def test_enclosing_site_does_not_retry_an_exhausted_one():
    """dispatch.ani wraps the backend call that holds
    dispatch.fragment-ani: once the inner site gives up, the outer one
    raises too instead of retrying it again."""
    tfaults.install(FaultInjector(
        [FaultSpec(site="dispatch.fragment-ani", kind="raise", prob=1.0)]))
    sup = DispatchSupervisor(NO_WAIT)
    with pytest.raises(TransientDispatchError) as info:
        sup.run("dispatch.ani", lambda: sup.run(
            "dispatch.fragment-ani", lambda: [0.5]))
    assert tdispatch.retry_counts() == {"dispatch.fragment-ani": 2}
    assert info.value.__notes__ == [
        "dispatch.fragment-ani: gave up after 3 attempt(s)"]


def test_supervisor_garbage_result_caught_by_validator():
    tfaults.install(FaultInjector(
        [FaultSpec(site="s", kind="garbage", prob=1.0, max_faults=1)]))
    out = DispatchSupervisor(NO_WAIT).run("s", lambda: [0.1, 0.2],
                                          validate=expect_len(2))
    assert out == [0.1, 0.2]  # the truncated result rejected, retry clean
    assert tdispatch.retry_counts() == {"s": 1}


def test_supervisor_hang_caught_by_attempt_deadline():
    tfaults.install(FaultInjector(
        [FaultSpec(site="s", kind="hang", hang_seconds=30.0,
                   max_faults=1)]))
    sup = DispatchSupervisor(RetryPolicy(
        max_attempts=2, base_delay=0.0, jitter=0.0, attempt_deadline=0.5))
    t0 = time.monotonic()
    assert sup.run("s", lambda: "done") == "done"
    assert time.monotonic() - t0 < 5.0
    assert tdispatch.retry_counts() == {"s": 1}


def test_supervisor_counts_metric_and_event():
    from galah_tpu_torch.obs import events, metrics

    events.reset()
    before = metrics.snapshot().get("dispatch.retries", {}).get("value", 0)
    tfaults.install(FaultInjector(
        [FaultSpec(site="dispatch.ani", kind="device-lost", max_faults=1)]))
    tdispatch.run("dispatch.ani", lambda: [1.0])
    assert metrics.snapshot()["dispatch.retries"]["value"] == before + 1
    retry = [e for e in events.snapshot() if e["kind"] == "retry"]
    assert retry and retry[-1]["site"] == "dispatch.ani"
    assert "DeviceLostError" in retry[-1]["error"]


def test_validators():
    expect_len(2)([1, 2])
    with pytest.raises(GarbageResultError):
        expect_len(2)([1])
    with pytest.raises(GarbageResultError):
        expect_len(1)(object())
    v = expect_ani_values(3)
    v([None, 0.0, 1.0])
    with pytest.raises(GarbageResultError):
        v([None, 0.5, 1.5])  # out of range
    with pytest.raises(GarbageResultError):
        v([None, float("nan"), 0.5])  # NaN
    with pytest.raises(GarbageResultError):
        v([0.5, 0.5])  # wrong length


def test_supervisor_thread_safety_every_caller_raises():
    tfaults.install(FaultInjector([FaultSpec(site="s", prob=1.0)]))
    sup = DispatchSupervisor(RetryPolicy(max_attempts=2, base_delay=0.0,
                                         jitter=0.0))
    results = []

    def worker():
        try:
            sup.run("s", lambda: "p")
            results.append("p")
        except TransientDispatchError:
            results.append("raised")

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == ["raised"] * 8
    assert tdispatch.retry_counts() == {"s": 8}
    assert sup.demotions() == []
