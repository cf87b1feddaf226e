"""The reliability layer in the port on the CPU against the JAX package:
the 22 cases of ``tests/test_chaos.py`` run through both packages — each
case asserts the reference's invariants in either package and returns
what it observed, and the two observations must be equal — and
``benchmarks/chaos.py``'s ``main`` at ``per_task=20`` with the fleet
variant (and the variant alone at n = 24 and 80), whose run records
(trajectories, per-arm selections, retries, timeouts, breaker opens, the
fleet's fail-over) must equal the JAX package's ``bench_chaos``.

  * the circuit breaker's transitions (open at the failure rate, the
    cooldown, the probe trickle, re-close and re-open, the hook);
  * fault specs, ``fault_storm``'s seeded schedules (the same specs in
    both packages), stalls, garbage and the chaos scenario's
    fingerprint;
  * the scheduler: a deadline expiring to TIMED_OUT, a retry routed away
    from the failed arm, a corrupt completion retried to a clean answer,
    the reliability-off baseline, exhausted retries, the pre-bound
    counters, the hedge's health guard, the governor's charge released
    exactly once, the livelock snapshot, and a disaggregated pool under
    repeated prefill and twin kills (smoke granite-3-8b in fp32 on the
    JAX weights, the port's energy constants set to the JAX package's)."""
import json
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.costmodel as jax_costmodel
import repro.serving as jax_serving
import repro.serving.reliability as jax_reliability
import repro.telemetry as jax_telemetry
from benchmarks import bench_chaos as jax_chaos
from repro.configs import get_config as jax_get_config
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data import scenarios as jax_scenarios
from repro.data import tokenizer as jax_tok
import repro_torch.costmodel as port_costmodel
import repro_torch.serving as port_serving
import repro_torch.serving.reliability as port_reliability
import repro_torch.telemetry as port_telemetry
from repro_torch.benchmarks import chaos
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import ModelProfile, Query, RouterConfig
from repro_torch.data import scenarios
from repro_torch.data import tokenizer as tok
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401
from test_torch_disagg import F32, _weights
from test_torch_serving import equal_energy_constants  # noqa: F401

pytestmark = [pytest.mark.port, pytest.mark.chaos]


def _ns(serving, reliability, telemetry, costmodel, **kw):
    return types.SimpleNamespace(
        BreakerConfig=serving.BreakerConfig,
        CircuitBreaker=serving.CircuitBreaker, CLOSED=reliability.CLOSED,
        OPEN=reliability.OPEN, HALF_OPEN=reliability.HALF_OPEN,
        FaultInjector=serving.FaultInjector, FaultSpec=serving.FaultSpec,
        fault_storm=serving.fault_storm, LivelockError=serving.LivelockError,
        ModelEngine=serving.ModelEngine, PoolServer=serving.PoolServer,
        Request=serving.Request, RequestState=serving.RequestState,
        SimEngine=serving.SimEngine,
        EnergyBudgetGovernor=telemetry.EnergyBudgetGovernor,
        Telemetry=telemetry.Telemetry, to_prometheus=telemetry.to_prometheus,
        EnergyCostModel=costmodel.EnergyCostModel, **kw)


JAX = _ns(jax_serving, jax_reliability, jax_telemetry, jax_costmodel,
          ModelPool=JaxModelPool, Router=JaxRouter,
          RouterConfig=JaxRouterConfig, ModelProfile=JaxModelProfile,
          Query=JaxQuery, chaos=jax_scenarios.chaos,
          encode=jax_tok.encode, router_kw={})
PORT = _ns(port_serving, port_reliability, port_telemetry, port_costmodel,
           ModelPool=ModelPool, Router=GreenServRouter,
           RouterConfig=RouterConfig, ModelProfile=ModelProfile, Query=Query,
           chaos=scenarios.chaos, encode=tok.encode,
           router_kw=dict(device="cpu"))


def _both(case):
    """Run ``case(ns)`` in each package; the observations must be equal."""
    want, got = case(JAX), case(PORT)
    assert_close(got, want, 1e-12)
    return got


# ---------------------------------------------------------------------------
# circuit breaker state machine
# ---------------------------------------------------------------------------


def _cfg(ns, **kw):
    base = dict(window=4, failure_threshold=0.5, min_samples=2,
                open_steps=10, probe_quota=1, probe_successes=2)
    base.update(kw)
    return ns.BreakerConfig(**base)


def _opens_at_failure_threshold(ns):
    br = ns.CircuitBreaker(_cfg(ns))
    br.record_failure(1)
    assert br.state == ns.CLOSED           # min_samples not met yet
    br.record_failure(2)
    assert br.state == ns.OPEN
    assert br.n_opens == 1
    assert not br.routable(3)
    return [br.state, br.n_opens, br.failure_rate()]


def _successes_keep_it_closed(ns):
    br = ns.CircuitBreaker(_cfg(ns))
    for s in range(8):
        br.record_success(s)
    br.record_failure(9)                   # 1 failure in a window of 4
    assert br.state == ns.CLOSED
    assert br.routable(10)
    return [br.state, br.failure_rate()]


def _cooldown_probe_and_reclose(ns):
    br = ns.CircuitBreaker(_cfg(ns))
    br.record_failure(1), br.record_failure(2)
    assert br.state == ns.OPEN
    assert not br.routable(5)              # cooling down
    assert br.routable(12, pending=0)      # open_steps elapsed -> HALF_OPEN
    assert br.state == ns.HALF_OPEN
    # probe trickle: quota=1 means a busy arm admits nothing more
    assert not br.routable(12, pending=1)
    br.record_success(13)
    assert br.state == ns.HALF_OPEN        # needs probe_successes=2
    br.record_success(14)
    assert br.state == ns.CLOSED
    assert br.failure_rate() == 0.0        # window cleared on close
    return [br.state, br.n_opens]


def _probe_failure_reopens(ns):
    br = ns.CircuitBreaker(_cfg(ns))
    br.record_failure(1), br.record_failure(2)
    assert br.routable(12)                 # HALF_OPEN
    br.record_failure(13)                  # the probe died
    assert br.state == ns.OPEN
    assert br.n_opens == 2
    assert not br.routable(14)
    assert br.routable(23)                 # cooldown restarted from step 13
    return [br.state, br.n_opens]


def _transition_hook(ns):
    seen = []
    br = ns.CircuitBreaker(_cfg(ns),
                           on_transition=lambda o, n, s: seen.append(
                               (o, n, s)))
    br.record_failure(1), br.record_failure(2)
    br.routable(12)
    br.record_success(13), br.record_success(14)
    assert [s[:2] for s in seen] == [(ns.CLOSED, ns.OPEN),
                                     (ns.OPEN, ns.HALF_OPEN),
                                     (ns.HALF_OPEN, ns.CLOSED)]
    return seen


def _config_validation(ns):
    for kw in (dict(failure_threshold=0.0), dict(failure_threshold=1.5),
               dict(window=0)):
        with pytest.raises(ValueError):
            ns.BreakerConfig(**kw)
    return True


@pytest.mark.parametrize("case", [
    _opens_at_failure_threshold, _successes_keep_it_closed,
    _cooldown_probe_and_reclose, _probe_failure_reopens, _transition_hook,
    _config_validation], ids=lambda c: c.__name__.strip("_"))
def test_circuit_breaker(case):
    _both(case)


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------


def _profile(ns, name="sim0", params_b=1.0):
    return ns.ModelProfile(name=name, family="s", params_b=params_b,
                           ms_per_token=1.0, prefill_ms=10.0)


def _outcome(query, model):
    return 0.8, 0.01, 10.0, 4


def _fault_spec_validation(ns):
    with pytest.raises(ValueError):
        ns.FaultSpec(t_s=0.0, kind="meteor")
    spec = ns.FaultSpec(t_s=1.0, kind="stall", duration_s=2.0)
    assert spec.active(1.5) and not spec.active(3.5)
    return [spec.t_s, spec.kind, spec.duration_s, spec.magnitude]


def _specs(schedules):
    return {n: [[f.t_s, f.kind, f.duration_s, f.magnitude] for f in fs]
            for n, fs in sorted(schedules.items())}


def _fault_storm_deterministic(ns):
    a = ns.fault_storm(100.0, "m0", ["m1", "m2"], seed=3, n_crashes=4)
    b = ns.fault_storm(100.0, "m0", ["m1", "m2"], seed=3, n_crashes=4)
    assert a == b
    c = ns.fault_storm(100.0, "m0", ["m1", "m2"], seed=4, n_crashes=4)
    assert a != c
    crashes = [f for f in a["m0"] if f.kind == "crash"]
    assert len(crashes) == 4
    assert all(35.0 <= f.t_s <= 65.0 for f in crashes)
    return [_specs(a), _specs(c)]


def _stall_keeps_modeled_time(ns):
    clk = {"t": 0.0}
    eng = ns.SimEngine(_profile(ns), _outcome, clock=lambda: clk["t"])
    inj = ns.FaultInjector(eng, [ns.FaultSpec(t_s=0.0, kind="stall",
                                              duration_s=5.0)],
                           clock=lambda: clk["t"])
    t0 = inj.modeled_time_s()
    assert inj.step() == []
    assert inj.stats["stall_steps"] == 1
    assert inj.modeled_time_s() > t0       # the stalled tick still costs
    return [inj.modeled_time_s(), dict(inj.stats)]


def _garbage_corrupts(ns):
    clk = {"t": 0.0}
    eng = ns.SimEngine(_profile(ns), _outcome, clock=lambda: clk["t"])
    inj = ns.FaultInjector(eng, [ns.FaultSpec(t_s=0.0, kind="garbage",
                                              duration_s=1e9)],
                           clock=lambda: clk["t"])
    inj.submit(ns.Request(query=ns.Query(uid=0, text="q"),
                          prompt_tokens=[1, 2], max_new_tokens=2))
    out = []
    for _ in range(10):
        out += inj.step()
        if out:
            break
    assert out and out[0].corrupt
    assert out[0].tokens == [] and out[0].accuracy == 0.0
    assert out[0].energy_wh > 0.0          # the joules really happened
    assert inj.stats["garbage"] == 1
    assert inj.cumulative_joules() > 0.0   # delegation to the inner
    return [out[0].energy_wh, out[0].prefill_wh, inj.cumulative_joules(),
            dict(inj.stats)]


def _chaos_fingerprint(ns):
    a = ns.chaos(per_task=2, seed=0, targets=("qwen2.5-7b",))
    b = ns.chaos(per_task=2, seed=0, targets=("qwen2.5-7b",))
    assert a.fingerprint() == b.fingerprint()
    assert a.faults and "qwen2.5-7b" in a.faults
    c = ns.chaos(per_task=2, seed=0, targets=("qwen2.5-7b",), n_crashes=2)
    assert a.fingerprint() != c.fingerprint()   # schedule is hashed
    return [a.fingerprint(), c.fingerprint(), _specs(a.faults)]


@pytest.mark.parametrize("case", [
    _fault_spec_validation, _fault_storm_deterministic,
    _stall_keeps_modeled_time, _garbage_corrupts, _chaos_fingerprint],
    ids=lambda c: c.__name__.strip("_"))
def test_fault_injection(case):
    _both(case)


# ---------------------------------------------------------------------------
# scheduler integration: deadlines, retries, terminal failure
# ---------------------------------------------------------------------------


def _server(ns, n=2, clk=None, telemetry=None, steps_per_query=1, **kw):
    """A small sim pool on a shared virtual clock the case advances."""
    clk = clk if clk is not None else {"t": 0.0}
    clock = lambda: clk["t"]  # noqa: E731
    profiles = [_profile(ns, f"sim{i}", params_b=i + 1.0) for i in range(n)]
    engines = {p.name: ns.SimEngine(p, _outcome, clock=clock,
                                    steps_per_query=steps_per_query)
               for p in profiles}
    router = ns.Router(ns.RouterConfig(lam=0.4, max_arms=8),
                       ns.ModelPool(profiles), **ns.router_kw)
    server = ns.PoolServer(router, engines, clock=clock, telemetry=telemetry,
                           **kw)
    return server, engines, clk


def _record(server) -> dict:
    """The scheduler's order-dependent state, as both packages fill it."""
    return {"stats": dict(server.stats),
            "dispatch_counts": dict(server.dispatch_counts),
            "failed": {uid: [r.state.value, r.attempts, r.model_name]
                       for uid, r in server.failed.items()},
            "responses": {uid: [r.model_name, r.energy_wh,
                                bool(getattr(r, "corrupt", False))]
                          for uid, r in server.responses.items()},
            "parked": [[due, req.uid, arm]
                       for due, req, arm in server._retry_parked],
            "breakers": {n: [b.state, b.n_opens, b.failure_rate()]
                         for n, b in server.breakers.items()}}


def _deadline_expires(ns):
    clk = {"t": 0.0}
    server, engines, _ = _server(
        ns, n=1, clk=clk, steps_per_query=10_000,  # never finishes in time
        deadline_s=1.0, max_retries=0,
        telemetry=ns.Telemetry(clock=lambda: clk["t"]))
    req = server.submit(ns.Query(uid=0, text="slow one"))
    assert req.deadline_s == 1.0
    server.step()
    assert not server.failed               # deadline not passed yet
    clk["t"] = 2.0
    server.step()
    assert server.failed[0].state is ns.RequestState.TIMED_OUT
    assert 0 not in server.inflight
    assert server.stats["timeouts"] == 1
    assert server.stats["slo_violations"] == 1
    # the engine still held the request; defunct work is dropped on sight
    server.step()
    assert engines["sim0"].pending == 0
    assert set(server.responses) | set(server.failed) == {0}
    text = ns.to_prometheus(server.telemetry.registry)
    assert "greenserv_timeouts_total 1" in text
    assert "greenserv_slo_violations_total 1" in text
    return [_record(server), text]


def _retry_reroutes(ns):
    server, engines, clk = _server(
        ns, n=2, steps_per_query=3, max_retries=2, retry_backoff_steps=1,
        breaker_config=ns.BreakerConfig(window=4, min_samples=1,
                                        failure_threshold=0.5,
                                        open_steps=50))
    tel = ns.Telemetry(clock=lambda: clk["t"])
    server.telemetry = tel
    req = server.submit(ns.Query(uid=0, text="route me"))
    first_arm = req.model_name
    engines[first_arm].inject_failure()
    # crash -> restart -> failure recorded -> parked for backoff
    server.step()
    assert server.stats["restarts"] == 1
    assert req.attempts == 1
    assert 0 in server.inflight            # parked retries stay visible
    for _ in range(30):
        server.step()
        clk["t"] += 0.1
        if server.responses:
            break
    assert 0 in server.responses
    assert req.model_name != first_arm     # blocked veto re-routed it
    assert server.stats["retries"] == 1
    assert server.breakers[first_arm].failure_rate() > 0.0
    text = ns.to_prometheus(tel.registry)
    assert "greenserv_retries_total 1" in text
    assert (f'greenserv_attempt_failures_total{{engine="{first_arm}"}} 1'
            in text)
    return [first_arm, _record(server), text]


def _corrupt_retries(ns):
    server, engines, clk = _server(
        ns, n=2, steps_per_query=2, max_retries=2, retry_backoff_steps=1,
        breaker_config=ns.BreakerConfig(window=4, min_samples=1,
                                        failure_threshold=0.5,
                                        open_steps=50))
    req = server.submit(ns.Query(uid=0, text="poisoned arm"))
    bad = req.model_name
    server.engines[bad] = ns.FaultInjector(
        engines[bad], [ns.FaultSpec(t_s=0.0, kind="garbage",
                                    duration_s=1e9)],
        clock=server.clock)
    for _ in range(30):
        server.step()
        clk["t"] += 0.1
        if server.responses:
            break
    resp = server.responses[0]
    assert not getattr(resp, "corrupt", False)
    assert resp.model_name != bad
    assert server.stats["retries"] >= 1
    # the poisoned arm's breaker saw the garbage as a failure
    assert (server.breakers[bad].failure_rate() > 0.0
            or server.breakers[bad].state != ns.CLOSED)
    return [bad, _record(server)]


def _reliability_off(ns):
    server, engines, clk = _server(ns, n=1, steps_per_query=2)
    req = server.submit(ns.Query(uid=0, text="no retries"))
    server.engines[req.model_name] = ns.FaultInjector(
        engines[req.model_name],
        [ns.FaultSpec(t_s=0.0, kind="garbage", duration_s=1e9)],
        clock=server.clock)
    for _ in range(10):
        server.step()
        clk["t"] += 0.1
        if server.responses:
            break
    assert server.responses[0].corrupt     # served, degraded — not lost
    assert server.responses[0].accuracy == 0.0
    assert not server.failed and server.stats["retries"] == 0
    return _record(server)


def _attempts_exhausted(ns):
    clk = {"t": 0.0}
    tel = ns.Telemetry(clock=lambda: clk["t"])
    server, engines, _ = _server(
        ns, n=2, clk=clk, steps_per_query=2, max_retries=1,
        retry_backoff_steps=1, telemetry=tel,
        breaker_config=ns.BreakerConfig(window=8, min_samples=2,
                                        failure_threshold=0.5,
                                        open_steps=4))
    for name, eng in list(engines.items()):   # every arm serves garbage
        server.engines[name] = ns.FaultInjector(
            eng, [ns.FaultSpec(t_s=0.0, kind="garbage", duration_s=1e9)],
            clock=server.clock)
    server.submit(ns.Query(uid=0, text="doomed"))
    for _ in range(40):
        server.step()
        clk["t"] += 0.1
        if server.failed:
            break
    assert server.failed[0].state is ns.RequestState.FAILED
    assert server.failed[0].attempts == 2     # initial + 1 retry
    assert server.stats["failed"] == 1
    assert set(server.responses) | set(server.failed) == {0}
    text = ns.to_prometheus(tel.registry)
    assert "greenserv_failed_total 1" in text
    assert "greenserv_breaker_transitions_total" in text
    return [_record(server), text]


def _counters_prebound(ns):
    text = ns.to_prometheus(ns.Telemetry().registry)
    for name in ("greenserv_retries_total", "greenserv_timeouts_total",
                 "greenserv_failed_total", "greenserv_slo_violations_total",
                 "greenserv_breaker_transitions_total"):
        assert f"{name} 0" in text
    return text


def _hedge_health_guard(ns):
    server, engines, clk = _server(
        ns, n=3, steps_per_query=1_000, hedge_after_steps=1,
        breaker_config=ns.BreakerConfig(window=4, min_samples=1,
                                        failure_threshold=0.5,
                                        open_steps=999))
    clk["t"] = 100.0
    for eng in engines.values():
        eng._last_step_s = 100.0           # all fresh at t=100
    req1 = server.submit(ns.Query(uid=0, text="first, occupies the slot"))
    req2 = server.submit(ns.Query(uid=1, text="second, stuck QUEUED"))
    # force both onto one arm so uid 1 genuinely queues behind uid 0
    arm = req1.model_name
    if req2.model_name != arm:
        for eng in engines.values():
            eng.queue = [r for r in eng.queue if r.uid != 1]
        engines[arm].submit(req2)
    others = [n for n in engines if n != arm]
    server.breakers[others[0]].record_failure(0)           # OPEN
    engines[others[1]]._last_step_s = 0.0                  # stale
    assert server.breakers[others[0]].state == ns.OPEN
    assert not server._engine_healthy(others[1], engines[others[1]])
    server.wait_steps[1] = 5               # straggling well past the bar
    server.stats["restarts"] = 0
    server._maybe_hedge()
    assert server.stats["hedges"] == 0     # nowhere healthy to hedge to
    # heal the stale engine: it becomes the only eligible target
    engines[others[1]]._last_step_s = clk["t"]
    server._maybe_hedge()
    assert server.stats["hedges"] == 1
    assert server.hedges[1].model_name == others[1]
    return [arm, others, _record(server)]


def _governor_cancel_idempotent(ns):
    gov = ns.EnergyBudgetGovernor(10.0, horizon_queries=100)
    gov.on_admission(1, predicted=[(7, 0.5)])
    assert gov.inflight_predicted_wh == pytest.approx(0.5)
    # retry re-admission REPLACES the uid's charge, never stacks it
    gov.on_admission(0, predicted=[(7, 0.8)])
    assert gov.inflight_predicted_wh == pytest.approx(0.8)
    gov.on_cancel(7)
    assert gov.inflight_predicted_wh == 0.0
    assert gov.inflight_pred == {}
    gov.on_cancel(7)                       # second release: a no-op
    assert gov.inflight_predicted_wh == 0.0
    gov.on_cancel(12345)                   # never-predicted uid: a no-op
    assert gov.inflight_predicted_wh == 0.0
    return gov.stats()


def _timeout_after_retry(ns):
    clk = {"t": 0.0}
    gov = ns.EnergyBudgetGovernor(10.0, horizon_queries=100)
    tel = ns.Telemetry(governor=gov, clock=lambda: clk["t"])
    server, engines, _ = _server(
        ns, n=2, clk=clk, steps_per_query=10_000, telemetry=tel,
        cost_model=ns.EnergyCostModel(), deadline_s=2.0, max_retries=2,
        retry_backoff_steps=1)
    req = server.submit(ns.Query(uid=0, text="will time out after a retry"))
    assert 0 in gov.inflight_pred          # admission predicted a charge
    charges = [gov.inflight_predicted_wh]
    engines[req.model_name].inject_failure()
    server.step()                          # crash -> parked retry
    clk["t"] += 0.1
    server.step()                          # backoff elapsed -> re-admitted
    assert server.stats["retries"] == 1
    assert 0 in gov.inflight_pred          # replaced, still exactly one
    charges.append(gov.inflight_predicted_wh)
    assert charges[-1] >= 0.0
    clk["t"] = 5.0                         # blow the end-to-end deadline
    server.step()
    assert server.failed[0].state is ns.RequestState.TIMED_OUT
    assert gov.inflight_pred == {}         # released exactly once
    assert gov.inflight_predicted_wh == 0.0
    tel.on_cancelled(0)                    # stray second release: no-op
    assert gov.inflight_predicted_wh == 0.0
    return [charges, _record(server)]


def _livelock_snapshot(ns):
    server, _, _ = _server(ns, n=2, steps_per_query=10**6,
                           deadline_s=0.0, max_retries=1,
                           breaker_config=ns.BreakerConfig())
    server.submit(ns.Query(uid=0, text="never finishes"))
    with pytest.raises(ns.LivelockError) as err:
        server.run_until_drained(max_steps=3)
    msg = str(err.value)
    assert "still in flight" in msg
    assert "retry-parked" in msg           # the reliability ledger
    assert "sim0" in msg and "breaker" in msg
    return msg


def _disagg_kill_cycles(ns):
    """Kill the prefill engine AND its decode twin in the same window,
    twice, mid-traffic: every request still completes, hedge bookkeeping
    is clear, and the governor's in-flight ledger balances to zero."""
    arch = "granite-3-8b"
    jparams, model = _weights(arch)
    kw = dict(max_batch=2, max_len=48, prefill_chunk=4)
    if ns is JAX:
        cfg, key = jax_get_config(arch, **F32), jax.random.PRNGKey(0)
        eng = ns.ModelEngine(arch, cfg, key, params=jparams, **kw)
        twin = ns.ModelEngine(arch, cfg, key, params=eng.params,
                              role="decode", **kw)
    else:
        cfg = get_config(arch, **F32)
        eng = ns.ModelEngine(arch, cfg, params=model, device="cpu", **kw)
        twin = ns.ModelEngine(arch, cfg, params=eng.params, role="decode",
                              device="cpu", **kw)
    gov = ns.EnergyBudgetGovernor(50.0, horizon_queries=100)
    router = ns.Router(ns.RouterConfig(lam=0.4, energy_scale_wh=0.05),
                       ns.ModelPool([eng.profile]), **ns.router_kw)
    server = ns.PoolServer(router, {eng.name: eng}, tokenizer=ns.encode,
                           prefill_chunk=4, decode_engines={eng.name: twin},
                           telemetry=ns.Telemetry(governor=gov),
                           hedge_after_steps=2)
    rng = np.random.default_rng(0)
    n = 6
    for i in range(n):
        server.submit(ns.Query(uid=i, text=f"probe {i} " + "ctx " * int(
            rng.integers(1, 6)), max_new_tokens=int(rng.integers(2, 5))))
    kill_at = {4, 12}                      # two full kill cycles
    for step in range(600):
        if step in kill_at:
            eng.inject_failure()
            twin.inject_failure()
        server.step()
        if len(server.responses) == n:
            break
    assert set(server.responses) == set(range(n))   # nothing lost
    assert not server.failed
    assert server.stats["restarts"] >= 4   # both roles, both cycles
    assert not server.hedges               # hedge bookkeeping cleared
    assert gov.inflight_pred == {}         # governor ledger balanced
    assert gov.inflight_predicted_wh == 0.0
    return [_record(server), {uid: list(r.tokens)
                              for uid, r in server.responses.items()}]


@pytest.mark.parametrize("case", [
    _deadline_expires, _retry_reroutes, _corrupt_retries, _reliability_off,
    _attempts_exhausted, _counters_prebound, _hedge_health_guard,
    _governor_cancel_idempotent, _timeout_after_retry, _livelock_snapshot],
    ids=lambda c: c.__name__.strip("_"))
def test_scheduler(case):
    _both(case)


def test_disagg_survives_repeated_prefill_and_twin_kill_cycles(
        equal_energy_constants):
    _both(_disagg_kill_cycles)


# ---------------------------------------------------------------------------
# the chaos bench
# ---------------------------------------------------------------------------


def test_chaos_main_matches_jax(tmp_path):
    """``chaos.main(per_task=20)`` at both packages' defaults, the fleet
    variant included, holds its seven invariants and writes the JAX
    package's lines and artifact: the calibrated storm targets, the three
    runs' records (the fleet's events and trajectory among them) and the
    headline (goodput, terminal fraction, storm shares)."""
    want_path, got_path = tmp_path / "jax.json", tmp_path / "port.json"
    want_lines = jax_chaos.main(per_task=20, artifact=str(want_path))
    got_lines = chaos.main(per_task=20, artifact=str(got_path),
                           device="cpu")
    assert got_lines[:-1] == want_lines[:-1]      # all but the path line
    assert got_lines[-2].startswith("fleet,80/80,0,")
    want = json.loads(want_path.read_text())
    got = json.loads(got_path.read_text())
    assert got["runs"]["reliability"]["stats"]["breaker_opens"] >= 1
    assert_close(got, want, 1e-12)


@pytest.mark.parametrize("n", [24, 80])
def test_run_fleet_chaos_matches_jax(n):
    """The fleet variant alone — three shards, shard 0's engines in the
    storm, shard 2 killed at 40% of the arrivals — gives the JAX
    package's record: counts, the controller's stats, the fail-over
    event and the trajectory (floats 1e-9)."""
    want = jax_chaos.run_fleet_chaos(n=n)
    got = chaos.run_fleet_chaos(n=n, device="cpu")
    assert got["completed"] + got["failed"] == got["n_queries"]
    assert got["stats"]["failovers"] == 1
    assert_close(json.loads(json.dumps(got)), json.loads(json.dumps(want)),
                 1e-9)
