"""Telemetry and the energy-budget governor in the port on the CPU
against the JAX package: the 24 cases of ``tests/test_telemetry.py``
through both packages — P² quantiles equal on the same stream, Prometheus
text equal for equal registries, JSONL written by one package read by the
other's ``load_jsonl``, the governor's mechanics with the same λ calls,
``set_lambda``'s re-scalarization, ``SimEngine`` concurrency, the hedge
duplicate's charge, the phase split — then the governed paper pool at
T = 150 through ``drive_pool_stream`` with the same λ history, arms and
Wh, the reference's 1,000-query cap case on the port alone, a whole
served run on a virtual clock with equal exports, GreenCache's
avoided-energy credit (``tests/test_cache.py``'s governor case, its
telemetry checks, and the cache workload with the governor in the loop),
and ``PoolServer``'s injectable clock in the JAX package's position.

Past ~150 queries LinUCB's trace can leave the JAX package's at a near
tie (A⁻¹ rounds one ulp apart), and the governor's λ feeds back through
``set_lambda``; so the T = 1,000 cap case holds the reference's
assertions on the port alone."""
import inspect
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.costmodel as jax_costmodel
import repro.telemetry as jax_telemetry
from benchmarks import common as jax_common
from repro.cache import GreenCache as JaxGreenCache
from repro.configs import get_config as jax_get_config
from repro.configs import pool as jax_pool
from repro.configs.pool import PAPER_POOL
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Feedback as JaxFeedback
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data import OutcomeSimulator as JaxOutcomeSimulator
from repro.data import tokenizer as jax_tok
from repro.data.stream import make_stream as jax_make_stream
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro.serving import Request as JaxRequest
from repro.serving import SimEngine as JaxSimEngine
import repro_torch.costmodel as port_costmodel
import repro_torch.telemetry as port_telemetry
from repro_torch.benchmarks import cache as cache_bench
from repro_torch.benchmarks import common
from repro_torch.cache import GreenCache
from repro_torch.configs import get_config
from repro_torch.configs import pool as port_pool
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query, RouterConfig
from repro_torch.data import OutcomeSimulator
from repro_torch.data import tokenizer as tok
from repro_torch.data.stream import make_stream
from repro_torch.serving import ModelEngine, PoolServer, Request, SimEngine
from test_torch_costmodel import (  # noqa: F401
    EXACT, F32, _assert_same_forecasts, _params, assert_close,
    one_torch_thread)
from test_torch_serving import equal_energy_constants  # noqa: F401

pytestmark = pytest.mark.port

PACKAGES = {
    "jax": types.SimpleNamespace(
        tel=jax_telemetry, Router=JaxRouter, RouterConfig=JaxRouterConfig,
        ModelPool=JaxModelPool, ModelProfile=JaxModelProfile,
        Query=JaxQuery, Feedback=JaxFeedback, Request=JaxRequest,
        SimEngine=JaxSimEngine, PoolServer=JaxPoolServer,
        GreenCache=JaxGreenCache, Sim=JaxOutcomeSimulator,
        EnergyCostModel=jax_costmodel.EnergyCostModel,
        make_stream=jax_make_stream, encode=jax_tok.encode, router_kw={},
        state=lambda t: np.asarray(t)),
    "port": types.SimpleNamespace(
        tel=port_telemetry, Router=GreenServRouter, RouterConfig=RouterConfig,
        ModelPool=ModelPool, ModelProfile=ModelProfile, Query=Query,
        Feedback=Feedback, Request=Request, SimEngine=SimEngine,
        PoolServer=PoolServer, GreenCache=GreenCache, Sim=OutcomeSimulator,
        EnergyCostModel=port_costmodel.EnergyCostModel,
        make_stream=make_stream, encode=tok.encode,
        router_kw=dict(device="cpu"),
        state=lambda t: t.cpu().numpy()),
}
JAX, PORT = PACKAGES["jax"], PACKAGES["port"]


def _both(case, *args, **kwargs):
    return (case(JAX, *args, **kwargs), case(PORT, *args, **kwargs))


# ---------------------------------------------------------------------------
# metrics primitives
# ---------------------------------------------------------------------------


def _counter_and_gauge(ns):
    r = ns.tel.MetricsRegistry()
    c = r.counter("requests_total", {"model": "a"})
    c.inc()
    c.inc(2.5)
    assert c.value == pytest.approx(3.5)
    g = r.gauge("queue_depth")
    g.set(7)
    assert g.value == 7.0
    return ns.tel.to_prometheus(r)


def test_counter_and_gauge():
    want, got = _both(_counter_and_gauge)
    assert got == want


def _registry_identity(ns):
    r = ns.tel.MetricsRegistry()
    assert r.counter("x", {"m": "1"}) is r.counter("x", {"m": "1"})
    assert r.counter("x", {"m": "1"}) is not r.counter("x", {"m": "2"})
    with pytest.raises(TypeError):
        r.gauge("x", {"m": "1"})    # same name+labels, different kind
    return len(r)


def test_registry_get_or_create_identity():
    want, got = _both(_registry_identity)
    assert got == want == 2


def _p2(ns):
    rng = np.random.default_rng(0)
    data = rng.lognormal(3.0, 0.7, size=5000)
    out = {}
    for q in (0.5, 0.95, 0.99):
        est = ns.tel.P2Quantile(q)
        for x in data:
            est.update(x)
        assert est.value == pytest.approx(np.percentile(data, 100 * q),
                                          rel=0.12)
        out[q] = (est.value, list(est.heights), list(est.positions))
    return out


def test_p2_quantile_approximates_numpy():
    """The same stream gives the same markers in both, bit for bit."""
    want, got = _both(_p2)
    assert got == want


@pytest.mark.parametrize("dist", ["lognormal", "ties", "constant"])
def test_p2_batched_updates_equal_jax(dist):
    """The port folds a histogram's observations into its estimators in
    batches (``P2Quantile.update_many``, once a scheduler step): over
    batches of every size from 0 to 40, with ties and a constant stream,
    the markers equal the JAX package's one-at-a-time updates bit for
    bit, and so does a histogram's export read mid-stream."""
    rng = np.random.default_rng(3)
    data = {"lognormal": rng.lognormal(3.0, 0.7, size=4000),
            "ties": rng.integers(0, 4, size=4000).astype(float),
            "constant": np.full(400, 7.0)}[dist]
    for q in (0.1, 0.5, 0.95, 0.99):
        want, got = JAX.tel.P2Quantile(q), PORT.tel.P2Quantile(q)
        for x in data:
            want.update(x)
        i = 0
        while i < len(data):
            n = int(rng.integers(0, 41))
            got.update_many(data[i:i + n])
            i += n
        assert (got.n, got.heights, got.positions) == (
            want.n, want.heights, want.positions)
    regs = [ns.tel.MetricsRegistry() for ns in (JAX, PORT)]
    hists = [r.histogram("latency_ms") for r in regs]
    for i, x in enumerate(data[:1500]):
        for h in hists:
            h.record(x)
        if i % 97 == 0:
            assert hists[1].quantiles == hists[0].quantiles
    assert PORT.tel.to_prometheus(regs[1]) == JAX.tel.to_prometheus(regs[0])


def test_on_step_folds_every_histogram_of_its_registry():
    """``Telemetry.on_step`` folds the pending observations of every
    histogram its registry holds, the hub's own and any other made on the
    same registry, so no P² work is left for the export reads, which lie
    outside the timed hooks."""
    tel = PORT.tel.Telemetry()
    other = tel.registry.histogram("greenserv_other_ms")
    other.record(3.0)
    tel._latency.record(5.0)
    assert other._pending and tel._latency._pending
    tel.on_step({})
    hists = [m for m in tel.registry if m.kind == "histogram"]
    assert other in hists and len(hists) >= 5
    assert not any(h._pending for h in hists)
    assert (other.quantile(0.5), tel._latency.quantile(0.5)) == (3.0, 5.0)


def _histogram(ns):
    r = ns.tel.MetricsRegistry()
    h = r.histogram("latency_ms")
    for v in [1.0, 2.0, 3.0, 4.0, 100.0]:
        h.record(v)
    assert h.count == 5
    assert h.sum == pytest.approx(110.0)
    assert h.min == 1.0 and h.max == 100.0
    assert h.mean == pytest.approx(22.0)
    assert 1.0 <= h.quantile(0.5) <= 4.0
    return h.quantiles, ns.tel.to_prometheus(r)


def test_histogram_summary_stats():
    want, got = _both(_histogram)
    assert got == want


class TestPowerTrace:
    @staticmethod
    def _watts(ns):
        tr = ns.tel.PowerTrace()
        for i, t in enumerate([0.0, 2.0, 4.0, 6.0]):
            tr.sample_all(t, {"a": 10.0 * i, "b": 10.0 * i})
        assert tr.last_watts("a") == pytest.approx(5.0)
        assert tr.last_watts() == pytest.approx(10.0)      # pool
        assert tr.peak_watts() == pytest.approx(10.0)
        assert tr.avg_watts() == pytest.approx(10.0)
        assert tr.total_wh() == pytest.approx(60.0 / 3600.0)
        return list(tr.to_rows())

    def test_watts_from_joule_deltas(self):
        want, got = _both(self._watts)
        assert got == want

    @staticmethod
    def _non_monotone(ns):
        tr = ns.tel.PowerTrace()
        tr.sample("a", 1.0, 0.0)
        tr.sample("a", 1.0, 5.0)      # same timestamp: folded, not crashed
        tr.sample("a", 2.0, 10.0)
        assert tr.last_watts("a") == pytest.approx(10.0)
        return list(tr.to_rows())

    def test_non_monotone_clock_does_not_divide_by_zero(self):
        want, got = _both(self._non_monotone)
        assert got == want


# ---------------------------------------------------------------------------
# export round-trips, across the packages
# ---------------------------------------------------------------------------


def _recorded(ns):
    r = ns.tel.MetricsRegistry()
    r.counter("greenserv_completed_total", {"model": "m1"},
              help="completions").inc(41)
    r.gauge("greenserv_lambda").set(0.62)
    h = r.histogram("greenserv_latency_ms", {"model": "m1"})
    for v in np.linspace(5.0, 500.0, 200):
        h.record(float(v))
    tr = ns.tel.PowerTrace()
    for i, t in enumerate([0.0, 1.0, 2.0]):
        tr.sample_all(t, {"eng": 36.0 * i})
    ev = ns.tel.EventLog()
    ev.emit("restart", 1.5, engine="eng", n_requeued=3)
    return r, tr, ev


def _prometheus(ns):
    r, _, _ = _recorded(ns)
    text = ns.tel.to_prometheus(r)
    parsed = ns.tel.parse_prometheus(text)
    assert parsed[("greenserv_completed_total", (("model", "m1"),))] == 41.0
    assert parsed[("greenserv_lambda", ())] == pytest.approx(0.62)
    h = r.find("greenserv_latency_ms", {"model": "m1"})
    key = ("greenserv_latency_ms",
           tuple(sorted((("model", "m1"), ("quantile", "0.5")))))
    assert parsed[key] == pytest.approx(h.quantile(0.5))
    assert parsed[("greenserv_latency_ms_count", (("model", "m1"),))] == 200
    return text, parsed


def test_prometheus_round_trip():
    """Equal registries render to equal text, and each package parses
    the other's."""
    (jtext, jparsed), (ptext, pparsed) = _both(_prometheus)
    assert ptext == jtext
    assert PORT.tel.parse_prometheus(jtext) == jparsed == pparsed
    assert JAX.tel.parse_prometheus(ptext) == pparsed


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_jsonl_round_trip(tmp_path, writer, reader):
    w, rd = PACKAGES[writer], PACKAGES[reader]
    r, tr, ev = _recorded(w)
    path = str(tmp_path / "metrics.jsonl")
    assert w.tel.dump_jsonl(path, r, tr, ev, meta={"run": "test"}) > 0
    back = rd.tel.load_jsonl(path)
    assert back["meta"][0]["run"] == "test"
    counters = {(row["name"], tuple(sorted(row["labels"].items()))): row
                for row in back["counter"]}
    assert counters[("greenserv_completed_total",
                     (("model", "m1"),))]["value"] == 41.0
    hist = back["histogram"][0]
    h = r.find("greenserv_latency_ms", {"model": "m1"})
    assert hist["count"] == h.count
    assert hist["sum"] == pytest.approx(h.sum)
    assert hist["quantiles"]["0.5"] == pytest.approx(h.quantile(0.5))
    pool_rows = [row for row in back["power"] if row["source"] == "__pool__"]
    assert [r_["watts"] for r_ in pool_rows] == pytest.approx(
        [s.watts for s in tr.series()])
    assert back["event"][0]["engine"] == "eng"
    # and the reader's own dump of the same records reads back equal
    r2, tr2, ev2 = _recorded(rd)
    path2 = str(tmp_path / "own.jsonl")
    rd.tel.dump_jsonl(path2, r2, tr2, ev2, meta={"run": "test"})
    assert rd.tel.load_jsonl(path2) == back


# ---------------------------------------------------------------------------
# governor mechanics (unit level), both packages against one λ trail
# ---------------------------------------------------------------------------


class _RouterStub:
    def __init__(self, ns, lam=0.4):
        self.config = ns.RouterConfig(lam=lam)
        self.calls = []

    def set_lambda(self, lam):
        self.config.lam = lam
        self.calls.append(lam)


def _governed(ns, case):
    router = _RouterStub(ns)
    gov = case(ns, router)
    return router.calls, gov.lambda_history, gov.stats()


def _assert_same_governed(case):
    (jcalls, jhist, jstats), (pcalls, phist, pstats) = _both(_governed, case)
    assert pcalls == jcalls and phist == jhist
    assert_close(pstats, jstats)
    return pcalls


def test_requires_exactly_one_horizon():
    for ns in (JAX, PORT):
        with pytest.raises(ValueError):
            ns.tel.EnergyBudgetGovernor(1.0)
        with pytest.raises(ValueError):
            ns.tel.EnergyBudgetGovernor(1.0, horizon_queries=10,
                                        horizon_s=10.0)


def _overburn(ns, router):
    gov = ns.tel.EnergyBudgetGovernor(1.0, horizon_queries=100, router=router)
    for i in range(30):                       # 10× the sustainable rate
        gov.on_completion(0.1, t_s=float(i))
    assert router.config.lam > 0.4
    assert gov.pressure > 0.5
    return gov


def test_overburn_tightens_lambda():
    assert _assert_same_governed(_overburn)


def _underburn(ns, router):
    gov = ns.tel.EnergyBudgetGovernor(10.0, horizon_queries=100,
                                      router=router)
    for i in range(20):
        gov.on_completion(0.2, t_s=float(i))  # hot: 2× sustainable
    tight = router.config.lam
    assert tight > 0.4
    assert not gov.exhausted
    for i in range(20, 60):
        gov.on_completion(0.001, t_s=float(i))  # cold: 1% of rate
    assert router.config.lam < tight
    return gov


def test_underburn_relaxes_lambda_back():
    assert _assert_same_governed(_underburn)


def _exhaustion(ns, router):
    gov = ns.tel.EnergyBudgetGovernor(1.0, horizon_queries=1000,
                                      router=router, lambda_max=0.85)
    for i in range(10):
        gov.on_completion(0.12, t_s=float(i))  # blows the whole budget
    assert gov.exhausted
    assert router.config.lam == pytest.approx(0.85)
    return gov


def test_exhaustion_pins_lambda_max():
    assert _assert_same_governed(_exhaustion)


def _wall_clock(ns, router):
    gov = ns.tel.EnergyBudgetGovernor(3600.0, horizon_s=3600.0,
                                      router=router)
    gov.step(0.0)
    gov.on_completion(50.0, t_s=1.0)          # drain far below refill
    gov.step(1.0)
    drained = gov.bucket_wh
    gov.step(100.0)                           # 99 s of ~1 Wh/s refill
    assert gov.bucket_wh > drained
    return gov


def test_wall_clock_refill():
    _assert_same_governed(_wall_clock)


def _carbon(ns):
    dirty = ns.tel.EnergyBudgetGovernor(100.0, horizon_queries=100,
                                        carbon_fn=lambda t: 2.0)
    clean = ns.tel.EnergyBudgetGovernor(100.0, horizon_queries=100,
                                        carbon_fn=lambda t: 0.5)
    for gov in (dirty, clean):
        gov.bucket_wh = 0.0
        gov.on_completion(0.0, t_s=0.0)
    assert dirty.bucket_wh < clean.bucket_wh
    return dirty.bucket_wh, clean.bucket_wh


def test_carbon_signal_scales_refill():
    want, got = _both(_carbon)
    assert got == want


def _diurnal(ns):
    period = 86_400.0
    vals = [ns.tel.diurnal_carbon_intensity(t, period_s=period)
            for t in np.linspace(0, period, 97)]
    assert max(vals) > 1.2 and min(vals) < 0.8
    assert np.mean(vals) == pytest.approx(1.0, abs=0.02)
    return vals


def test_diurnal_carbon_intensity_cycles():
    want, got = _both(_diurnal)
    assert got == want


# ---------------------------------------------------------------------------
# set_lambda re-scalarization (the governor's actuator), both routers
# ---------------------------------------------------------------------------


def _posterior_shift(ns):
    profiles = [ns.ModelProfile(name="cheap", family="s", params_b=1.0),
                ns.ModelProfile(name="lux", family="s", params_b=30.0)]
    pool = ns.ModelPool(profiles)
    router = ns.Router(ns.RouterConfig(lam=0.1, energy_scale_wh=0.05,
                                       max_arms=4, alpha_ucb=0.01), pool,
                       **ns.router_kw)
    q = [ns.Query(uid=i, text=f"question number {i} about physics")
         for i in range(40)]
    outcomes = {"cheap": (0.5, 0.01), "lux": (0.9, 0.09)}
    for i, query in enumerate(q):
        arm = i % 2                           # force both arms to learn
        d = router.route(query)
        name = pool[arm].name
        acc, e = outcomes[name]
        router._pending[query.uid] = d.__class__(
            query_uid=query.uid, model_index=arm, model_name=name,
            context=d.context, ucb_scores=d.ucb_scores,
            feasible_mask=d.feasible_mask, overhead_ms=0.0)
        router.feedback(ns.Feedback(query_uid=query.uid, model_index=arm,
                                    accuracy=acc, energy_wh=e,
                                    latency_ms=1.0))
    probe = ns.Query(uid=999, text="a fresh probe question about physics")
    assert router.route(probe).model_name == "lux"    # λ=0.1: accuracy
    router.set_lambda(0.9)
    probe2 = ns.Query(uid=1000, text="a fresh probe question about physics")
    assert router.route(probe2).model_name == "cheap"  # λ=0.9: energy
    return ns.state(router.policy.state.b)


def test_posterior_shifts_without_new_feedback():
    want, got = _both(_posterior_shift)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _legacy_checkpoint(ns):
    pool = ns.ModelPool([ns.ModelProfile(name="m", family="s", params_b=1.0)])
    router = ns.Router(ns.RouterConfig(lam=0.4, max_arms=2), pool,
                       **ns.router_kw)
    router.route(ns.Query(uid=1, text="warm the posterior with one "
                          "observation"))
    router.feedback(ns.Feedback(query_uid=1, model_index=0, accuracy=0.8,
                                energy_wh=0.02, latency_ms=1.0))
    sd = router.state_dict()
    del sd["decomposed"]                      # pre-decomposition era
    pool2 = ns.ModelPool([ns.ModelProfile(name="m", family="s",
                                          params_b=1.0)])
    restored = ns.Router(ns.RouterConfig(lam=0.4, max_arms=2), pool2,
                         **ns.router_kw)
    restored.load_state_dict(sd)
    b_before = ns.state(restored.policy.state.b).copy()
    assert np.any(b_before != 0.0)
    restored.set_lambda(0.9)
    assert restored.config.lam == 0.9
    np.testing.assert_array_equal(ns.state(restored.policy.state.b),
                                  b_before)
    return b_before


def test_set_lambda_after_legacy_checkpoint_keeps_posterior():
    want, got = _both(_legacy_checkpoint)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_set_lambda_validates_and_updates_rewards():
    for ns in (JAX, PORT):
        pool = ns.ModelPool([ns.ModelProfile(name="m", family="s",
                                             params_b=1.0)])
        router = ns.Router(ns.RouterConfig(lam=0.4, max_arms=2), pool,
                           **ns.router_kw)
        with pytest.raises(ValueError):
            router.set_lambda(1.5)
        router.set_lambda(0.7)
        assert router.config.lam == 0.7
        assert router.rewards.config.lam == 0.7   # shared config object


# ---------------------------------------------------------------------------
# SimEngine concurrency
# ---------------------------------------------------------------------------


def _sim_engine(ns, concurrency, steps_per_query=1, n=10):
    prof = ns.ModelProfile(name="sim", family="s", params_b=1.0)
    eng = ns.SimEngine(prof, lambda q, m: (1.0, 0.001, 1.0, 4),
                       steps_per_query=steps_per_query,
                       concurrency=concurrency)
    for i in range(n):
        eng.submit(ns.Request(query=ns.Query(uid=i, text=f"q{i}"),
                              prompt_tokens=[1, 2], max_new_tokens=4))
    return eng


def _trail(ns, concurrency, steps_per_query, n, ticks):
    eng = _sim_engine(ns, concurrency, steps_per_query, n)
    return [([r.uid for r in eng.step()], eng.pending) for _ in range(ticks)]


@pytest.mark.parametrize("concurrency,steps,n,want", [
    (3, 1, 10, [3]),                      # deep queue drains k per step
    (1, 2, 2, [0, 1]),                    # the old serial semantics
    (2, 2, 4, [0, 2, 0, 2]),              # progress per request
], ids=["deep_queue_drains_k_per_step",
        "default_concurrency_matches_old_serial_semantics",
        "progress_is_per_request_not_per_queue"])
def test_sim_engine_concurrency(concurrency, steps, n, want):
    jt, pt = _both(_trail, concurrency, steps, n, len(want))
    assert pt == jt
    assert [len(done) for done, _ in pt] == want
    if concurrency == 3:
        assert pt[0][1] == 7


# ---------------------------------------------------------------------------
# the hedge duplicate's energy, the phase split
# ---------------------------------------------------------------------------


def _hedge_charge(ns):
    profiles = [ns.ModelProfile(name="sim0", family="s", params_b=1.0),
                ns.ModelProfile(name="sim1", family="s", params_b=2.0)]

    def outcome(query, model):
        return 0.5, 0.02, 10.0, 4
    engines = {"sim0": ns.SimEngine(profiles[0], outcome, steps_per_query=50),
               "sim1": ns.SimEngine(profiles[1], outcome, steps_per_query=1)}
    router = ns.Router(ns.RouterConfig(max_arms=4), ns.ModelPool(profiles),
                       **ns.router_kw)
    governor = ns.tel.EnergyBudgetGovernor(10.0, horizon_queries=4)
    server = ns.PoolServer(router, engines, hedge_after_steps=1,
                           telemetry=ns.tel.Telemetry(governor=governor))
    q = ns.make_stream(per_task=1)[0]
    server.submit(q)
    for _ in range(10):
        server.step()
        if q.uid in server.responses:
            break
    assert server.stats["hedges"] == 1
    resp_wh = sum(r.energy_wh for r in server.responses.values())
    assert governor.cumulative_wh == pytest.approx(2 * resp_wh)
    hedges = server.telemetry.registry.find("greenserv_hedges_total").value
    return governor.cumulative_wh, hedges, server.responses[q.uid].model_name


def test_hedge_duplicate_energy_charged_to_governor():
    want, got = _both(_hedge_charge)
    assert got == want


class _PhaseFakeEngine:
    """Minimal engine stand-in reporting phase-tagged joules."""

    def __init__(self):
        self.pending = 0
        self.joules = {"prefill": 0.0, "decode": 0.0}

    def cumulative_joules(self):
        return sum(self.joules.values())

    def cumulative_joules_by_phase(self):
        return dict(self.joules)


def _phase_split(ns):
    from importlib import import_module
    power = import_module(ns.tel.__name__ + ".power")
    governor = ns.tel.EnergyBudgetGovernor(10.0, horizon_queries=100)
    clock = iter(float(i) for i in range(100))
    tel = ns.tel.Telemetry(governor=governor, clock=lambda: next(clock))
    eng = _PhaseFakeEngine()
    engines = {"m0": eng}
    tel.on_step(engines)                       # anchor sample
    eng.joules = {"prefill": 36.0, "decode": 0.0}     # 36 J = 0.01 Wh
    tel.on_step(engines)
    eng.joules = {"prefill": 36.0, "decode": 72.0}
    tel.on_step(engines)
    pre = tel.registry.find("greenserv_energy_joules_total",
                            {"phase": "prefill"})
    dec = tel.registry.find("greenserv_energy_joules_total",
                            {"phase": "decode"})
    assert pre.value == pytest.approx(36.0)
    assert dec.value == pytest.approx(72.0)
    assert tel.power.last_watts(power.PHASE_PREFILL) == pytest.approx(0.0)
    assert tel.power.last_watts(power.PHASE_DECODE) == pytest.approx(72.0)
    assert tel.power.total_wh(power.PHASE_PREFILL) == pytest.approx(
        36.0 / 3600.0)
    assert set(tel.power.sources) == {"m0"}
    stats = governor.stats()
    assert stats["prefill_wh"] == pytest.approx(0.01)
    assert stats["decode_wh"] == pytest.approx(0.02)
    assert governor.cumulative_wh == 0.0
    assert "phases" in tel.summary()
    return ns.tel.to_prometheus(tel.registry), tel.summary(), stats


def test_hub_tags_prefill_vs_decode_energy():
    (jprom, jsum, jstats), (pprom, psum, pstats) = _both(_phase_split)
    assert pprom == jprom and psum == jsum
    assert_close(pstats, jstats)


# ---------------------------------------------------------------------------
# the governed paper pool: λ history equal at T = 150, the cap at T = 1,000
# ---------------------------------------------------------------------------


_KEEP = {"qwen2.5-0.5b", "qwen2.5-1.5b", "qwen2.5-7b", "llama-3.1-8b",
         "phi-4-mini-4b", "phi-4-14b", "gemma-3-12b", "qwen2.5-14b"}
_EXCLUDE = [row[0] for row in PAPER_POOL if row[0] not in _KEEP]
_SERVE = dict(seed=0, batch=10, exclude=_EXCLUDE, max_arms=16,
              fit_classifier=True)


def _serve_stream(port: bool, queries, telemetry):
    if port:
        return common.drive_pool_stream(queries, telemetry, device="cpu",
                                        **_SERVE)
    return jax_common.drive_pool_stream(queries, telemetry, **_SERVE)


def test_governed_lambda_history_equal_at_150_queries():
    """Ungoverned then governed at 60% of its Wh (the reference's
    acceptance settings) through both packages: the same λ history, arms,
    accuracy and Wh."""
    runs = []
    for port, ns, stream_fn in ((False, JAX, jax_make_stream),
                                (True, PORT, make_stream)):
        queries = stream_fn(per_task=30, seed=0)
        free = _serve_stream(port, queries, ns.tel.Telemetry())
        governor = ns.tel.EnergyBudgetGovernor(
            0.6 * free.total_energy_wh, horizon_queries=len(queries),
            gain=0.005, lambda_max=0.75)
        gov = _serve_stream(port, queries, ns.tel.Telemetry(
            governor=governor))
        assert governor.lambda_history           # the governor acted
        runs.append((free, gov, governor))
    (jfree, jgov, jg), (pfree, pgov, pg) = runs
    for want, got in ((jfree, pfree), (jgov, pgov)):
        assert ({u: r.model_name for u, r in got.server.responses.items()}
                == {u: r.model_name for u, r in want.server.responses.items()})
        assert got.mean_accuracy == want.mean_accuracy
        assert got.total_energy_wh == pytest.approx(want.total_energy_wh,
                                                     rel=EXACT)
        assert got.n_steps == want.n_steps
    assert [lam for _, lam in pg.lambda_history] == pytest.approx(
        [lam for _, lam in jg.lambda_history], rel=EXACT)
    assert_close(pg.stats(), jg.stats())


def test_governor_holds_cap_and_preserves_accuracy():
    """The reference's acceptance on the port: a Wh cap at 60% of the
    ungoverned consumption is held, with mean accuracy within 10%
    relative of the ungoverned run (T = 1,000)."""
    queries = make_stream(per_task=200, seed=0)
    free = _serve_stream(True, queries, port_telemetry.Telemetry())
    budget = 0.6 * free.total_energy_wh
    governor = port_telemetry.EnergyBudgetGovernor(
        budget, horizon_queries=len(queries), gain=0.005, lambda_max=0.75)
    run = _serve_stream(True, queries,
                        port_telemetry.Telemetry(governor=governor))
    assert run.total_energy_wh <= budget
    assert run.mean_accuracy >= 0.9 * free.mean_accuracy
    assert len(governor.lambda_history) > 0
    assert max(lam for _, lam in governor.lambda_history) > 0.4
    assert governor.cumulative_wh == pytest.approx(run.total_energy_wh,
                                                   rel=1e-6)
    tel = run.server.telemetry
    assert tel.registry.find("greenserv_admitted_total").value == len(queries)
    lat = tel.registry.find("greenserv_latency_ms")
    assert lat is not None and lat.count == len(queries)
    assert tel.power.total_wh() > 0


# ---------------------------------------------------------------------------
# a whole served run on a virtual clock: equal exports
# ---------------------------------------------------------------------------


SIM_MODELS = (("qwen2.5-7b", "qwen", 7.0), ("gemma-3-12b", "gemma", 12.0),
              ("llama-3.1-8b", "llama", 8.0))


def _virtual_run(ns, pool_mod, tmp_path):
    clk = {"t": 10.0}
    clock = lambda: clk["t"]  # noqa: E731
    sim = ns.Sim(seed=3)
    engines = {name: ns.SimEngine(pool_mod.make_profile(name, fam, b), sim,
                                  steps_per_query=2, concurrency=2,
                                  clock=clock)
               for name, fam, b in SIM_MODELS}
    router = ns.Router(ns.RouterConfig(lam=0.4, energy_scale_wh=0.05),
                       ns.ModelPool([e.profile for e in engines.values()]),
                       **ns.router_kw)
    governor = ns.tel.EnergyBudgetGovernor(0.5, horizon_queries=40)
    tel = ns.tel.Telemetry(governor=governor, clock=clock)
    server = ns.PoolServer(router, engines, tokenizer=ns.encode,
                           hedge_after_steps=3, telemetry=tel, clock=clock)
    for q in ns.make_stream(per_task=8, seed=2):
        server.enqueue(q)
        server.step()
        clk["t"] += 0.125
    while server.inflight or server.arrivals:
        server.step()
        clk["t"] += 0.125
    path = str(tmp_path / f"{ns.tel.__name__}.jsonl")
    ns.tel.dump_jsonl(path, tel.registry, tel.power, tel.events,
                      meta={"queries": 40})
    return server, path


def test_served_run_exports_equal_on_a_virtual_clock(tmp_path):
    """The same clock in ``Telemetry``, ``PoolServer`` and the engines:
    the two packages' Prometheus texts are equal line for line, and each
    package's ``load_jsonl`` reads the other's dump as its own."""
    jserver, jpath = _virtual_run(JAX, jax_pool, tmp_path)
    pserver, ppath = _virtual_run(PORT, port_pool, tmp_path)
    assert len(pserver.responses) == len(jserver.responses) == 40
    assert ({u: r.model_name for u, r in pserver.responses.items()}
            == {u: r.model_name for u, r in jserver.responses.items()})
    jtext = JAX.tel.to_prometheus(jserver.telemetry.registry)
    ptext = PORT.tel.to_prometheus(pserver.telemetry.registry)
    assert ptext.splitlines() == jtext.splitlines()
    assert "greenserv_hedges_total" in ptext
    assert PORT.tel.load_jsonl(jpath) == JAX.tel.load_jsonl(ppath) \
        == PORT.tel.load_jsonl(ppath)
    assert (pserver.telemetry.summary().splitlines()
            == jserver.telemetry.summary().splitlines())


# ---------------------------------------------------------------------------
# PoolServer's clock: the JAX package's position, and used where it is
# ---------------------------------------------------------------------------


def test_pool_server_takes_its_clock_in_the_reference_position():
    want = list(inspect.signature(JaxPoolServer).parameters)
    assert list(inspect.signature(PoolServer).parameters) == want
    stamps = []
    for ns in (JAX, PORT):
        clock = lambda: 42.5  # noqa: E731
        prof = ns.ModelProfile(name="sim", family="s", params_b=1.0)
        for positional in (True, False):
            engines = {"sim": ns.SimEngine(prof, lambda q, m: (1.0, 0.001,
                                                               1.0, 4))}
            router = ns.Router(ns.RouterConfig(), ns.ModelPool([prof]),
                               **ns.router_kw)
            if positional:
                # router, engines, tokenizer, hedge_after_steps,
                # heartbeat_timeout_s, accuracy_fn, telemetry,
                # prefill_chunk, cache, decode_engines, cost_model,
                # admission_planner, clock
                server = ns.PoolServer(router, engines, None, None, 30.0,
                                       None, None, None, None, None, None,
                                       False, clock)
            else:
                server = ns.PoolServer(router, engines, clock=clock)
            req = server.submit(ns.Query(uid=1, text="what time is it"))
            stamps.append(req.submit_s)
    assert stamps == [42.5] * 4


# ---------------------------------------------------------------------------
# GreenCache's avoided energy, credited to telemetry and the governor
# ---------------------------------------------------------------------------


def _avoided_credit(ns):
    gov = ns.tel.EnergyBudgetGovernor(budget_wh=10.0, horizon_queries=100,
                                      control_on_completion=False)
    gov.bucket_wh = 0.0
    gov.on_avoided_energy(0.25, "prefix")
    gov.on_avoided_energy(0.1, "semantic")
    s = gov.stats()
    assert s["avoided_prefix_wh"] == pytest.approx(0.25)
    assert s["avoided_semantic_wh"] == pytest.approx(0.1)
    assert gov.bucket_wh == pytest.approx(min(0.35, gov.capacity_wh))
    assert gov.cumulative_wh == 0.0                   # credit, not un-spend
    gov.on_completion(0.1, 0.0)
    gov.on_admission(4, 0.0, expected_savings_wh=0.0)
    hot = gov._rate_error()
    gov2 = ns.tel.EnergyBudgetGovernor(budget_wh=10.0, horizon_queries=100,
                                       control_on_completion=False)
    gov2.on_completion(0.1, 0.0)
    gov2.on_admission(4, 0.0, expected_savings_wh=0.2)
    assert -1.0 < gov2._rate_error() < hot < 1.0
    return s, hot, gov2._rate_error()


def test_governor_avoided_energy_credit_and_inflight_discount():
    want, got = _both(_avoided_credit)
    assert_close(got, want)


def _granite_server(ns, cache_mode):
    """``tests/test_cache.py``'s ``_small_server`` with telemetry, on one
    set of fp32 smoke weights for both packages."""
    jcfg, pcfg, params, model = _params("granite-3-8b", 0)
    if ns is JAX:
        eng = JaxModelEngine("granite-3-8b", jcfg, jax.random.PRNGKey(0),
                             max_batch=2, max_len=64, params=params)
    else:
        eng = ModelEngine("granite-3-8b", pcfg, max_batch=2, max_len=64,
                          params=model, device="cpu")
    router = ns.Router(ns.RouterConfig(lam=0.4, energy_scale_wh=0.05),
                       ns.ModelPool([eng.profile]), **ns.router_kw)
    cache = ns.GreenCache(mode=cache_mode, kv_cache_blocks=32,
                          semantic_threshold=0.99)
    server = ns.PoolServer(router, {"granite-3-8b": eng},
                           tokenizer=ns.encode, prefill_chunk=4, cache=cache,
                           telemetry=ns.tel.Telemetry())
    return server, cache


def _semantic_hit_export(ns):
    server, _ = _granite_server(ns, "full")
    text = "Answer the question about entropy now"
    server.submit_batch([ns.Query(uid=0, text=text, max_new_tokens=3)])
    server.run_until_drained()
    reqs = server.submit_batch([ns.Query(uid=1, text=text, max_new_tokens=3)])
    assert reqs[0].done
    prom = ns.tel.to_prometheus(server.telemetry.registry)
    assert 'greenserv_cache_hits_total{kind="semantic"} 1.0' in prom
    avoided = server.telemetry.registry.find(
        "greenserv_energy_joules_avoided_total", {"kind": "semantic"}).value
    assert avoided == pytest.approx(server.responses[0].energy_wh * 3600.0)
    return server.responses[1].tokens, avoided


def test_semantic_hit_is_counted_in_the_export(equal_energy_constants):
    want, got = _both(_semantic_hit_export)
    assert got[0] == want[0]
    assert got[1] == pytest.approx(want[1], rel=EXACT)


def _late_joiner(ns):
    server, cache = _granite_server(ns, "prefix")
    if ns is JAX:
        late = JaxModelEngine("qwen2-moe-a2.7b",
                              jax_get_config("qwen2-moe-a2.7b", **F32),
                              jax.random.PRNGKey(1), max_batch=2, max_len=64)
    else:
        late = ModelEngine("qwen2-moe-a2.7b",
                           get_config("qwen2-moe-a2.7b", **F32),
                           max_batch=2, max_len=64, device="cpu")
    server.add_engine(late.profile, late)
    assert late.prefill_chunk == 4
    assert late.prefix_cache is cache.prefix_for("qwen2-moe-a2.7b")
    prom = ns.tel.to_prometheus(server.telemetry.registry)
    assert 'greenserv_queue_depth{engine="qwen2-moe-a2.7b"}' in prom
    assert server.telemetry.events.counts["engine_added"] == 1
    return prom


def test_configure_engine_prebinds_telemetry_for_late_joiners():
    want, got = _both(_late_joiner)
    assert got == want


def _cache_servers(mode, budget_wh, carbon_amplitude=None,
                   cost_model=False):
    """The cache workload's SimEngine pool in each package with the
    governor on the drive's virtual clock (and, with ``cost_model``, each
    package's ``EnergyCostModel``): [(server, queries, arrivals, clock),
    ...]."""
    queries, arrivals = cache_bench.make_workload(60, seed=0)
    out = []
    for ns, pool_mod in ((JAX, jax_pool), (PORT, port_pool)):
        clk = {"t": 0.0}
        sim = ns.Sim(seed=3)
        engines = {name: ns.SimEngine(pool_mod.make_profile(name, fam, b),
                                      sim, steps_per_query=2, concurrency=2)
                   for name, fam, b in SIM_MODELS}
        router = ns.Router(ns.RouterConfig(lam=0.4, energy_scale_wh=0.05),
                           ns.ModelPool([e.profile
                                         for e in engines.values()]),
                           **ns.router_kw)
        if ns is PORT:
            tel = cache_bench.governed_telemetry(
                budget_wh, arrivals, clk, carbon_amplitude=carbon_amplitude)
        else:   # the JAX bench's own construction (bench_cache.drive)
            carbon_fn = None
            if carbon_amplitude is not None:
                carbon_fn = lambda t: ns.tel.diurnal_carbon_intensity(  # noqa
                    t, amplitude=carbon_amplitude, period_s=arrivals[-1])
            gov = (ns.tel.EnergyBudgetGovernor(
                budget_wh, horizon_s=arrivals[-1] + 5.0, carbon_fn=carbon_fn)
                if budget_wh else None)
            tel = ns.tel.Telemetry(governor=gov,
                                   clock=lambda c=clk: c["t"])
        cache = ns.GreenCache(mode=mode, kv_cache_blocks=512,
                              semantic_threshold=0.92,
                              clock=lambda c=clk: c["t"])
        server = ns.PoolServer(router, engines, tokenizer=ns.encode,
                               prefill_chunk=4, cache=cache, telemetry=tel,
                               cost_model=(ns.EnergyCostModel() if cost_model
                                           else None))
        q = (queries if ns is PORT else
             [JaxQuery(uid=x.uid, text=x.text,
                       max_new_tokens=x.max_new_tokens) for x in queries])
        out.append((server, q, arrivals, clk))
    return out


@pytest.mark.parametrize("budget_frac,carbon_amplitude,cost_model", [
    (1.0, None, False), (0.25, None, False), (0.25, 0.3, False),
    (0.25, None, True)],
    ids=["off_spend", "tight", "tight_diurnal", "tight_cost_model"])
def test_cache_workload_credits_avoided_energy_to_the_governor(
        budget_frac, carbon_amplitude, cost_model):
    """The JAX bench's governed run (its budget: the uncached run's
    spend) and a tight one that moves λ, flat, under the diurnal carbon
    signal and with the cost model on: the same hits, arms, joules,
    forecasts, governor ledger and λ trace in both packages, with avoided
    prefix and semantic Wh credited."""
    off = [cache_bench.drive(s, q, a, clock=c)
           for s, q, a, c in _cache_servers("off", None)]
    assert off[1]["joules"] == pytest.approx(off[0]["joules"], rel=EXACT)
    budget_wh = budget_frac * off[1]["joules"] / 3600.0
    servers = _cache_servers("full", budget_wh, carbon_amplitude, cost_model)
    cards = [cache_bench.drive(s, q, a, clock=c) for s, q, a, c in servers]
    want, got = cards
    (jserver, *_), (pserver, *_) = servers
    assert ({u: r.model_name for u, r in pserver.responses.items()}
            == {u: r.model_name for u, r in jserver.responses.items()})
    if cost_model:
        _assert_same_forecasts(jserver.cost_model, pserver.cost_model)
        assert pserver.cost_model.n_reconciled > 0
    for key in ("completed", "semantic_hits", "prefix_hits", "steps",
                "admission_batches"):
        assert got[key] == want[key], key
    assert got["joules"] == pytest.approx(want["joules"], rel=EXACT)
    assert_close(got["governor"], want["governor"])
    assert_close(got["lambda_trace"], want["lambda_trace"])
    gov = got["governor"]
    assert gov["avoided_prefix_wh"] > 0.0 and gov["avoided_semantic_wh"] > 0.0
    assert got["joules"] < off[1]["joules"]
    assert (gov["lambda_changes"] > 0) == (budget_frac < 1.0)
