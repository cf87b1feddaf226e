"""The energy cost model in the port on the CPU against the JAX package:
every case of ``tests/test_costmodel.py`` run through both packages with
the port's energy constants set to the JAX package's and the JAX weights
carried by ``params_from_jax`` — the analytic prior against the metered
ledger (rwkv6, fp32 smoke), reconciliation, the RLS residual and the
decode-length EWMA on the same ledger (1e-12), ``discount_wh`` (granite),
the state round trip across the packages, the uniform and shaped cost
matrices and the tilt baseline's checkpoint, the governor's
predict-then-reconcile traces, and the admission planner on
``SimEngine``s and on a smoke granite ``ModelEngine``: the same
decisions, predicted and metered Wh and deferrals.  The reference's
hypothesis case is its seeded-trace case here (hypothesis is optional
and the seeded traces cover the same interpreter)."""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.costmodel as jax_costmodel
from repro.configs import get_config as jax_get_config
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data import tokenizer as jax_tok
from repro.models import api as jax_api
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro.serving import SimEngine as JaxSimEngine
from repro.telemetry import EnergyBudgetGovernor as JaxGovernor
from repro.telemetry import Telemetry as JaxTelemetry
import repro_torch.costmodel as port_costmodel
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import ModelProfile, Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ModelEngine, PoolServer, SimEngine
from repro_torch.telemetry import EnergyBudgetGovernor, Telemetry
from test_torch_serving import (equal_energy_constants,  # noqa: F401
                                one_torch_thread)

pytestmark = [pytest.mark.port, pytest.mark.costmodel]

EXACT = 1e-12          # the same numpy float64 arithmetic in both packages
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")
RWKV, DENSE = "rwkv6-1.6b", "granite-3-8b"

PACKAGES = {
    "jax": types.SimpleNamespace(
        Router=JaxRouter, RouterConfig=JaxRouterConfig,
        ModelPool=JaxModelPool, ModelProfile=JaxModelProfile,
        Query=JaxQuery, EnergyCostModel=jax_costmodel.EnergyCostModel,
        EngineCostModel=jax_costmodel.EngineCostModel,
        SimEngine=JaxSimEngine, PoolServer=JaxPoolServer,
        Governor=JaxGovernor, Telemetry=JaxTelemetry,
        encode=jax_tok.encode, router_kw={}),
    "port": types.SimpleNamespace(
        Router=GreenServRouter, RouterConfig=RouterConfig,
        ModelPool=ModelPool, ModelProfile=ModelProfile, Query=Query,
        EnergyCostModel=port_costmodel.EnergyCostModel,
        EngineCostModel=port_costmodel.EngineCostModel,
        SimEngine=SimEngine, PoolServer=PoolServer,
        Governor=EnergyBudgetGovernor, Telemetry=Telemetry,
        encode=tok.encode, router_kw=dict(device="cpu")),
}
JAX, PORT = PACKAGES["jax"], PACKAGES["port"]


def _both(case, *args, **kwargs):
    """Run ``case(ns, ...)`` through each package: (JAX result, port's)."""
    return (case(JAX, *args, **kwargs), case(PORT, *args, **kwargs))


def assert_close(got, want, rel=EXACT):
    """Nested dicts/lists of the same shape: floats within ``rel``,
    everything else (ints, bools, strings, None) equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_close(got[k], want[k], rel)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, rel)
    elif isinstance(want, float) and not isinstance(got, bool):
        assert got == pytest.approx(want, rel=rel, abs=1e-300)
    else:
        assert got == want


@functools.lru_cache(maxsize=None)
def _params(arch: str, seed: int):
    """(JAX config, port config, JAX params, the same weights in the
    port) for an fp32 smoke model."""
    jcfg = jax_get_config(arch, **F32)
    pcfg = get_config(arch, **F32)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                            device="cpu")
    return jcfg, pcfg, params, model


def _engine(ns, arch=RWKV, max_batch=3, max_len=96, seed=0,
            prefill_chunk=4):
    """The reference's ``_real_engine`` in ``ns``'s package, on one set of
    weights for both."""
    jcfg, pcfg, params, model = _params(arch, seed)
    if ns is JAX:
        return JaxModelEngine(arch, jcfg, jax.random.PRNGKey(seed),
                              max_batch=max_batch, max_len=max_len,
                              params=params, prefill_chunk=prefill_chunk,
                              detokenize=jax_tok.decode)
    return ModelEngine(arch, pcfg, max_batch=max_batch, max_len=max_len,
                       params=model, prefill_chunk=prefill_chunk,
                       detokenize=tok.decode, device="cpu")


def _assert_same_responses(want, got):
    assert sorted(got) == sorted(want)
    for uid in want:
        assert got[uid].model_name == want[uid].model_name
        assert got[uid].tokens == want[uid].tokens
        assert got[uid].energy_wh == pytest.approx(want[uid].energy_wh,
                                                   rel=EXACT)


def _assert_same_forecasts(want, got):
    """Equal reconciliation counts and (predicted, metered) histories."""
    ws, gs = want.stats(), got.stats()
    for key in ("n_predicted", "n_reconciled", "inflight_predicted"):
        assert gs[key] == ws[key], key
    assert gs["mae_ratio"] == pytest.approx(ws["mae_ratio"], rel=EXACT)
    assert len(got.history) == len(want.history)
    for w, g in zip(want.history, got.history):
        assert g["engine"] == w["engine"]
        assert g["predicted_wh"] == pytest.approx(w["predicted_wh"],
                                                  rel=EXACT)
        assert g["measured_wh"] == pytest.approx(w["measured_wh"],
                                                 rel=EXACT)


# -- analytic prior mirrors the engine's accounting of record ---------------


def _prior_run(ns):
    eng = _engine(ns)
    router = ns.Router(ns.RouterConfig(max_arms=4),
                       ns.ModelPool([eng.profile]),
                       **ns.router_kw)
    cm = ns.EnergyCostModel()
    server = ns.PoolServer(router, {eng.profile.name: eng},
                           tokenizer=ns.encode, prefill_chunk=4,
                           cost_model=cm)
    server.enqueue_many([ns.Query(uid=i, text=f"measure prompt number {i} "
                                  f"with some words", max_new_tokens=3 + i % 4)
                         for i in range(5)])
    server.run_until_drained(max_steps=5000)
    m = cm.engines[eng.profile.name]
    assert m.split_phases
    priors = []
    for uid, resp in sorted(server.responses.items()):
        a_pre, a_dec = m.analytic_split_wh(resp.input_tokens,
                                           resp.output_tokens)
        assert resp.energy_wh == pytest.approx(a_pre + a_dec, rel=1e-9)
        priors.append((a_pre, a_dec))
    return server.responses, cm, priors


def test_analytic_prior_matches_metered_unified(equal_energy_constants):
    (jresp, jcm, jpri), (presp, pcm, ppri) = _both(_prior_run)
    _assert_same_responses(jresp, presp)
    _assert_same_forecasts(jcm, pcm)
    np.testing.assert_allclose(ppri, jpri, rtol=EXACT)


def _reconcile_run(ns):
    eng = _engine(ns)
    router = ns.Router(ns.RouterConfig(max_arms=4),
                       ns.ModelPool([eng.profile]),
                       **ns.router_kw)
    cm = ns.EnergyCostModel()
    server = ns.PoolServer(router, {eng.profile.name: eng},
                           tokenizer=ns.encode, cost_model=cm)
    server.enqueue_many([ns.Query(uid=i, text=f"query {i}", max_new_tokens=4)
                         for i in range(6)])
    server.run_until_drained(max_steps=5000)
    assert cm.n_predicted == cm.n_reconciled == 6
    assert cm.inflight_predicted == 0
    assert cm.mae_ratio() < 0.5
    return server.responses, cm


def test_cost_model_reconciles_every_completion(equal_energy_constants):
    (jresp, jcm), (presp, pcm) = _both(_reconcile_run)
    _assert_same_responses(jresp, presp)
    _assert_same_forecasts(jcm, pcm)


# -- RLS residual calibration ----------------------------------------------


def _assert_same_residuals(want, got):
    assert got.out_ratio == pytest.approx(want.out_ratio, rel=EXACT)
    assert got.n_obs == want.n_obs
    for ph in want.residuals:
        w, g = want.residuals[ph], got.residuals[ph]
        np.testing.assert_allclose(g.w, w.w, rtol=EXACT, atol=0.0)
        np.testing.assert_allclose(g.P, w.P, rtol=EXACT, atol=0.0)
        assert g.n_obs == w.n_obs


def _linear_ledger(ns):
    m = ns.EngineCostModel("sim", cost_params=None)
    rng = np.random.default_rng(0)
    base, slope = 4e-3, 2e-5
    for _ in range(200):
        n_p = int(rng.integers(8, 64))
        n_out = int(rng.integers(2, 12))
        m.observe(n_prompt=n_p, n_out=n_out, max_new_tokens=n_out,
                  reused=0, migrated=False, occupancy=0.0,
                  measured_wh=base + slope * (n_p + n_out))
    preds = []
    for n_p, n_out in [(16, 4), (40, 8), (60, 10)]:
        pred = m.predict_wh(n_p, n_out)
        assert pred == pytest.approx(base + slope * (n_p + n_out), rel=0.05)
        preds.append(pred)
    return m, preds


def test_rls_residual_learns_linear_ledger():
    (jm, jp), (pm, pp) = _both(_linear_ledger)
    _assert_same_residuals(jm, pm)
    np.testing.assert_allclose(pp, jp, rtol=EXACT)


def _early_stopping(ns):
    m = ns.EngineCostModel("sim", cost_params=None)
    for _ in range(60):
        m.observe(n_prompt=10, n_out=5, max_new_tokens=10, reused=0,
                  migrated=False, occupancy=0.0, measured_wh=1e-3)
    assert m.out_ratio == pytest.approx(0.5, abs=0.05)
    assert m.expected_out(10) == pytest.approx(5, abs=1)
    return m


def test_out_ratio_tracks_early_stopping():
    _assert_same_residuals(*_both(_early_stopping))


def _discounts(ns):
    eng = _engine(ns, arch=DENSE, max_batch=2, max_len=96, prefill_chunk=8)
    cm = ns.EnergyCostModel()
    cm.register_engine(eng.profile.name, eng)
    name = eng.profile.name
    assert cm.engines[name].prefill_chunk == 8
    assert cm.discount_wh(name, 32, 4, reused=0) == 0.0
    deep = cm.discount_wh(name, 32, 4, reused=24)
    shallow = cm.discount_wh(name, 32, 4, reused=8)
    assert deep > 0.0 and shallow >= 0.0
    return deep, shallow, cm.predict_wh(name, 32, 4)


def test_discount_wh_positive_only_with_reuse(equal_energy_constants):
    want, got = _both(_discounts)
    np.testing.assert_allclose(got, want, rtol=EXACT)


def test_discount_wh_positive_on_the_port_constants():
    """The same case on the port's own H100 constants (unpatched)."""
    deep, shallow, cold = _discounts(PORT)
    assert 0.0 < deep < cold


# -- checkpoint roundtrip ---------------------------------------------------


def _observed_model(ns):
    src = ns.EnergyCostModel()
    m = src.register_engine("sim")
    rng = np.random.default_rng(1)
    for _ in range(50):
        n = int(rng.integers(8, 64))
        m.observe(n_prompt=n, n_out=6, max_new_tokens=8, reused=0,
                  migrated=False, occupancy=0.0, measured_wh=1e-4 * n)
    return src


@pytest.mark.parametrize("src_pkg,dst_pkg", [("port", "port"),
                                             ("port", "jax"),
                                             ("jax", "port")])
def test_cost_model_state_roundtrip(src_pkg, dst_pkg):
    """A state written by one package loads into the other (and into its
    own) with equal predictions after."""
    src = _observed_model(PACKAGES[src_pkg])
    dst = PACKAGES[dst_pkg].EnergyCostModel()
    dst.load_state_dict(src.state_dict())
    for n_p in (10, 30, 50):
        assert dst.predict_wh("sim", n_p, 8) == pytest.approx(
            src.predict_wh("sim", n_p, 8), rel=EXACT)
    assert dst.engines["sim"].out_ratio == pytest.approx(
        src.engines["sim"].out_ratio, rel=EXACT)
    assert dst.engines["sim"].n_obs == src.engines["sim"].n_obs
    _assert_same_residuals(src.engines["sim"], dst.engines["sim"])


def test_observed_models_equal_across_packages():
    _assert_same_residuals(*(m.engines["sim"]
                             for m in _both(_observed_model)))


# -- router predicted-cost tilt --------------------------------------------


def _tilt_router(ns, seed=0):
    profiles = [ns.ModelProfile(name=f"sim{i}", family="s", params_b=i + 1.0)
                for i in range(3)]
    return ns.Router(
        ns.RouterConfig(lam=0.5, energy_scale_wh=0.01, max_arms=8, seed=seed),
        ns.ModelPool(profiles), **ns.router_kw)


def _uniform(ns):
    qs = [ns.Query(uid=i, text=f"tilt query {i}") for i in range(12)]
    base = [d.model_index for d in _tilt_router(ns).route_batch(qs)]
    costs = np.tile([0.001, 0.005, 0.02], (len(qs), 1))
    tilted = [d.model_index for d in
              _tilt_router(ns).route_batch(qs, energy_costs_wh=costs)]
    assert tilted == base
    return tilted


def test_uniform_cost_matrix_never_perturbs_decisions():
    want, got = _both(_uniform)
    assert got == want


def _shaped(ns):
    qs = [ns.Query(uid=i, text=f"steer query {i}") for i in range(8)]
    base = [d.model_index for d in _tilt_router(ns).route_batch(qs)]
    costs = np.full((len(qs), 3), 0.001)
    costs[0, base[0]] = 5.0        # query 0: its chosen arm forecast huge
    tilted = [d.model_index for d in
              _tilt_router(ns).route_batch(qs, energy_costs_wh=costs)]
    assert tilted[0] != base[0]
    return base, tilted


def test_shaped_cost_matrix_steers_away_from_expensive_arm():
    want, got = _both(_shaped)
    assert got == want


def _tilt_checkpoint(ns):
    r = _tilt_router(ns)
    qs = [ns.Query(uid=i, text=f"ckpt query {i}") for i in range(6)]
    costs = np.abs(np.random.default_rng(2).normal(0.01, 0.004, (6, 3)))
    arms = [d.model_index for d in r.route_batch(qs, energy_costs_wh=costs)]
    r2 = _tilt_router(ns)
    r2.load_state_dict(r.state_dict())
    np.testing.assert_allclose(r2._pred_cost_mean, r._pred_cost_mean)
    np.testing.assert_array_equal(r2._pred_cost_seen, r._pred_cost_seen)
    return arms, r2._pred_cost_mean, r2._pred_cost_seen


def test_router_tilt_baseline_checkpoints():
    (ja, jm, js), (pa, pm, ps) = _both(_tilt_checkpoint)
    assert pa == ja
    np.testing.assert_allclose(pm, jm, rtol=EXACT)
    np.testing.assert_array_equal(ps, js)


# -- governor predict-then-reconcile (property-style) -----------------------
#
# Trace interpreter: a sequence of (op, uid, wh) steps runs against both
# packages' governors and a plain-dict reference model; the reference's
# invariants hold after every step, and the two governors agree.


def _run_trace(ops):
    govs = [ns.Governor(100.0, horizon_queries=1000) for ns in (JAX, PORT)]
    ref = {}
    reconciled = 0
    for op, uid, wh in ops:
        if op == "admit":
            for gov in govs:
                gov.on_admission(1, predicted=[(uid, wh)])
            ref[uid] = max(wh, 0.0)
        elif op == "complete":
            if uid in ref:
                reconciled += 1
                ref.pop(uid)
            for gov in govs:
                gov.on_completion(wh, uid=uid)
        elif op == "cancel":
            ref.pop(uid, None)
            for gov in govs:
                gov.on_cancel(uid)
        for gov in govs:
            assert gov.inflight_predicted_wh >= -1e-12
            assert gov.inflight_predicted_wh == pytest.approx(
                sum(ref.values()), abs=1e-9)
            assert set(gov.inflight_pred) == set(ref)
            assert gov.prediction_error["n"] == reconciled
        assert_close(govs[1].stats(), govs[0].stats())
    for uid in list(ref):
        for gov in govs:
            gov.on_completion(1e-3, uid=uid)
        reconciled += 1
    for gov in govs:
        assert gov.inflight_predicted_wh == pytest.approx(0.0, abs=1e-9)
        assert not gov.inflight_pred
        assert gov.prediction_error["n"] == reconciled
    assert govs[1].lambda_history == govs[0].lambda_history


def _random_ops(rng, n_steps=40, n_uids=8):
    ops = []
    for _ in range(n_steps):
        op = rng.choice(["admit", "admit", "complete", "cancel"])
        uid = int(rng.integers(0, n_uids))
        wh = float(rng.uniform(0.0, 0.01))
        ops.append((op, uid, wh))
    return ops


def test_governor_predict_reconcile_seeded_traces():
    for seed in range(40):
        _run_trace(_random_ops(np.random.default_rng(seed)))


def _readmission(ns):
    gov = ns.Governor(100.0, horizon_queries=1000)
    gov.on_admission(1, predicted=[(7, 0.004)])
    gov.on_admission(1, predicted=[(7, 0.009)])
    assert gov.inflight_predicted_wh == pytest.approx(0.009)
    gov.on_completion(0.008, uid=7)
    assert gov.inflight_predicted_wh == pytest.approx(0.0)
    assert gov.prediction_error["n"] == 1
    return gov.stats()


def test_governor_readmission_replaces_charge():
    want, got = _both(_readmission)
    assert_close(got, want)


def _headroom(ns):
    gov = ns.Governor(10.0, horizon_queries=100, burst_frac=0.1)
    h0 = gov.admission_headroom_wh()
    gov.on_admission(1, predicted=[(1, 0.5)])
    h1 = gov.admission_headroom_wh()
    assert h1 == pytest.approx(h0 - 0.5)
    gov.on_cancel(1)
    assert gov.admission_headroom_wh() == pytest.approx(h0)
    return h0, h1


def test_governor_headroom_shrinks_with_inflight_predictions():
    want, got = _both(_headroom)
    assert got == pytest.approx(want, rel=EXACT)


# -- admission planner ------------------------------------------------------


def _planner_server(ns, budget_wh, admission_planner=True, n_queries=12,
                    wh_per_query=0.01):
    profiles = [ns.ModelProfile(name=f"sim{i}", family="s", params_b=i + 1.0)
                for i in range(2)]
    router = ns.Router(ns.RouterConfig(lam=0.4, max_arms=8),
                       ns.ModelPool(profiles), **ns.router_kw)
    engines = {p.name: ns.SimEngine(
        p, lambda q, m: (0.9, wh_per_query, 5.0, 4)) for p in profiles}
    gov = ns.Governor(budget_wh, horizon_queries=n_queries)
    cm = ns.EnergyCostModel()
    for p in profiles:
        eng_m = cm.register_engine(p.name)
        for _ in range(30):
            eng_m.observe(n_prompt=8, n_out=4, max_new_tokens=4, reused=0,
                          migrated=False, occupancy=0.0,
                          measured_wh=wh_per_query)
    server = ns.PoolServer(router, engines,
                           telemetry=ns.Telemetry(governor=gov),
                           cost_model=cm, admission_planner=admission_planner)
    server.enqueue_many([ns.Query(uid=i, text=f"plan query {i}",
                                  max_new_tokens=4)
                         for i in range(n_queries)])
    return server, n_queries


def _served(server) -> dict:
    """What a planner run decided and metered, for comparison."""
    gov = server.telemetry.governor
    return {"arms": {u: r.model_name for u, r in server.responses.items()},
            "deferred": server.stats["deferred"],
            "defer_events": [e.payload for e in
                             server.telemetry.events.of_kind("defer")],
            "metered_wh": sorted((u, r.energy_wh)
                                 for u, r in server.responses.items()),
            "governor": gov.stats(),
            "lambda_history": [lam for _, lam in gov.lambda_history]}


def _assert_same_served(want, got):
    assert got["arms"] == want["arms"]
    assert got["deferred"] == want["deferred"]
    assert_close(got, want)


def _planner_case(ns, budget_wh, admission_planner, deferred):
    server, n = _planner_server(ns, budget_wh,
                                admission_planner=admission_planner)
    server.run_until_drained()
    assert len(server.responses) == n             # head-of-line liveness
    assert (server.stats["deferred"] > 0) == deferred
    return _served(server), server.cost_model


@pytest.mark.parametrize("budget_wh,planner,deferred", [
    (0.02, True, True),      # tight budget: defers but never stalls
    (10.0, True, False),     # headroom: admits freely
    (0.02, False, False),    # planner off: never defers
], ids=["defers_under_tight_budget_but_never_stalls",
        "admits_freely_with_headroom", "off_never_defers"])
def test_planner(budget_wh, planner, deferred):
    (want, jcm), (got, pcm) = _both(_planner_case, budget_wh, planner,
                                    deferred)
    _assert_same_served(want, got)
    _assert_same_forecasts(jcm, pcm)


def _reconcile_into_governor(ns):
    server, n = _planner_server(ns, budget_wh=10.0)
    server.run_until_drained()
    gov = server.telemetry.governor
    cm = server.cost_model
    assert cm.n_reconciled == n
    assert cm.inflight_predicted == 0
    assert gov.prediction_error["n"] == n
    assert gov.inflight_predicted_wh == pytest.approx(0.0, abs=1e-9)
    assert not gov.inflight_pred
    return _served(server), cm


def test_end_to_end_predictions_reconcile_into_governor():
    (want, jcm), (got, pcm) = _both(_reconcile_into_governor)
    _assert_same_served(want, got)
    _assert_same_forecasts(jcm, pcm)


def _model_engine_planner(ns, headroom_queries):
    """The planner over one smoke granite ``ModelEngine`` (2 layers): a
    budget whose headroom holds ``headroom_queries`` cold forecasts."""
    eng = _engine(ns, arch=DENSE, max_batch=4, max_len=64, prefill_chunk=4)
    probe = ns.EnergyCostModel()
    probe.register_engine(DENSE, eng)
    per_query = probe.predict_wh(DENSE, 12, 4)
    # the soft headroom is bucket + capacity = 2·burst_frac·budget
    budget = headroom_queries * per_query / (2 * 0.08)
    router = ns.Router(ns.RouterConfig(lam=0.4, energy_scale_wh=0.05),
                       ns.ModelPool([eng.profile]), **ns.router_kw)
    gov = ns.Governor(budget, horizon_queries=8)
    cm = ns.EnergyCostModel()
    server = ns.PoolServer(router, {DENSE: eng}, tokenizer=ns.encode,
                           telemetry=ns.Telemetry(governor=gov),
                           prefill_chunk=4, cost_model=cm,
                           admission_planner=True)
    server.enqueue_many([ns.Query(uid=i, text=f"plan me {i:05d}",
                                  max_new_tokens=4) for i in range(8)])
    server.run_until_drained(max_steps=2000)
    assert len(server.responses) == 8
    assert server.stats["deferred"] > 0
    assert cm.n_predicted == cm.n_reconciled == 8
    return _served(server), cm


def test_planner_on_a_model_engine(equal_energy_constants):
    (want, jcm), (got, pcm) = _both(_model_engine_planner, 2.5)
    _assert_same_served(want, got)
    _assert_same_forecasts(jcm, pcm)
