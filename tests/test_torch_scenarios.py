"""The scenario lab in the port on the CPU against the JAX package: the
traffic generators (``repro_torch.data.scenarios``) and the closed-loop
drive (``benchmarks/common.py::run_scenario``) over the paper pool's
``SimEngine``s on the virtual clock, the routers on the host path.

  * every generator's ``fingerprint`` (stream texts, arrival times, pool
    events, fault schedules) equals the JAX package's at two seeds, and
    so do the arrival processes;
  * ``benchmarks/scenarios.py``'s flash crowd (planner on, the governor
    at 0.8 of the random spend), duplicate flood and pool churn, and a
    steady run, at ``per_task`` <= 30 (T <= 150, where the float32
    trajectories of the two packages stay together): the same completed
    and failed counts, ``stats``, ``dispatch_counts``, trajectory and λ,
    Wh and accuracy within 1e-9;
  * the closed loops of ``benchmarks/baselines.py`` and
    ``benchmarks/routerbench.py`` at small sizes, record for record;
  * ``run_record``'s schema, the reference's scenario invariants, and
    the RouterBench sweep's hoisted classifier fit equal to a refit per
    point.

The JAX side runs once per module (``jax_runs``)."""
import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from benchmarks import bench_baselines as jax_baselines
from benchmarks import bench_routerbench as jax_routerbench
from benchmarks import bench_scenarios as jax_bench
from benchmarks import common as jax_common
from repro.data import OutcomeSimulator as JaxOutcomeSimulator
from repro.data import scenarios as jax_scenarios
from repro_torch.benchmarks import baselines, common, routerbench
from repro_torch.benchmarks import scenarios as bench
from repro_torch.configs.pool import PAPER_POOL, make_profile
from repro_torch.core.pool import ModelPool
from repro_torch.core.types import RouterConfig
from repro_torch.data import ENERGY_SCALE_WH, OutcomeSimulator, scenarios
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.port, pytest.mark.scenario]

REL = 1e-9
GENERATORS = ("steady", "flash_crowd", "duplicate_flood", "pool_churn",
              "chaos")
BENCH_RUNS = ("run_flash_crowd", "run_duplicate_flood", "run_pool_churn")
PER_TASK = 30


def _key(result) -> dict:
    """What the two packages must agree on after a closed-loop drive:
    exact counts, stats, per-arm dispatches, trajectory (its λ samples
    included) and final λ; Wh and accuracy within ``REL``."""
    return {"completed": result.completed, "failed": result.failed,
            "n_queries": result.n_queries,
            "stats": dict(result.stats),
            "dispatch_counts": dict(result.server.dispatch_counts),
            "trajectory": result.trajectory,
            "lam": float(result.server.router.config.lam),
            "span_s": result.span_s}


def _close(got, want) -> None:
    assert _key(got) == _key(want)
    assert got.total_energy_wh == pytest.approx(want.total_energy_wh,
                                                rel=REL)
    assert got.mean_accuracy == pytest.approx(want.mean_accuracy, rel=REL)
    assert got.avoided_wh == pytest.approx(want.avoided_wh, rel=REL,
                                           abs=1e-300)


def _steady(mod, router_kw):
    scenario = mod["scenarios"].steady(per_task=PER_TASK, seed=0)
    router = mod["common"].make_closed_loop_router(lam=0.4, seed=0,
                                                   **router_kw)
    return mod["common"].run_scenario(scenario, router,
                                      outcome_fn=mod["sim"](seed=7), seed=0,
                                      cache_mode="full",
                                      semantic_threshold=0.97)


JAX_MODULES = {"scenarios": jax_scenarios, "common": jax_common,
               "sim": JaxOutcomeSimulator}
PORT_MODULES = {"scenarios": scenarios, "common": common,
                "sim": OutcomeSimulator}


@pytest.fixture(scope="module")
def jax_runs():
    out = {name: getattr(jax_bench, name)(per_task=PER_TASK, seed=0)[0]
           for name in BENCH_RUNS}
    out["steady"] = _steady(JAX_MODULES, {})
    out["baselines"] = jax_baselines.run_closed_loop(per_task=10, seed=0)
    out["routerbench"] = jax_routerbench.run_closed_loop(n_per_task=10,
                                                         seed=0)
    return out


# -- generators ----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("gen", GENERATORS)
def test_generator_fingerprint_matches_jax(gen, seed):
    kw = dict(per_task=10, seed=seed)
    got = getattr(scenarios, gen)(**kw)
    want = getattr(jax_scenarios, gen)(**kw)
    assert got.fingerprint() == want.fingerprint()
    assert got.arrivals_s == want.arrivals_s
    assert got.exclude == want.exclude
    assert [(q.uid, q.task, q.text) for q in got.queries] == [
        (q.uid, int(q.task), q.text) for q in want.queries]
    if got.carbon_fn is not None:
        ts = np.linspace(0.0, got.span_s, 7)
        assert [got.carbon_fn(t) for t in ts] == [want.carbon_fn(t)
                                                  for t in ts]
    assert got.fingerprint() == getattr(scenarios, gen)(**kw).fingerprint()


def test_arrival_processes_match_jax():
    for fn, kw in (("poisson_arrivals", dict(rate_qps=20.0)),
                   ("mmpp_arrivals", dict())):
        got = getattr(scenarios, fn)(200, seed=1, **kw)
        assert got == getattr(jax_scenarios, fn)(200, seed=1, **kw)
        assert all(b > a for a, b in zip(got, got[1:]))


def test_pool_churn_events_are_ordered_and_exclude_addition():
    sc = scenarios.pool_churn(per_task=10, seed=0)
    kinds = [e.kind for e in sorted(sc.events, key=lambda e: e.t_s)]
    assert kinds == ["kill", "add"]
    add = next(e for e in sc.events if e.kind == "add")
    assert sc.exclude == [add.model]
    assert all(0.0 < e.t_s < sc.span_s for e in sc.events)


# -- the closed loop against the JAX package -----------------------------


@pytest.mark.parametrize("name", BENCH_RUNS)
def test_scenario_bench_matches_jax(name, jax_runs):
    """The bench's own runs and checks (drained, semantic hits, the
    restart and the grown pool) on the host path."""
    got, checks = getattr(bench, name)(per_task=PER_TASK, seed=0,
                                       device="cpu")
    assert checks
    _close(got, jax_runs[name])


def test_steady_closed_loop_matches_jax(jax_runs):
    _close(_steady(PORT_MODULES, dict(device="cpu")), jax_runs["steady"])


def test_baselines_closed_loop_matches_jax(jax_runs):
    got = baselines.run_closed_loop(per_task=10, seed=0, device="cpu")
    assert_close(got, jax_runs["baselines"], REL)
    for rec in got.values():
        assert rec["completed"] == rec["n_queries"]


def test_routerbench_closed_loop_matches_jax(jax_runs):
    got = routerbench.run_closed_loop(n_per_task=10, seed=0, device="cpu")
    assert_close(got, jax_runs["routerbench"], REL)
    for rec in got.values():
        assert rec["completed"] == rec["n_queries"]


# -- the reference's invariants on the port ------------------------------


def _small_pool():
    names = ("yi-34b", "phi-4-mini-4b", "qwen2.5-14b")
    return ModelPool([make_profile(*r) for r in PAPER_POOL
                      if r[0] in names])


def _small_config():
    return RouterConfig(lam=0.4, seed=0, energy_scale_wh=ENERGY_SCALE_WH,
                        max_arms=8)


def test_closed_loop_greenserv_beats_random_on_acc_and_wh():
    """The paper's headline ordering through the serving stack: the pool
    mixes an expensive-and-weak arm (yi-34b) with cheap and mid arms, so
    learning to avoid it wins both axes at once."""
    scenario = scenarios.steady(per_task=40, seed=0)
    results = {}
    for policy in ("greenserv", "random"):
        router = common.make_closed_loop_router(
            policy=policy, pool=_small_pool(), config=_small_config(),
            device="cpu")
        results[policy] = common.run_scenario(
            scenario, router, outcome_fn=OutcomeSimulator(seed=7), seed=0,
            cache_mode="full", semantic_threshold=0.97)
    gs, rnd = results["greenserv"], results["random"]
    assert gs.completed == rnd.completed == scenario.n_queries
    assert gs.mean_accuracy >= rnd.mean_accuracy
    assert gs.total_energy_wh < rnd.total_energy_wh


def test_run_record_schema_is_uniform(tmp_path):
    scenario = scenarios.steady(per_task=5, seed=0)
    router = common.make_closed_loop_router(pool=_small_pool(),
                                            config=_small_config(),
                                            fit_classifier=False,
                                            device="cpu")
    res = common.run_scenario(scenario, router,
                              outcome_fn=OutcomeSimulator(seed=7), seed=0,
                              trace_every=5)
    rec = common.run_record(res)
    assert set(rec) == {"mean_accuracy", "total_energy_wh", "wh_per_query",
                        "completed", "failed", "n_queries", "span_s",
                        "avoided_wh", "stats", "trajectory"}
    assert rec["completed"] == scenario.n_queries
    assert rec["failed"] == 0
    traj = rec["trajectory"]
    assert traj, "trajectory must not be empty"
    keys = {"t_s", "completed", "failed", "joules", "inflight", "parked",
            "deferred", "cache_hits", "retries", "timeouts", "breaker_opens",
            "selections", "lam"}
    assert all(set(p) == keys for p in traj)
    ts = [p["t_s"] for p in traj]
    assert ts == sorted(ts)
    assert traj[-1]["completed"] == scenario.n_queries
    # per-arm selection counters are cumulative: every completion was
    # either routed to an engine or answered from cache
    last = traj[-1]
    assert sum(last["selections"].values()) + last["cache_hits"] \
        == scenario.n_queries
    # the artifact round-trips in the JAX package's schema
    path = tmp_path / "bench.json"
    common.write_bench_artifact(str(path), bench="x", seed=0,
                                headline={"a": 1}, runs={"r": rec})
    jax_path = tmp_path / "jax.json"
    jax_common.write_bench_artifact(str(jax_path), bench="x", seed=0,
                                    headline={"a": 1}, runs={"r": rec})
    assert json.loads(path.read_text()) == json.loads(jax_path.read_text())


def test_scenario_bench_main_writes_one_artifact_per_scenario(tmp_path):
    lines = bench.main(scenarios=["duplicate_flood"], per_task=10,
                       artifact_prefix=str(tmp_path / "s_"), device="cpu")
    assert lines[1].startswith("duplicate_flood,")
    assert (tmp_path / "s_duplicate_flood.json").exists()


def test_run_algorithm_hoisted_fit_matches_refit():
    """The task classifier is fit once per sweep instead of once per WTP
    point; with identical training data per point the scorecards must be
    bitwise identical."""
    kw = dict(wtps=(0.0, 0.4, 1.0), n_per_task=10, seed=0, device="cpu")
    hoisted = routerbench.run_algorithm("linucb", refit_per_point=False,
                                        **kw)
    refit = routerbench.run_algorithm("linucb", refit_per_point=True, **kw)
    assert hoisted == refit
