"""The port's paper-scale closed loop on the CPU against the JAX package,
on the same inputs: the outcome tables and their draws, the 16-model pool,
the RouterBench table, ``SimEngine`` on an injected clock, ε-greedy (plain
and contextual) draw for draw with the bandit key, and the replay harness
(``run_policy``, ``drive_pool_stream``, the baselines table, the
RouterBench sweep) decision for decision."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from benchmarks import bench_baselines as jax_baselines
from benchmarks import bench_routerbench as jax_routerbench
from benchmarks import common as jax_common
from repro.configs import pool as jax_pool
from repro.core.bandits import BanditPolicy as JaxBanditPolicy
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.core.types import TaskType as JaxTaskType
from repro.data import profiles as jax_profiles
from repro.data import routerbench as jax_rb
from repro.serving.engine import SimEngine as JaxSimEngine
from repro.serving.request import Request as JaxRequest
from repro.serving.request import RequestState as JaxRequestState
from repro_torch.benchmarks import baselines, common, routerbench
from repro_torch.cache import PrefixCache
from repro_torch.configs import pool
from repro_torch.core.bandits import BanditPolicy
from repro_torch.core.types import Query, RouterConfig, TaskType
from repro_torch.data import OutcomeSimulator, profiles
from repro_torch.data import routerbench as rb
from repro_torch.serving import SimEngine
from repro_torch.serving.request import Request, RequestState
from repro_torch.telemetry import Telemetry

pytestmark = pytest.mark.port

PER_TASK = 30                         # T = 150


def test_outcome_draws_equal():
    jq = jax_common.stream(per_task=8, seed=3)
    pq = common.stream(per_task=8, seed=3)
    jsim, psim = jax_profiles.OutcomeSimulator(5), OutcomeSimulator(5)
    names = [row[0] for row in pool.PAPER_POOL]
    for i, (a, b) in enumerate(zip(jq, pq)):
        model = names[i % len(names)]
        assert psim(b, model) == jsim(a, model)
    for task in TaskType:
        got = psim.oracle_tables(names, task)
        want = jsim.oracle_tables(names, JaxTaskType(int(task)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert profiles.ENERGY_SCALE_WH == jax_profiles.ENERGY_SCALE_WH
    for name in names:
        for task in TaskType:
            jt = JaxTaskType(int(task))
            assert (profiles.mean_energy_mwh(name, task)
                    == jax_profiles.mean_energy_mwh(name, jt))
            assert (profiles.mean_accuracy(name, task)
                    == jax_profiles.mean_accuracy(name, jt))


@pytest.mark.parametrize("exclude", [None, [pool.ADDITION_MODEL]])
def test_paper_pool_profiles_equal(exclude):
    assert pool.PAPER_POOL == jax_pool.PAPER_POOL
    assert pool.ADDITION_MODEL == jax_pool.ADDITION_MODEL
    got = pool.build_paper_pool(exclude=exclude)
    want = jax_pool.build_paper_pool(exclude=exclude)
    assert len(got) == len(want) == 16 - len(exclude or [])
    for i in range(len(got)):
        g, w = dataclasses.asdict(got[i]), dataclasses.asdict(want[i])
        assert g == w


def test_paper_pool_refuses_unknown_exclude():
    for build in (pool.build_paper_pool, jax_pool.build_paper_pool):
        with pytest.raises(ValueError, match="not in PAPER_POOL"):
            build(exclude=["gemma-3-12B"])


def test_routerbench_table_and_aiq_equal():
    got, want = rb.build_table(n_per_task=25, seed=4), \
        jax_rb.build_table(n_per_task=25, seed=4)
    assert (got.tasks, got.models) == (want.tasks, want.models)
    for name in ("accuracy", "cost", "task_of", "mean_acc"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert ([rb.query_text(got, i) for i in range(30)]
            == [jax_rb.query_text(want, i) for i in range(30)])
    rng = np.random.default_rng(2)
    for n in (0, 1, 2, 7):
        pts = [tuple(p) for p in rng.random((n, 2))]
        assert rb.aiq(pts) == jax_rb.aiq(pts)
    assert rb.aiq([(1.0, 0.3), (1.0, 0.5)]) == jax_rb.aiq([(1.0, 0.3),
                                                            (1.0, 0.5)])


def _sim_engine_run(engine_cls, request_cls, state_cls, query_cls, task_cls):
    """Submit a stream to one SimEngine (concurrency 2, 2 steps a query)
    on a clock advanced by hand; cancel one request, fail and restart the
    engine mid-run.  Returns every observable, in order."""
    clk = {"t": 100.0}
    sim = (OutcomeSimulator(9) if engine_cls is SimEngine
           else jax_profiles.OutcomeSimulator(9))
    prof = (pool if engine_cls is SimEngine else jax_pool).make_profile(
        "gemma-3-4b", "gemma", 4.0)
    eng = engine_cls(prof, sim, steps_per_query=2, concurrency=2,
                     clock=lambda: clk["t"])
    stream = jax_common.stream(per_task=2, seed=6)
    reqs = [request_cls(query=query_cls(uid=q.uid, text=q.text,
                                        task=task_cls(int(q.task))),
                        prompt_tokens=list(range(3 + i % 5)),
                        max_new_tokens=8, submit_s=clk["t"])
            for i, q in enumerate(stream)]
    eng.submit_many(reqs[:6])
    out, seen = [], []
    for tick in range(40):
        clk["t"] += 0.25
        if tick == 1:
            reqs[3].state = state_cls.CANCELLED
        if tick == 3:
            eng.inject_failure()
            with pytest.raises(RuntimeError):
                eng.step()
            back = eng.restart()
            seen.append([r.uid for r in back])
            eng.submit_many(back + reqs[6:])
            continue
        for resp in eng.step():
            out.append((resp.uid, resp.accuracy, resp.energy_wh,
                        resp.prefill_wh, resp.latency_ms, resp.queue_ms,
                        resp.input_tokens, resp.output_tokens,
                        resp.ttft_ms))
        seen.append((eng.pending, eng.free_capacity, eng.modeled_time_s(),
                     eng.cumulative_joules(),
                     eng.cumulative_joules_by_phase()))
    stamps = [(r.uid, r.start_s, r.finish_s, r.state.value) for r in reqs]
    return out, seen, stamps


def test_sim_engine_responses_equal_on_an_injected_clock():
    got = _sim_engine_run(SimEngine, Request, RequestState, Query, TaskType)
    want = _sim_engine_run(JaxSimEngine, JaxRequest, JaxRequestState,
                           JaxQuery, JaxTaskType)
    assert got == want
    assert len(got[0]) == 9                # 10 requests, one cancelled


def test_sim_engine_refuses_the_prefix_cache():
    """The cache slice gave ``SimEngine`` its prefix cache (it used to
    refuse one): it attaches with no layout gate, and detaches with
    None (``tests/test_torch_cache.py`` drives it against the JAX
    package)."""
    eng = SimEngine(pool.make_profile("qwen2.5-7b", "qwen", 7.0),
                    OutcomeSimulator(0))
    pc = PrefixCache(max_blocks=4, block_tokens=4)
    eng.set_prefix_cache(pc)
    assert eng.prefix_cache is pc
    assert eng.estimate_prefill_wh(8) == 0.0      # nothing observed yet
    eng.set_prefix_cache(None)
    assert eng.prefix_cache is None


@pytest.mark.parametrize("algorithm", ["eps_greedy", "eps_greedy_ctx"])
def test_eps_greedy_draws_and_key_bit_equal(algorithm):
    """Batched selection (Q = 5: the JAX package pads the scan to 8 with
    rows that draw nothing) and Q sequential selections against the JAX
    package's batched scan and its sequential ``select``: the same arms
    and the same key after every batch, and the same masked scores — bit
    for bit for the plain means, to LinUCB's 1e-4 for θ·x, whose θ = A⁻¹b the
    two packages round differently in the last bits."""
    kw = dict(max_arms=8, algorithm=algorithm, epsilon_decay=0.9,
              epsilon_min=0.05, seed=3)
    jb = JaxBanditPolicy(JaxRouterConfig(**kw), n_arms=6)
    js = JaxBanditPolicy(JaxRouterConfig(**kw), n_arms=6)
    pb = BanditPolicy(RouterConfig(**kw), n_arms=6, device="cpu")
    ps = BanditPolicy(RouterConfig(**kw), n_arms=6, device="cpu")
    rng = np.random.default_rng(0)
    d = RouterConfig().context_dim
    explored = 0
    for _ in range(30):
        q = int(rng.choice([1, 3, 5]))
        X = (rng.random((q, d)) < 0.4).astype(np.float32)
        X[:, -1] = 1.0
        F = rng.random((q, 6)) < 0.7
        F[0] = False                       # a row with no feasible arm
        ja, jm = jb.select_batch(X, F)
        pa, pm = pb.select_batch(X, F)
        np.testing.assert_array_equal(pa, ja)
        if algorithm == "eps_greedy":
            np.testing.assert_array_equal(pm, jm)
        else:
            np.testing.assert_allclose(pm, jm, rtol=1e-4, atol=1e-5)
        seq = [(js.select(x, f)[0], ps.select_batch(x[None], f[None])[0][0])
               for x, f in zip(X, F)]
        assert [a for a, _ in seq] == [b for _, b in seq] == list(ja)
        greedy = np.argmax(jm, axis=1)
        explored += int((ja != greedy).sum())
        for pol in (jb, js, pb, ps):
            np.testing.assert_array_equal(pol.state_dict()["key"],
                                          jb.state_dict()["key"])
        for a, x in zip(ja, X):
            r = float(rng.normal())
            for pol in (jb, js, pb, ps):
                pol.update(int(a), x, r)
    assert explored > 0                    # the draws were exercised


def test_linucb_key_follows_jax_through_both_featurize_paths():
    """After LinUCB batches a port ``state_dict`` equals the JAX package's,
    key included, whichever featurize path scored them."""
    stream = common.stream(per_task=4, seed=21)
    ref = jax_common.make_router(seed=5)
    ports = {f: common.make_router(seed=5, device="cpu", featurize=f)
             for f in ("host", "device")}
    assert ports["device"]._device_featurize_active()
    assert not ports["host"]._device_featurize_active()
    for i in range(0, len(stream), 6):
        qs = stream[i:i + 6]
        want = [d.model_index for d in ref.route_batch(
            [JaxQuery(uid=q.uid, text=q.text) for q in qs])]
        for p in ports.values():
            assert [d.model_index for d in p.route_batch(qs)] == want
    for p in ports.values():
        got, exp = p.policy.state_dict(), ref.policy.state_dict()
        np.testing.assert_array_equal(got["key"], exp["key"])
        assert got["key"].dtype == np.uint32
        np.testing.assert_array_equal(got["counts"], exp["counts"])


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="unknown algorithm"):
        BanditPolicy(RouterConfig(algorithm="ucb1"), 3, device="cpu")


# (name, port make_router kwargs, run_policy kwargs)
POLICIES = {
    "linucb-host": (dict(featurize="host"), {}),
    "linucb-device": (dict(featurize="device"), {}),
    "eps-greedy": (dict(algorithm="eps_greedy",
                        features=(False, False, False)), {}),
    "eps-greedy-ctx": (dict(algorithm="eps_greedy_ctx"), {}),
    "random": (None, dict(random_seed=3)),
    "static": (None, dict(static_model="gemma-3-27b")),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_run_policy_identical_to_jax(name):
    router_kw, run_kw = POLICIES[name]
    jq = jax_common.stream(per_task=PER_TASK)
    pq = common.stream(per_task=PER_TASK)
    jr = pr = None
    if router_kw is not None:
        jax_kw = {k: v for k, v in router_kw.items() if k != "featurize"}
        jr = jax_common.make_router(**jax_kw)
        pr = common.make_router(device="cpu", **router_kw)
    want = jax_common.run_policy(jr, jq, jax_profiles.OutcomeSimulator(7),
                                 name, **run_kw)
    got = common.run_policy(pr, pq, OutcomeSimulator(7), name, **run_kw)
    np.testing.assert_array_equal(got.selection_trace, want.selection_trace)
    np.testing.assert_array_equal(got.selections, want.selections)
    for field in ("mean_accuracy", "total_energy_wh", "cumulative_regret"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=1e-6, err_msg=field)
    np.testing.assert_allclose(got.regret_curve, want.regret_curve, rtol=1e-6)
    if pr is not None:
        np.testing.assert_array_equal(pr.policy.state_dict()["key"],
                                      jr.policy.state_dict()["key"])
        assert got.mean_decision_ms > 0.0


def test_run_policy_model_addition_identical_to_jax():
    """§6.2.4: gemma-3-12b held out, joining at query 60 with a fresh arm."""
    kw = dict(add_model_at=60, add_model_name=pool.ADDITION_MODEL)
    jr = jax_common.make_router(exclude=[pool.ADDITION_MODEL])
    pr = common.make_router(exclude=[pool.ADDITION_MODEL], device="cpu")
    want = jax_common.run_policy(jr, jax_common.stream(per_task=24),
                                 jax_profiles.OutcomeSimulator(7), "add",
                                 **kw)
    got = common.run_policy(pr, common.stream(per_task=24),
                            OutcomeSimulator(7), "add", **kw)
    np.testing.assert_array_equal(got.selection_trace, want.selection_trace)
    assert len(pr.pool) == 16
    assert pr.pool.names[-1] == pool.ADDITION_MODEL
    assert got.selections.shape == (16,)


def test_drive_pool_stream_answers_each_uid_with_the_same_arm():
    jq = jax_common.stream(per_task=20, seed=2)
    pq = common.stream(per_task=20, seed=2)
    want = jax_common.drive_pool_stream(jq, batch=25, seed=1)
    got = common.drive_pool_stream(pq, batch=25, seed=1, device="cpu")
    assert len(got.server.responses) == len(pq) == 100
    assert ({u: r.model_name for u, r in got.server.responses.items()}
            == {u: r.model_name for u, r in want.server.responses.items()})
    assert got.mean_accuracy == want.mean_accuracy
    np.testing.assert_allclose(got.total_energy_wh, want.total_energy_wh,
                               rtol=1e-12)
    assert got.n_steps == want.n_steps
    assert got.telemetry is None
    tel = Telemetry()
    run = common.drive_pool_stream(pq[:5], telemetry=tel, device="cpu")
    assert run.telemetry is tel and run.server.telemetry is tel
    assert tel.registry.find("greenserv_admitted_total").value == 5


def test_random_closed_loop_router_identical_to_jax():
    stream = common.stream(per_task=8, seed=4)
    jr = jax_common.make_closed_loop_router("random", lam=0.4, seed=2)
    pr = common.make_closed_loop_router("random", lam=0.4, seed=2,
                                        device="cpu")
    assert isinstance(pr, common.RandomRouter)
    for i in range(0, len(stream), 8):
        qs = stream[i:i + 8]
        want = [d.model_index for d in jr.route_batch(
            [JaxQuery(uid=q.uid, text=q.text) for q in qs])]
        assert [d.model_index for d in pr.route_batch(qs)] == want
        for r in (jr, pr):
            r._pending.clear()


def test_baselines_table_identical_to_jax():
    want = jax_baselines.run(per_task=6, seed=1)
    got = baselines.run(per_task=6, seed=1, device="cpu")
    assert list(got) == list(want)
    for name, r in got.items():
        np.testing.assert_array_equal(r.selection_trace,
                                      want[name].selection_trace)
        assert r.mean_accuracy == want[name].mean_accuracy
    lines = baselines.table(got)
    assert lines[-1].startswith("# paper targets")
    assert len(lines) == len(got) + 2


def test_baselines_refuse_thompson_rows():
    """The table runs its ``ctx-thompson`` row now (CTS is ported); it
    still refuses a row it does not have (``thompson`` is RouterBench's
    name)."""
    got = baselines.run(per_task=1, rows=["ctx-thompson"], device="cpu")
    assert list(got) == ["ctx-thompson"]
    with pytest.raises(ValueError, match="unknown rows"):
        baselines.run(per_task=1, rows=["thompson"], device="cpu")


@pytest.mark.parametrize("algorithm", routerbench.ALGORITHMS)
def test_routerbench_sweep_identical_to_jax(algorithm):
    # 10 a task: the classifier is fit on the table's first 90 queries
    kw = dict(wtps=(0.0, 0.4, 1.0), n_per_task=10, seed=0)
    want = jax_routerbench.run_algorithm(algorithm, **kw)
    got = routerbench.run_algorithm(algorithm, device="cpu", **kw)
    assert got == want
