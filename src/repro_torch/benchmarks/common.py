"""Shared simulation harness for the paper-scale runs.

Two drive modes share this module:

  * the *offline* replay (``run_policy``) — the router's ``route()`` loop
    over calibrated outcome tables, reproducing the paper's Figs. 2-4
    numbers in isolation from the serving stack;
  * the paced serving drive (``drive_pool_stream``) — the same streams
    through ``PoolServer.submit_batch`` → ``route_batch`` over one
    ``SimEngine`` per pool member;
  * the *closed-loop* scenario drive (``run_scenario``) — a
    ``repro_torch.data.scenarios`` stream through the full production
    path on a virtual clock: ``PoolServer.enqueue`` → GreenCache probe →
    ``route_batch`` (cost-model tilt) → governor, with mid-run pool
    events, chaos fault schedules and the reliability layer.  Every
    closed-loop run gives the uniform trajectory record (``run_record``
    / ``write_bench_artifact``).

Every router here is built on ``device`` (None: the card);
``make_router`` also takes the featurize placement ("auto": the device
path when the device is CUDA).  The cache's own workload and drive are
``benchmarks/cache.py``.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.pool import PAPER_POOL, build_paper_pool, make_profile
from repro_torch.cache import GreenCache
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, Query, RouteDecision, RouterConfig
from repro_torch.costmodel import EnergyCostModel
from repro_torch.data import ENERGY_SCALE_WH, OutcomeSimulator
from repro_torch.data.scenarios import Scenario
from repro_torch.data.stream import labeled_sample, make_stream
from repro_torch.serving import (FaultInjector, LivelockError, PoolServer,
                                 SimEngine)
from repro_torch.telemetry.budget import EnergyBudgetGovernor
from repro_torch.telemetry.hub import Telemetry


@dataclasses.dataclass
class RunResult:
    name: str
    mean_accuracy: float
    total_energy_wh: float
    cumulative_regret: float
    regret_curve: np.ndarray
    selections: np.ndarray
    selection_trace: np.ndarray
    mean_decision_ms: float
    feature_ms: Dict[str, float]


def _fit_classifier(router: GreenServRouter, seed: int) -> None:
    texts, labels = labeled_sample(n_per_task=40, seed=seed + 1)
    router.context.task_classifier.fit(texts, labels, steps=150)


def make_router(lam: float = 0.4, algorithm: str = "linucb",
                features=(True, True, True), seed: int = 0,
                exclude: Optional[List[str]] = None, device=None,
                featurize: str = "auto") -> GreenServRouter:
    cfg = RouterConfig(lam=lam, algorithm=algorithm, seed=seed,
                       energy_scale_wh=ENERGY_SCALE_WH, max_arms=32,
                       featurize=featurize)
    pool = build_paper_pool(exclude=exclude)
    router = GreenServRouter(cfg, pool, device=device)
    router.context.set_features(*features)
    if features[0]:
        _fit_classifier(router, seed)
    return router


def run_policy(router: Optional[GreenServRouter], queries: Sequence[Query],
               sim: OutcomeSimulator, name: str,
               static_model: Optional[str] = None,
               random_seed: Optional[int] = None,
               add_model_at: Optional[int] = None,
               add_model_name: Optional[str] = None) -> RunResult:
    """router=None + static_model/random_seed runs the paper's baselines;
    ``add_model_at``/``add_model_name`` add a held-out paper-pool model
    at that query (§6.2.4)."""
    pool = router.pool if router else build_paper_pool()
    names = pool.names
    rng = np.random.default_rng(random_seed or 0)
    accs: List[float] = []
    energy = 0.0
    regret_hist: List[float] = []
    selections = np.zeros(32, np.int64)
    trace = np.zeros(len(queries), np.int16)

    for t, q in enumerate(queries):
        if router and add_model_at is not None and t == add_model_at:
            row = next(r for r in PAPER_POOL if r[0] == add_model_name)
            pool.add(make_profile(*row))
            names = pool.names
        if router is not None:
            decision = router.route(q)
            m_idx = decision.model_index
        elif static_model is not None:
            m_idx = names.index(static_model)
        else:
            m_idx = int(rng.integers(len(names)))
        model = names[m_idx]
        acc, e_wh, lat, _ = sim(q, model)
        accs.append(acc)
        energy += e_wh
        selections[m_idx] += 1
        trace[t] = m_idx
        # oracle regret over the mean tables (Eq. 6-8)
        acc_tab, e_tab = sim.oracle_tables(names, q.task)
        lam = router.config.lam if router else 0.4
        rewards = (1 - lam) * acc_tab - lam * e_tab / ENERGY_SCALE_WH
        chosen_mean = rewards[m_idx]
        regret_hist.append(float(rewards.max() - chosen_mean))
        if router is not None:
            router.feedback(Feedback(query_uid=q.uid, model_index=m_idx,
                                     accuracy=acc, energy_wh=e_wh,
                                     latency_ms=lat))
    feature_ms = router.context.mean_overhead_ms() if router else {}
    return RunResult(
        name=name, mean_accuracy=float(np.mean(accs)),
        total_energy_wh=energy,
        cumulative_regret=float(np.sum(regret_hist)),
        regret_curve=np.cumsum(regret_hist),
        selections=selections[: len(names)],
        selection_trace=trace,
        mean_decision_ms=router.mean_decision_ms if router else 0.0,
        feature_ms=feature_ms)


def stream(per_task: int = 500, seed: int = 0):
    return make_stream(per_task=per_task, seed=seed)


@dataclasses.dataclass
class ServeResult:
    """Outcome of one paced PoolServer drive over a stream."""

    mean_accuracy: float
    total_energy_wh: float
    step_s_total: float
    n_steps: int
    server: object                      # the drained PoolServer
    telemetry: object                   # the Telemetry passed in, or None

    @property
    def step_ms(self) -> float:
        return self.step_s_total / max(self.n_steps, 1) * 1e3


def drive_pool_stream(queries: Sequence[Query], telemetry=None,
                      lam: float = 0.4, seed: int = 0, batch: int = 25,
                      concurrency: int = 4,
                      max_inflight: Optional[int] = None,
                      exclude: Optional[List[str]] = None,
                      max_arms: int = 32,
                      fit_classifier: bool = False,
                      device=None) -> ServeResult:
    """Serve a stream through a SimEngine pool behind PoolServer.

    Admission is paced — the next batch waits until in-flight work drains
    below ``max_inflight`` (default 2·batch), since open-loop blasting
    into a backed-up pool would let hundreds of stale routing decisions
    queue before their first feedback — and, with a governed
    ``telemetry``, between a λ adjustment and its first observable
    effect.
    """
    max_inflight = max_inflight if max_inflight is not None else 2 * batch
    pool = build_paper_pool(exclude=exclude)
    router = GreenServRouter(
        RouterConfig(lam=lam, energy_scale_wh=ENERGY_SCALE_WH,
                     max_arms=max_arms, seed=seed),
        pool, device=device)
    if fit_classifier:
        _fit_classifier(router, seed)
    sim = OutcomeSimulator(seed=seed)
    engines = {pool[i].name: SimEngine(pool[i], sim, concurrency=concurrency)
               for i in range(len(pool))}
    server = PoolServer(router, engines, telemetry=telemetry)
    step_s = 0.0
    n_steps = 0

    def timed_step():
        nonlocal step_s, n_steps
        t0 = time.perf_counter()
        server.step()
        step_s += time.perf_counter() - t0
        n_steps += 1

    for i in range(0, len(queries), batch):
        while len(server.inflight) > max_inflight and n_steps < 100_000:
            timed_step()
        server.submit_batch(queries[i:i + batch])
        timed_step()
    while server.inflight and n_steps < 100_000:
        timed_step()
    accs = [getattr(r, "accuracy", 0.0) for r in server.responses.values()]
    wh = sum(r.energy_wh for r in server.responses.values())
    return ServeResult(mean_accuracy=float(np.mean(accs)),
                       total_energy_wh=wh, step_s_total=step_s,
                       n_steps=n_steps, server=server, telemetry=telemetry)


class RandomRouter(GreenServRouter):
    """The paper's random baseline behind the *full* serving stack.

    Runs the real ``route_batch`` (featurization, k-means updates,
    feasibility masks, overhead timing all stay honest), then overrides
    each arm choice with a uniformly random feasible arm.  The pending
    -decision entry is overwritten with the replaced decision so
    ``feedback`` — which validates the fed-back arm against the decision
    it recorded — closes cleanly; the posterior still learns from the
    random pulls, exactly like the offline random baseline."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._rand = np.random.default_rng(self.config.seed + 104729)

    def route_batch(self, queries: Sequence[Query],
                    **kwargs) -> List[RouteDecision]:
        decisions = super().route_batch(queries, **kwargs)
        n_models = len(self.pool.names)
        out = []
        for q, d in zip(queries, decisions):
            feasible = np.flatnonzero(
                np.asarray(d.feasible_mask)[:n_models])
            idx = (int(self._rand.choice(feasible)) if feasible.size
                   else d.model_index)
            nd = dataclasses.replace(d, model_index=idx,
                                     model_name=self.pool.names[idx])
            self._pending[q.uid] = nd
            out.append(nd)
        return out


def make_closed_loop_router(policy: str = "greenserv", lam: float = 0.2,
                            seed: int = 0,
                            exclude: Optional[List[str]] = None,
                            fit_classifier: bool = True,
                            max_arms: int = 32,
                            pool=None,
                            config: Optional[RouterConfig] = None,
                            device=None) -> GreenServRouter:
    """A router wired for the serving loop: ``policy`` is ``"greenserv"``
    (LinUCB) or ``"random"`` (uniform feasible arm through the same
    stack).  Pass ``pool``/``config`` to run non-paper pools (e.g. the
    RouterBench models)."""
    cfg = config or RouterConfig(lam=lam, seed=seed,
                                 energy_scale_wh=ENERGY_SCALE_WH,
                                 max_arms=max_arms)
    pool = pool if pool is not None else build_paper_pool(exclude=exclude)
    cls = {"greenserv": GreenServRouter, "random": RandomRouter}[policy]
    router = cls(cfg, pool, device=device)
    if fit_classifier:
        _fit_classifier(router, seed)
    return router


@dataclasses.dataclass
class ClosedLoopResult:
    """Outcome of one ``run_scenario`` drive (and the source of the
    uniform BENCH run record, ``run_record``)."""

    name: str
    mean_accuracy: float
    total_energy_wh: float
    completed: int
    n_queries: int
    span_s: float                       # modeled seconds start → drain
    stats: Dict[str, int]               # PoolServer.stats copy
    trajectory: List[dict]
    avoided_wh: float                   # prefix-KV reuse credit (engines)
    server: object
    telemetry: object
    failed: int = 0                     # terminal TIMED_OUT/FAILED uids


def run_record(result: ClosedLoopResult) -> dict:
    """The uniform per-run payload every BENCH artifact embeds."""
    return {
        "mean_accuracy": float(result.mean_accuracy),
        "total_energy_wh": float(result.total_energy_wh),
        "wh_per_query": float(result.total_energy_wh
                              / max(result.completed, 1)),
        "completed": int(result.completed),
        "failed": int(result.failed),
        "n_queries": int(result.n_queries),
        "span_s": float(result.span_s),
        "avoided_wh": float(result.avoided_wh),
        "stats": {k: int(v) for k, v in result.stats.items()},
        "trajectory": result.trajectory,
    }


def write_bench_artifact(path: str, bench: str, seed: int,
                         headline: Dict[str, float],
                         runs: Dict[str, dict], **top) -> None:
    """The uniform BENCH_*.json schema every bench and scenario emits:
    ``{"bench", "seed", "headline", "runs"}`` (plus a bench's own ``top``
    fields, e.g. ``n_queries``) where each run carries a ``trajectory``
    list, so runs diff across commits.  A headline value is a number or a
    dict of numbers (per-cell figures)."""
    def num(v):
        return ({k: float(x) for k, x in v.items()} if isinstance(v, dict)
                else float(v))

    with open(path, "w") as f:
        json.dump({"bench": bench, "seed": int(seed),
                   "headline": {k: num(v) for k, v in headline.items()},
                   "runs": runs, **top}, f, indent=1, sort_keys=True)


def run_scenario(scenario: Scenario, router: GreenServRouter,
                 outcome_fn: Optional[Callable] = None, *,
                 name: Optional[str] = None,
                 seed: int = 0,
                 concurrency: int = 4,
                 steps_per_query: int = 1,
                 cache_mode: str = "full",
                 semantic_threshold: float = 0.92,
                 budget_wh_per_query: Optional[float] = None,
                 governor_kwargs: Optional[dict] = None,
                 admission_planner: bool = False,
                 use_cost_model: bool = True,
                 hedge_after_steps: Optional[int] = None,
                 engine_factory: Optional[Callable] = None,
                 server_kwargs: Optional[dict] = None,
                 trace_every: int = 25,
                 max_steps: int = 250_000) -> ClosedLoopResult:
    """Drive one scenario through the full closed loop on a virtual clock.

    The loop mirrors ``benchmarks/disagg.py``'s ``drive``: the clock idle-jumps to the
    next arrival when the pool is empty, due arrivals go through
    ``PoolServer.enqueue`` (admission happens at step() capacity), pool
    events fire when the clock passes them, and each tick advances the
    clock by the pool-wide modeled-time delta.  Engines, caches, the
    governor, telemetry, and the scheduler all share the *same* clock —
    no wall time leaks into TTFT/queue stats or TTL decisions.

    ``budget_wh_per_query`` arms an ``EnergyBudgetGovernor`` sized to the
    scenario (budget = per-query × n_queries) with the scenario's
    ``carbon_fn``; ``admission_planner`` additionally gates admission on
    its headroom.  ``engine_factory(profile, clock)`` overrides SimEngine
    construction for non-paper pools (RouterBench tables).

    ``server_kwargs`` passes extra PoolServer knobs straight through —
    the reliability layer rides in here (``deadline_s``, ``max_retries``,
    ``retry_backoff_steps``, ``breaker_config``).  When the scenario
    carries a ``faults`` plan, each named engine is wrapped in a seeded
    ``FaultInjector`` before the drive starts (docs/RELIABILITY.md).

    The router's device and featurize placement are the caller's: the
    drive itself is host code over the router's ``route_batch``."""
    clk = {"t": 0.0}
    clock = lambda: clk["t"]  # noqa: E731 — the shared virtual time source
    outcome_fn = outcome_fn or OutcomeSimulator(seed=seed)
    if engine_factory is None:
        engine_factory = lambda prof, c: SimEngine(  # noqa: E731
            prof, outcome_fn, steps_per_query=steps_per_query,
            concurrency=concurrency, clock=c)
    pool = router.pool
    engines = {pool[i].name: engine_factory(pool[i], clock)
               for i in range(len(pool))}
    for eng_name, faults in (scenario.faults or {}).items():
        if eng_name in engines and faults:
            engines[eng_name] = FaultInjector(engines[eng_name], faults,
                                              clock=clock)
    cache = (GreenCache(mode=cache_mode,
                        semantic_threshold=semantic_threshold, clock=clock)
             if cache_mode != "off" else None)
    governor = None
    if budget_wh_per_query is not None:
        governor = EnergyBudgetGovernor(
            budget_wh_per_query * scenario.n_queries,
            horizon_queries=scenario.n_queries,
            carbon_fn=scenario.carbon_fn, **(governor_kwargs or {}))
    telemetry = Telemetry(governor=governor, clock=clock)
    server = PoolServer(
        router, engines, telemetry=telemetry, cache=cache,
        cost_model=EnergyCostModel() if use_cost_model else None,
        admission_planner=admission_planner,
        hedge_after_steps=hedge_after_steps,
        # virtual idle-jumps can cross any wall-style timeout in one tick;
        # engine failures still surface through the _failed flag
        heartbeat_timeout_s=1e18,
        clock=clock, **(server_kwargs or {}))
    queries, arrivals = scenario.queries, scenario.arrivals_s
    events = sorted(scenario.events, key=lambda e: e.t_s)
    arr_i = ev_i = steps = 0
    last_modeled = 0.0
    trajectory: List[dict] = []

    def sample() -> dict:
        return {"t_s": round(clk["t"], 6),
                "completed": len(server.responses),
                "failed": len(server.failed),
                "joules": round(sum(e.cumulative_joules()
                                    for e in server.engines.values()), 6),
                "inflight": len(server.inflight),
                "parked": len(server.arrivals),
                "deferred": int(server.stats["deferred"]),
                "cache_hits": int(server.stats["cache_hits"]),
                "retries": int(server.stats["retries"]),
                "timeouts": int(server.stats["timeouts"]),
                "breaker_opens": int(server.stats["breaker_opens"]),
                # cumulative routing decisions per arm — the chaos bench
                # differences consecutive samples to show the breaker
                # shifting share off a faulty engine mid-run
                "selections": {n: int(c) for n, c
                               in sorted(server.dispatch_counts.items())},
                "lam": float(router.config.lam)}

    while arr_i < len(queries) or server.inflight or server.arrivals:
        if steps >= max_steps:
            raise LivelockError(
                f"scenario {scenario.name!r}: {len(server.inflight)} in "
                f"flight, {len(server.arrivals)} parked, "
                f"{len(queries) - arr_i} future arrivals after "
                f"{max_steps} steps\n" + server.drain_snapshot())
        # pool events fire once the virtual clock passes them
        while ev_i < len(events) and events[ev_i].t_s <= clk["t"]:
            ev = events[ev_i]
            ev_i += 1
            if ev.kind == "kill":
                server.engines[ev.model].inject_failure()
            elif ev.kind == "add":
                row = next(r for r in PAPER_POOL if r[0] == ev.model)
                prof = make_profile(*row)
                server.add_engine(prof, engine_factory(prof, clock))
            else:
                raise ValueError(f"unknown PoolEvent kind {ev.kind!r}")
        # idle: jump straight to the next arrival (or pending event)
        if (arr_i < len(queries) and not server.inflight
                and not server.arrivals and clk["t"] < arrivals[arr_i]):
            jump_to = arrivals[arr_i]
            if ev_i < len(events):
                jump_to = min(jump_to, events[ev_i].t_s)
            clk["t"] = jump_to
            continue
        while arr_i < len(queries) and arrivals[arr_i] <= clk["t"]:
            server.enqueue(queries[arr_i])
            arr_i += 1
        server.step()
        steps += 1
        now_modeled = max((e.modeled_time_s()
                           for e in server.engines.values()), default=0.0)
        clk["t"] += max(now_modeled - last_modeled, 1e-7)
        last_modeled = now_modeled
        if steps % trace_every == 0:
            trajectory.append(sample())
    trajectory.append(sample())
    accs = [getattr(r, "accuracy", 0.0) for r in server.responses.values()]
    wh = sum(r.energy_wh for r in server.responses.values())
    avoided = sum(e.cumulative_joules_avoided()
                  for e in server.engines.values()) / 3600.0
    return ClosedLoopResult(
        name=name or scenario.name,
        mean_accuracy=float(np.mean(accs)) if accs else 0.0,
        total_energy_wh=float(wh), completed=len(server.responses),
        n_queries=scenario.n_queries, span_s=float(clk["t"]),
        stats=dict(server.stats), trajectory=trajectory,
        avoided_wh=float(avoided), server=server, telemetry=telemetry,
        failed=len(server.failed))
