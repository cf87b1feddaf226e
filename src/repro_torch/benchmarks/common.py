"""Shared simulation harness for the paper-scale runs.

Two drive modes share this module:

  * the *offline* replay (``run_policy``) — the router's ``route()`` loop
    over calibrated outcome tables, reproducing the paper's Figs. 2-4
    numbers in isolation from the serving stack;
  * the paced serving drive (``drive_pool_stream``) — the same streams
    through ``PoolServer.submit_batch`` → ``route_batch`` over one
    ``SimEngine`` per pool member.

Every router here is built on ``device`` (None: the card);
``make_router`` also takes the featurize placement ("auto": the device
path when the device is CUDA).  The
JAX package's closed-loop scenario drive (``run_scenario``, ``run_record``,
``ClosedLoopResult``) runs the cache, the cost model, telemetry and the
governor, and waits for the port's cost-model and telemetry slices (the
cache's own workload and drive are ``benchmarks/cache.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.configs.pool import PAPER_POOL, build_paper_pool, make_profile
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, Query, RouteDecision, RouterConfig
from repro_torch.data import ENERGY_SCALE_WH, OutcomeSimulator
from repro_torch.data.stream import labeled_sample, make_stream
from repro_torch.serving import PoolServer, SimEngine


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
    telemetry: object                   # always None until telemetry is ported

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
    queue before their first feedback.  ``telemetry`` is refused by the
    port's ``PoolServer`` until its telemetry slice.
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
