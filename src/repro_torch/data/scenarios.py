"""Composable traffic scenarios for the paper-scale closed-loop benches.

A :class:`Scenario` bundles everything a closed-loop drive needs to replay
a traffic shape deterministically: the query stream, per-query arrival
times on the virtual clock, mid-run pool events (engine kills, runtime
model additions), and an optional carbon-intensity signal for the
governor.  Generators compose the shapes the GreenServ evaluation cares
about:

  * :func:`steady`          — Poisson arrivals, optional diurnal carbon;
  * :func:`flash_crowd`     — two-state MMPP arrivals (calm stretches
    punctuated by flash crowds, the geometry of ``benchmarks/disagg.py``)
    under a diurnal carbon cycle scaled to the run's span;
  * :func:`duplicate_flood` — adversarial near-duplicate bursts aimed at
    the semantic cache: hot queries replayed with small textual
    perturbations that should (and, with the cluster guard, safely can)
    hit the embedding-similarity lookup;
  * :func:`pool_churn`      — an engine killed mid-run (fault-tolerance
    path) plus the paper's §6.2.4 held-out model joining via
    ``add_engine`` (zero-calibration adaptability).

Everything is seeded — the same seed replays the identical scenario, byte
for byte (``Scenario.fingerprint`` hashes the whole thing for tests).
Arrival timescales are *modeled* seconds: ``SimEngine`` ticks advance the
virtual clock by per-query latency shares (hundreds of ms to seconds), so
the default rates put calm load near a 16-model pool's service rate and
bursts well past it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.types import Query
from repro_torch.data.stream import make_stream
from repro_torch.telemetry.budget import diurnal_carbon_intensity


@dataclasses.dataclass(frozen=True)
class PoolEvent:
    """A mid-run pool-membership change, applied when the virtual clock
    passes ``t_s``: ``kind="kill"`` injects a failure into the named
    engine (the scheduler's heartbeat/restart path recovers it);
    ``kind="add"`` registers the named paper-pool model as a fresh engine
    + bandit arm via ``PoolServer.add_engine``."""

    t_s: float
    kind: str          # "kill" | "add"
    model: str


@dataclasses.dataclass
class Scenario:
    """One replayable traffic shape for the closed-loop harness."""

    name: str
    queries: List[Query]
    arrivals_s: List[float]
    events: List[PoolEvent] = dataclasses.field(default_factory=list)
    carbon_fn: Optional[Callable[[float], float]] = None
    # models held out of the *starting* pool (an "add" event brings them in)
    exclude: Optional[List[str]] = None
    # chaos plan: engine name -> FaultSpec list (serving.faults), wrapped
    # around the matching engine by the harness before the drive starts
    faults: Optional[dict] = None

    @property
    def n_queries(self) -> int:
        return len(self.queries)

    @property
    def span_s(self) -> float:
        return self.arrivals_s[-1] if self.arrivals_s else 0.0

    def fingerprint(self) -> str:
        """Deterministic digest of the whole scenario (stream texts,
        arrival times, events) — the determinism tests compare these."""
        h = hashlib.sha256()
        for q, t in zip(self.queries, self.arrivals_s):
            h.update(f"{q.uid}|{q.task}|{t:.9f}|{q.text}".encode())
        for e in self.events:
            h.update(f"{e.t_s:.9f}|{e.kind}|{e.model}".encode())
        for name in sorted(self.faults or {}):
            for f in self.faults[name]:
                h.update(f"{name}|{f.kind}|{f.t_s:.9f}|{f.duration_s:.9f}"
                         f"|{f.magnitude:.9f}".encode())
        return h.hexdigest()


# -- arrival processes --------------------------------------------------------


def poisson_arrivals(n: int, rate_qps: float, seed: int = 0) -> List[float]:
    """``n`` Poisson arrival times at ``rate_qps`` queries per (modeled)
    second, starting at t=0+."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_qps, 1e-9), size=n)
    return list(np.cumsum(gaps))


def mmpp_arrivals(n: int, seed: int = 0, calm_qps: float = 12.0,
                  burst_qps: float = 120.0, mean_calm_run: int = 40,
                  mean_burst_run: int = 60) -> List[float]:
    """Two-state Markov-modulated Poisson arrivals: calm stretches at
    ``calm_qps`` alternate with flash crowds at ``burst_qps``; run lengths
    (in queries) are geometric with the given means.  Fully seeded."""
    rng = np.random.default_rng(seed)
    times: List[float] = []
    t = 0.0
    in_burst, remaining = False, 0
    for _ in range(n):
        if remaining <= 0:
            in_burst = not in_burst
            mean_run = mean_burst_run if in_burst else mean_calm_run
            remaining = int(rng.geometric(1.0 / max(mean_run, 1)))
        remaining -= 1
        rate = burst_qps if in_burst else calm_qps
        t += float(rng.exponential(1.0 / rate))
        times.append(t)
    return times


def _diurnal_fn(span_s: float, amplitude: float,
                days: float = 1.5) -> Callable[[float], float]:
    """A diurnal carbon signal whose period packs ``days`` full cycles
    into the run's expected span — paper-scale runs last modeled minutes,
    not actual days, so the cycle is compressed to stay observable."""
    period = max(span_s / max(days, 1e-6), 1e-6)
    return lambda t_s: diurnal_carbon_intensity(t_s, amplitude=amplitude,
                                                period_s=period)


# -- scenario generators ------------------------------------------------------


def steady(per_task: int = 100, seed: int = 0, rate_qps: float = 24.0,
           carbon_amplitude: float = 0.0) -> Scenario:
    """Steady Poisson traffic over the paper's 5-task stream; the neutral
    baseline shape (``benchmarks/baselines.py`` runs its closed loop
    here)."""
    queries = make_stream(per_task=per_task, seed=seed)
    arrivals = poisson_arrivals(len(queries), rate_qps, seed=seed + 1)
    carbon = (_diurnal_fn(arrivals[-1], carbon_amplitude)
              if carbon_amplitude > 0 else None)
    return Scenario(name="steady", queries=queries, arrivals_s=arrivals,
                    carbon_fn=carbon)


def flash_crowd(per_task: int = 100, seed: int = 0, calm_qps: float = 12.0,
                burst_qps: float = 120.0, carbon_amplitude: float = 0.3
                ) -> Scenario:
    """Diurnal carbon + MMPP flash crowds: calm load near the pool's
    service rate, bursts ~10x past it — the regime where admission
    planning and budget governance (not raw capacity) set the outcome."""
    queries = make_stream(per_task=per_task, seed=seed)
    arrivals = mmpp_arrivals(len(queries), seed=seed + 1, calm_qps=calm_qps,
                             burst_qps=burst_qps)
    return Scenario(name="flash_crowd", queries=queries, arrivals_s=arrivals,
                    carbon_fn=_diurnal_fn(arrivals[-1], carbon_amplitude))


def duplicate_flood(per_task: int = 60, seed: int = 0, n_hot: int = 8,
                    dup_factor: int = 6, rate_qps: float = 30.0) -> Scenario:
    """Adversarial near-duplicate flood against the semantic cache: a base
    stream plus ``n_hot`` hot queries each replayed ``dup_factor`` times
    with small textual perturbations (politeness suffixes, whitespace) —
    close enough in embedding space to hit the similarity lookup, so the
    cache serves the flood at zero engine work.  Duplicates inherit the
    hot query's task and reference (the cached answer is genuinely
    correct for them)."""
    rng = random.Random(seed + 2)
    base = make_stream(per_task=per_task, seed=seed)
    hot = rng.sample(base, min(n_hot, len(base)))
    suffixes = [" Thanks!", " Please answer.", "  ", " (urgent)",
                " Appreciate it.", " Respond concisely."]
    flood: List[Query] = []
    uid = len(base)
    for q in hot:
        for _ in range(dup_factor):
            flood.append(Query(uid=uid, text=q.text + rng.choice(suffixes),
                               task=q.task, reference=q.reference,
                               max_new_tokens=q.max_new_tokens))
            uid += 1
    queries = list(base)
    # splice the flood in as bursts right after the mid-point, so the hot
    # originals have completed (and been inserted) before their duplicates
    mid = len(base) // 2
    queries[mid:mid] = flood
    queries = [dataclasses.replace(q, uid=i) if q.uid != i else q
               for i, q in enumerate(queries)]
    arrivals = poisson_arrivals(len(queries), rate_qps, seed=seed + 3)
    return Scenario(name="duplicate_flood", queries=queries,
                    arrivals_s=arrivals)


def pool_churn(per_task: int = 60, seed: int = 0, rate_qps: float = 24.0,
               kill_model: str = "qwen2.5-14b", kill_frac: float = 0.3,
               add_model: str = "gemma-3-12b",
               add_frac: float = 0.5) -> Scenario:
    """Model-pool churn mid-run: ``kill_model`` fails at ``kill_frac`` of
    the arrival span (its in-flight requests must be re-routed, nothing
    lost) and the held-out ``add_model`` (paper §6.2.4) joins at
    ``add_frac`` via ``add_engine`` — a fresh bandit arm with zero
    offline calibration."""
    queries = make_stream(per_task=per_task, seed=seed)
    arrivals = poisson_arrivals(len(queries), rate_qps, seed=seed + 1)
    span = arrivals[-1]
    events = [PoolEvent(t_s=kill_frac * span, kind="kill", model=kill_model),
              PoolEvent(t_s=add_frac * span, kind="add", model=add_model)]
    return Scenario(name="pool_churn", queries=queries, arrivals_s=arrivals,
                    events=events, exclude=[add_model])


def chaos(per_task: int = 60, seed: int = 0, rate_qps: float = 12.0,
          targets: tuple = ("qwen2.5-14b", "mistral-7b"),
          background_models: tuple = ("llama-3.1-8b", "gemma-3-4b"),
          background_rate: float = 0.5, frac_start: float = 0.35,
          frac_end: float = 0.85, n_crashes: int = 4) -> Scenario:
    """Chaos drill: steady Poisson traffic while a seeded fault storm
    (``serving.faults.fault_storm``) batters the pool — each ``targets``
    engine serves garbage (NaN-grade, zero-accuracy) output through the
    same mid-run window and crashes twice inside it, while
    ``background_models`` pick up Poisson-placed stalls and slow-step
    episodes.  The default targets are the arms the converged bandit
    leans on hardest (one big, one small), so the storm hits real
    traffic — the regime where deadlines, retries, and per-arm circuit
    breakers (not raw capacity) set the outcome: with the reliability
    layer off, the router keeps feeding the poisoned arms until their
    zero-accuracy completions wash back through the bandit."""
    from repro_torch.serving.faults import fault_storm  # avoid an import cycle
    queries = make_stream(per_task=per_task, seed=seed)
    arrivals = poisson_arrivals(len(queries), rate_qps, seed=seed + 1)
    faults: dict = {}
    for i, target in enumerate(targets):
        storm = fault_storm(
            span_s=arrivals[-1], target=target,
            # background faults ride along with the first storm only
            others=list(background_models) if i == 0 else [],
            seed=seed + 2 + i, frac_start=frac_start, frac_end=frac_end,
            n_crashes=n_crashes, background_rate=background_rate)
        for name, specs in storm.items():
            faults.setdefault(name, []).extend(specs)
    return Scenario(name="chaos", queries=queries, arrivals_s=arrivals,
                    faults=faults)


__all__ = ["PoolEvent", "Scenario", "poisson_arrivals", "mmpp_arrivals",
           "steady", "flash_crowd", "duplicate_flood", "pool_churn",
           "chaos"]
