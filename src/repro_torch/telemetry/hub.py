"""The ``Telemetry`` facade: one object the serving stack reports into.

``PoolServer`` calls four hooks (admission, completion, hedge/restart,
per-step) and this hub fans the data out to the metrics registry, the
power trace, the event log, and — when governed — the
``EnergyBudgetGovernor``.  All hooks are O(1) per call with pre-bound
metric handles, so telemetry stays well under the 5 % step-overhead
budget the JAX package's ``benchmarks/bench_telemetry.py`` asserts.  The
reliability and migration hooks (``on_attempt_failure`` … ``on_breaker``,
``on_migration``) count retries, timeouts, failures, SLO violations,
breaker transitions and KV migrations, with their counters pre-bound so
an export lists the same series as the JAX package's.

Metric conventions (exported names):

  greenserv_admitted_total / greenserv_completed_total{model=}
  greenserv_hedges_total / greenserv_restarts_total{engine=}
  greenserv_tokens_total{model=, dir=in|out}
  greenserv_energy_mwh_total{model=}
  greenserv_latency_ms{model=} · greenserv_ttft_ms · greenserv_queue_wait_ms
  greenserv_energy_per_token_mwh{model=}
  greenserv_queue_depth{engine=} · greenserv_power_watts{source=}
  greenserv_energy_joules_total{phase=prefill|decode}
  greenserv_energy_joules_avoided_total{kind=prefix|semantic}
  greenserv_cache_hits_total{kind=prefix|semantic}
  greenserv_energy_prediction_error_ratio
  greenserv_lambda · greenserv_budget_pressure

Energy is phase-split: engines report cumulative joules tagged prefill
(prompt ingestion, compute-bound) vs decode (generation, bandwidth-bound);
the hub exports phase counters + phase watts gauges, samples phase series
into the PowerTrace, and feeds the governor's phase ledger.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.telemetry import events as ev
from repro_torch.telemetry.budget import EnergyBudgetGovernor
from repro_torch.telemetry.events import EventLog
from repro_torch.telemetry.metrics import Counter, Histogram, MetricsRegistry
from repro_torch.telemetry.power import (AVOIDED, PHASE_DECODE,
                                         PHASE_PREFILL, POOL, PowerTrace)
from repro_torch.core.energy import JOULES_PER_WH


class Telemetry:
    def __init__(self,
                 registry: Optional[MetricsRegistry] = None,
                 power: Optional[PowerTrace] = None,
                 events: Optional[EventLog] = None,
                 governor: Optional[EnergyBudgetGovernor] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.power = power if power is not None else PowerTrace()
        self.events = events if events is not None else EventLog()
        self.governor = governor
        self.clock = clock or time.monotonic
        r = self.registry
        self._admitted = r.counter(
            "greenserv_admitted_total", help="queries admitted to the pool")
        self._hedges = r.counter(
            "greenserv_hedges_total", help="straggler hedges fired")
        self._latency = r.histogram(
            "greenserv_latency_ms", help="end-to-end request latency (ms)")
        self._ttft = r.histogram(
            "greenserv_ttft_ms", help="time to first token (ms)")
        self._queue_wait = r.histogram(
            "greenserv_queue_wait_ms", help="time queued before execution")
        self._lambda = r.gauge(
            "greenserv_lambda", help="router accuracy-energy trade-off λ")
        self._pressure = r.gauge(
            "greenserv_budget_pressure", help="governor pressure in [0,1]")
        # cost-model reconciliation: |metered − predicted| / metered Wh,
        # one sample per completion that carried a pre-dispatch forecast
        self._pred_err = r.histogram(
            "greenserv_energy_prediction_error_ratio",
            help="abs(metered-predicted)/metered Wh per completion")
        # reliability layer (docs/RELIABILITY.md): pre-bound so the
        # counters export at zero on healthy runs
        self._retries = r.counter(
            "greenserv_retries_total",
            help="failed/expired dispatches re-routed to another arm")
        self._timeouts = r.counter(
            "greenserv_timeouts_total",
            help="requests terminal TIMED_OUT (deadline passed)")
        self._req_failed = r.counter(
            "greenserv_failed_total",
            help="requests terminal FAILED (attempts exhausted)")
        self._slo_violations = r.counter(
            "greenserv_slo_violations_total",
            help="deadline misses (timeouts + late completions)")
        self._breaker_transitions = r.counter(
            "greenserv_breaker_transitions_total",
            help="circuit-breaker state changes across all arms")
        # per-model/per-engine handles, bound lazily on first use
        # (completed, energy per token, energy mWh, tokens in, tokens out)
        self._model_handles: Dict[str, Tuple[Counter, Histogram, Counter,
                                             Counter, Counter]] = {}
        self._restarts: Dict[str, Counter] = {}
        self._queue_gauges: Dict[str, object] = {}
        self._power_gauges: Dict[str, object] = {}
        self._pool_power_gauge = r.gauge("greenserv_power_watts",
                                         {"source": "pool"})
        # phase-split energy: cumulative joules per serving phase across
        # the pool (prefill = prompt ingestion, decode = generation)
        self._phase_energy = {
            ph: r.counter("greenserv_energy_joules_total", {"phase": ph},
                          help="pool-wide metered joules by serving phase")
            for ph in ("prefill", "decode")}
        self._phase_power_gauges = {
            "prefill": r.gauge("greenserv_power_watts",
                               {"source": "prefill"}),
            "decode": r.gauge("greenserv_power_watts", {"source": "decode"})}
        self._phase_last: Dict[str, float] = {"prefill": 0.0, "decode": 0.0}
        # GreenCache avoided energy: joules never spent thanks to
        # prefix-KV reuse (engines meter it, diffed per step like phase
        # joules) and semantic answers (scheduler reports per hit)
        self._avoided_energy = {
            kind: r.counter("greenserv_energy_joules_avoided_total",
                            {"kind": kind},
                            help="modeled joules avoided by GreenCache")
            for kind in ("prefix", "semantic")}
        self._cache_hits = {
            kind: r.counter("greenserv_cache_hits_total", {"kind": kind},
                            help="GreenCache hits by layer")
            for kind in ("prefix", "semantic")}
        self._prefix_avoided_last = 0.0
        self._prefix_hits_last = 0
        self._avoided_cum_joules = 0.0
        # disaggregated serving: KV migrations (per prefill engine) and
        # per-engine cumulative joules for the role-attribution diff
        self._migrations: Dict[str, Counter] = {}
        # per-engine reliability handles (lazy, like restarts)
        self._attempt_failures: Dict[str, Counter] = {}
        self._breaker_open: Dict[str, object] = {}
        self._role_energy = {
            role: r.counter("greenserv_energy_joules_total", {"role": role},
                            help="pool-wide metered joules by engine role")
            for role in ("unified", "prefill", "decode")}
        self._engine_joules_last: Dict[str, float] = {}

    # -- scheduler hooks ----------------------------------------------------

    def on_admit(self, n: int, queue_depth: int,
                 expected_savings_wh: float = 0.0,
                 predicted=None) -> None:
        """``predicted``: optional ``[(uid, predicted_wh), …]`` from the
        energy cost model — forwarded to the governor's predict-then-
        reconcile charge (released at completion/cancellation)."""
        t = self.clock()
        self._admitted.inc(n)
        self.events.emit(ev.ADMIT, t, n=n, queue_depth=queue_depth)
        if self.governor is not None:
            self.governor.on_admission(
                n, t, expected_savings_wh=expected_savings_wh,
                predicted=predicted)

    def on_admission_deferred(self, n: int, predicted_wh: float,
                              headroom_wh: float) -> None:
        """The admission planner parked ``n`` arrivals whose predicted Wh
        would breach the governor's remaining budget this tick."""
        self.events.emit(ev.DEFER, self.clock(), n=n,
                         predicted_wh=predicted_wh,
                         headroom_wh=headroom_wh)

    def on_cancelled(self, uid: int) -> None:
        """A predicted query will never complete (cancelled before any
        engine work); release its in-flight predicted charge."""
        if self.governor is not None:
            self.governor.on_cancel(uid, self.clock())

    def on_cache_hit(self, kind: str, avoided_wh: float,
                     model: str = "") -> None:
        """A GreenCache layer short-circuited work: ``kind="semantic"``
        (whole query answered from cache — the scheduler calls this per
        hit) with the original completion's Wh as the avoided energy.
        Prefix-KV hits flow through the engines' avoided-joule meters and
        are diffed in ``on_step`` instead — call this only for hits no
        engine meters."""
        t = self.clock()
        self._cache_hits[kind].inc()
        joules = max(avoided_wh, 0.0) * JOULES_PER_WH
        self._avoided_energy[kind].inc(joules)
        self._avoided_cum_joules += joules
        self.events.emit(ev.CACHE_HIT, t, layer=kind,
                         avoided_wh=avoided_wh, model=model)
        if self.governor is not None:
            self.governor.on_avoided_energy(avoided_wh, kind, t)

    def on_engine_added(self, name: str, engine,
                        initial: bool = False) -> None:
        """Pool-membership hook (``PoolServer._configure_engine``):
        pre-bind the engine's queue/power gauges so a late joiner is
        visible in the export from its first step; runtime additions
        (``initial=False``) also log a pool-growth event."""
        if name not in self._queue_gauges:
            self._queue_gauges[name] = self.registry.gauge(
                "greenserv_queue_depth", {"engine": name})
            self._power_gauges[name] = self.registry.gauge(
                "greenserv_power_watts", {"source": name})
        if not initial:
            self.events.emit(ev.ENGINE_ADDED, self.clock(), engine=name)

    def on_completion(self, resp, accuracy: float,
                      predicted_wh: Optional[float] = None) -> None:
        """``predicted_wh``: the pre-dispatch forecast for this query, if
        the scheduler ran a cost model — recorded as a relative error
        sample against the metered ``resp.energy_wh``."""
        t = self.clock()
        model = resp.model_name
        handles = self._model_handles.get(model)
        if handles is None:
            r, lbl = self.registry, {"model": model}
            # created in the JAX package's order: the registry exports in
            # creation order
            completed = r.counter("greenserv_completed_total", lbl)
            per_tok = r.histogram("greenserv_energy_per_token_mwh", lbl)
            handles = self._model_handles[model] = (
                completed, per_tok,
                r.counter("greenserv_energy_mwh_total", lbl),
                r.counter("greenserv_tokens_total",
                          {"model": model, "dir": "in"}),
                r.counter("greenserv_tokens_total",
                          {"model": model, "dir": "out"}))
        completed, per_tok, energy_total, tokens_in, tokens_out = handles
        completed.inc()
        self._latency.record(resp.latency_ms)
        ttft = resp.ttft_ms
        if ttft:
            self._ttft.record(ttft)
        self._queue_wait.record(resp.queue_ms)
        energy_total.inc(resp.energy_wh * 1e3)
        tokens_in.inc(resp.input_tokens)
        tokens_out.inc(resp.output_tokens)
        if resp.output_tokens > 0:
            per_tok.record(resp.energy_wh * 1e3 / resp.output_tokens)
        self.events.emit(ev.COMPLETE, t, uid=resp.uid, model=model,
                         latency_ms=resp.latency_ms,
                         energy_wh=resp.energy_wh, accuracy=accuracy)
        if predicted_wh is not None and predicted_wh > 0.0:
            self._pred_err.record(abs(resp.energy_wh - predicted_wh)
                                  / max(resp.energy_wh, 1e-12))
        if self.governor is not None:
            self.governor.on_completion(resp.energy_wh, t, uid=resp.uid)

    def on_duplicate_work(self, energy_wh: float) -> None:
        """A hedged pair resolved: the losing duplicate burned energy that
        never produces a Response.  Charge the budget (winner's energy as
        a conservative proxy — the loser was cancelled partway, so this
        overcharges, which errs on the safe side of a Wh cap)."""
        if self.governor is not None:
            self.governor.on_extra_energy(energy_wh, self.clock())

    def on_hedge(self, uid: int, target: str) -> None:
        self._hedges.inc()
        self.events.emit(ev.HEDGE, self.clock(), uid=uid, target=target)

    def on_migration(self, engine: str, n_tokens: int) -> None:
        """A request's prompt KV was handed from ``engine`` (prefill role)
        to its decode twin at the phase boundary."""
        c = self._migrations.get(engine)
        if c is None:
            c = self._migrations[engine] = self.registry.counter(
                "greenserv_migrations_total", {"engine": engine})
        c.inc()
        self.events.emit(ev.MIGRATE, self.clock(), engine=engine,
                         kv_tokens=n_tokens)

    def on_restart(self, engine: str, n_requeued: int) -> None:
        c = self._restarts.get(engine)
        if c is None:
            c = self._restarts[engine] = self.registry.counter(
                "greenserv_restarts_total", {"engine": engine})
        c.inc()
        self.events.emit(ev.RESTART, self.clock(), engine=engine,
                         n_requeued=n_requeued)

    # -- reliability hooks (docs/RELIABILITY.md) ----------------------------

    def on_attempt_failure(self, uid: int, engine: str, reason: str,
                           energy_wh: float = 0.0) -> None:
        """One dispatch of a request died on ``engine`` (crash, garbage
        output, timeout…).  Any ``energy_wh`` it burned produced no
        completion, so the governor charges it as extra energy — exactly
        like a hedge loser's duplicate work."""
        c = self._attempt_failures.get(engine)
        if c is None:
            c = self._attempt_failures[engine] = self.registry.counter(
                "greenserv_attempt_failures_total", {"engine": engine})
        c.inc()
        self.events.emit(ev.ATTEMPT_FAIL, self.clock(), uid=uid,
                         engine=engine, reason=reason, energy_wh=energy_wh)
        if self.governor is not None and energy_wh > 0.0:
            self.governor.on_extra_energy(energy_wh, self.clock())

    def on_retry(self, uid: int, attempt: int, from_engine: str,
                 to_engine: str) -> None:
        self._retries.inc()
        self.events.emit(ev.RETRY, self.clock(), uid=uid, attempt=attempt,
                         from_engine=from_engine, to_engine=to_engine)

    def on_timeout(self, uid: int, waited_s: float) -> None:
        """Deadline passed before any completion: terminal TIMED_OUT.
        Every timeout is an SLO violation by definition.  The governor's
        in-flight charge is released by the scheduler's ``on_cancelled``
        call (its exactly-once bookkeeping), not here."""
        self._timeouts.inc()
        self._slo_violations.inc()
        self.events.emit(ev.TIMEOUT, self.clock(), uid=uid,
                         waited_s=waited_s)

    def on_request_failed(self, uid: int, reason: str) -> None:
        """Attempts exhausted: terminal FAILED (no response exists)."""
        self._req_failed.inc()

    def on_slo_violation(self, uid: int, latency_ms: float) -> None:
        """A completion arrived, but after its deadline (late answer —
        served, yet out of SLO).  Timeouts count through ``on_timeout``."""
        self._slo_violations.inc()

    def on_breaker(self, engine: str, old: str, new: str,
                   step: int) -> None:
        """A circuit breaker changed state on ``engine``'s arm."""
        self._breaker_transitions.inc()
        g = self._breaker_open.get(engine)
        if g is None:
            g = self._breaker_open[engine] = self.registry.gauge(
                "greenserv_breaker_open", {"engine": engine})
        g.set(0.0 if new == "closed" else 1.0)
        self.events.emit(ev.BREAKER, self.clock(), engine=engine,
                         old=old, new=new, step=step)

    def on_step(self, engines: Dict[str, object]) -> None:
        """Once per ``PoolServer.step``: power samples (per engine, pool,
        and per serving phase), queue depths, phase-tagged joule counters,
        and one governor control step."""
        t = self.clock()
        joules = {}
        pre_tot = dec_tot = 0.0
        prefix_avoided = 0.0
        prefix_hits = 0
        last = self._engine_joules_last
        for name, eng in engines.items():
            phases = eng.cumulative_joules_by_phase()
            pre, dec = phases.get("prefill", 0.0), phases.get("decode", 0.0)
            j = joules[name] = pre + dec
            pre_tot += pre
            dec_tot += dec
            # role attribution: the same joules, keyed by which *class* of
            # engine burned them (all-unified pools book under "unified")
            d_role = j - last.get(name, 0.0)
            if d_role > 0.0:
                role = getattr(eng, "role", "unified")
                counter = self._role_energy.get(role)
                if counter is None:
                    counter = self._role_energy[role] = self.registry.counter(
                        "greenserv_energy_joules_total", {"role": role},
                        help="pool-wide metered joules by engine role")
                counter.inc(d_role)
                if self.governor is not None:
                    self.governor.on_role_energy(role,
                                                 d_role / JOULES_PER_WH)
            last[name] = j
            # getattr: duck-typed engines (tests, adapters) may predate
            # the avoided-energy surface
            avoided = getattr(eng, "cumulative_joules_avoided", None)
            if avoided is not None:
                prefix_avoided += avoided()
            hits = getattr(eng, "prefix_hit_count", None)
            if hits is not None:
                prefix_hits += hits()
            qg = self._queue_gauges.get(name)
            if qg is None:
                qg = self._queue_gauges[name] = self.registry.gauge(
                    "greenserv_queue_depth", {"engine": name})
                self._power_gauges[name] = self.registry.gauge(
                    "greenserv_power_watts", {"source": name})
            qg.set(eng.pending)
        phase_tot = {"prefill": pre_tot, "decode": dec_tot}
        # the histograms' observations of this step into their quantile
        # estimators, inside the hook (so a step's telemetry cost is here)
        self.registry.flush()
        self.power.sample_all(t, joules, phase_joules=phase_tot)
        # prefix-KV avoided energy is metered inside the engines; diff the
        # cumulative counters once per step (exactly like phase joules)
        d_avoided = max(prefix_avoided - self._prefix_avoided_last, 0.0)
        if d_avoided:
            self._avoided_energy["prefix"].inc(d_avoided)
            self._avoided_cum_joules += d_avoided
            if self.governor is not None:
                self.governor.on_avoided_energy(
                    d_avoided / JOULES_PER_WH, "prefix", t)
        self._prefix_avoided_last = prefix_avoided
        d_hits = prefix_hits - self._prefix_hits_last
        if d_hits > 0:
            self._cache_hits["prefix"].inc(d_hits)
        self._prefix_hits_last = prefix_hits
        self.power.sample(AVOIDED, t, self._avoided_cum_joules)
        deltas = {}
        for ph, cur in phase_tot.items():
            deltas[ph] = max(cur - self._phase_last[ph], 0.0)
            if deltas[ph]:
                self._phase_energy[ph].inc(deltas[ph])
            self._phase_last[ph] = cur
        last_watts = self.power.last_watts
        for name, pg in self._power_gauges.items():
            pg.set(last_watts(name))
        self._pool_power_gauge.set(last_watts(POOL))
        self._phase_power_gauges["prefill"].set(last_watts(PHASE_PREFILL))
        self._phase_power_gauges["decode"].set(last_watts(PHASE_DECODE))
        if self.governor is not None and (deltas["prefill"]
                                          or deltas["decode"]):
            self.governor.on_phase_energy(deltas["prefill"] / JOULES_PER_WH,
                                          deltas["decode"] / JOULES_PER_WH)
        if self.governor is not None:
            before = self.governor.current_lambda
            lam = self.governor.step(t)
            self._lambda.set(lam)
            self._pressure.set(self.governor.pressure)
            if before is not None and lam != before:
                self.events.emit(ev.LAMBDA, t, value=lam,
                                 pressure=self.governor.pressure)

    # -- reporting ----------------------------------------------------------

    def summary(self) -> str:
        """Compact human-readable end-of-run summary (used by serve.py)."""
        lines = ["[telemetry]"]
        lat = self._latency
        if lat.count:
            lines.append(
                f"  latency   p50 {lat.quantile(0.5):8.1f} ms   "
                f"p95 {lat.quantile(0.95):8.1f} ms   "
                f"p99 {lat.quantile(0.99):8.1f} ms   (n={lat.count})")
        qw = self._queue_wait
        if qw.count:
            lines.append(
                f"  queue     p50 {qw.quantile(0.5):8.1f} ms   "
                f"p95 {qw.quantile(0.95):8.1f} ms")
        if self._ttft.count:
            lines.append(
                f"  ttft      p50 {self._ttft.quantile(0.5):8.1f} ms   "
                f"p95 {self._ttft.quantile(0.95):8.1f} ms")
        if self.power.series(POOL):
            lines.append(
                f"  power     avg {self.power.avg_watts():10.1f} W   "
                f"peak {self.power.peak_watts():10.1f} W   "
                f"total {self.power.total_wh():.4f} Wh")
        pre_wh = self.power.total_wh(PHASE_PREFILL)
        dec_wh = self.power.total_wh(PHASE_DECODE)
        if pre_wh or dec_wh:
            frac = pre_wh / max(pre_wh + dec_wh, 1e-12)
            lines.append(
                f"  phases    prefill {pre_wh:.4f} Wh ({frac:5.1%})   "
                f"decode {dec_wh:.4f} Wh")
        if self._avoided_cum_joules > 0.0:
            mwh = 1e3 / JOULES_PER_WH
            pj = self._avoided_energy["prefix"].value
            sj = self._avoided_energy["semantic"].value
            lines.append(
                f"  cache     avoided {self._avoided_cum_joules * mwh:.4g} mWh "
                f"(prefix {pj * mwh:.4g} / semantic {sj * mwh:.4g})   "
                f"hits prefix {int(self._cache_hits['prefix'].value)} / "
                f"semantic {int(self._cache_hits['semantic'].value)}")
        for model in sorted(self._model_handles):
            completed, h = self._model_handles[model][:2]
            if h.count:
                lines.append(
                    f"    {model:20s} {h.mean:8.3f} mWh/token "
                    f"({int(completed.value)} completions)")
        if self.governor is not None:
            g = self.governor.stats()
            lines.append(
                f"  budget    {g['cumulative_wh']:.3f} / "
                f"{g['budget_wh']:.3f} Wh spent   pressure "
                f"{g['pressure']:.2f}   λ now {g['lambda']:.3f}   "
                f"({g['lambda_changes']} adjustments)")
            avoided = g["avoided_prefix_wh"] + g["avoided_semantic_wh"]
            if avoided > 0.0:
                lines.append(
                    f"            avoided {avoided * 1e3:.4g} mWh credited "
                    f"(prefix {g['avoided_prefix_wh'] * 1e3:.4g} / semantic "
                    f"{g['avoided_semantic_wh'] * 1e3:.4g})")
        return "\n".join(lines)
