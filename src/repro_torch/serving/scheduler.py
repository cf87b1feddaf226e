"""GreenServ pool server: router → per-model engines → feedback loop.

Implements the paper's online deployment (§4.4):

  * routing: every query goes through GreenServRouter (context → feasible →
    LinUCB), execution through the selected model's engine, and the
    measured (accuracy, energy, latency) closes the bandit loop, flushed
    once per scheduler step through ``feedback_batch``;
  * continuous operation: ``enqueue``d arrivals are admitted into free
    engine slots each tick and routed at admission; engines are stepped
    round-robin, admitting new work between decode steps;
  * straggler mitigation: a request stuck behind a deep queue past its
    hedge deadline is duplicated onto the least-loaded healthy engine; the
    first completion wins, the loser is cancelled (hedged requests);
  * fault tolerance: engines carry heartbeats; a stalled or failed engine
    is restarted and its in-flight requests re-routed;
  * model addition (§6.3.4): ``add_engine`` registers a new pool member at
    runtime — the router grows a fresh arm, zero offline calibration.

This is the constructor-default path of the JAX package's ``PoolServer``.
GreenCache, telemetry, the energy cost model and admission planner,
disaggregated decode engines, deadlines, retries and circuit breakers
wait for later slices of the port: asking for one raises
``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query
from repro_torch.serving.engine import BaseEngine, EngineFailure
from repro_torch.serving.request import Request, RequestState, Response


class LivelockError(TimeoutError):
    """``run_until_drained`` exhausted its step budget with live requests —
    the continuous-batching loop stopped making progress (a bug), or the
    budget is simply too small for the workload.  Subclasses TimeoutError
    so callers treating drain exhaustion as a timeout keep working."""


_LATER_SLICES = {
    "telemetry": "telemetry", "cache": "cache", "decode_engines":
    "disaggregation", "cost_model": "cost-model", "admission_planner":
    "cost-model", "deadline_s": "reliability", "max_retries": "reliability",
    "breaker_config": "reliability"}


class PoolServer:
    """The GreenServ scheduler: routes queries, steps engines, closes the
    bandit loop.  ``hedge_after_steps`` is measured in scheduler steps
    spent QUEUED; ``heartbeat_timeout_s`` in wall-clock seconds.
    ``prefill_chunk`` (prompt tokens per engine prefill tick) is applied
    to every engine at construction and on ``add_engine``."""

    def __init__(self, router: GreenServRouter,
                 engines: Dict[str, BaseEngine],
                 tokenizer: Optional[Callable[[str], List[int]]] = None,
                 hedge_after_steps: Optional[int] = None,
                 heartbeat_timeout_s: float = 30.0,
                 accuracy_fn: Optional[Callable] = None,
                 telemetry=None,
                 prefill_chunk: Optional[int] = None,
                 cache=None,
                 decode_engines=None,
                 cost_model=None,
                 admission_planner: bool = False,
                 deadline_s: Optional[float] = None,
                 max_retries: int = 0,
                 breaker_config=None):
        asked = {"telemetry": telemetry is not None,
                 "cache": cache is not None and getattr(cache, "mode",
                                                        "on") != "off",
                 "decode_engines": bool(decode_engines),
                 "cost_model": cost_model is not None,
                 "admission_planner": bool(admission_planner),
                 "deadline_s": deadline_s is not None,
                 "max_retries": int(max_retries) > 0,
                 "breaker_config": breaker_config is not None}
        for arg, on in asked.items():
            if on:
                raise NotImplementedError(
                    f"PoolServer({arg}=...) waits for the port's "
                    f"{_LATER_SLICES[arg]} slice")
        names = router.pool.names
        missing = [n for n in names if n not in engines]
        if missing:
            raise ValueError(f"engines missing for pool members: {missing}")
        self.router = router
        self.engines = engines
        self.tokenizer = tokenizer or (lambda text: [1 + (ord(c) % 250)
                                                     for c in text[:32]])
        self.hedge_after_steps = hedge_after_steps
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.accuracy_fn = accuracy_fn
        self.prefill_chunk = prefill_chunk
        self._step_idx = 0
        for eng in engines.values():
            self._configure_engine(eng)
        self.inflight: Dict[int, Request] = {}
        self.hedges: Dict[int, Request] = {}
        self.responses: Dict[int, Response] = {}
        self.wait_steps: Dict[int, int] = {}
        # continuous-batching arrivals queue: ``enqueue``d queries wait
        # here until a step() tick has free prefill capacity for them
        self.arrivals: List[Query] = []
        self.stats = {"hedges": 0, "restarts": 0, "completed": 0}
        # cumulative routing decisions landed per engine (primaries,
        # hedges, restart replays)
        self.dispatch_counts: Dict[str, int] = {}
        # feedback for completions collected during the current step(); the
        # router is updated once per step via feedback_batch
        self._fb_buffer: List[Feedback] = []

    # -- pool growth (paper §6.3.4) ---------------------------------------------

    def _configure_engine(self, engine: BaseEngine) -> None:
        """Apply every pool-level serving setting to one engine — the
        single choke point used at construction and by ``add_engine``."""
        if self.prefill_chunk is not None:
            engine.set_prefill_chunk(self.prefill_chunk)

    def add_engine(self, profile: ModelProfile, engine: BaseEngine) -> None:
        """Zero-calibration model addition: new engine + fresh bandit arm."""
        self._configure_engine(engine)
        self.engines[profile.name] = engine
        self.router.pool.add(profile)   # fires the router's add-arm hook

    # -- submission ---------------------------------------------------------------

    def submit(self, query: Query) -> Request:
        """Route and enqueue one query (a batch of one; tools/demos)."""
        return self.submit_batch([query])[0]

    def enqueue(self, query: Query) -> None:
        """Continuous-batching entry point: park an arrival until a
        ``step()`` tick has free prefill capacity for it.  Unlike
        ``submit``, routing is deferred to admission time — the bandit
        sees the queue state that actually exists when the query gets a
        slot, and a burst never floods engine queues beyond what the
        slots can absorb."""
        self.arrivals.append(query)

    def enqueue_many(self, queries: Sequence[Query]) -> None:
        self.arrivals.extend(queries)

    def _admit_arrivals(self) -> None:
        """Admit as many parked arrivals as the pool has free slots this
        tick (FIFO).  Capacity is summed over the routable (prefill-side)
        engines.  Admitted queries go through the normal batched
        ``submit_batch`` hot path (route_batch → per-engine slices)."""
        if not self.arrivals:
            return
        free = sum(e.free_capacity for e in self.engines.values())
        if free <= 0:
            return
        batch, self.arrivals = self.arrivals[:free], self.arrivals[free:]
        if batch:
            self.submit_batch(batch)

    def submit_batch(self, queries: Sequence[Query]) -> List[Request]:
        """Admit a batch: one ``route_batch`` call routes every query and
        each engine receives its slice in arrival order.  This is the
        serving hot path — featurization and LinUCB scoring amortize over
        the batch instead of paying per-query dispatch."""
        # routed models always come from the pool, so checking the
        # pool/engine invariant up front fails before ANY bookkeeping
        missing = [n for n in self.router.pool.names
                   if n not in self.engines]
        if missing:
            raise KeyError(f"no engine for pool member(s): {missing}")
        tokens = [self.tokenizer(q.text) for q in queries]
        decisions = self.router.route_batch(queries)
        per_engine: Dict[str, List[Request]] = {}
        out: List[Request] = []
        for i, (query, decision) in enumerate(zip(queries, decisions)):
            req = Request(query=query, prompt_tokens=tokens[i],
                          max_new_tokens=query.max_new_tokens,
                          submit_s=time.monotonic())
            per_engine.setdefault(decision.model_name, []).append(req)
            self.inflight[query.uid] = req
            self.wait_steps[query.uid] = 0
            out.append(req)
        for name, batch in per_engine.items():
            self.engines[name].submit_many(batch)
            self.dispatch_counts[name] = (
                self.dispatch_counts.get(name, 0) + len(batch))
        return out

    # -- hedged (straggler-mitigating) dispatch ------------------------------------

    def _engine_healthy(self, name: str, eng: BaseEngine) -> bool:
        """Hedge-target health gate: a failed/stalled-heartbeat engine must
        never receive a hedge — duplicating onto a sick engine doubles the
        work and saves nothing."""
        if getattr(eng, "_failed", False):
            return False
        return time.monotonic() - eng.heartbeat() <= self.heartbeat_timeout_s

    def _maybe_hedge(self) -> None:
        if self.hedge_after_steps is None:
            return
        for uid, req in list(self.inflight.items()):
            if req.done or uid in self.hedges or req.hedge_of is not None:
                continue
            if (req.state == RequestState.QUEUED
                    and self.wait_steps[uid] >= self.hedge_after_steps):
                # pick the least-loaded *healthy* other engine as target
                others = [(e.pending, n) for n, e in self.engines.items()
                          if n != req.model_name
                          and self._engine_healthy(n, e)]
                if not others:
                    continue
                _, target = min(others)
                hedge = Request(query=req.query,
                                prompt_tokens=list(req.prompt_tokens),
                                max_new_tokens=req.max_new_tokens,
                                hedged=True, hedge_of=uid,
                                submit_s=time.monotonic())
                self.engines[target].submit(hedge)
                self.dispatch_counts[target] = (
                    self.dispatch_counts.get(target, 0) + 1)
                self.hedges[uid] = hedge
                self.stats["hedges"] += 1

    # -- fault tolerance -------------------------------------------------------------

    def _check_engines(self) -> None:
        now = time.monotonic()
        for name, eng in self.engines.items():
            stalled = now - eng.heartbeat() > self.heartbeat_timeout_s
            if stalled or getattr(eng, "_failed", False):
                self._restart_engine(name)

    def _restart_engine(self, name: str) -> None:
        inflight = self.engines[name].restart()
        self.stats["restarts"] += 1
        # flush buffered feedback first so re-routing sees the updated
        # bandit, and so no pending decision consumed by the flush is
        # overwritten by the re-route below
        self._flush_feedback()
        # displaced hedges are dropped, not resubmitted — clear their
        # bookkeeping so _maybe_hedge can protect the primary again
        for req in inflight:
            if (req.hedge_of is not None
                    and self.hedges.get(req.hedge_of) is req):
                req.state = RequestState.CANCELLED
                del self.hedges[req.hedge_of]
        # re-route the displaced batch in one shot: the bandit may now
        # prefer a different (healthy) arm.  restart() resets every held
        # request to QUEUED — including a hedge loser whose query was
        # already answered; resurrecting it would re-insert a finished uid
        # into inflight (never drains) and duplicate the work.
        replay = [req for req in inflight
                  if req.hedge_of is None and req.uid not in self.responses]
        if not replay:
            return
        decisions = self.router.route_batch([req.query for req in replay])
        for req, decision in zip(replay, decisions):
            self.inflight[req.uid] = req
            self.engines[decision.model_name].submit(req)
            self.dispatch_counts[decision.model_name] = (
                self.dispatch_counts.get(decision.model_name, 0) + 1)

    def _flush_feedback(self) -> None:
        if self._fb_buffer:
            fbs, self._fb_buffer = self._fb_buffer, []
            self.router.feedback_batch(fbs, strict=False)

    # -- completion -------------------------------------------------------------------

    def _complete(self, resp: Response, req: Request) -> None:
        primary_uid = req.hedge_of if req.hedge_of is not None else req.uid
        primary = self.inflight.get(primary_uid)
        if primary is None or primary_uid in self.responses:
            return                          # race already resolved
        # cancel the loser of a hedged pair
        if req.hedge_of is not None:        # hedge won
            primary.state = RequestState.CANCELLED
        elif primary_uid in self.hedges:    # primary won
            self.hedges[primary_uid].state = RequestState.CANCELLED
        accuracy = getattr(resp, "accuracy", None)
        if accuracy is None:
            accuracy = (self.accuracy_fn(primary.query, resp)
                        if self.accuracy_fn else 0.0)
        # buffered: the router is updated once per step via feedback_batch
        # (a hedge that finished on a non-routed arm is skipped at flush; a
        # hedge that won on an engine outside the pool has no arm at all)
        try:
            model_index = self.router.pool.index_of(resp.model_name)
        except KeyError:
            model_index = None
        if model_index is not None:
            self._fb_buffer.append(Feedback(
                query_uid=primary_uid, model_index=model_index,
                accuracy=float(accuracy), energy_wh=resp.energy_wh,
                latency_ms=resp.latency_ms,
                input_tokens=resp.input_tokens,
                output_tokens=resp.output_tokens))
        self.responses[primary_uid] = resp
        self.inflight.pop(primary_uid, None)
        self.hedges.pop(primary_uid, None)
        self.wait_steps.pop(primary_uid, None)
        self.stats["completed"] += 1

    # -- main loop ---------------------------------------------------------------------

    def step(self) -> List[Response]:
        """One scheduler tick: health checks, hedging, arrival admission
        into free prefill slots, one ``step()`` per engine (each engine
        tick is one chunk-prefill or decode call), one batched feedback
        flush.  Returns the responses completed this tick."""
        done: List[Response] = []
        self._step_idx += 1
        self._check_engines()
        self._maybe_hedge()
        self._admit_arrivals()
        for name, eng in self.engines.items():
            try:
                for resp in eng.step():
                    req = self._find_request(resp.uid, name)
                    if req is None:
                        continue
                    self._complete(resp, req)
                    done.append(resp)
            except EngineFailure:
                self._restart_engine(name)
        self._flush_feedback()
        for uid, req in self.inflight.items():
            if req.state == RequestState.QUEUED:
                self.wait_steps[uid] = self.wait_steps.get(uid, 0) + 1
        return done

    def _find_request(self, uid: int, engine_name: str) -> Optional[Request]:
        req = self.inflight.get(uid)
        if req is not None and req.model_name == engine_name:
            return req
        for primary_uid, hedge in self.hedges.items():
            if hedge.uid == uid and hedge.model_name == engine_name:
                return hedge
        return req

    def drain_snapshot(self) -> str:
        """Multi-line diagnostic of everything that could hold a drain
        open: arrivals, per-engine occupancy/health, and the in-flight uids
        with their states.  Embedded in LivelockError so a stuck drain is
        diagnosable from the exception alone."""
        lines = [f"arrivals queued: {len(self.arrivals)}; "
                 f"now step {self._step_idx}"]
        for name, eng in self.engines.items():
            lines.append(
                f"  engine {name}: pending={eng.pending} "
                f"free={eng.free_capacity} "
                f"failed={bool(getattr(eng, '_failed', False))}")
        if self.inflight:
            shown = list(self.inflight.items())[:16]
            more = len(self.inflight) - len(shown)
            lines.append("  inflight: " + ", ".join(
                f"{uid}:{req.state.value}@{req.model_name or '?'}"
                for uid, req in shown) + (f" …+{more} more" if more else ""))
        return "\n".join(lines)

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        """Step until nothing is in flight *and* no arrival is parked.
        Raises ``LivelockError`` (a ``TimeoutError``) if the step budget
        runs out with live work — a silent return here would mask a
        scheduler livelock, which the continuous loop must never hide.
        The error message carries a full ``drain_snapshot`` (queue depth,
        per-engine occupancy/state, in-flight uids)."""
        for _ in range(max_steps):
            if not self.inflight and not self.arrivals:
                return
            self.step()
        if not self.inflight and not self.arrivals:
            return      # the budget's last step drained the pool
        raise LivelockError(
            f"{len(self.inflight)} request(s) still in flight and "
            f"{len(self.arrivals)} arrival(s) still parked after "
            f"{max_steps} steps\n" + self.drain_snapshot())
