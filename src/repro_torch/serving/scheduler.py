"""GreenServ pool server: router → per-model engines → feedback loop.

Implements the paper's online deployment (§4.4):

  * caching: GreenCache (``repro_torch.cache``) is consulted before
    routing — a semantic hit answers the query with zero engine work, and
    prefix-KV hit lengths become expected-energy discounts in the routing
    decision (only the queries that need compute are routed);
  * routing: every query goes through GreenServRouter (context → feasible →
    LinUCB), execution through the selected model's engine, and the
    measured (accuracy, energy, latency) closes the bandit loop, flushed
    once per scheduler step through ``feedback_batch``;
  * energy: an optional ``EnergyCostModel`` forecasts each (query, arm)'s
    Wh before dispatch (the router's energy tilt, the governor's in-flight
    charge) and calibrates from the metered ledger at completion; an
    optional ``Telemetry`` hub records every admission, completion, hedge,
    restart, cache hit and step, and its ``EnergyBudgetGovernor`` drives
    the router's λ; with both, the admission planner defers arrivals whose
    forecast would breach the budget's headroom;
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

This is the JAX package's ``PoolServer`` with GreenCache, the cost model,
telemetry and the governor.  Disaggregated decode engines, deadlines,
retries and circuit breakers wait for a later slice of the port: asking
for one raises ``NotImplementedError``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cache import GreenCache
from repro_torch.cache.semantic import SemanticEntry
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query
from repro_torch.costmodel import EnergyCostModel
from repro_torch.serving.engine import BaseEngine, EngineFailure
from repro_torch.serving.request import Request, RequestState, Response
from repro_torch.telemetry.hub import Telemetry


class LivelockError(TimeoutError):
    """``run_until_drained`` exhausted its step budget with live requests —
    the continuous-batching loop stopped making progress (a bug), or the
    budget is simply too small for the workload.  Subclasses TimeoutError
    so callers treating drain exhaustion as a timeout keep working."""


_LATER_SLICES = {
    "decode_engines": "disaggregation", "deadline_s": "reliability",
    "max_retries": "reliability", "breaker_config": "reliability"}


class PoolServer:
    """The GreenServ scheduler: routes queries, steps engines, closes the
    bandit loop.  ``hedge_after_steps`` is measured in scheduler steps
    spent QUEUED; ``heartbeat_timeout_s`` in seconds of ``clock`` (the
    wall clock unless the caller injects one, as virtual-clock drives
    do).  Every pool-level serving setting — ``prefill_chunk`` (prompt
    tokens per engine prefill tick), the ``cache`` handles (GreenCache
    prefix-KV / semantic reuse, consulted before routing; ``mode="off"``
    is no cache), the cost model's registration and telemetry's
    pre-binding — is applied through one ``_configure_engine`` choke
    point at construction and again on ``add_engine``.
    ``retry_backoff_steps`` is taken in the JAX package's position and
    kept; the retries that read it wait for the reliability slice."""

    def __init__(self, router: GreenServRouter,
                 engines: Dict[str, BaseEngine],
                 tokenizer: Optional[Callable[[str], List[int]]] = None,
                 hedge_after_steps: Optional[int] = None,
                 heartbeat_timeout_s: float = 30.0,
                 accuracy_fn: Optional[Callable] = None,
                 telemetry: Optional[Telemetry] = None,
                 prefill_chunk: Optional[int] = None,
                 cache: Optional[GreenCache] = None,
                 decode_engines=None,
                 cost_model: Optional[EnergyCostModel] = None,
                 admission_planner: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 deadline_s: Optional[float] = None,
                 max_retries: int = 0,
                 retry_backoff_steps: int = 2,
                 breaker_config=None):
        asked = {"decode_engines": bool(decode_engines),
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
        # injectable time source: virtual-clock drives pass the clock their
        # telemetry (and SimEngines) share, so submit/heartbeat timestamps
        # never mix wall and modeled time
        self.clock = clock or time.monotonic
        self.accuracy_fn = accuracy_fn
        self.telemetry = telemetry
        self.prefill_chunk = prefill_chunk
        self.cache = cache if (cache is None or cache.mode != "off") else None
        if self.cache is not None:
            # guard features must live in the router's embedding space
            self.cache.bind_context(router.context)
        # pre-dispatch Wh forecasts: the router's energy tilt, the
        # governor's in-flight charge and (when enabled) the admission
        # planner
        self.cost_model = cost_model
        self.admission_planner = bool(admission_planner)
        self.retry_backoff_steps = max(int(retry_backoff_steps), 1)
        self._step_idx = 0
        for name, eng in engines.items():
            self._configure_engine(name, eng, initial=True)
        if telemetry is not None and telemetry.governor is not None:
            telemetry.governor.attach(router)
        self.inflight: Dict[int, Request] = {}
        self.hedges: Dict[int, Request] = {}
        self.responses: Dict[int, Response] = {}
        self.wait_steps: Dict[int, int] = {}
        # continuous-batching arrivals queue: ``enqueue``d queries wait
        # here until a step() tick has free prefill capacity for them
        self.arrivals: List[Query] = []
        self.stats = {"hedges": 0, "restarts": 0, "completed": 0,
                      "cache_hits": 0, "deferred": 0}
        # cumulative routing decisions landed per engine (primaries,
        # hedges, restart replays)
        self.dispatch_counts: Dict[str, int] = {}
        # feedback for completions collected during the current step(); the
        # router is updated once per step via feedback_batch
        self._fb_buffer: List[Feedback] = []

    # -- pool growth (paper §6.3.4) ---------------------------------------------

    def _configure_engine(self, name: str, engine: BaseEngine,
                          initial: bool = False) -> None:
        """Apply every pool-level serving setting to one engine — the
        single choke point used at construction and by ``add_engine``, so
        a late joiner never misses a knob (prefill chunking, its
        prefix-KV cache handle, its cost-model registration, telemetry
        pre-binding).  The prefix cache and the cost model are keyed by
        the model name (KV and shape terms are parameter-specific)."""
        model_name = name.split("#", 1)[0]
        if self.prefill_chunk is not None:
            engine.set_prefill_chunk(self.prefill_chunk)
        if self.cache is not None:
            engine.set_prefix_cache(self.cache.prefix_for(model_name))
        if self.cost_model is not None:
            # registered after set_prefill_chunk: the prior mirrors the
            # chunk the engine actually runs
            self.cost_model.register_engine(model_name, engine)
        if self.telemetry is not None:
            self.telemetry.on_engine_added(name, engine, initial=initial)

    def add_engine(self, profile: ModelProfile, engine: BaseEngine) -> None:
        """Zero-calibration model addition: new engine + fresh bandit arm.
        Every server-level setting applies to the late joiner through
        ``_configure_engine``."""
        self._configure_engine(profile.name, engine)
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
        batch, rest = self.arrivals[:free], self.arrivals[free:]
        if self._planner_active():
            batch, deferred = self._plan_admissions(batch)
            rest = deferred + rest
        self.arrivals = rest
        if batch:
            self.submit_batch(batch)

    def _planner_active(self) -> bool:
        """Energy-aware admission requires all three legs: the planner
        knob, a cost model to forecast with, and a governor whose budget
        headroom is the thing being planned against."""
        return (self.admission_planner and self.cost_model is not None
                and self.telemetry is not None
                and self.telemetry.governor is not None)

    def _engine_occupancy(self, name: str) -> float:
        """Fraction of the engine's slot/queue capacity in use — the cost
        model's batching-pressure feature."""
        eng = self.engines.get(name)
        if eng is None:
            return 0.0
        cap = max(int(getattr(eng, "max_batch", 0)
                      or getattr(eng, "concurrency", 0) or 1), 1)
        return min(eng.pending / cap, 1.0)

    def _plan_admissions(self, batch: List[Query]) -> tuple:
        """(admit, deferred): FIFO stop-at-first-breach over the
        governor's remaining Wh headroom.  Each arrival is costed at its
        *cheapest* arm (the planner must never defer a query the router
        could still serve within budget); the first arrival whose
        forecast would breach the headroom stops the scan — no
        reordering behind the breach.  An idle pool always admits the
        head-of-line arrival regardless of headroom: admission pressure
        may slow the pool down, but it must never stop it
        (``run_until_drained`` would raise LivelockError)."""
        gov = self.telemetry.governor
        headroom = gov.admission_headroom_wh()
        names = self.router.pool.names
        costs = self.cost_model.predict_matrix(
            names, [len(self.tokenizer(q.text)) for q in batch],
            [q.max_new_tokens for q in batch],
            occupancy={n: self._engine_occupancy(n) for n in names})
        per_query = costs.min(axis=1)
        admit: List[Query] = []
        planned = 0.0
        breach_wh = 0.0
        pool_idle = not self.inflight
        for q, wh in zip(batch, per_query):
            if planned + wh > headroom:
                if not admit and pool_idle:
                    admit.append(q)      # head-of-line liveness guarantee
                    planned += float(wh)
                else:
                    breach_wh = float(wh)
                break
            admit.append(q)
            planned += float(wh)
        deferred = list(batch[len(admit):])
        if deferred:
            self.stats["deferred"] += len(deferred)
            self.telemetry.on_admission_deferred(
                len(deferred), predicted_wh=breach_wh,
                headroom_wh=max(headroom - planned, 0.0))
        return admit, deferred

    def submit_batch(self, queries: Sequence[Query]) -> List[Request]:
        """Admit a batch: cache consultation, then one ``route_batch`` call
        routes every remaining query and each engine receives its slice in
        arrival order.  This is the serving hot path — featurization and
        LinUCB scoring amortize over the batch instead of paying per-query
        dispatch.

        GreenCache runs *before* routing: a semantic hit short-circuits
        the query entirely (its Request comes back already DONE, the
        cached Response is immediately available in ``responses``), and
        per-(query, engine) prefix-KV hit lengths become expected-energy
        discounts in the router's arm scores plus an in-flight savings
        credit for the governor.  With a cost model, the (Q, M) predicted
        Wh tilts each decision and the winning arm's forecast (net of its
        prefix discount) is noted for reconciliation at completion."""
        # routed models always come from the pool, so checking the
        # pool/engine invariant up front fails before ANY bookkeeping
        missing = [n for n in self.router.pool.names
                   if n not in self.engines]
        if missing:
            raise KeyError(f"no engine for pool member(s): {missing}")
        req_by_uid: Dict[int, Request] = {}
        routable: List[Query] = []
        miss_features: List[Optional[tuple]] = []
        # one batched probe featurizes the whole admission (on the device
        # path one featurize launch); the per-query loop below only does
        # the similarity lookups
        probe = None
        if (self.cache is not None and self.cache.semantic_enabled
                and queries):
            probe = self.cache.features_batch([q.text for q in queries])
        for i, query in enumerate(queries):
            feats_in = (None if probe is None else
                        (int(probe[0][i]), int(probe[1][i]), probe[2][i]))
            hit, feats = self._try_semantic(query, feats_in)
            if hit is not None:
                req_by_uid[query.uid] = hit
            else:
                routable.append(query)
                miss_features.append(feats)
        tokens = [self.tokenizer(q.text) for q in routable]
        discounts = self._prefix_discounts(routable, tokens)
        # forward the probe's feature work (the embeddings included) into
        # routing instead of re-deriving it there
        embs = labels = None
        if routable and miss_features[0] is not None:
            labels = np.asarray([f[0] for f in miss_features], np.int64)
            embs = np.stack([f[2] for f in miss_features])
        # pre-dispatch joule forecasts: a (Q, M) predicted-Wh matrix tilts
        # the routing decision per (query, arm); float64 on the host, as
        # the router applies it
        costs = occ = None
        if self.cost_model is not None and routable:
            names = self.router.pool.names
            occ = {n: self._engine_occupancy(n) for n in names}
            costs = self.cost_model.predict_matrix(
                names, [len(t) for t in tokens],
                [q.max_new_tokens for q in routable], occupancy=occ)
        decisions = self.router.route_batch(
            routable, energy_discounts_wh=discounts,
            energy_costs_wh=costs, embeddings=embs, task_labels=labels)
        per_engine: Dict[str, List[Request]] = {}
        expected_savings_wh = 0.0
        predicted = [] if costs is not None else None
        for i, (query, decision) in enumerate(zip(routable, decisions)):
            req = Request(query=query, prompt_tokens=tokens[i],
                          max_new_tokens=query.max_new_tokens,
                          cache_features=miss_features[i],
                          submit_s=self.clock())
            per_engine.setdefault(decision.model_name, []).append(req)
            self.inflight[query.uid] = req
            self.wait_steps[query.uid] = 0
            req_by_uid[query.uid] = req
            if discounts is not None:
                expected_savings_wh += float(
                    discounts[i, decision.model_index])
            if costs is not None:
                # the query's forecast on the arm that won, net of its
                # predicted prefix-reuse saving (cold − discount = warm)
                wh = float(costs[i, decision.model_index])
                if discounts is not None:
                    wh = max(wh - float(discounts[i, decision.model_index]),
                             0.0)
                req.predicted_wh = wh
                self.cost_model.note_admission(
                    query.uid, decision.model_name, wh,
                    n_prompt=len(tokens[i]),
                    max_new_tokens=query.max_new_tokens,
                    occupancy=occ.get(decision.model_name, 0.0))
                predicted.append((query.uid, wh))
        for name, batch in per_engine.items():
            self.engines[name].submit_many(batch)
            self.dispatch_counts[name] = (
                self.dispatch_counts.get(name, 0) + len(batch))
        if self.telemetry is not None:
            # with the cost model on, the per-uid predictions are already
            # net of prefix reuse — also crediting expected_savings_wh
            # would discount the governor's in-flight commitment twice
            self.telemetry.on_admit(
                len(routable), sum(e.pending for e in self.engines.values()),
                expected_savings_wh=(0.0 if costs is not None
                                     else expected_savings_wh),
                predicted=predicted)
        return [req_by_uid[q.uid] for q in queries]

    # -- GreenCache consultation ---------------------------------------------------

    def _try_semantic(self, query: Query,
                      feats: Optional[tuple] = None) -> tuple:
        """(already-DONE Request | None, probe features | None).

        A hit synthesizes the cached completion as this query's Response
        (zero engine work, zero routing) and returns an already-DONE
        Request; the avoided energy — the cached completion's measured Wh
        — is credited via ``Telemetry.on_cache_hit("semantic", …)``.  Cached queries never touch router state (no k-means
        update, no bandit pull): they are invisible to the learning loop,
        exactly like traffic that never arrived.  On a miss the computed
        (task, cluster, embedding) features come back so the query is
        embedded exactly once per lifecycle — routing and the
        completion-time insert both reuse them.  ``feats`` carries the
        batched admission probe's row for this query."""
        if self.cache is None or not self.cache.semantic_enabled:
            return None, None
        if feats is None:
            feats = self.cache.features(query.text)
        task, cluster, emb = feats
        entry = self.cache.semantic.lookup(emb, task, cluster)
        if entry is None:
            return None, feats
        resp = Response(
            uid=query.uid, model_name=entry.model_name,
            tokens=list(entry.tokens), text=entry.text_out,
            latency_ms=0.0, queue_ms=0.0, energy_wh=0.0,
            input_tokens=entry.input_tokens,
            output_tokens=entry.output_tokens, ttft_ms=0.0)
        resp.accuracy = entry.accuracy  # type: ignore[attr-defined]
        self.responses[query.uid] = resp
        self.stats["cache_hits"] += 1
        if self.telemetry is not None:
            self.telemetry.on_cache_hit("semantic", entry.energy_wh,
                                        model=entry.model_name)
        req = Request(query=query, prompt_tokens=[],
                      max_new_tokens=query.max_new_tokens,
                      state=RequestState.DONE,
                      model_name=entry.model_name)
        return req, feats

    def _prefix_discounts(self, queries: Sequence[Query],
                          tokens: Sequence[List[int]]
                          ) -> Optional[np.ndarray]:
        """(Q, n_models) expected Wh each engine's prefix cache would save
        per query — the router adds λ·ΔWh/scale to those arms' scores.
        Probes use ``peek_len`` (no LRU touch): an unrouted probe must not
        keep blocks warm.  With a cost model attached the discount is the
        calibrated predicted-suffix-minus-full (``discount_wh``) instead
        of the engine's raw analytic prefill estimate, so the tilt and
        the governor's in-flight charge come from the same forecaster."""
        if self.cache is None or not self.cache.prefix_enabled or not queries:
            return None
        names = self.router.pool.names
        disc = np.zeros((len(queries), len(names)), np.float64)
        for j, name in enumerate(names):
            eng = self.engines[name]
            pc = getattr(eng, "prefix_cache", None)
            if pc is None:
                continue
            occ = (self._engine_occupancy(name)
                   if self.cost_model is not None else 0.0)
            for i, toks in enumerate(tokens):
                p = pc.peek_len(toks, max_tokens=len(toks) - 1)
                if p > 0:
                    if self.cost_model is not None:
                        disc[i, j] = self.cost_model.discount_wh(
                            name, len(toks), queries[i].max_new_tokens,
                            p, occ)
                    else:
                        disc[i, j] = eng.estimate_prefill_wh(p)
        return disc if disc.any() else None

    # -- hedged (straggler-mitigating) dispatch ------------------------------------

    def _engine_healthy(self, name: str, eng: BaseEngine) -> bool:
        """Hedge-target health gate: a failed/stalled-heartbeat engine must
        never receive a hedge — duplicating onto a sick engine doubles the
        work and saves nothing."""
        if getattr(eng, "_failed", False):
            return False
        return self.clock() - eng.heartbeat() <= self.heartbeat_timeout_s

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
                                submit_s=self.clock())
                self.engines[target].submit(hedge)
                self.dispatch_counts[target] = (
                    self.dispatch_counts.get(target, 0) + 1)
                self.hedges[uid] = hedge
                self.stats["hedges"] += 1
                if self.telemetry is not None:
                    self.telemetry.on_hedge(uid, target)

    # -- fault tolerance -------------------------------------------------------------

    def _check_engines(self) -> None:
        now = self.clock()
        for name, eng in self.engines.items():
            stalled = now - eng.heartbeat() > self.heartbeat_timeout_s
            if stalled or getattr(eng, "_failed", False):
                self._restart_engine(name)

    def _restart_engine(self, name: str) -> None:
        inflight = self.engines[name].restart()
        self.stats["restarts"] += 1
        if self.telemetry is not None:
            self.telemetry.on_restart(name, len(inflight))
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
        hedged_pair = (req.hedge_of is not None
                       or primary_uid in self.hedges)
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
        if self.cache is not None and self.cache.semantic_enabled:
            # the admission-time probe features (one embed per query);
            # a fresh probe only if they were never stashed
            task, cluster, emb = (primary.cache_features
                                  or self.cache.features(primary.query.text))
            self.cache.semantic.insert(emb, SemanticEntry(
                text=primary.query.text, task_label=task, cluster=cluster,
                model_name=resp.model_name, tokens=list(resp.tokens),
                text_out=resp.text, energy_wh=resp.energy_wh,
                accuracy=float(accuracy), input_tokens=resp.input_tokens,
                output_tokens=resp.output_tokens))
        predicted_wh = None
        if self.cost_model is not None:
            # reconcile the admission-time forecast against the metered
            # Wh and fold the completion into the residual calibration
            predicted_wh = self.cost_model.observe_response(
                resp, float(accuracy))
        if self.telemetry is not None:
            self.telemetry.on_completion(resp, float(accuracy),
                                         predicted_wh=predicted_wh)
            if hedged_pair:
                # the cancelled duplicate's work never completes; charge
                # the energy budget for it (winner's cost as proxy)
                self.telemetry.on_duplicate_work(resp.energy_wh)

    # -- main loop ---------------------------------------------------------------------

    def step(self) -> List[Response]:
        """One scheduler tick: health checks, hedging, arrival admission
        into free prefill slots, one ``step()`` per engine (each engine
        tick is one chunk-prefill or decode call), one batched feedback
        flush, one telemetry/governor step.  Returns the responses
        completed this tick."""
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
        # telemetry last: power samples see the step's energy, and the
        # governor's λ adjustment lands after this step's feedback flush
        if self.telemetry is not None:
            self.telemetry.on_step(self.engines)
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
