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
    restart, cache hit, migration, failure and step, and its
    ``EnergyBudgetGovernor`` drives the router's λ; with both, the
    admission planner defers arrivals whose forecast would breach the
    budget's headroom;
  * continuous operation: ``enqueue``d arrivals are admitted into free
    engine slots each tick and routed at admission; engines are stepped
    round-robin, admitting new work between decode steps;
  * disaggregated prefill/decode (``decode_engines``): a member's engine
    takes the prefill role and a decode twin sharing its weights decodes,
    the prompt KV migrating at the phase boundary;
  * straggler mitigation: a request stuck behind a deep queue past its
    hedge deadline is duplicated onto the least-loaded healthy engine; the
    first completion wins, the loser is cancelled (hedged requests);
  * fault tolerance: engines carry heartbeats; a stalled or failed engine
    is restarted and its in-flight requests re-routed.  The reliability
    layer (docs/RELIABILITY.md) adds end-to-end deadlines, retries with
    backoff that route away from the failed arm, corrupt-response
    handling and per-arm circuit breakers whose mask enters the router's
    feasibility matrix.  Only ``EngineFailure`` is caught: any other
    error from an engine's step (a kernel's among them) propagates;
  * model addition (§6.3.4): ``add_engine`` registers a new pool member at
    runtime — the router grows a fresh arm, zero offline calibration.

This is the JAX package's ``PoolServer``.
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
from repro_torch.serving.reliability import BreakerConfig, CircuitBreaker
from repro_torch.serving.request import Request, RequestState, Response
from repro_torch.telemetry.hub import Telemetry


class LivelockError(TimeoutError):
    """``run_until_drained`` exhausted its step budget with live requests —
    the continuous-batching loop stopped making progress (a bug), or the
    budget is simply too small for the workload.  Subclasses TimeoutError
    so callers treating drain exhaustion as a timeout keep working."""


class PoolServer:
    """The GreenServ scheduler: routes queries, steps engines, closes the
    bandit loop.  ``hedge_after_steps`` is measured in scheduler steps
    spent QUEUED; ``heartbeat_timeout_s`` in seconds of ``clock`` (the
    wall clock unless the caller injects one, as virtual-clock drives
    do).  Every pool-level serving setting — ``prefill_chunk`` (prompt tokens per
    engine prefill tick), the ``cache`` handles (GreenCache prefix-KV /
    semantic reuse, consulted before routing), telemetry pre-binding — is
    applied through one ``_configure_engine`` choke point at construction
    and again on ``add_engine``, so a server-level setting governs the
    whole pool including late joiners."""

    def __init__(self, router: GreenServRouter,
                 engines: Dict[str, BaseEngine],
                 tokenizer: Optional[Callable[[str], List[int]]] = None,
                 hedge_after_steps: Optional[int] = None,
                 heartbeat_timeout_s: float = 30.0,
                 accuracy_fn: Optional[Callable] = None,
                 telemetry: Optional[Telemetry] = None,
                 prefill_chunk: Optional[int] = None,
                 cache: Optional[GreenCache] = None,
                 decode_engines: Optional[Dict[str, BaseEngine]] = None,
                 cost_model: Optional[EnergyCostModel] = None,
                 admission_planner: bool = False,
                 clock: Optional[Callable[[], float]] = None,
                 deadline_s: Optional[float] = None,
                 max_retries: int = 0,
                 retry_backoff_steps: int = 2,
                 breaker_config: Optional[BreakerConfig] = None):
        names = router.pool.names
        missing = [n for n in names if n not in engines]
        if missing:
            raise ValueError(f"engines missing for pool members: {missing}")
        self.router = router
        self.engines = engines
        # prefill/decode disaggregation: primary-name → decode twin.  The
        # primary becomes the prefill-role engine; requests migrate to the
        # twin at phase boundary (docs/SERVING.md "Disaggregated serving")
        self.decode_engines: Dict[str, BaseEngine] = {}
        self.tokenizer = tokenizer or (lambda text: [1 + (ord(c) % 250)
                                                     for c in text[:32]])
        self.hedge_after_steps = hedge_after_steps
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # injectable time source (same pattern as SemanticCache.clock):
        # virtual-clock benches pass the clock their SimEngines share, so
        # submit/heartbeat timestamps never mix wall and modeled time
        self.clock = clock or time.monotonic
        self.accuracy_fn = accuracy_fn
        self.telemetry = telemetry
        self.prefill_chunk = prefill_chunk
        self.cache = cache if (cache is None or cache.mode != "off") else None
        if self.cache is not None:
            # guard features must live in the router's embedding space
            self.cache.bind_context(router.context)
        # predictive energy cost model (repro_torch.costmodel): pre-dispatch Wh
        # forecasts feeding the router tilt, the governor's in-flight
        # charge, and (when enabled) the energy-aware admission planner
        self.cost_model = cost_model
        self.admission_planner = bool(admission_planner)
        # reliability layer (docs/RELIABILITY.md): per-request end-to-end
        # deadline (None = no deadlines), retry budget per request, retry
        # backoff in *scheduler steps* (virtual-clock aware — the benches
        # advance modeled time, not wall time), and per-(engine, role)
        # circuit breakers (None = breakers off).  All defaults preserve
        # the reliability-off behaviour exactly.
        self.deadline_s = deadline_s
        self.max_retries = int(max_retries)
        self.retry_backoff_steps = max(int(retry_backoff_steps), 1)
        self.breaker_config = breaker_config
        self.breakers: Dict[str, CircuitBreaker] = {}
        self._step_idx = 0
        # retries parked for backoff: (due_step, request, failed engine).
        # Parked requests stay in ``inflight`` so drain conditions and
        # fleet fail-over account for them.
        self._retry_parked: List[tuple] = []
        self._parked_uids: set = set()
        # terminal registry: TIMED_OUT / FAILED requests (no Response
        # exists; ``responses`` ∪ ``failed`` covers every admitted uid)
        self.failed: Dict[int, Request] = {}
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
                      "cache_hits": 0, "migrations": 0, "deferred": 0,
                      "retries": 0, "timeouts": 0, "failed": 0,
                      "slo_violations": 0, "breaker_opens": 0}
        # cumulative routing decisions landed per engine (primaries,
        # hedges, retries, restart replays) — the trajectory signal the
        # chaos bench reads to show breakers shifting share off a bad arm
        self.dispatch_counts: Dict[str, int] = {}
        # feedback for completions collected during the current step(); the
        # router is updated once per step via feedback_batch
        self._fb_buffer: List[Feedback] = []
        for name, twin in (decode_engines or {}).items():
            self.attach_decode_engine(name, twin)
        if self.breaker_config is not None:
            # OPEN arms vanish from route_batch's argmax on both scoring
            # backends (the mask rides the feasibility matrix)
            self.router.set_arm_health(self._arm_health_mask)

    # -- pool growth (paper §6.3.4) ---------------------------------------------

    def _configure_engine(self, name: str, engine: BaseEngine,
                          initial: bool = False,
                          role: Optional[str] = None) -> None:
        """Apply *every* pool-level serving setting to one engine — the
        single choke point used at construction and by ``add_engine``, so
        a late joiner can never silently miss a knob (prefill chunking,
        its prefix-KV cache handle, its phase role, telemetry
        pre-binding).  ``name`` is the telemetry display key (a decode
        twin shows up as ``<primary>#decode``); the prefix cache is keyed
        by the *model* name so twins share one cache (they share params —
        the KV blocks are interchangeable)."""
        if self.prefill_chunk is not None:
            engine.set_prefill_chunk(self.prefill_chunk)
        if self.cache is not None:
            model_name = name.split("#", 1)[0]
            engine.set_prefix_cache(self.cache.prefix_for(model_name))
        if role is not None:
            engine.set_role(role)
        if self.cost_model is not None:
            # the predictor is keyed by *model* name: a decode twin shares
            # the primary's cost model (same params, same shape terms —
            # the disaggregation surcharge is a flag set by
            # attach_decode_engine, not a separate predictor)
            self.cost_model.register_engine(name.split("#", 1)[0], engine)
        if self.telemetry is not None:
            self.telemetry.on_engine_added(name, engine, initial=initial)
        if self.breaker_config is not None and name not in self.breakers:
            # one breaker per (engine, role): primaries under their model
            # name, decode twins under ``<name>#decode``.  Only primary
            # breakers enter the routing mask (twins receive work through
            # migration, not routing); twin breakers still gate hedging
            # and feed the transition telemetry.
            self.breakers[name] = CircuitBreaker(
                self.breaker_config,
                on_transition=self._breaker_transition_hook(name))

    def _breaker_transition_hook(self, name: str) -> Callable:
        def hook(old: str, new: str, step: int) -> None:
            if new == "open":
                self.stats["breaker_opens"] += 1
            if self.telemetry is not None:
                self.telemetry.on_breaker(name, old, new, step)
        return hook

    def _arm_health_mask(self) -> Optional[np.ndarray]:
        """(n_models,) bool for the router: False = breaker holds the arm
        (OPEN, or HALF_OPEN at its probe quota).  Polled once per
        ``route_batch``; ``routable`` also advances OPEN→HALF_OPEN."""
        names = self.router.pool.names
        out = np.ones(len(names), bool)
        for j, n in enumerate(names):
            br = self.breakers.get(n)
            if br is None:
                continue
            eng = self.engines.get(n)
            out[j] = br.routable(self._step_idx,
                                 pending=(eng.pending if eng is not None
                                          else 0))
        return out

    def add_engine(self, profile: ModelProfile, engine: BaseEngine,
                   decode_engine: Optional[BaseEngine] = None) -> None:
        """Zero-calibration model addition: new engine + fresh bandit arm.
        Every server-level setting (``prefill_chunk``, cache handles,
        telemetry hooks) applies to late joiners via _configure_engine.
        Pass ``decode_engine`` to register the member disaggregated from
        the start (the twin must share the primary's params)."""
        self._configure_engine(profile.name, engine)
        self.engines[profile.name] = engine
        self.router.pool.add(profile)   # fires the router's add-arm hook
        if decode_engine is not None:
            self.attach_decode_engine(profile.name, decode_engine)

    def attach_decode_engine(self, name: str, twin: BaseEngine) -> None:
        """Disaggregate pool member ``name``: the existing engine becomes
        the prefill-role engine and ``twin`` (sharing its params) takes
        the decode phase via KV migration.  Layouts without a full-depth
        positional KV cache can't export/import KV — ``set_role`` falls
        back to ``unified`` there, and the twin is not registered (the
        member keeps serving both phases on one engine)."""
        if name not in self.engines:
            raise KeyError(f"no pool member named {name!r}")
        primary = self.engines[name]
        primary.set_role("prefill")
        if primary.role != "prefill":       # unified fallback (e.g. rwkv)
            return
        self._configure_engine(f"{name}#decode", twin, role="decode")
        self.decode_engines[name] = twin
        if self.cost_model is not None:
            # the prior now charges the phase-boundary KV DMA too
            self.cost_model.set_disaggregated(name, True)

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
        engines only — decode twins receive work through migration, never
        admission.  Admitted queries go through the normal batched
        ``submit_batch`` hot path (cache probe → route_batch → slices)."""
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
        governor's remaining per-tick Wh headroom (docs/ENERGY.md).  Each
        arrival is costed at its *cheapest* arm (the planner must never
        defer a query the router could still serve within budget); the
        first arrival whose forecast would breach the headroom stops the
        scan — no reordering, no cherry-picking behind the breach.  An
        idle pool always admits the head-of-line arrival regardless of
        headroom: admission pressure may slow the pool down, but it must
        never stop it (``run_until_drained`` would raise LivelockError)."""
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
        credit for the governor."""
        # routed models always come from the pool, so checking the
        # pool/engine invariant up front fails before ANY bookkeeping
        # (router pending entries included) — a half-registered batch
        # would sit in inflight forever with nothing dispatched
        missing = [n for n in self.router.pool.names
                   if n not in self.engines]
        if missing:
            raise KeyError(f"no engine for pool member(s): {missing}")
        req_by_uid: Dict[int, Request] = {}
        routable: List[Query] = []
        miss_features: List[Optional[tuple]] = []
        # one batched probe featurizes the whole admission (on the device
        # path this is a single fused kernel call); the per-query loop
        # below only does the similarity lookups
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
        # forward the cache probe's feature work (one batched embed +
        # classify — the device embeddings included) into routing instead
        # of re-deriving it there
        embs = labels = None
        if routable and miss_features[0] is not None:
            labels = np.asarray([f[0] for f in miss_features], np.int64)
            embs = np.stack([f[2] for f in miss_features])
        # pre-dispatch joule forecasts: a (Q, M) predicted-Wh matrix tilts
        # the routing decision per (query, arm), replacing the bandit's
        # coarse per-arm energy statistics for this decision
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
                          submit_s=self.clock(),
                          deadline_s=(self.deadline_s or 0.0),
                          max_retries=self.max_retries)
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

    # -- GreenCache consultation (docs/CACHING.md) -------------------------------

    def _try_semantic(self, query: Query,
                      feats: Optional[tuple] = None) -> tuple:
        """(already-DONE Request | None, probe features | None).

        A hit synthesizes the cached completion as this query's Response
        (zero engine work, zero routing) and returns an already-DONE
        Request; the avoided energy — the cached completion's measured Wh
        — is credited via ``Telemetry.on_cache_hit("semantic", …)``.
        Cached queries never touch router state (no k-means update, no
        bandit pull): they are invisible to the learning loop, exactly
        like traffic that never arrived.  On a miss the computed
        (task, cluster, embedding) features come back so the query is
        embedded exactly once per lifecycle — routing and the
        completion-time insert both reuse them.  ``feats`` carries the
        batched admission probe's row for this query (one featurization
        pass per batch; on the device path, one fused kernel call)."""
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
        """Hedge-target health gate: a failed/stalled-heartbeat engine or
        a breaker-held arm must never receive a hedge — duplicating onto
        a sick engine doubles the work and saves nothing."""
        if getattr(eng, "_failed", False):
            return False
        if self.clock() - eng.heartbeat() > self.heartbeat_timeout_s:
            return False
        br = self.breakers.get(name)
        if br is not None and not br.routable(self._step_idx,
                                              pending=eng.pending):
            return False
        return True

    def _maybe_hedge(self) -> None:
        if self.hedge_after_steps is None:
            return
        for uid, req in list(self.inflight.items()):
            if req.done or uid in self.hedges or req.hedge_of is not None:
                continue
            if uid in self._parked_uids:
                continue        # backing off for a retry, not straggling
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
                                submit_s=self.clock(),
                                deadline_s=req.deadline_s)
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
        for name, twin in self.decode_engines.items():
            stalled = now - twin.heartbeat() > self.heartbeat_timeout_s
            if stalled or getattr(twin, "_failed", False):
                self._restart_engine(name, decode=True)

    def _restart_engine(self, name: str, decode: bool = False) -> None:
        eng = self.decode_engines[name] if decode else self.engines[name]
        inflight = eng.restart()
        self.stats["restarts"] += 1
        if self.telemetry is not None:
            self.telemetry.on_restart(f"{name}#decode" if decode else name,
                                      len(inflight))
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
        display = f"{name}#decode" if decode else name
        primaries = [req for req in inflight
                     if req.hedge_of is None
                     and req.uid not in self.responses
                     and req.uid not in self.failed]
        # retry-eligible requests go through the reliability path: the
        # failure is recorded (breaker + zero-accuracy bandit observation)
        # and the request backs off before re-routing *away* from this
        # arm.  Requests without a retry budget keep the legacy immediate
        # re-route (no failure feedback — their pending decision must
        # survive for the eventual completion).
        retriable = [r for r in primaries if r.max_retries > 0]
        replay = [r for r in primaries if r.max_retries == 0]
        if not retriable:
            br = self.breakers.get(display)
            if br is not None:
                # no per-request evidence will be recorded, but the
                # restart itself is evidence against the arm
                br.record_failure(self._step_idx)
        for req in retriable:
            self._schedule_retry_or_fail(req, display, "engine_restart")
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

    # -- deadlines + retries (docs/RELIABILITY.md) ---------------------------------

    def _attempt_failed(self, req: Request, engine_name: str, reason: str,
                        energy_wh: float = 0.0) -> None:
        """One dispatch of ``req`` died on ``engine_name``: record it with
        the arm's breaker, feed the bandit the failure as a *real*
        observation (the energy actually burned, zero accuracy — LinUCB
        learns to avoid a degrading engine before the breaker trips), and
        let telemetry charge the wasted energy to the governor.  The
        bandit feedback consumes the attempt's pending routing decision
        (flushed strict=False, so a mismatch is skipped, never fatal)."""
        br = self.breakers.get(engine_name)
        if br is not None:
            br.record_failure(self._step_idx)
        if req.hedge_of is None:
            # a decode twin's display name maps to the primary's arm
            arm = engine_name.split("#", 1)[0]
            try:
                model_index = self.router.pool.index_of(arm)
            except KeyError:
                model_index = None
            if model_index is not None:
                self._fb_buffer.append(Feedback(
                    query_uid=req.uid, model_index=model_index,
                    accuracy=0.0, energy_wh=energy_wh, latency_ms=0.0,
                    input_tokens=len(req.prompt_tokens), output_tokens=0))
        if self.telemetry is not None:
            self.telemetry.on_attempt_failure(req.uid, engine_name, reason,
                                              energy_wh)

    def _reset_for_retry(self, req: Request) -> None:
        """Back to a clean QUEUED request (the same reset ``restart``
        applies): no slot, no generated tokens, no prompt cursor, no KV in
        transit.  ``submit_s`` is deliberately untouched — the deadline
        spans all attempts."""
        req.state = RequestState.QUEUED
        req.slot = -1
        req.generated = []
        req.n_prompt_fed = 0
        req.prefix_reused = 0
        req.first_token_s = 0.0
        req.start_s = 0.0
        req.kv_payload = None
        req.kv_migrated = 0
        req.prefill_wh = 0.0

    def _schedule_retry_or_fail(self, req: Request, engine_name: str,
                                reason: str, energy_wh: float = 0.0) -> None:
        """An attempt died: record the failure, then either park the
        request for an exponential-backoff retry (steps, virtual-clock
        aware) or — budget exhausted — declare it terminally FAILED."""
        self._attempt_failed(req, engine_name, reason, energy_wh)
        req.attempts += 1
        if req.attempts <= req.max_retries:
            self._reset_for_retry(req)
            due = self._step_idx + (self.retry_backoff_steps
                                    * (2 ** (req.attempts - 1)))
            self._retry_parked.append((due, req, engine_name))
            self._parked_uids.add(req.uid)
            self.inflight[req.uid] = req     # fail-over must still see it
            self.wait_steps[req.uid] = 0
            self.stats["retries"] += 1
        else:
            self._terminal_failure(req, RequestState.FAILED, reason)

    def _admit_retries(self) -> None:
        """Re-dispatch parked retries whose backoff elapsed: flush the
        buffered failure feedback first (the re-route must not overwrite
        a pending decision the flush consumes), then route the batch with
        each request's failed arm vetoed (``blocked``) and re-predict its
        in-flight charge — the governor *replaces* the prior charge for
        the uid, never stacks it."""
        if not self._retry_parked:
            return
        due = [e for e in self._retry_parked if e[0] <= self._step_idx]
        if not due:
            return
        self._retry_parked = [e for e in self._retry_parked
                              if e[0] > self._step_idx]
        for _, req, _ in due:
            self._parked_uids.discard(req.uid)
        self._flush_feedback()
        live = [(req, failed_arm) for _, req, failed_arm in due
                if not req.defunct and req.uid in self.inflight
                and req.uid not in self.responses]
        if not live:
            return
        names = self.router.pool.names
        blocked = np.zeros((len(live), len(names)), bool)
        for i, (req, failed_arm) in enumerate(live):
            arm = failed_arm.split("#", 1)[0]
            if arm in names:
                blocked[i, names.index(arm)] = True
        costs = occ = None
        if self.cost_model is not None:
            occ = {n: self._engine_occupancy(n) for n in names}
            costs = self.cost_model.predict_matrix(
                names, [len(req.prompt_tokens) for req, _ in live],
                [req.max_new_tokens for req, _ in live], occupancy=occ)
        decisions = self.router.route_batch(
            [req.query for req, _ in live], energy_costs_wh=costs,
            blocked=blocked)
        predicted = [] if costs is not None else None
        for i, ((req, failed_arm), decision) in enumerate(zip(live,
                                                              decisions)):
            self.wait_steps[req.uid] = 0
            if costs is not None:
                wh = float(costs[i, decision.model_index])
                req.predicted_wh = wh
                self.cost_model.note_admission(
                    req.uid, decision.model_name, wh,
                    n_prompt=len(req.prompt_tokens),
                    max_new_tokens=req.max_new_tokens,
                    occupancy=occ.get(decision.model_name, 0.0))
                predicted.append((req.uid, wh))
            self.engines[decision.model_name].submit(req)
            self.dispatch_counts[decision.model_name] = (
                self.dispatch_counts.get(decision.model_name, 0) + 1)
            if self.telemetry is not None:
                self.telemetry.on_retry(req.uid, req.attempts, failed_arm,
                                        decision.model_name)
        if self.telemetry is not None and predicted:
            # n=0: these uids were already counted at first admission —
            # this call only swaps their governor in-flight charges
            self.telemetry.on_admit(
                0, sum(e.pending for e in self.engines.values()),
                predicted=predicted)

    def _check_deadlines(self) -> None:
        """Expire requests whose end-to-end deadline passed: cancel any
        hedge, count the SLO violation, record the attempt failure on the
        arm that was holding it, and terminalize as TIMED_OUT.  Engines
        holding the request drop it on sight (``Request.defunct``)."""
        now = self.clock()
        for uid, req in list(self.inflight.items()):
            if req.deadline_s <= 0.0 or req.done:
                continue
            waited = now - req.submit_s
            if waited <= req.deadline_s:
                continue
            if uid in self._parked_uids:
                self._retry_parked = [e for e in self._retry_parked
                                      if e[1].uid != uid]
                self._parked_uids.discard(uid)
            hedge = self.hedges.get(uid)
            if hedge is not None:
                hedge.state = RequestState.CANCELLED
            if req.model_name:
                self._attempt_failed(req, req.model_name, "timeout", 0.0)
            self._terminal_failure(req, RequestState.TIMED_OUT, "timeout",
                                   waited_s=waited)

    def _terminal_failure(self, req: Request, state: RequestState,
                          reason: str, waited_s: float = 0.0) -> None:
        """The request is over without a Response: move it to the
        ``failed`` terminal registry, release its governor in-flight
        charge exactly once (``on_cancelled`` pops the uid; a second call
        is a no-op), and drop its cost-model pending prediction."""
        uid = req.uid
        req.state = state
        req.finish_s = self.clock()
        self.failed[uid] = req
        self.inflight.pop(uid, None)
        self.hedges.pop(uid, None)
        self.wait_steps.pop(uid, None)
        if state is RequestState.TIMED_OUT:
            self.stats["timeouts"] += 1
            self.stats["slo_violations"] += 1
            if self.telemetry is not None:
                self.telemetry.on_timeout(uid, waited_s)
        else:
            self.stats["failed"] += 1
            if self.telemetry is not None:
                self.telemetry.on_request_failed(uid, reason)
        if self.telemetry is not None:
            self.telemetry.on_cancelled(uid)
        if self.cost_model is not None:
            self.cost_model.forget_query(uid)

    def _handle_corrupt(self, resp: Response, req: Request,
                        engine_name: str) -> bool:
        """A completion came back marked ``corrupt`` (the NaN/inf-logits
        failure mode — energy burned, output garbage).  Returns True when
        the response was intercepted (retry scheduled / hedge dropped);
        False lets it complete as a zero-accuracy answer (the reliability-
        off baseline, and the retry-budget-exhausted fallthrough is
        handled inside ``_schedule_retry_or_fail``)."""
        if req.hedge_of is not None:
            # a corrupt hedge must never win the race: drop the duplicate,
            # the primary keeps running
            if self.hedges.get(req.hedge_of) is req:
                del self.hedges[req.hedge_of]
            req.state = RequestState.CANCELLED
            br = self.breakers.get(engine_name)
            if br is not None:
                br.record_failure(self._step_idx)
            if self.telemetry is not None:
                self.telemetry.on_attempt_failure(req.uid, engine_name,
                                                  "garbage", resp.energy_wh)
            return True
        if req.max_retries > 0:
            self._schedule_retry_or_fail(req, engine_name, "garbage",
                                         resp.energy_wh)
            return True
        br = self.breakers.get(engine_name)
        if br is not None:
            br.record_failure(self._step_idx)
        return False

    # -- completion -------------------------------------------------------------------

    def _complete(self, resp: Response, req: Request) -> None:
        primary_uid = req.hedge_of if req.hedge_of is not None else req.uid
        primary = self.inflight.get(primary_uid)
        if primary is None or primary_uid in self.responses:
            return                          # race already resolved
        br = self.breakers.get(resp.model_name)
        if br is not None:
            br.record_success(self._step_idx)
        if (primary.deadline_s > 0.0
                and self.clock() - primary.submit_s > primary.deadline_s):
            # answered, but late: served out of SLO (deadline enforcement
            # runs before engine steps, so a same-tick finish still wins)
            self.stats["slo_violations"] += 1
            if self.telemetry is not None:
                self.telemetry.on_slo_violation(primary_uid,
                                                resp.latency_ms)
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
            # fall back to a fresh probe only if they were never stashed
            # (e.g. the cache was attached mid-flight)
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
        tick is one chunk-prefill or decode call, prefill-side
        engines first so a phase boundary migrates the same tick it is
        reached), the migration pump, one batched feedback flush, one
        telemetry/governor step.  Returns the responses completed this
        tick."""
        done: List[Response] = []
        self._step_idx += 1
        self._check_engines()
        self._check_deadlines()
        self._admit_retries()
        self._maybe_hedge()
        self._admit_arrivals()
        for name, eng in self.engines.items():
            try:
                for resp in eng.step():
                    req = self._find_request(resp.uid, name)
                    if req is None:
                        continue
                    if (getattr(resp, "corrupt", False)
                            and self._handle_corrupt(resp, req, name)):
                        continue
                    self._complete(resp, req)
                    done.append(resp)
            except EngineFailure:
                self._restart_engine(name)
        for name, twin in self.decode_engines.items():
            try:
                for resp in twin.step():
                    req = self._find_request(resp.uid, name)
                    if req is None:
                        continue
                    if (getattr(resp, "corrupt", False)
                            and self._handle_corrupt(resp, req,
                                                     f"{name}#decode")):
                        continue
                    self._complete(resp, req)
                    done.append(resp)
            except EngineFailure:
                self._restart_engine(name, decode=True)
        self._pump_migrations()
        self._flush_feedback()
        for uid, req in self.inflight.items():
            if req.state == RequestState.QUEUED:
                self.wait_steps[uid] = self.wait_steps.get(uid, 0) + 1
        # telemetry last: power samples see the step's energy, and the
        # governor's λ adjustment lands after this step's feedback flush
        if self.telemetry is not None:
            self.telemetry.on_step(self._all_engines())
        return done

    def _all_engines(self) -> Dict[str, BaseEngine]:
        """Telemetry view of the pool: primaries under their model name,
        decode twins under ``<name>#decode``."""
        if not self.decode_engines:
            return self.engines
        view = dict(self.engines)
        for name, twin in self.decode_engines.items():
            view[f"{name}#decode"] = twin
        return view

    def _pump_migrations(self) -> None:
        """Move phase-boundary requests from each prefill-role engine's
        outbox into its decode twin's queue.  Runs after engine stepping,
        so a prefill that completes at tick t starts decoding at t+1 —
        the one-tick handoff is the (honest) migration latency.  If the
        twin vanished mid-flight the request re-prefills on the primary
        (payload dropped); nothing is ever lost."""
        for name, eng in self.engines.items():
            if eng.role != "prefill":
                continue
            twin = self.decode_engines.get(name)
            for req in eng.drain_migrations():
                if req.defunct:
                    continue
                if twin is None:
                    req.kv_payload = None
                    req.kv_migrated = 0
                    req.prefill_wh = 0.0
                    req.state = RequestState.QUEUED
                    req.generated = []
                    req.n_prompt_fed = 0
                    req.prefix_reused = 0
                    eng.submit(req)
                    continue
                twin.submit_migrated(req)
                self.stats["migrations"] += 1
                if self.telemetry is not None:
                    self.telemetry.on_migration(name, req.kv_migrated)

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
        open: arrivals, retry parking, per-engine occupancy/health, and
        the in-flight uids with their states.  Embedded in LivelockError
        so a stuck drain is diagnosable from the exception alone."""
        lines = [f"arrivals queued: {len(self.arrivals)}; "
                 f"retry-parked: {len(self._retry_parked)} "
                 f"(next due step {min((e[0] for e in self._retry_parked), default='-')}; "
                 f"now step {self._step_idx})"]
        for name, eng in self._all_engines().items():
            br = self.breakers.get(name)
            lines.append(
                f"  engine {name}: pending={eng.pending} "
                f"free={eng.free_capacity} "
                f"role={getattr(eng, 'role', 'unified')} "
                f"failed={bool(getattr(eng, '_failed', False))}"
                + (f" breaker={br.state}" if br is not None else ""))
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
