"""GreenServ router: context → feasibility → bandit → reward → update.

Implements Algorithm 1 of the paper as a long-lived service object:

    for each query q_t:
        x_t  = GenerateContext(q_t)                 (ContextGenerator)
        m_t  = SelectModel(x_t, M_t*, A)            (BanditPolicy over pool)
        resp = InferenceExecution(m_t, q_t)         (caller / serving engine)
        acc, energy, latency = Monitor(resp)        (caller feeds back)
        r_t  = (1-λ)·acc − λ·energy                 (RewardManager)
        UpdateMAB(A_m, b_m, x_t, r_t)               (BanditPolicy.update)

The router is deliberately decoupled from inference execution: ``route()``
returns a decision, the engine executes it, and ``feedback()`` closes the
loop.  This matches the paper's partial-feedback structure and lets the
serving runtime batch/queue independently.

The router lives on one device (the card unless the caller passes
``device="cpu"``): the bandit state, the k-means device copy and the
classifier weights stay there, and the device featurize→score path
(``_fused_decide``) launches the featurize and LinUCB kernels on it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bandits import NEG_INF, BanditPolicy
from repro_torch.core.context import (ContextGenerator,
                                      flesch_score_bin_device,
                                      kmeans_update_scan)
from repro_torch.core.pool import ModelPool
from repro_torch.core.rewards import RegretTracker, RewardManager, scalarize
from repro_torch.core.types import (ContextVector, Feedback, ModelProfile,
                                    Query, RouteDecision, RouterConfig)
from repro_torch.device import resolve_device, sync
from repro_torch.kernels.featurize import hashed_embed
from repro_torch.kernels.featurize.ops import pad_pow2
from repro_torch.kernels.linucb import linucb_scores


# EWMA step for the per-arm baseline of offered cost-model predictions
# (route_batch's energy_costs_wh tilt); slow enough that one odd batch
# does not swing the baseline, fast enough to track load shifts
_PRED_COST_BETA = 0.1


def _fused_decide(ids, weights, emb_in, labels_in, proj, w_clf, b_clf,
                  centroids, kcounts, kinit, comp_counts, comp_lo,
                  comp_width, feasible, valid, a_inv, theta, active, *,
                  mode: str, use_task: bool, use_cluster: bool,
                  use_complexity: bool, n_tasks: int, n_clusters: int,
                  n_bins: int, alpha: float):
    """The whole routing decision as one device function.

    featurize (hashed-embedding kernel over the padded id/weight tensors)
    → task-classifier logits → Eq. 9–10 k-means rows in arrival order →
    Flesch score+bin from the host-tokenized counts → one-hot context
    encoding → LinUCB scoring kernel → feasibility-masked argmax (ties to
    the lowest index).  Every input is a tensor on the router's device and
    nothing is read back inside: one host→device transfer in (feature
    ids, complexity counts, feasibility), one device→host transfer out
    (arms, scores, labels, clusters, complexity).

    ``comp_counts`` is the (Q, 3) int32 (words, sentences, syllables)
    matrix from ``ContextGenerator.complexity_counts_batch``; the Eq. 11
    arithmetic is the float32 op-order mirror of the host reference
    (``flesch_score_bin_device``), so host and device produce identical
    bins.

    ``mode`` says what the stacked id tensor holds: "both" = full texts
    then instruction slices, "full"/"instr" = one of them, "none" = the
    caller forwarded embeddings/labels and no featurization is needed.
    Every (Q,)-shaped input is padded to a power of two by the caller;
    ``valid`` marks the real rows — padding rows must not touch the
    k-means state and are sliced off on the host.  With ``use_cluster``
    off the k-means inputs are None and come back None.
    """
    q = comp_counts.shape[0]
    dev = comp_counts.device
    emb, emb_i = emb_in, None
    if mode == "both":
        e2 = hashed_embed(ids, weights, proj)
        emb, emb_i = e2[:q], e2[q:]
    elif mode == "full":
        emb = hashed_embed(ids, weights, proj)
    elif mode == "instr":
        emb_i = hashed_embed(ids, weights, proj)
    if use_task:
        labels = (torch.argmax(emb_i @ w_clf + b_clf, dim=1).to(torch.int32)
                  if labels_in is None else labels_in)
    else:
        labels = torch.zeros((q,), dtype=torch.int32, device=dev)
    if use_cluster:
        centroids, kcounts, kinit, clusters = kmeans_update_scan(
            centroids, kcounts, kinit, emb, valid=valid)
    else:
        clusters = torch.zeros((q,), dtype=torch.int32, device=dev)
    if use_complexity:
        comp_scores, comp_bins = flesch_score_bin_device(
            comp_counts, comp_lo, comp_width, n_bins)
    else:
        comp_scores = torch.full((q,), 100.0, dtype=torch.float32, device=dev)
        comp_bins = torch.zeros((q,), dtype=torch.int32, device=dev)
    one_hot = torch.nn.functional.one_hot
    zeros = lambda n: torch.zeros((q, n), dtype=torch.float32, device=dev)
    parts = [
        one_hot(labels.long(), n_tasks).float() if use_task else zeros(n_tasks),
        (one_hot(clusters.long(), n_clusters).float() if use_cluster
         else zeros(n_clusters)),
        (one_hot(comp_bins.long(), n_bins).float() if use_complexity
         else zeros(n_bins)),
        torch.ones((q, 1), dtype=torch.float32, device=dev),
    ]
    x = torch.cat(parts, dim=1)
    scores = linucb_scores(a_inv, theta, x, alpha)
    masked = torch.where(active[None, :] & feasible, scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=dev))
    arms = torch.argmax(masked, dim=1)
    return (arms, masked, labels, clusters, centroids, kcounts, kinit,
            comp_scores, comp_bins)


class GreenServRouter:
    """The paper's contribution as a composable module."""

    def __init__(self, config: RouterConfig, pool: ModelPool,
                 context: Optional[ContextGenerator] = None, device=None):
        self.config = config
        self.pool = pool
        self.device = resolve_device(device)
        self.context = context or ContextGenerator(config, device=self.device)
        if self.context.device != self.device:
            raise ValueError(f"context on {self.context.device}, router on "
                             f"{self.device}")
        self.policy = BanditPolicy(config, n_arms=len(pool),
                                   device=self.device)
        self.rewards = RewardManager(config)
        self.regret = RegretTracker()
        self._pending: Dict[int, RouteDecision] = {}
        self.decision_ms_total = 0.0
        self.n_routed = 0
        # λ-decomposed sufficient statistics: b_m = (1-λ)·Σ acc·x −
        # λ·Σ (e/scale)·x, so set_lambda can re-scalarize the bandit
        # exactly instead of waiting for fresh pulls to wash out old λ
        m, d = config.max_arms, config.context_dim
        self._b_acc = np.zeros((m, d), np.float64)
        self._b_cost = np.zeros((m, d), np.float64)
        self._acc_sum = np.zeros(m, np.float64)
        self._cost_sum = np.zeros(m, np.float64)
        self._decomposed_complete = True
        # predictive-cost tilt baseline (route_batch's energy_costs_wh):
        # per-arm EWMA of the predictions *offered* to this router, so each
        # arm's forecast is scored relative to its own norm — a constant
        # prediction (or any per-arm-constant matrix) tilts nothing and
        # decisions match the cost-model-off path exactly
        self._pred_cost_mean = np.zeros(m, np.float64)
        self._pred_cost_seen = np.zeros(m, bool)
        # failure-aware routing (docs/RELIABILITY.md): an optional health
        # provider — () -> (n_models,) bool, True = routable — ANDed into
        # the feasibility matrix each decision.  PoolServer wires this to
        # its per-arm circuit breakers; None = every arm healthy.
        self._arm_health: Optional[Callable[[], Optional[np.ndarray]]] = None
        # zero-calibration model addition: pool insert → fresh bandit arm
        pool.on_add(self._on_model_added)

    def set_arm_health(self,
                       provider: Optional[Callable[[], Optional[np.ndarray]]]
                       ) -> None:
        """Install (or clear, with None) the per-arm health provider.
        The provider is polled once per ``route_batch`` call; a short or
        None result means "no opinion" for the uncovered arms."""
        self._arm_health = provider

    # -- pool growth ---------------------------------------------------------

    def _on_model_added(self, profile: ModelProfile, idx: int) -> None:
        arm = self.policy.add_arm()
        if arm != idx:
            raise RuntimeError(
                f"pool/bandit index skew: pool={idx} arm={arm}")
        self._b_acc[arm] = 0.0
        self._b_cost[arm] = 0.0
        self._acc_sum[arm] = 0.0
        self._cost_sum[arm] = 0.0
        self._pred_cost_mean[arm] = 0.0
        self._pred_cost_seen[arm] = False

    # -- online λ control (telemetry.budget drives this) -----------------------

    def set_lambda(self, lam: float, rescalarize: bool = True) -> None:
        """Retune the accuracy–energy trade-off online (governor hook).

        Future rewards scalarize under the new λ immediately (RewardManager
        shares this config).  With ``rescalarize`` the bandit's reward
        statistics are also rebuilt from the decomposed accuracy/energy
        sums, so the *posterior* shifts toward cheaper arms in the same
        step — A/A⁻¹ are context-only and stay untouched.
        """
        if not (0.0 <= lam <= 1.0):
            raise ValueError(f"lam must be in [0, 1], got {lam}")
        if lam == self.config.lam:
            return
        self.config.lam = lam
        # a checkpoint from before decomposed stats existed cannot be
        # rescalarized: the sums would be partial (or zero) and rebuilding
        # b/θ from them would silently wipe the restored posterior
        if rescalarize and self._decomposed_complete:
            scale = self.config.energy_scale_wh
            b = (1.0 - lam) * self._b_acc - lam * self._b_cost / scale
            rsum = (1.0 - lam) * self._acc_sum - lam * self._cost_sum / scale
            self.policy.rescalarize(b, rsum)

    # -- Algorithm 1 ---------------------------------------------------------

    def route(self, query: Query) -> RouteDecision:
        # the batch-of-one: keeps the sequential and batched decision paths
        # structurally identical (see route_batch's equivalence guarantee)
        return self.route_batch([query])[0]

    def route_batch(self, queries: Sequence[Query],
                    energy_discounts_wh: Optional[np.ndarray] = None,
                    energy_costs_wh: Optional[np.ndarray] = None,
                    embeddings: Optional[np.ndarray] = None,
                    task_labels: Optional[np.ndarray] = None,
                    blocked: Optional[np.ndarray] = None
                    ) -> List[RouteDecision]:
        """Route an admitted batch in one shot (the serving hot path).

        Featurization is vectorized (one embed + one classifier matmul for
        the whole batch) and LinUCB scoring runs as a single fused (Q, M)
        kernel call, so per-query decision overhead amortizes to the
        batched cost.  Arm choices are identical to calling ``route`` on
        each query in order (k-means updates are applied in arrival order,
        and LinUCB selection is deterministic given the bandit state).

        ``energy_discounts_wh`` (Q, n_models), optional: expected Wh each
        arm would *save* on each query — e.g. a prefix-KV cache hit whose
        spliced tokens skip prefill (``PoolServer`` fills this from the
        engines' prefix indexes).  The discount enters the decision as the
        energy term of the reward it cancels, ``λ·ΔWh/energy_scale`` added
        to the arm's score, so a warm-cache arm can win over a nominally
        cheaper cold one.  The bandit's *posterior* is untouched: the
        realized saving arrives through feedback (cheap completions), the
        discount only tilts this decision.  Only rows with a nonzero
        discount are re-picked — undiscounted queries keep their original
        arm, so a stochastic policy's exploration draws survive except on
        the queries the tilt is actually about (where the discounted
        greedy choice deliberately wins).

        ``energy_costs_wh`` (Q, n_models), optional: the cost model's
        *predicted* Wh for running each query on each arm (``PoolServer``
        fills this from ``EnergyCostModel.predict_matrix``).  Predictions
        replace the bandit's coarse per-arm energy statistics for *this*
        decision: each arm's forecast is centred on its own running EWMA
        baseline of offered predictions, and the centred excess enters as
        an energy penalty ``−λ·(pred − baseline)/energy_scale`` before
        the argmax.  Centring makes the tilt shape-sensitive rather than
        level-sensitive — a per-arm-constant matrix tilts nothing, so an
        uncalibrated cost model cannot perturb decisions, and systematic
        arm-level cost differences stay the posterior's job (learned from
        realized feedback, not forecasts).

        ``embeddings`` (Q, dim) / ``task_labels`` (Q,) forward feature
        work the caller already did on these texts (the scheduler's cache
        probe) into ``ContextGenerator.batch`` — bitwise identical to
        recomputing, since embedder and classifier are deterministic.

        ``blocked`` (Q, n_models) bool, optional: per-(query, arm) veto
        ANDed (inverted) into feasibility — e.g. a retry must not land
        back on the arm that just failed it.  Both the per-row veto and
        the pool-wide arm-health provider (``set_arm_health``; the
        scheduler's circuit breakers) enter through ``_feasible_matrix``,
        so host and device scoring see identical masks.  Masking never
        strands a query: a row left with no arm falls back to its
        unmasked feasible row — serving degrades, it does not refuse.

        With ``RouterConfig.featurize`` resolving to "device" (and the
        deterministic LinUCB/Sherman–Morrison policy), featurize→score
        runs as one fused device function (``_fused_decide``): the host
        contributes one vectorized hashing pass + Flesch word/sentence/
        syllable counts, the device does everything else (including the
        Eq. 11 score + binning arithmetic).  The host path below stays the reference
        implementation; both agree (tests/test_featurize_parity.py).
        """
        if not queries:
            return []
        if self._device_featurize_active():
            ctxs, arms, scores, feasible, t0 = self._featurize_score_device(
                queries, embeddings, task_labels, blocked)
        else:
            ctxs, arms, scores, feasible, t0 = self._featurize_score_host(
                queries, embeddings, task_labels, blocked)
        if energy_costs_wh is not None:
            c = np.asarray(energy_costs_wh, np.float64)
            if c.shape[0] != len(queries):
                raise ValueError(
                    f"energy_costs_wh rows {c.shape[0]} != batch "
                    f"{len(queries)}")
            w = min(c.shape[1], scores.shape[1])
            cols = c[:, :w]
            batch_mean = cols.mean(axis=0)
            seen = self._pred_cost_seen[:w]
            self._pred_cost_mean[:w] = np.where(
                seen,
                (1.0 - _PRED_COST_BETA) * self._pred_cost_mean[:w]
                + _PRED_COST_BETA * batch_mean,
                batch_mean)
            self._pred_cost_seen[:w] = True
            tilt = np.zeros_like(scores)
            tilt[:, :w] = (-self.config.lam
                           * (cols - self._pred_cost_mean[:w])
                           / self.config.energy_scale_wh)
            if np.any(tilt):
                # NEG_INF (infeasible/inactive) scores survive any finite
                # tilt, so a plain re-argmax is safe
                scores = scores + tilt
                arms = np.argmax(scores, axis=1).astype(arms.dtype)
        if energy_discounts_wh is not None:
            d = np.asarray(energy_discounts_wh, np.float32)
            if d.shape[0] != len(queries):
                raise ValueError(
                    f"energy_discounts_wh rows {d.shape[0]} != batch "
                    f"{len(queries)}")
            rows = np.flatnonzero(d.any(axis=1))
            if rows.size:
                bonus = np.zeros_like(scores)
                w = min(d.shape[1], bonus.shape[1])
                bonus[:, :w] = (self.config.lam * d[:, :w]
                                / self.config.energy_scale_wh)
                scores = scores + bonus
                # infeasible arms carry NEG_INF scores; a finite bonus
                # cannot resurrect them, so an argmax re-pick of the
                # discounted rows suffices
                arms = arms.copy()
                arms[rows] = np.argmax(scores[rows], axis=1).astype(
                    arms.dtype)
        batch_ms = (time.perf_counter() - t0) * 1e3
        per_query_ms = batch_ms / len(queries)
        self.decision_ms_total += batch_ms
        self.n_routed += len(queries)
        decisions: List[RouteDecision] = []
        for q, ctx, arm, score_row, feas_row in zip(queries, ctxs, arms,
                                                    scores, feasible):
            decision = RouteDecision(
                query_uid=q.uid, model_index=int(arm),
                model_name=self.pool[int(arm)].name, context=ctx,
                ucb_scores=score_row, feasible_mask=feas_row,
                overhead_ms=per_query_ms)
            self._pending[q.uid] = decision
            decisions.append(decision)
        return decisions

    # -- featurize→score backends (route_batch dispatches between them) -------

    def _device_featurize_active(self) -> bool:
        """Device pipeline gate: the ``featurize`` toggle must resolve to
        device AND the policy must be deterministic batched LinUCB
        (stochastic policies and the per-decision Cholesky mode need
        sequential per-query semantics, so they stay on the host path)."""
        return (self.config.resolve_featurize_device(self.device)
                and self.config.algorithm == "linucb"
                and self.config.solve_mode == "sherman_morrison")

    def _feasible_matrix(self, queries: Sequence[Query],
                         blocked: Optional[np.ndarray] = None) -> np.ndarray:
        masks = [self.pool.feasible_mask(q) for q in queries]
        # a concurrent pool.add() mid-batch yields ragged rows; pad earlier
        # rows with False (those queries were routed before the new model
        # existed, matching sequential semantics)
        width = max(m.shape[0] for m in masks)
        feasible = np.zeros((len(masks), width), dtype=bool)
        for i, m in enumerate(masks):
            feasible[i, : m.shape[0]] = m
        # reliability masks ride the same matrix both scoring backends
        # consume, so breaker state can never break host/device parity
        masked = feasible
        if self._arm_health is not None:
            health = self._arm_health()
            if health is not None:
                health = np.asarray(health, bool)
                w = min(health.shape[0], width)
                masked = masked.copy()
                masked[:, :w] &= health[:w]
        if blocked is not None:
            b = np.asarray(blocked, bool)
            if b.shape[0] != len(masks):
                raise ValueError(
                    f"blocked rows {b.shape[0]} != batch {len(masks)}")
            w = min(b.shape[1], width)
            if masked is feasible:
                masked = feasible.copy()
            masked[:, :w] &= ~b[:, :w]
        if masked is not feasible:
            # serve-anyway guarantee: a query every arm of which is vetoed
            # keeps its plain feasibility row (a fully-open pool must
            # still answer; the breakers' probe trickle needs traffic)
            dead = ~masked.any(axis=1)
            if dead.any():
                masked[dead] = feasible[dead]
            feasible = masked
        return feasible

    def _featurize_score_host(self, queries: Sequence[Query],
                              embeddings: Optional[np.ndarray],
                              task_labels: Optional[np.ndarray],
                              blocked: Optional[np.ndarray] = None
                              ) -> Tuple[list, np.ndarray, np.ndarray,
                                         np.ndarray, float]:
        """Reference path: host featurization, then the batched selector."""
        ctxs = self.context.batch([q.text for q in queries],
                                  embeddings=embeddings,
                                  task_labels=task_labels)
        t0 = time.perf_counter()
        feasible = self._feasible_matrix(queries, blocked)
        x = np.stack([c.vector for c in ctxs])
        arms, scores = self.policy.select_batch(x, feasible)
        sync(self.device)             # timing boundary (route_batch's clock)
        return ctxs, arms, scores, feasible, t0

    def _featurize_score_device(self, queries: Sequence[Query],
                                embeddings: Optional[np.ndarray],
                                task_labels: Optional[np.ndarray],
                                blocked: Optional[np.ndarray] = None
                                ) -> Tuple[list, np.ndarray, np.ndarray,
                                           np.ndarray, float]:
        """Fused path: one host hashing pass, then ``_fused_decide``."""
        ctx = self.context
        dev = self.device
        texts = [q.text for q in queries]
        n = len(texts)
        tc0 = time.perf_counter()
        comp_counts = ctx.complexity_counts_batch(texts)
        tc1 = time.perf_counter()
        need_emb = ctx.use_cluster and embeddings is None
        need_instr = ctx.use_task and task_labels is None
        mode = {(True, True): "both", (True, False): "full",
                (False, True): "instr", (False, False): "none"}[
            (need_emb, need_instr)]
        # Q (and L, inside padded_feature_tensors) padded to powers of two,
        # the JAX package's layout: the kernels see a handful of shapes
        q_pad = pad_pow2(n)
        ids = weights = emb_in = labels_in = None
        if mode != "none":
            ids, weights = ctx.padded_feature_tensors(
                texts, want_full=need_emb, want_instr=need_instr,
                q_pad=q_pad)
            ids = torch.from_numpy(ids).to(dev)
            weights = torch.from_numpy(weights).to(dev)
        if embeddings is not None and ctx.use_cluster:
            e = np.zeros((q_pad, ctx.embedder.dim), np.float32)
            e[:n] = np.asarray(embeddings, np.float32)
            emb_in = torch.from_numpy(e).to(dev)
        if task_labels is not None and ctx.use_task:
            lab = np.zeros(q_pad, np.int32)
            lab[:n] = np.asarray(task_labels)
            labels_in = torch.from_numpy(lab).to(dev)
        pad_rows = np.zeros((q_pad - n, 3), np.int32)
        pad_rows[:, 1] = 1            # sentences >= 1: padding rows never 0/0
        comp_counts = np.concatenate([comp_counts, pad_rows])
        valid = np.arange(q_pad) < n
        ctx.record_device_batch(n, (time.perf_counter() - tc1) * 1e3,
                                (tc1 - tc0) * 1e3)
        t0 = time.perf_counter()
        feasible = self._feasible_matrix(queries, blocked)
        feas_pad = np.zeros((q_pad, self.config.max_arms), bool)
        feas_pad[:n, : feasible.shape[1]] = feasible
        cent = cnt = ini = None
        if ctx.use_cluster:
            cent, cnt, ini = ctx.kmeans.device_state()
        w_clf, b_clf = ctx.classifier_params()
        st = self.policy.state
        out = _fused_decide(
            ids, weights, emb_in, labels_in, ctx.embedder.proj_device(dev),
            w_clf, b_clf, cent, cnt, ini, torch.from_numpy(comp_counts).to(dev),
            torch.tensor(ctx.complexity.lo, dtype=torch.float32, device=dev),
            torch.tensor(ctx.complexity.bin_width32, dtype=torch.float32,
                         device=dev),
            torch.from_numpy(feas_pad).to(dev), torch.from_numpy(valid).to(dev),
            st.A_inv, st.theta, st.active,
            mode=mode, use_task=ctx.use_task, use_cluster=ctx.use_cluster,
            use_complexity=ctx.use_complexity,
            n_tasks=self.config.n_tasks, n_clusters=self.config.n_clusters,
            n_bins=self.config.n_complexity_bins,
            alpha=float(self.config.alpha_ucb))
        (arms_d, masked, labels, clusters, cent2, cnt2, ini2,
         comp_scores_d, comp_bins_d) = out
        # one device→host transfer out; it also closes the decision clock
        arms_h, masked_h, labels_h, clusters_h, scores_h, bins_h = (
            t.cpu().numpy() for t in (arms_d, masked, labels, clusters,
                                      comp_scores_d, comp_bins_d))
        if ctx.use_cluster:
            ctx.kmeans.load_device_state(cent2, cnt2, ini2)
        self.policy.advance_key()     # mirror select_batch's state step
        comp = [(float(s), int(b)) for s, b in
                zip(scores_h.astype(np.float32)[:n], bins_h[:n])]
        ctxs = ctx.make_contexts(labels_h.astype(np.int64)[:n],
                                 clusters_h.astype(np.int64)[:n], comp)
        return (ctxs, arms_h.astype(np.int64)[:n],
                masked_h.astype(np.float32)[:n], feasible, t0)

    def feedback(self, fb: Feedback,
                 oracle_reward: Optional[float] = None) -> float:
        """Close the loop for a routed query; returns the scalarized reward.

        ``oracle_reward`` (counterfactual best reward, Eq. 6) is only
        available in simulation/offline evaluation; when given, regret is
        tracked (Eq. 8).
        """
        decision = self._pending.pop(fb.query_uid, None)
        if decision is None:
            raise KeyError(f"no pending decision for query {fb.query_uid}")
        if fb.model_index != decision.model_index:
            raise ValueError("feedback model does not match routed model")
        r_t = self.rewards.reward(fb.accuracy, fb.energy_wh)
        arm, x = decision.model_index, decision.context.vector
        self._b_acc[arm] += fb.accuracy * x
        self._b_cost[arm] += fb.energy_wh * x
        self._acc_sum[arm] += fb.accuracy
        self._cost_sum[arm] += fb.energy_wh
        self.policy.update(arm, x, r_t)
        if oracle_reward is not None:
            self.regret.step(r_t, oracle_reward)
        return r_t

    def feedback_batch(self, fbs: Sequence[Feedback],
                       oracle_rewards: Optional[Sequence[float]] = None,
                       strict: bool = True) -> List[Optional[float]]:
        """Close the loop for a batch of completions, in the given order.

        Bandit updates to *different* arms commute exactly (each arm owns
        its own sufficient statistics), so completion order across arms
        does not change the posterior; same-arm updates are applied in
        sequence.  With ``strict=False`` a feedback whose query was never
        routed here, or whose model does not match the routed arm (a hedge
        duplicate that won on a non-routed engine), is skipped and its slot
        in the returned reward list is None.
        """
        rewards: List[Optional[float]] = []
        for i, fb in enumerate(fbs):
            oracle = (oracle_rewards[i] if oracle_rewards is not None
                      else None)
            try:
                rewards.append(self.feedback(fb, oracle))
            except (KeyError, ValueError):
                if strict:
                    raise
                rewards.append(None)
        return rewards

    def oracle_reward(self, acc_by_model: np.ndarray,
                      energy_by_model: np.ndarray,
                      feasible: Optional[np.ndarray] = None) -> float:
        """Eq. 6 helper for simulators holding full counterfactual tables."""
        r = np.array([scalarize(a, e, self.config.lam, self.config.energy_scale_wh)
                      for a, e in zip(acc_by_model, energy_by_model)])
        if feasible is not None:
            r = np.where(feasible, r, -np.inf)
        return float(np.max(r))

    # -- introspection / persistence ------------------------------------------

    @property
    def mean_decision_ms(self) -> float:
        return self.decision_ms_total / max(self.n_routed, 1)

    def selection_counts(self) -> np.ndarray:
        return self.policy.state.counts.cpu().numpy()[: len(self.pool)]

    def state_dict(self) -> dict:
        """Serialize the full routing state.

        The bandit dict carries the whole ``BanditState`` (the opaque key
        and the A matrices included), the context dict
        forces the k-means device→host sync, and ``lam`` pins the
        scalarization the posterior was built under, so a restored router
        routes identically to the one that saved.  ``load_state_dict``
        takes this dict or the JAX package's router's, as it is.
        """
        return {"bandit": self.policy.state_dict(),
                "context": self.context.state_dict(),
                "lam": float(self.config.lam),
                "n_routed": self.n_routed,
                "decomposed": {"b_acc": self._b_acc.copy(),
                               "b_cost": self._b_cost.copy(),
                               "acc_sum": self._acc_sum.copy(),
                               "cost_sum": self._cost_sum.copy()},
                "pred_cost_mean": {"mean": self._pred_cost_mean.copy(),
                                   "seen": self._pred_cost_seen.copy()}}

    def load_state_dict(self, d: dict) -> None:
        self.policy.load_state_dict(d["bandit"])
        self.context.load_state_dict(d["context"])
        lam = d.get("lam")
        if lam is not None:
            # restore λ directly (no rescalarize — the loaded posterior
            # was already built under it; rebuilding from the decomposed
            # sums below would be a no-op modulo float noise)
            self.config.lam = float(lam)
        self.n_routed = int(d.get("n_routed", 0))
        dec = d.get("decomposed")
        if dec is not None:
            self._b_acc = np.asarray(dec["b_acc"], np.float64).copy()
            self._b_cost = np.asarray(dec["b_cost"], np.float64).copy()
            self._acc_sum = np.asarray(dec["acc_sum"], np.float64).copy()
            self._cost_sum = np.asarray(dec["cost_sum"], np.float64).copy()
            self._decomposed_complete = True
        else:
            # pre-decomposition checkpoint: the loaded posterior is valid
            # but cannot be re-derived — set_lambda keeps working, minus
            # the instant posterior rebuild
            self._decomposed_complete = False
        pc = d.get("pred_cost_mean")
        if pc is not None:
            self._pred_cost_mean = np.asarray(pc["mean"], np.float64).copy()
            self._pred_cost_seen = np.asarray(pc["seen"], bool).copy()
