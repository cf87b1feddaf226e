"""Adaptive energy-budget governance: a closed loop from joules to λ.

GreenServ's λ fixes the accuracy–energy trade-off at launch; the
``EnergyBudgetGovernor`` makes it a control variable.  A token bucket holds
Wh credit: completions drain it by their measured energy, a refill stream
adds credit at the budget's sustainable rate (per completed query against a
known horizon, or per second against a wall-clock window).  Bucket
depletion maps to *pressure* in [0, 1], and pressure interpolates λ from
its launch value toward ``lambda_max`` — so the bandit shifts toward
cheaper arms exactly when the budget tightens and relaxes when headroom
returns (workload-conditioned budget-optimal serving in the sense of
Wilkins et al., arXiv:2407.04014).

An optional carbon-intensity signal scales the refill rate: when the grid
is dirty the same Wh budget buys fewer tokens *now*, deferring energy
spend to cleaner hours (diurnal model below; plug a live signal in via
``carbon_fn``).

λ changes propagate through ``GreenServRouter.set_lambda``, which
re-scalarizes the bandit's sufficient statistics under the new λ — the
posterior reacts to the new trade-off immediately instead of waiting for
thousands of fresh observations to wash out the old one.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple


def diurnal_carbon_intensity(t_s: float, amplitude: float = 0.3,
                             period_s: float = 86_400.0,
                             phase_s: float = 0.0) -> float:
    """Relative grid carbon intensity (≈1.0 mean): a smooth daily cycle
    peaking mid-period (evening demand) and bottoming out off-peak."""
    return 1.0 + amplitude * math.sin(
        2.0 * math.pi * (t_s + phase_s) / period_s)


class EnergyBudgetGovernor:
    """Token-bucket Wh governor driving the router's λ online.

    Exactly one of ``horizon_queries`` (refill per completion — offline
    runs over a known stream) or ``horizon_s`` (refill per second — live
    serving against a wall-clock window) must be given.

    The bucket holds at most ``burst_frac · budget_wh`` and may run the
    same amount into debt; pressure is the depletion fraction of that
    span.  Two extra brakes keep cumulative spend under the cap rather
    than merely near it:

      * *projection*: once the recent per-query burn rate projects the run
        past the budget, pressure is floored at the overshoot fraction;
      * *exhaustion*: past ``hard_frac`` of the budget λ pins to
        ``lambda_max`` until headroom returns.
    """

    def __init__(self, budget_wh: float,
                 horizon_queries: Optional[int] = None,
                 horizon_s: Optional[float] = None,
                 router=None,
                 lambda_max: float = 0.8,
                 burst_frac: float = 0.08,
                 hard_frac: float = 0.95,
                 safety: float = 0.95,
                 carbon_fn: Optional[Callable[[float], float]] = None,
                 min_delta: float = 5e-3,
                 ewma_alpha: float = 0.05,
                 gain: float = 0.01,
                 initial_lambda: Optional[float] = None,
                 control_on_completion: bool = True):
        if budget_wh <= 0:
            raise ValueError("budget_wh must be positive")
        if (horizon_queries is None) == (horizon_s is None):
            raise ValueError(
                "exactly one of horizon_queries / horizon_s is required")
        self.budget_wh = float(budget_wh)
        self.horizon_queries = horizon_queries
        self.horizon_s = horizon_s
        self.router = router
        self.lambda_max = float(lambda_max)
        self.base_lambda: Optional[float] = (
            float(router.config.lam) if router is not None else None)
        self.capacity_wh = burst_frac * self.budget_wh
        self.bucket_wh = self.capacity_wh
        self.hard_frac = hard_frac
        self.safety = safety        # refill toward safety·budget, not budget
        self.carbon_fn = carbon_fn
        self.min_delta = min_delta
        self.ewma_alpha = ewma_alpha
        self.gain = gain            # integral gain: Δλ per control tick
        self.control_on_completion = control_on_completion
        # opening stance: default to the router's launch λ.  Opening at
        # λ_max ("budget-first") banks headroom but biases the early
        # posterior cheap — the bandit under-explores accurate arms and
        # that conservatism persists after λ relaxes; operators with very
        # tight caps can still opt in via initial_lambda.
        self.initial_lambda = initial_lambda
        # state
        self.cumulative_wh = 0.0
        self.completed = 0
        self.admitted = 0
        self.wh_per_query_ewma: Optional[float] = None
        self.pressure = 0.0
        self.current_lambda: Optional[float] = self.base_lambda
        self._lam_target: Optional[float] = (
            self.initial_lambda if self.initial_lambda is not None
            else self.base_lambda)
        self.lambda_history: List[Tuple[float, float]] = []
        self._last_refill_s: Optional[float] = None
        self.exhausted = False
        # phase ledger (Wh): attribution of the metered burn to prefill vs
        # decode, fed per step by Telemetry.on_step from the engines'
        # phase-tagged joule counters
        self.phase_wh = {"prefill": 0.0, "decode": 0.0}
        # role ledger (Wh): the same burn keyed by *engine role* (unified /
        # prefill / decode).  Under disaggregated serving this is the
        # per-role energy attribution the bench reads; an all-unified pool
        # books everything under "unified"
        self.role_wh = {"unified": 0.0, "prefill": 0.0, "decode": 0.0}
        # GreenCache credit ledger (Wh): energy the cache *avoided*
        # spending (prefix-KV splices, semantic answers).  Avoided energy
        # earns bucket credit — work the budget no longer has to fund —
        # but never counts as negative spend against the hard cap.
        self.avoided_wh = {"prefix": 0.0, "semantic": 0.0}
        # expected Wh savings of queries routed-but-not-completed (prefix
        # hits known at admission); discounts the in-flight commitment so
        # a warm-cache burst doesn't tighten λ for energy it won't spend
        self.inflight_savings_wh = 0.0
        # predict-then-reconcile (docs/ENERGY.md): per-query predicted Wh
        # charged at admission (uid-keyed so a completion releases exactly
        # its own charge — hedge winners share the primary's uid), plus
        # the running ledger of prediction-vs-metered error ratios
        self.inflight_pred: Dict[int, float] = {}
        self.inflight_predicted_wh = 0.0
        self.prediction_error = {"n": 0, "abs_ratio_sum": 0.0,
                                 "ratio_sum": 0.0, "max_abs_ratio": 0.0}

    def attach(self, router) -> None:
        self.router = router
        if self.base_lambda is None:
            self.base_lambda = float(router.config.lam)
            self.current_lambda = self.base_lambda

    # -- accounting ---------------------------------------------------------

    def _refill_rate_scale(self, t_s: float) -> float:
        if self.carbon_fn is None:
            return 1.0
        # dirty grid → each wall-clock unit earns proportionally less credit
        return 1.0 / max(self.carbon_fn(t_s), 1e-6)

    def on_admission(self, n: int, t_s: float = 0.0,
                     expected_savings_wh: float = 0.0,
                     predicted=None) -> None:
        """Note routed-but-not-yet-completed queries.  Routing commits
        energy long before completion meters it; the projection charges
        each in-flight query its expected (EWMA) cost so admission bursts
        tighten λ *before* their bill arrives, not a pipeline-delay later.

        ``expected_savings_wh``: Wh the batch is expected *not* to spend
        (prefix-KV hits known at routing time); it discounts the in-flight
        commitment until the corresponding completions retire it.

        ``predicted``: iterable of ``(uid, predicted_wh)`` from the energy
        cost model — each query's *own* pre-dispatch forecast replaces the
        pool-average EWMA in the in-flight commitment, and the charge is
        released (and reconciled against the metered Wh) when that uid
        completes or is cancelled."""
        self.admitted += n
        self.inflight_savings_wh += max(expected_savings_wh, 0.0)
        if predicted is not None:
            for uid, wh in predicted:
                wh = max(float(wh), 0.0)
                prev = self.inflight_pred.pop(uid, None)
                if prev is not None:       # re-admission (restart re-route)
                    self.inflight_predicted_wh -= prev
                self.inflight_pred[uid] = wh
                self.inflight_predicted_wh += wh
        if self.control_on_completion:
            self._control(t_s)

    def on_avoided_energy(self, energy_wh: float, kind: str,
                          t_s: float = 0.0) -> None:
        """Credit energy a cache hit avoided spending (``kind`` is
        ``"prefix"`` or ``"semantic"``).  Ledger entry + bucket refill
        credit: the avoided Wh is headroom the budget gets back, so
        pressure relaxes in the same step — the closed-loop face of
        "the cheapest token is the one never computed".  Cumulative spend
        (the hard cap) is untouched: avoided energy is not negative
        consumption."""
        wh = max(energy_wh, 0.0)
        self.avoided_wh[kind] = self.avoided_wh.get(kind, 0.0) + wh
        self.bucket_wh = min(self.bucket_wh + wh, self.capacity_wh)
        if self.control_on_completion:
            self._control(t_s)

    def on_extra_energy(self, energy_wh: float, t_s: float = 0.0) -> None:
        """Charge energy that produced no completion of its own — e.g. a
        hedge duplicate's discarded work.  Drains the bucket and counts
        toward the cap without perturbing the per-query burn statistics."""
        self.cumulative_wh += energy_wh
        self.bucket_wh = max(self.bucket_wh - energy_wh, -self.capacity_wh)
        if self.control_on_completion:
            self._control(t_s)

    def on_phase_energy(self, prefill_wh: float, decode_wh: float) -> None:
        """Attribute a step's metered energy (Wh deltas) to the prefill /
        decode phases.  This is a *ledger*, not a second drain: the bucket
        is still drained by per-completion Wh (which already includes both
        phases) — the split tells operators (and ``stats()``) which phase
        is consuming the budget, e.g. whether tightening λ should shed
        long-prompt traffic or long generations."""
        self.phase_wh["prefill"] += max(prefill_wh, 0.0)
        self.phase_wh["decode"] += max(decode_wh, 0.0)

    def on_role_energy(self, role: str, energy_wh: float) -> None:
        """Attribute a step's metered energy (Wh delta) to the reporting
        engine's *role* — a second ledger view next to the phase split.
        Phases say what kind of work burned the joules; roles say which
        class of engine did, which is what disaggregated serving needs to
        size its prefill vs decode fleets."""
        self.role_wh[role] = self.role_wh.get(role, 0.0) \
            + max(energy_wh, 0.0)

    def on_completion(self, energy_wh: float, t_s: float = 0.0,
                      uid: Optional[int] = None) -> None:
        """Drain the bucket by a completion's measured energy; in query-
        horizon mode also earn this completion's refill credit.  With a
        ``uid`` the completion releases its admission-time predicted
        charge (exactly once — the map is popped) and the prediction is
        reconciled against the metered Wh into the ``prediction_error``
        ledger."""
        if uid is not None:
            pred = self.inflight_pred.pop(uid, None)
            if pred is not None:
                self.inflight_predicted_wh = max(
                    self.inflight_predicted_wh - pred, 0.0)
                self._record_prediction_error(pred, energy_wh)
        # the completing query carries away its (average) share of the
        # expected in-flight cache savings — realized savings now show up
        # in the measured energy itself
        inflight = max(self.admitted - self.completed, 1)
        self.inflight_savings_wh *= 1.0 - 1.0 / inflight
        self.cumulative_wh += energy_wh
        self.completed += 1
        self.bucket_wh -= energy_wh
        if self.horizon_queries is not None:
            rate = self.safety * self.budget_wh / max(self.horizon_queries, 1)
            self.bucket_wh += rate * self._refill_rate_scale(t_s)
        a = self.ewma_alpha
        if self.wh_per_query_ewma is None:
            self.wh_per_query_ewma = energy_wh
        else:
            self.wh_per_query_ewma = (1 - a) * self.wh_per_query_ewma \
                + a * energy_wh
        self.bucket_wh = min(max(self.bucket_wh, -self.capacity_wh),
                             self.capacity_wh)
        if self.control_on_completion:
            self._control(t_s)

    def on_cancel(self, uid: int, t_s: float = 0.0) -> None:
        """Release a cancelled query's predicted in-flight charge without
        reconciling (no completion ever meters it).  Idempotent — a uid
        already released (or never predicted) is a no-op, so the bucket
        can never be credited twice."""
        pred = self.inflight_pred.pop(uid, None)
        if pred is not None:
            self.inflight_predicted_wh = max(
                self.inflight_predicted_wh - pred, 0.0)
        if self.control_on_completion:
            self._control(t_s)

    def _record_prediction_error(self, predicted_wh: float,
                                 measured_wh: float) -> None:
        ratio = (measured_wh - predicted_wh) / max(measured_wh, 1e-12)
        e = self.prediction_error
        e["n"] += 1
        e["abs_ratio_sum"] += abs(ratio)
        e["ratio_sum"] += ratio
        e["max_abs_ratio"] = max(e["max_abs_ratio"], abs(ratio))

    def admission_headroom_wh(self) -> float:
        """Wh of *new* predicted work the budget can absorb right now —
        the admission planner's gate.  The bucket may legally run
        ``capacity_wh`` into debt, so the spendable span is
        ``bucket + capacity``; predicted in-flight work has already
        claimed its share, and the hard cap bounds everything."""
        if self.exhausted:
            return 0.0
        soft = self.bucket_wh + self.capacity_wh - self.inflight_predicted_wh
        hard = (self.hard_frac * self.budget_wh - self.cumulative_wh
                - self.inflight_predicted_wh)
        return max(min(soft, hard), 0.0)

    def _rate_error(self) -> Optional[float]:
        """Dimensionless burn-rate error: 0 = on the sustainable rate,
        positive = burning hot (tighten λ), negative = headroom (relax).

        Query-horizon mode compares the EWMA per-query burn against the
        rate the remaining (safety-margined) headroom supports, charging
        in-flight queries their expected cost — routing commits energy
        long before completion meters it.  Wall-clock mode reads the
        token bucket level (its drift *is* the integrated rate error).
        """
        if self.horizon_queries is not None:
            if self.wh_per_query_ewma is None or self.completed == 0:
                return None
            inflight = max(self.admitted - self.completed, 0)
            # queries with a cost-model forecast are charged their own
            # predicted Wh; only the unpredicted remainder falls back to
            # the pool-average EWMA
            unpredicted = max(inflight - len(self.inflight_pred), 0)
            expected_inflight_wh = (self.inflight_predicted_wh
                                    + unpredicted * self.wh_per_query_ewma)
            # prefix-KV hits known at admission won't spend their full
            # EWMA cost; the discount never exceeds the commitment itself
            expected_inflight_wh -= min(self.inflight_savings_wh,
                                        expected_inflight_wh)
            committed = self.cumulative_wh + expected_inflight_wh
            remaining_q = self.horizon_queries - max(self.admitted,
                                                     self.completed)
            if remaining_q <= 0:
                return None                       # no routing authority left
            headroom = self.safety * self.budget_wh - committed
            if headroom <= 0.0:
                return 1.0
            target = headroom / remaining_q
            # symmetric clip: per-task energy spans an order of magnitude,
            # and letting hot spikes integrate twice as fast as cool ones
            # skews the time-average λ into cheap-arm saturation
            return min(max(self.wh_per_query_ewma / target - 1.0, -1.0), 1.0)
        # wall-clock mode: half-full bucket = on rate
        half = max(self.capacity_wh, 1e-12)
        return min(max(1.0 - 2.0 * self.bucket_wh / half, -1.0), 1.0)

    # -- the control step ---------------------------------------------------

    def _control(self, t_s: float) -> float:
        """Integrate the burn-rate error into λ and push it to the router.

        Integral action (Δλ = gain·err per tick) finds the *equilibrium*
        λ where the bandit's spending matches the sustainable rate and
        settles there — a proportional map from error to λ either leaves
        a steady-state overburn or slams between base and λ_max.
        """
        base = self.base_lambda if self.base_lambda is not None else 0.4
        lo, hi = min(base, self.lambda_max), self.lambda_max
        if self._lam_target is None:
            self._lam_target = base
        err = self._rate_error()
        if err is not None:
            self._lam_target += self.gain * err
        self.exhausted = self.cumulative_wh >= self.hard_frac * self.budget_wh
        if self.exhausted:
            self._lam_target = hi                 # out of budget: pin to max
        self._lam_target = min(max(self._lam_target, lo), hi)
        self.pressure = (self._lam_target - lo) / max(hi - lo, 1e-9)
        lam = self._lam_target

        if (self.router is not None and self.current_lambda is not None
                and abs(lam - self.current_lambda) > self.min_delta):
            self.router.set_lambda(lam)
            self.lambda_history.append((t_s, lam))
            self.current_lambda = lam
        elif self.current_lambda is None:
            self.current_lambda = lam
        return self.current_lambda if self.current_lambda is not None else lam

    def step(self, t_s: float) -> float:
        """The per-scheduler-step control point; returns the λ in force.

        In wall-clock mode this is also where refill credit accrues.
        (With ``control_on_completion`` the λ recompute additionally runs
        at every completion — scheduler steps that complete whole admission
        batches would otherwise give the loop too few control points.)
        """
        if self.horizon_s is not None:
            if self._last_refill_s is not None:
                dt = max(t_s - self._last_refill_s, 0.0)
                rate = self.safety * self.budget_wh / self.horizon_s
                self.bucket_wh = min(
                    self.bucket_wh
                    + rate * dt * self._refill_rate_scale(t_s),
                    self.capacity_wh)
            self._last_refill_s = t_s
        return self._control(t_s)

    # -- introspection ------------------------------------------------------

    @property
    def remaining_wh(self) -> float:
        return max(self.budget_wh - self.cumulative_wh, 0.0)

    def stats(self) -> dict:
        return {
            "budget_wh": self.budget_wh,
            "cumulative_wh": self.cumulative_wh,
            "remaining_wh": self.remaining_wh,
            "bucket_wh": self.bucket_wh,
            "pressure": self.pressure,
            "lambda": self.current_lambda,
            "lambda_changes": len(self.lambda_history),
            "completed": self.completed,
            "exhausted": self.exhausted,
            "prefill_wh": self.phase_wh["prefill"],
            "decode_wh": self.phase_wh["decode"],
            "role_wh": dict(self.role_wh),
            "avoided_prefix_wh": self.avoided_wh["prefix"],
            "avoided_semantic_wh": self.avoided_wh["semantic"],
            "inflight_predicted_wh": self.inflight_predicted_wh,
            "prediction_error": {
                "n": self.prediction_error["n"],
                "mae_ratio": (self.prediction_error["abs_ratio_sum"]
                              / max(self.prediction_error["n"], 1)),
                "mean_ratio": (self.prediction_error["ratio_sum"]
                               / max(self.prediction_error["n"], 1)),
                "max_abs_ratio": self.prediction_error["max_abs_ratio"],
            },
        }
