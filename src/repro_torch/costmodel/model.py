"""Predictive per-(model, shape) energy cost model (pre-dispatch forecasts).

Before a query is dispatched, ``EnergyCostModel.predict`` forecasts the
Wh its completion will meter, per candidate engine:

  * an **analytic prior** composed from the roofline terms in
    ``core.energy`` over (prompt len, expected decode len, prefix reuse,
    phase, role) — it mirrors, term for term, the charging rules the
    engines' own per-query accounting uses (``ModelEngine._query_wh`` /
    ``_migrated_query_wh``), so for a real engine the only irreducible
    error is the unknown decode length;
  * an **online residual** per (engine, phase) bucket — exponentially-
    forgetting RLS (``residual.RLSResidual``) fitted from the metered
    joule ledger at completion time, which also carries engines with no
    analytic shape model at all (``SimEngine``: zero prior, the residual
    learns Wh from token counts alone);
  * a per-engine **decode-length EWMA**: the ratio of generated tokens
    to ``max_new_tokens``, so predictions use the *expected* decode
    length while residual training uses the *actual* one.

Consumers (docs/ENERGY.md): the router's per-(query, arm) energy tilt,
the cache's predicted prefix discounts, the governor's in-flight
predicted-Wh charge, and the scheduler's admission planner.  State is a
plain dict of numpy arrays — it rides ``distributed.checkpoint`` next to
the router state.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.energy import (JOULES_PER_WH, decode_step_cost,
                                     energy_joules, kv_migration_cost,
                                     prefill_chunk_cost, prefill_cost,
                                     roofline)
from repro_torch.costmodel.residual import RLSResidual

PHASES = ("prefill", "decode")
FEATURE_DIM = 4      # [analytic phase Wh, 1, tokens/256, occupancy]
_TOK_SCALE = 256.0


def _phi(analytic_wh: float, tokens: float, occupancy: float) -> np.ndarray:
    return np.array([analytic_wh, 1.0, tokens / _TOK_SCALE, occupancy],
                    np.float64)


class EngineCostModel:
    """Per-engine predictor: analytic prior + per-phase RLS residuals.

    ``cost_params`` is the engine's ``CostModelParams`` (None for engines
    without a shape model — the prior is then 0 and the residual carries
    the whole prediction).  ``prefill_chunk``/``chips``/``max_len``/
    ``disaggregated`` replicate the knobs that change what the engine's
    accounting charges, so the prior stays an exact mirror.
    """

    def __init__(self, name: str, cost_params=None, prefill_chunk: int = 1,
                 chips: int = 1, max_len: Optional[int] = None,
                 disaggregated: bool = False, forget: float = 0.99,
                 out_alpha: float = 0.2):
        self.name = name
        self.cost_params = cost_params
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.chips = int(chips)
        self.max_len = max_len
        self.disaggregated = bool(disaggregated)
        self.out_alpha = float(out_alpha)
        # split phase buckets only when a shape model exists: engines
        # without one meter a single undifferentiated Wh, so their
        # observations (and predictions) live in one "decode" bucket
        self.split_phases = cost_params is not None
        self.residuals = {ph: RLSResidual(FEATURE_DIM, forget=forget,
                                          w0=[1.0, 0.0, 0.0, 0.0])
                          for ph in PHASES}
        # expected fraction of max_new_tokens actually generated (EOS cuts
        # generations short); cold start assumes the full budget is used,
        # which over-predicts decode — the safe direction for admission
        self.out_ratio = 1.0
        self.n_obs = 0

    # -- analytic prior ------------------------------------------------------

    def _slab_joules(self, n_tokens: int, kv_start: int) -> float:
        """Chunk-slab prefill joules — ``ModelEngine._prefill_joules``'s
        charging rule: slabs > 1 token cost ``prefill_chunk_cost``, single
        tokens ``decode_step_cost``, walked from ``kv_start``."""
        p = self.cost_params
        C = self.prefill_chunk
        joules, kv = 0.0, kv_start
        end = kv_start + n_tokens
        while kv < end:
            n = min(C, end - kv)
            if n > 1:
                f, b = prefill_chunk_cost(p, n, kv)
            else:
                f, b = decode_step_cost(p, max(kv + n, 1))
            joules += energy_joules(roofline(f, b, 0.0, self.chips))
            kv += n
        return joules

    def analytic_split_wh(self, n_prompt: int, n_out: int, reused: int = 0,
                          migrated: Optional[bool] = None
                          ) -> Tuple[float, float]:
        """(prefill Wh, decode Wh) the engine's accounting of record would
        charge for this shape — ``_query_wh`` for unified members,
        ``_prefill_phase_wh`` + decode + KV DMA for disaggregated ones.
        The migration DMA is booked on the prefill side, exactly where the
        decode twin's ``_migrated_query_wh`` charges it."""
        p = self.cost_params
        if p is None:
            return 0.0, 0.0
        n_prompt = int(n_prompt)
        n_out = int(n_out)
        reused = max(int(reused), 0)
        n_p = max(n_prompt, 1)
        if migrated is None:
            migrated = self.disaggregated
        if migrated and self.max_len is not None \
                and n_prompt > self.max_len - 1:
            migrated = False     # per-request unified fallback (overflow)
        if reused > 0:
            pre_j = self._slab_joules(max(n_p - reused, 1), reused)
        else:
            f, b = prefill_cost(p, n_p)
            pre_j = energy_joules(roofline(f, b, 0.0, self.chips))
        if migrated:
            f, b = kv_migration_cost(p, n_p)
            pre_j += energy_joules(roofline(f, b, 0.0, self.chips))
        mid_kv = n_prompt + max(n_out, 1) // 2
        f, b = decode_step_cost(p, mid_kv)
        dec_j = max(n_out, 0) * energy_joules(
            roofline(f, b, 0.0, self.chips))
        return pre_j / JOULES_PER_WH, dec_j / JOULES_PER_WH

    # -- prediction ----------------------------------------------------------

    def expected_out(self, max_new_tokens: int) -> int:
        return max(int(round(self.out_ratio * max(int(max_new_tokens), 1))),
                   1)

    def _features(self, n_prompt: int, n_out: int, reused: int,
                  occupancy: float) -> Dict[str, np.ndarray]:
        a_pre, a_dec = self.analytic_split_wh(n_prompt, n_out, reused)
        if self.split_phases:
            return {"prefill": _phi(a_pre, n_prompt, occupancy),
                    "decode": _phi(a_dec, n_out, occupancy)}
        # single-bucket engines: one feature row over the whole query
        return {"decode": _phi(a_pre + a_dec, n_prompt + n_out, occupancy)}

    def predict_split(self, n_prompt: int, max_new_tokens: int,
                      reused: int = 0, occupancy: float = 0.0
                      ) -> Tuple[float, float]:
        """(prefill Wh, decode Wh) forecast at the *expected* decode
        length.  Negative residual outputs clamp to 0 — energy is spent,
        never earned."""
        n_out = self.expected_out(max_new_tokens)
        feats = self._features(n_prompt, n_out, reused, occupancy)
        if self.split_phases:
            return (max(self.residuals["prefill"].predict(feats["prefill"]),
                        0.0),
                    max(self.residuals["decode"].predict(feats["decode"]),
                        0.0))
        return 0.0, max(self.residuals["decode"].predict(feats["decode"]),
                        0.0)

    def predict_wh(self, n_prompt: int, max_new_tokens: int,
                   reused: int = 0, occupancy: float = 0.0) -> float:
        pre, dec = self.predict_split(n_prompt, max_new_tokens, reused,
                                      occupancy)
        return pre + dec

    def discount_wh(self, n_prompt: int, max_new_tokens: int,
                    reused: int, occupancy: float = 0.0) -> float:
        """Predicted-suffix-minus-full: the Wh a ``reused``-token prefix
        hit is forecast to save on this engine (the decode terms cancel —
        prefix reuse avoids prefill work, never decode work)."""
        if reused <= 0:
            return 0.0
        cold = self.predict_wh(n_prompt, max_new_tokens, 0, occupancy)
        warm = self.predict_wh(n_prompt, max_new_tokens, reused, occupancy)
        return max(cold - warm, 0.0)

    # -- calibration ---------------------------------------------------------

    def observe(self, n_prompt: int, n_out: int, max_new_tokens: int,
                reused: int, migrated: bool, occupancy: float,
                measured_wh: float,
                measured_prefill_wh: Optional[float] = None) -> None:
        """Fold one completion from the metered ledger into the residuals.
        Features are built at the *actual* decode length (training must
        not inherit the expectation's error); the decode-length EWMA then
        absorbs that expectation error separately."""
        if max_new_tokens > 0:
            r = min(max(n_out / max_new_tokens, 0.0), 1.0)
            self.out_ratio += self.out_alpha * (r - self.out_ratio)
        a_pre, a_dec = self.analytic_split_wh(n_prompt, n_out, reused,
                                              migrated=migrated)
        if self.split_phases and measured_prefill_wh is not None \
                and measured_prefill_wh > 0.0:
            self.residuals["prefill"].update(
                _phi(a_pre, n_prompt, occupancy), measured_prefill_wh)
            self.residuals["decode"].update(
                _phi(a_dec, n_out, occupancy),
                max(measured_wh - measured_prefill_wh, 0.0))
        elif self.split_phases:
            # no phase split in the measurement: train the decode bucket
            # on the whole-query residual against the summed prior
            self.residuals["decode"].update(
                _phi(a_pre + a_dec, n_out, occupancy),
                max(measured_wh - a_pre, 0.0))
        else:
            self.residuals["decode"].update(
                _phi(a_pre + a_dec, n_prompt + n_out, occupancy),
                measured_wh)
        self.n_obs += 1

    # -- persistence ---------------------------------------------------------

    def state_dict(self) -> dict:
        return {"out_ratio": np.float64(self.out_ratio),
                "n_obs": np.int64(self.n_obs),
                "disaggregated": np.bool_(self.disaggregated),
                "residuals": {ph: r.state_dict()
                              for ph, r in self.residuals.items()}}

    def load_state_dict(self, d: dict) -> None:
        self.out_ratio = float(d["out_ratio"])
        self.n_obs = int(d["n_obs"])
        self.disaggregated = bool(d["disaggregated"])
        for ph, rd in d.get("residuals", {}).items():
            if ph in self.residuals:
                self.residuals[ph].load_state_dict(rd)


class EnergyCostModel:
    """The pool-level facade the scheduler/router/governor talk to.

    Owns one ``EngineCostModel`` per pool member (registered through the
    scheduler's ``_configure_engine`` choke point, so late joiners and
    decode twins are covered), the uid-keyed map of outstanding
    predictions (admission → completion reconciliation), and a bounded
    history of (engine, predicted, measured) pairs for benches.
    """

    def __init__(self, forget: float = 0.99, out_alpha: float = 0.2,
                 history: int = 4096):
        self.forget = float(forget)
        self.out_alpha = float(out_alpha)
        self.engines: Dict[str, EngineCostModel] = {}
        # uid → admission note (engine, predicted Wh, shape, occupancy);
        # popped at completion (reconcile) or cancellation (forget)
        self._pending: Dict[int, dict] = {}
        self.history: Deque[dict] = collections.deque(maxlen=history)
        self.n_predicted = 0
        self.n_reconciled = 0
        self.abs_err_wh = 0.0
        self.measured_wh_sum = 0.0

    # -- pool membership -----------------------------------------------------

    def register_engine(self, name: str, engine=None) -> EngineCostModel:
        """Idempotent: first registration snapshots the engine's analytic
        shape knobs (``cost_params``, ``prefill_chunk``, chips, slot
        depth); re-registration refreshes the mutable ones (the scheduler
        may set ``prefill_chunk`` after construction)."""
        m = self.engines.get(name)
        if m is None:
            energy = getattr(engine, "energy", None)
            m = EngineCostModel(
                name,
                cost_params=getattr(engine, "cost_params", None),
                prefill_chunk=getattr(engine, "prefill_chunk", 1),
                chips=getattr(energy, "chips", 1),
                max_len=getattr(engine, "max_len", None),
                forget=self.forget, out_alpha=self.out_alpha)
            self.engines[name] = m
        elif engine is not None:
            m.prefill_chunk = max(int(getattr(engine, "prefill_chunk",
                                              m.prefill_chunk)), 1)
        return m

    def set_disaggregated(self, name: str, disaggregated: bool) -> None:
        """Mark a member as serving through a prefill/decode pair — its
        prior then includes the phase-boundary KV DMA."""
        self.register_engine(name).disaggregated = bool(disaggregated)

    # -- forecasts -----------------------------------------------------------

    def predict_wh(self, name: str, n_prompt: int, max_new_tokens: int,
                   reused: int = 0, occupancy: float = 0.0) -> float:
        m = self.engines.get(name)
        if m is None:
            return 0.0
        return m.predict_wh(n_prompt, max_new_tokens, reused, occupancy)

    def predict_matrix(self, names: Sequence[str],
                       token_lens: Sequence[int],
                       max_new: Sequence[int],
                       occupancy: Optional[Dict[str, float]] = None
                       ) -> np.ndarray:
        """(Q, M) cold (reused=0) predicted Wh per (query, arm) — the
        router's energy tilt input.  Prefix discounts are fed separately
        (``discount_wh``), so reuse is never double-counted."""
        occupancy = occupancy or {}
        out = np.zeros((len(token_lens), len(names)), np.float64)
        for j, name in enumerate(names):
            m = self.engines.get(name)
            if m is None:
                continue
            occ = float(occupancy.get(name, 0.0))
            for i, (n_p, mx) in enumerate(zip(token_lens, max_new)):
                out[i, j] = m.predict_wh(n_p, mx, 0, occ)
        return out

    def discount_wh(self, name: str, n_prompt: int, max_new_tokens: int,
                    reused: int, occupancy: float = 0.0) -> float:
        m = self.engines.get(name)
        if m is None:
            return 0.0
        return m.discount_wh(n_prompt, max_new_tokens, reused, occupancy)

    # -- admission / reconciliation ------------------------------------------

    def note_admission(self, uid: int, name: str, predicted_wh: float,
                       n_prompt: int, max_new_tokens: int, reused: int = 0,
                       occupancy: float = 0.0) -> None:
        self._pending[uid] = {
            "engine": name, "predicted_wh": float(predicted_wh),
            "n_prompt": int(n_prompt), "max_new": int(max_new_tokens),
            "reused": int(reused), "occupancy": float(occupancy)}
        self.n_predicted += 1

    def forget_query(self, uid: int) -> None:
        """Drop a prediction whose query will never complete (cancelled
        before any engine work) — no residual update, no error sample."""
        self._pending.pop(uid, None)

    def observe_response(self, resp, accuracy: float = 0.0
                         ) -> Optional[float]:
        """Reconcile a completion against its admission-time prediction
        and train the winning engine's residuals from the metered Wh.
        Returns the predicted Wh (None if this uid was never predicted).
        Hedge winners may complete on a different engine than predicted —
        the measurement trains the engine that actually served."""
        note = self._pending.pop(resp.uid, None)
        m = self.engines.get(resp.model_name)
        occupancy = note["occupancy"] if note is not None else 0.0
        max_new = (note["max_new"] if note is not None
                   else max(resp.output_tokens, 1))
        if m is not None:
            m.observe(
                n_prompt=resp.input_tokens, n_out=resp.output_tokens,
                max_new_tokens=max_new, reused=resp.prefix_reused,
                migrated=resp.kv_migrated > 0, occupancy=occupancy,
                measured_wh=resp.energy_wh,
                measured_prefill_wh=getattr(resp, "prefill_wh", 0.0))
        if note is None:
            return None
        self.n_reconciled += 1
        self.abs_err_wh += abs(resp.energy_wh - note["predicted_wh"])
        self.measured_wh_sum += resp.energy_wh
        self.history.append({"engine": resp.model_name,
                             "predicted_wh": note["predicted_wh"],
                             "measured_wh": resp.energy_wh})
        return note["predicted_wh"]

    # -- introspection / persistence -----------------------------------------

    @property
    def inflight_predicted(self) -> int:
        return len(self._pending)

    def mae_ratio(self) -> float:
        """Mean absolute prediction error as a fraction of metered Wh
        (the bench_energy_model acceptance metric)."""
        return self.abs_err_wh / max(self.measured_wh_sum, 1e-12)

    def mae_ratio_by_engine(self) -> Dict[str, float]:
        err: Dict[str, List[float]] = {}
        for h in self.history:
            err.setdefault(h["engine"], [0.0, 0.0])
            err[h["engine"]][0] += abs(h["measured_wh"] - h["predicted_wh"])
            err[h["engine"]][1] += h["measured_wh"]
        return {k: v[0] / max(v[1], 1e-12) for k, v in err.items()}

    def stats(self) -> dict:
        return {"n_predicted": self.n_predicted,
                "n_reconciled": self.n_reconciled,
                "inflight_predicted": self.inflight_predicted,
                "mae_ratio": self.mae_ratio(),
                "engines": {n: {"n_obs": m.n_obs,
                                "out_ratio": m.out_ratio,
                                "split_phases": m.split_phases,
                                "disaggregated": m.disaggregated}
                            for n, m in self.engines.items()}}

    def state_dict(self) -> dict:
        """Plain dict of numpy leaves — rides ``distributed.checkpoint``
        next to the router state."""
        return {"engines": {n: m.state_dict()
                            for n, m in self.engines.items()}}

    def load_state_dict(self, d: dict) -> None:
        """Learned state only: analytic knobs (cost_params, chunk, chips)
        always come from the live engines at registration, so a restored
        checkpoint can never carry stale shape constants."""
        for name, md in d.get("engines", {}).items():
            self.register_engine(name).load_state_dict(md)
