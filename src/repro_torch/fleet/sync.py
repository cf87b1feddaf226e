"""Periodic all-reduce of router feedback sufficient statistics.

Each shard's router replica learns from the queries *it* served.  Because
every statistic LinUCB/CTS needs is an additive sum over feedback events
— ``A_m = λI + Σ x xᵀ``, ``b_m = Σ r x``, pull counts, reward sums, and
the λ-decomposed accuracy/energy sums the router keeps for
``set_lambda`` — merging replicas is *exact*: sum each replica's delta
since the last sync into a global per-base-model accumulator, then write
the global totals back.  After a sync every replica holds the posterior
a single router would have learned from the union of all feedback (up to
float addition order; tests/test_fleet.py::test_allreduce_exact_merge).

Delta bookkeeping (the classic all-reduce-with-residual pattern): for
every (shard, arm) we snapshot the prior-free stats at each sync; the
next sync contributes only ``current − snapshot``, so nothing is ever
double-counted no matter how many replicas hold the same base model.

Merging is keyed by *base* model name (``plan.base_model_name``): arms a
survivor adopts during fail-over (``m@shard1``) pool their feedback into
base ``m``'s global stats, but the write-back only overwrites the
original (un-suffixed) arms — adopted arms keep their own posterior so
their scores don't tie bit-for-bit with the original replica's arm
(argmax would then starve one of the two engines).

K-means centroids are deliberately *not* merged: the assignment step
makes them order-dependent (non-additive), so each replica keeps its own
clustering; the bandit all-reduce is what makes decisions converge.

Not synced across shards: ε/t/PRNG key (per-replica exploration state)
and λ, which the controller keeps fleet-uniform via ``set_lambda``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np

from repro_torch.core.router import GreenServRouter
from repro_torch.fleet.plan import base_model_name

# additive, prior-free per-arm statistics carried through the all-reduce:
# xxt = A − λI, plus the router's λ-decomposed reward splits
VECTOR_STATS = ("b", "b_acc", "b_cost")
SCALAR_STATS = ("counts", "reward_sum", "acc_sum", "cost_sum")
MATRIX_STATS = ("xxt",)
ALL_STATS = MATRIX_STATS + VECTOR_STATS + SCALAR_STATS

_SNAP_SEP = "|"


class FeedbackAllReduce:
    """Exact periodic merge of per-shard bandit sufficient statistics."""

    def __init__(self, lambda_reg: float, context_dim: int):
        self.lambda_reg = float(lambda_reg)
        self.dim = int(context_dim)
        # base model name -> stats accumulated over every shard's deltas
        self._global: Dict[str, Dict[str, np.ndarray]] = {}
        # "shard|member" -> stats at the last sync (delta baseline)
        self._snap: Dict[str, Dict[str, np.ndarray]] = {}
        self.syncs = 0

    # -- stats algebra -------------------------------------------------
    def _zeros(self) -> Dict[str, np.ndarray]:
        d = self.dim
        out = {"xxt": np.zeros((d, d), np.float64)}
        for k in VECTOR_STATS:
            out[k] = np.zeros(d, np.float64)
        for k in SCALAR_STATS:
            out[k] = np.zeros((), np.float64)
        return out

    @staticmethod
    def _copy(stats: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {k: np.array(v, np.float64) for k, v in stats.items()}

    @staticmethod
    def _add_delta(acc: Dict[str, np.ndarray],
                   new: Mapping[str, np.ndarray],
                   old: Mapping[str, np.ndarray]) -> None:
        for k in ALL_STATS:
            acc[k] = acc[k] + (new[k] - old[k])

    # -- per-router extraction / write-back ----------------------------
    def _extract(self, router: GreenServRouter):
        """(bandit state dict, per-arm prior-free stats) — one d2h sync
        (``policy.state_dict`` hands back numpy)."""
        sd = router.policy.state_dict()
        eye = self.lambda_reg * np.eye(self.dim, dtype=np.float64)
        arms = []
        for i, _ in enumerate(router.pool.names):
            arms.append({
                "xxt": np.asarray(sd["A"][i], np.float64) - eye,
                "b": np.asarray(sd["b"][i], np.float64),
                "b_acc": np.array(router._b_acc[i], np.float64),
                "b_cost": np.array(router._b_cost[i], np.float64),
                "counts": np.float64(sd["counts"][i]),
                "reward_sum": np.float64(sd["reward_sum"][i]),
                "acc_sum": np.float64(router._acc_sum[i]),
                "cost_sum": np.float64(router._cost_sum[i]),
            })
        return sd, arms

    def sync(self, routers: Mapping[str, GreenServRouter]) -> dict:
        """All-reduce: fold every replica's delta into the global stats,
        then write global totals back into each replica's original arms.
        Returns a small report for telemetry/benchmarks."""
        extracts = {s: self._extract(r) for s, r in routers.items()}
        # reduce: deltas since last sync, summed per base model
        for shard, (_, arms) in extracts.items():
            names = routers[shard].pool.names
            for i, member in enumerate(names):
                base = base_model_name(member)
                snap = self._snap.get(shard + _SNAP_SEP + member)
                old = snap if snap is not None else self._zeros()
                g = self._global.setdefault(base, self._zeros())
                self._add_delta(g, arms[i], old)
        # broadcast: rebuild each original arm from the global totals,
        # rounded into the bandit state's own dtype (float32) by the
        # assignments below
        arms_updated = 0
        eye = self.lambda_reg * np.eye(self.dim, dtype=np.float64)
        for shard, router in routers.items():
            sd, arms = extracts[shard]
            new = {k: np.array(sd[k]) for k in
                   ("A", "A_inv", "b", "theta", "counts", "reward_sum")}
            for i, member in enumerate(router.pool.names):
                base = base_model_name(member)
                g = self._global[base]
                if member == base:
                    a_full = eye + g["xxt"]
                    a_inv = np.linalg.inv(a_full)
                    new["A"][i] = a_full
                    new["A_inv"][i] = a_inv
                    new["b"][i] = g["b"]
                    new["theta"][i] = a_inv @ g["b"]
                    new["counts"][i] = g["counts"]
                    new["reward_sum"][i] = g["reward_sum"]
                    router._b_acc[i] = g["b_acc"]
                    router._b_cost[i] = g["b_cost"]
                    router._acc_sum[i] = g["acc_sum"]
                    router._cost_sum[i] = g["cost_sum"]
                    self._snap[shard + _SNAP_SEP + member] = self._copy(g)
                    arms_updated += 1
                else:
                    # adopted arm: contributes deltas, keeps its own
                    # posterior (see module docstring)
                    self._snap[shard + _SNAP_SEP + member] = \
                        self._copy(arms[i])
            sd.update(new)
            router.policy.load_state_dict(sd)
        self.syncs += 1
        return {"syncs": self.syncs, "bases": len(self._global),
                "arms_updated": arms_updated}

    # -- checkpointing --------------------------------------------------
    def state_dict(self) -> dict:
        return {"global": {b: self._copy(s)
                           for b, s in sorted(self._global.items())},
                "snap": {k: self._copy(s)
                         for k, s in sorted(self._snap.items())},
                "syncs": np.int64(self.syncs)}

    def load_state_dict(self, d: Mapping) -> None:
        self._global = {b: self._copy(s) for b, s in d["global"].items()}
        self._snap = {k: self._copy(s) for k, s in d["snap"].items()}
        self.syncs = int(d["syncs"])
