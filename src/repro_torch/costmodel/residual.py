"""Recursive-least-squares residual calibrator for the energy cost model.

The analytic roofline prior (core.energy) predicts most of a query's
joules from shape alone; what it cannot know — constant per-query
overheads, occupancy interference, any drift between the modeled and the
metered ledger — is absorbed by a small linear residual fitted online
with exponentially-forgetting recursive least squares, one instance per
(engine, phase) bucket.

The feature vector leads with the analytic prediction itself and the
weight vector initializes to [1, 0, …, 0], so a cold (never-updated)
residual predicts exactly the analytic prior.  Each update is O(d²)
with d = 4 — microseconds per completion, nothing on the serving path
waits for it.
"""
from __future__ import annotations

import numpy as np

# diagonal clamp on the covariance: with forgetting < 1 and a stretch of
# poorly-exciting observations P grows without bound (covariance windup)
# and the next informative sample would swing the weights violently
_P_MAX = 1e6


class RLSResidual:
    """Exponentially-forgetting RLS over a fixed feature vector.

    predict(phi) = w·phi;  update(phi, y) performs the standard gain step

        k = P·phi / (forget + phiᵀ·P·phi)
        w += k · (y − w·phi)
        P  = (P − k·phiᵀ·P) / forget

    ``w0`` sets the cold-start prediction (the analytic-prior passthrough
    [1, 0, …, 0] here); ``p0`` the initial covariance scale (uncertainty
    of that prior).
    """

    def __init__(self, dim: int, forget: float = 0.99, p0: float = 1.0,
                 w0=None):
        if not (0.0 < forget <= 1.0):
            raise ValueError(f"forget must be in (0, 1], got {forget}")
        self.dim = int(dim)
        self.forget = float(forget)
        if w0 is None:
            self.w = np.zeros(self.dim, np.float64)
        else:
            self.w = np.asarray(w0, np.float64).copy()
            if self.w.shape != (self.dim,):
                raise ValueError(f"w0 shape {self.w.shape} != ({self.dim},)")
        self.P = np.eye(self.dim, dtype=np.float64) * float(p0)
        self.n_obs = 0

    def predict(self, phi) -> float:
        return float(np.dot(self.w, np.asarray(phi, np.float64)))

    def update(self, phi, y: float) -> float:
        """One RLS step toward target ``y``; returns the a-priori error."""
        phi = np.asarray(phi, np.float64)
        p_phi = self.P @ phi
        denom = self.forget + float(phi @ p_phi)
        k = p_phi / denom
        err = float(y) - float(self.w @ phi)
        self.w = self.w + k * err
        self.P = (self.P - np.outer(k, p_phi)) / self.forget
        # windup guard: bound the covariance so a long uninformative
        # stretch cannot make the next sample rewrite the weights
        diag = np.einsum("ii->i", self.P)
        np.clip(diag, None, _P_MAX, out=diag)
        self.n_obs += 1
        return err

    def state_dict(self) -> dict:
        return {"w": self.w.copy(), "P": self.P.copy(),
                "n_obs": self.n_obs, "forget": self.forget}

    def load_state_dict(self, d: dict) -> None:
        self.w = np.asarray(d["w"], np.float64).copy()
        self.P = np.asarray(d["P"], np.float64).copy()
        self.n_obs = int(d.get("n_obs", 0))
        self.forget = float(d.get("forget", self.forget))
