"""Contextual multi-armed bandits (paper §4.3) over tensors.

The paper's three policies:

  * LinUCB (primary, Eq. 13)        — linear reward model + UCB exploration
  * Contextual Thompson sampling    — Bayesian linear posterior sampling
  * ε-greedy (contextual & plain)   — decayed random exploration

All state lives in one ``BanditState`` with *static* arm capacity
(``max_arms``) and an ``active`` mask, so models added at runtime never
change a tensor's shape (paper §6.3.4: zero-calibration addition).

Two solve modes:

  * ``sherman_morrison`` (default): A_m⁻¹ is maintained directly by the
    rank-1 Sherman–Morrison identity — O(d²) per update and O(|M|·d²)
    per decision, mathematically identical to inverting A_m.  LinUCB
    scores through the ``kernels/linucb`` kernel over the maintained
    inverses.
  * ``cholesky`` (paper-faithful, App. B): A_m is factored per decision
    and θ̂_m and A_m⁻¹x are solved from the factor — O(|M|·d³), kept for
    the §Perf comparison.  It runs in plain PyTorch on the state's
    device, as the JAX package runs it in plain jnp.

The updates write the state tensors in place (the JAX package replaces
its arrays and donates the old buffers; here the one copy on the device
is simply overwritten).

The stochastic policies draw from the policy's key through
``core/prng.py``, the JAX package's Threefry stream on the host, so
their draws are the JAX package's, draw for draw: ε-greedy's uniform
and choice, and CTS's ``normal(k_sel, (M, d))``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.residency import TransferLedger
from repro_torch.core.types import RouterConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.linucb import linucb_scores as linucb_scores_kernel

NEG_INF = -1e30
ALGORITHMS = ("linucb", "cts", "eps_greedy", "eps_greedy_ctx")
SOLVE_MODES = ("sherman_morrison", "cholesky")


def check_supported(config: RouterConfig) -> None:
    """Raise ValueError for an algorithm or solve mode no package knows."""
    if config.algorithm not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {config.algorithm!r}")
    if config.solve_mode not in SOLVE_MODES:
        raise ValueError(f"unknown solve_mode {config.solve_mode!r}")


class BanditState(NamedTuple):
    """Per-arm sufficient statistics. Shapes: M=max_arms, d=context dim.
    ``key`` is the policy's random-stream key as a (2,) uint32 numpy array
    on the host, a raw ``jax.random.PRNGKey``'s layout: a JAX state's key
    loads as it is and continues the same stream (``core/prng.py``)."""

    A: torch.Tensor           # (M, d, d) ridge design matrices A_m = λI + Σ x xᵀ
    A_inv: torch.Tensor       # (M, d, d) maintained inverses (Sherman–Morrison)
    b: torch.Tensor           # (M, d)    reward-weighted contexts Σ r x
    theta: torch.Tensor       # (M, d)    cached θ̂_m = A_m⁻¹ b_m
    reward_sum: torch.Tensor  # (M,)      Σ r      (non-contextual ε-greedy)
    counts: torch.Tensor      # (M,)      pull counts
    active: torch.Tensor      # (M,) bool — is this slot a live model?
    eps: torch.Tensor         # ()        current ε (decayed)
    t: torch.Tensor           # ()        global step
    key: np.ndarray           # (2,) uint32, host


def init_state(config: RouterConfig, n_arms: int,
               device=None) -> BanditState:
    """A fresh state for ``n_arms`` live arms on ``device`` (None: the
    card, see ``resolve_device``)."""
    device = resolve_device(device)
    m, d = config.max_arms, config.context_dim
    if n_arms > m:
        raise ValueError(f"n_arms={n_arms} exceeds max_arms={m}")
    lam = config.lambda_reg
    f32 = dict(dtype=torch.float32, device=device)
    eye = torch.eye(d, **f32)
    return BanditState(
        A=(eye[None] * lam).repeat(m, 1, 1),
        A_inv=(eye[None] / lam).repeat(m, 1, 1),
        b=torch.zeros((m, d), **f32),
        theta=torch.zeros((m, d), **f32),
        reward_sum=torch.zeros((m,), **f32),
        counts=torch.zeros((m,), **f32),
        active=torch.arange(m, device=device) < n_arms,
        eps=torch.tensor(config.epsilon0, **f32),
        t=torch.tensor(0, dtype=torch.int32, device=device),
        key=np.array([0, config.seed], dtype=np.uint32),
    )


def add_arm(state: BanditState, config: RouterConfig) -> Tuple[BanditState, int]:
    """Activate the next free slot with a fresh ridge prior (online
    addition), in place."""
    idx = int(state.active.sum())
    if idx >= config.max_arms:
        raise ValueError("bandit at capacity; raise RouterConfig.max_arms")
    d = config.context_dim
    eye = torch.eye(d, dtype=torch.float32, device=state.A.device)
    state.A[idx] = eye * config.lambda_reg
    state.A_inv[idx] = eye / config.lambda_reg
    state.b[idx] = 0.0
    state.theta[idx] = 0.0
    state.reward_sum[idx] = 0.0
    state.counts[idx] = 0.0
    state.active[idx] = True
    return state, idx


def linucb_scores_batch(state: BanditState, X: torch.Tensor,
                        alpha: float) -> torch.Tensor:
    """Eq. 13 over a query batch: (Q, d) contexts → (Q, M) UCB scores, by
    the LinUCB kernel over the maintained Sherman–Morrison inverses."""
    return linucb_scores_kernel(state.A_inv, state.theta, X, alpha)


def linucb_scores_cholesky(state: BanditState, X: torch.Tensor,
                           alpha: float) -> torch.Tensor:
    """Eq. 13 by the paper-faithful solve (App. B), (Q, d) → (Q, M):
    factor A_m = L Lᵀ, θ̂_m = A_m⁻¹ b_m and A_m⁻¹x by two triangular
    solves each, θ̂_mᵀx + α·sqrt(max(xᵀA_m⁻¹x, 0)).  Selection changes no
    statistic, so one factor serves every row of a batch; each row's
    scores are those of its own sequential decision."""
    chol = torch.linalg.cholesky(state.A)                        # (M, d, d)
    theta = torch.cholesky_solve(state.b[:, :, None], chol)[:, :, 0]
    rhs = X.T[None].expand(chol.shape[0], -1, -1)                # (M, d, Q)
    ainv_x = torch.cholesky_solve(rhs, chol)                     # (M, d, Q)
    mean = X @ theta.T                                           # (Q, M)
    var = torch.clamp(torch.einsum("mdq,qd->qm", ainv_x, X), min=0.0)
    return mean + alpha * torch.sqrt(var)


def thompson_scores(state: BanditState, X: torch.Tensor, z: torch.Tensor,
                    sigma: float) -> torch.Tensor:
    """Contextual Thompson sampling (Agrawal & Goyal 2013), (Q, d) → (Q, M):
    each row draws θ̃_m = θ̂_m + σ·chol(A_m⁻¹ + 1e-8 I) z_m from its own
    standard normals ``z`` (Q, M, d) and scores θ̃_mᵀx.  The factor maps
    N(0, I) to N(0, A_m⁻¹); it is taken once for the batch (selection
    changes no statistic)."""
    d = state.theta.shape[1]
    eye = torch.eye(d, dtype=state.A_inv.dtype, device=state.A_inv.device)
    chol = torch.linalg.cholesky(state.A_inv + 1e-8 * eye[None])  # (M, d, d)
    theta_s = state.theta[None] + sigma * torch.einsum("mij,qmj->qmi",
                                                       chol, z)
    return torch.einsum("qmi,qi->qm", theta_s, X)


def greedy_scores(state: BanditState, X: torch.Tensor,
                  contextual: bool) -> torch.Tensor:
    """ε-greedy's exploitation scores, (Q, d) contexts → (Q, M): θ̂_m·x
    (contextual), or each arm's mean reward Σr / max(pulls, 1)."""
    if contextual:
        return X @ state.theta.T
    mean = state.reward_sum / torch.clamp(state.counts, min=1.0)
    return mean[None, :].expand(X.shape[0], -1)


def _dot_chain(acc: torch.Tensor, a: torch.Tensor, v,
               host_v: np.ndarray = None) -> torch.Tensor:
    """``acc`` += Σ_j a[..., j]·v[j], in place, as XLA's CPU backend sums a
    float32 product of length 12: one fused multiply-add per j, in order.
    Each step runs in float64 (the product of two float32s is exact
    there) and rounds once into the float32 ``acc``; ``a`` and ``v`` are
    float64.  Where ``v`` is known on the host (``host_v``), its zero
    terms, which leave the sum as it is, are skipped."""
    for j in range(a.shape[-1]):
        if host_v is None:
            acc.addcmul_(a[..., j], v[j])
        elif host_v[j] != 0.0:
            acc.add_(a[..., j], alpha=float(host_v[j]))
    return acc


def sherman_morrison_update(state: BanditState, arm: int, x: np.ndarray,
                            r: np.float32, config: RouterConfig) -> None:
    """LinUCB posterior update (paper §4.3), in place:
        A_m ← A_m + x xᵀ ;  b_m ← b_m + r x ;  θ̂_m = A_m⁻¹ b_m
    with A⁻¹ maintained by Sherman–Morrison:
        A⁻¹ ← A⁻¹ − (A⁻¹ x)(A⁻¹ x)ᵀ / (1 + xᵀ A⁻¹ x)

    In the JAX package's float32 arithmetic on its CPU backend: the
    products and sums fuse into multiply-adds (A + x xᵀ and b + r x
    elementwise, each matrix-vector product a chain of them over j in
    order, the 1 of the denominator its chain's first term), and
    (A⁻¹x)(A⁻¹x)ᵀ / denom rounds the product, then the quotient.  Any
    other summation order rounds θ̂ and A⁻¹ an ulp or two apart, enough
    to flip a near tie between arms (``PERF.md`` §6).  A fused
    multiply-add is a float64 multiply-add rounded to float32: the same
    number unless the float64 sum is inexact and lands on a float32
    rounding midpoint, about one step in 2^29.  ``x`` and ``r`` are on
    the host; the state on any device."""
    dev = state.A.device
    x64 = torch.from_numpy(x).to(dev).double()
    ainv = state.A_inv[arm]
    ainv_x = _dot_chain(torch.zeros_like(state.b[arm]), ainv.double(), x64,
                        x)
    denom = _dot_chain(torch.ones((), device=dev), ainv_x.double(), x64, x)
    ainv_new = ainv - torch.outer(ainv_x, ainv_x) / denom
    state.A[arm].addcmul_(x64[:, None], x64[None, :])
    state.A_inv[arm] = ainv_new
    b_m = state.b[arm].add_(x64, alpha=float(r))
    state.theta[arm] = 0.0
    _dot_chain(state.theta[arm], ainv_new.double(), b_m.double())
    state.reward_sum[arm] += r
    state.counts[arm] += 1.0
    state.eps.copy_(torch.clamp(state.eps * config.epsilon_decay,
                                min=config.epsilon_min))
    state.t.add_(1)


class BanditPolicy:
    """Thin stateful wrapper holding a BanditState on ``device`` (None: the
    card, see ``resolve_device``)."""

    def __init__(self, config: RouterConfig, n_arms: int, device=None):
        check_supported(config)
        self.config = config
        self.device = resolve_device(device)
        self.state = init_state(config, n_arms, self.device)
        # residency audit: BanditState lives on the device; the ledger
        # counts the deliberate host syncs (state_dict / load /
        # rescalarize) so tests can assert routing itself moves no state
        self.transfers = TransferLedger()

    @property
    def n_arms(self) -> int:
        return int(self.state.active.sum())

    def select_batch(self, X: np.ndarray,
                     feasible: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized arm selection: X (Q, d), feasible (Q, n) bool →
        (arms (Q,), masked scores (Q, max_arms)).

        LinUCB with maintained inverses is deterministic, so the whole
        batch is scored by one kernel call and an argmax per row (ties to
        the lowest index) — arm choices are identical to Q sequential
        selections on the same state.  The other policies (CTS, ε-greedy)
        and the Cholesky mode keep sequential per-query semantics
        (``_select_sequential``)."""
        check_supported(self.config)
        X = np.asarray(X, dtype=np.float32)
        feas = np.asarray(feasible, dtype=bool)
        q, m = X.shape[0], self.config.max_arms
        if q == 0:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros((0, m), dtype=np.float32))
        if feas.shape[1] < m:
            feas = np.pad(feas, ((0, 0), (0, m - feas.shape[1])))
        x_dev = torch.from_numpy(X).to(self.device)
        if (self.config.algorithm != "linucb"
                or self.config.solve_mode != "sherman_morrison"):
            return self._select_sequential(x_dev, feas)
        scores = linucb_scores_batch(self.state, x_dev,
                                     self.config.alpha_ucb)
        mask = self.state.active.cpu().numpy()[None, :] & feas
        masked = np.where(mask, scores.cpu().numpy(), NEG_INF)
        arms = np.argmax(masked, axis=1)
        self.advance_key()
        return arms.astype(np.int64), masked.astype(np.float32)

    def _select_sequential(self, x_dev: torch.Tensor, feas: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """A batch, row by row as the JAX package's scan
        (``make_select_batch_scan_fn``): each row splits the key into
        (key, k_sel, k_eps), so Q rows leave the key where Q sequential
        selections would, whatever the policy.

          * LinUCB (Cholesky mode): the paper-faithful scores, argmax;
          * CTS: standard normals ``normal(k_sel, (M, d))``, the sampled
            posterior's scores, argmax;
          * ε-greedy: a uniform feasible arm from k_sel, taken when a
            uniform draw from k_eps falls below ε; otherwise the greedy
            arm.

        Argmaxes tie to the lowest index.  Selection changes no
        statistic, so the factors, ε and the deterministic scores are the
        same for every row, and the rows' draws are made in one host call
        after their keys.  The scores are computed on the router's
        device, where the state lives; per batch the (Q, M) scores, the
        (M,) active mask and ε cross to the host, as the LinUCB path
        reads its scores and mask; CTS's draws go up as one (Q, M, d)
        tensor.  Only the host key changes."""
        st, cfg = self.state, self.config
        q = x_dev.shape[0]
        key = st.key
        k_sel = np.empty((q, 2), np.uint32)
        k_eps = np.empty((q, 2), np.uint32)
        for i in range(q):
            key, k_sel[i], k_eps[i] = prng.split(key, 3)
        if cfg.algorithm == "cts":
            z = prng.normal(k_sel, tuple(st.theta.shape))      # (Q, M, d)
            scores = thompson_scores(st, x_dev,
                                     torch.from_numpy(z).to(self.device),
                                     cfg.cts_sigma)
        elif cfg.algorithm == "linucb":
            scores = linucb_scores_cholesky(st, x_dev, cfg.alpha_ucb)
        else:
            scores = greedy_scores(st, x_dev,
                                   cfg.algorithm == "eps_greedy_ctx")
        mask = st.active.cpu().numpy()[None, :] & feas
        masked = np.where(mask, scores.cpu().numpy(),
                          NEG_INF).astype(np.float32)
        arms = np.argmax(masked, axis=1).astype(np.int64)
        if cfg.algorithm in ("eps_greedy", "eps_greedy_ctx"):
            eps = np.float32(st.eps.cpu().numpy())
            m = masked.shape[1]
            for i, row_mask in enumerate(mask):
                if prng.uniform(k_eps[i]) < eps:
                    probs = (row_mask.astype(np.float32)
                             / np.float32(max(int(row_mask.sum()), 1)))
                    arms[i] = prng.choice(k_sel[i], m, probs)
        self.state = st._replace(key=key)
        return arms, masked

    def advance_key(self) -> None:
        """Advance the key as the JAX package's batched LinUCB selection
        does, to the first key of ``split(key, 2)``, so a batch is not a
        state no-op.  Shared by the host ``select_batch`` path and the
        router's fused device pipeline, so both leave the bandit state
        identically (LinUCB never draws from the key)."""
        self.state = self.state._replace(key=prng.split(self.state.key, 2)[0])

    def update(self, arm: int, x: np.ndarray, reward: float) -> None:
        sherman_morrison_update(self.state, int(arm),
                                np.asarray(x, np.float32).copy(),
                                np.float32(reward), self.config)

    def add_arm(self) -> int:
        self.state, idx = add_arm(self.state, self.config)
        return idx

    def rescalarize(self, b: np.ndarray, reward_sum: np.ndarray) -> None:
        """Swap in reward statistics recomputed under a new scalarization.

        A_m and A_m⁻¹ depend only on the observed contexts, never on the
        rewards, so a λ change (``GreenServRouter.set_lambda``) can rebuild
        b_m = Σ r(λ')·x exactly from decomposed accuracy/energy sums and
        refresh θ̂ = A⁻¹ b in one shot.
        """
        b = np.asarray(b, dtype=np.float32)
        a_inv = self.state.A_inv.cpu().numpy()
        self.transfers.count_d2h()
        theta = np.einsum("mij,mj->mi", a_inv, b)
        self.state = self.state._replace(
            b=torch.from_numpy(b).to(self.device),
            theta=torch.from_numpy(theta.astype(np.float32)).to(self.device),
            reward_sum=torch.from_numpy(
                np.asarray(reward_sum, np.float32)).to(self.device))
        self.transfers.count_h2d()

    def state_dict(self) -> dict:
        self.transfers.count_d2h()
        return {k: (np.asarray(v).copy() if isinstance(v, np.ndarray)
                    else v.cpu().numpy())
                for k, v in self.state._asdict().items()}

    def load_state_dict(self, d: dict) -> None:
        """Load a state dict — this package's or the JAX package's (its
        raw PRNG key loads as the (2,) uint32 key and continues the same
        stream)."""
        self.transfers.count_h2d()
        fields = {}
        for k in BanditState._fields:
            v = np.asarray(d[k])
            if k == "key":
                fields[k] = v.astype(np.uint32).copy()
            else:
                fields[k] = torch.from_numpy(v.copy()).to(self.device)
        self.state = BanditState(**fields)
