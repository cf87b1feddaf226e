"""Contextual multi-armed bandit (paper §4.3): LinUCB over tensors.

All state lives in one ``BanditState`` with *static* arm capacity
(``max_arms``) and an ``active`` mask, so models added at runtime never
change a tensor's shape (paper §6.3.4: zero-calibration addition).

A_m⁻¹ is maintained directly by the rank-1 Sherman–Morrison identity —
O(d²) per update and O(|M|·d²) per decision, mathematically identical to
inverting A_m.  Scoring runs the ``kernels/linucb`` kernel over the
maintained inverses.  The updates write the state tensors in place (the
JAX package replaces its arrays and donates the old buffers; here the one
copy on the device is simply overwritten).

Contextual Thompson sampling, ε-greedy and the paper-faithful Cholesky
solve mode are not in this slice: selecting them raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.residency import TransferLedger
from repro_torch.core.types import RouterConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.linucb import linucb_scores as linucb_scores_kernel

NEG_INF = -1e30


def check_supported(config: RouterConfig) -> None:
    """Raise for the policies this slice does not port yet."""
    if config.algorithm != "linucb" or config.solve_mode != "sherman_morrison":
        raise NotImplementedError(
            f"algorithm={config.algorithm!r} solve_mode={config.solve_mode!r}"
            f": CTS, ε-greedy and the Cholesky solve mode wait for the "
            f"port's stochastic-policies slice; this slice serves LinUCB "
            f"with Sherman–Morrison inverses")


class BanditState(NamedTuple):
    """Per-arm sufficient statistics. Shapes: M=max_arms, d=context dim.
    ``key`` is the policy's random-stream key as a (2,) uint32 numpy array:
    LinUCB never draws from it, so it is carried opaquely (a JAX key loads
    as it is) and only advanced per batch."""

    A: torch.Tensor           # (M, d, d) ridge design matrices A_m = λI + Σ x xᵀ
    A_inv: torch.Tensor       # (M, d, d) maintained inverses (Sherman–Morrison)
    b: torch.Tensor           # (M, d)    reward-weighted contexts Σ r x
    theta: torch.Tensor       # (M, d)    cached θ̂_m = A_m⁻¹ b_m
    reward_sum: torch.Tensor  # (M,)      Σ r
    counts: torch.Tensor      # (M,)      pull counts
    active: torch.Tensor      # (M,) bool — is this slot a live model?
    eps: torch.Tensor         # ()        current ε (decayed)
    t: torch.Tensor           # ()        global step
    key: np.ndarray           # (2,) uint32, opaque


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


def sherman_morrison_update(state: BanditState, arm: int, x: torch.Tensor,
                            r: torch.Tensor, config: RouterConfig) -> None:
    """LinUCB posterior update (paper §4.3), in place:
        A_m ← A_m + x xᵀ ;  b_m ← b_m + r x ;  θ̂_m = A_m⁻¹ b_m
    with A⁻¹ maintained by Sherman–Morrison:
        A⁻¹ ← A⁻¹ − (A⁻¹ x)(A⁻¹ x)ᵀ / (1 + xᵀ A⁻¹ x)
    """
    ainv = state.A_inv[arm]
    ainv_x = ainv @ x
    denom = 1.0 + x @ ainv_x
    ainv_new = ainv - torch.outer(ainv_x, ainv_x) / denom
    b_m = state.b[arm] + r * x
    state.A[arm] += torch.outer(x, x)
    state.A_inv[arm] = ainv_new
    state.b[arm] = b_m
    state.theta[arm] = ainv_new @ b_m
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
        selections on the same state."""
        check_supported(self.config)
        X = np.asarray(X, dtype=np.float32)
        feas = np.asarray(feasible, dtype=bool)
        q, m = X.shape[0], self.config.max_arms
        if q == 0:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros((0, m), dtype=np.float32))
        if feas.shape[1] < m:
            feas = np.pad(feas, ((0, 0), (0, m - feas.shape[1])))
        scores = linucb_scores_batch(
            self.state, torch.from_numpy(X).to(self.device),
            self.config.alpha_ucb)
        mask = self.state.active.cpu().numpy()[None, :] & feas
        masked = np.where(mask, scores.cpu().numpy(), NEG_INF)
        arms = np.argmax(masked, axis=1)
        self.advance_key()
        return arms.astype(np.int64), masked.astype(np.float32)

    def advance_key(self) -> None:
        """Advance the opaque random-stream key so a batched selection is
        not a state no-op.  Shared by the host ``select_batch`` path and
        the router's fused device pipeline so both leave the bandit state
        identically (LinUCB never draws from the key; its values are not
        the JAX package's threefry stream)."""
        nxt = np.random.default_rng(self.state.key.astype(np.uint64)).integers(
            0, 2 ** 32, size=2, dtype=np.uint64).astype(np.uint32)
        self.state = self.state._replace(key=nxt)

    def update(self, arm: int, x: np.ndarray, reward: float) -> None:
        sherman_morrison_update(
            self.state, int(arm),
            torch.as_tensor(np.asarray(x, np.float32), device=self.device),
            torch.tensor(reward, dtype=torch.float32, device=self.device),
            self.config)

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
        PRNG key is kept as an opaque uint32 array)."""
        self.transfers.count_h2d()
        fields = {}
        for k in BanditState._fields:
            v = np.asarray(d[k])
            if k == "key":
                fields[k] = v.astype(np.uint32).copy()
            else:
                fields[k] = torch.from_numpy(v.copy()).to(self.device)
        self.state = BanditState(**fields)
