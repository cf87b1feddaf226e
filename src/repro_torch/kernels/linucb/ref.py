"""Plain PyTorch version of the batched LinUCB scoring kernel (Eq. 13)."""
from __future__ import annotations

import torch


def linucb_scores_ref(a_inv: torch.Tensor, theta: torch.Tensor,
                      x: torch.Tensor, alpha: float) -> torch.Tensor:
    """a_inv: (M, d, d); theta: (M, d); x: (Q, d) → scores (Q, M):
    θ_mᵀx_q + α·sqrt(max(x_qᵀ A_m⁻¹ x_q, 0))."""
    mean = torch.einsum("md,qd->qm", theta, x)
    ax = torch.einsum("mij,qj->qmi", a_inv, x)
    var = torch.clamp(torch.einsum("qmi,qi->qm", ax, x), min=0.0)
    return mean + alpha * torch.sqrt(var)
