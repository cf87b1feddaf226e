"""Plain PyTorch version of the hashed-embedding featurization kernel."""
from __future__ import annotations

import torch


def hashed_embed_ref(ids: torch.Tensor, weights: torch.Tensor,
                     proj: torch.Tensor) -> torch.Tensor:
    """ids/weights: (Q, L) with id −1 = padding; proj: (H, D) → (Q, D)
    unit embeddings: normalize(log1p(scatter_add(weights by id)) @ proj).
    An id outside [0, H) matches no bucket, as in the Pallas kernel's
    one-hot (the JAX jnp oracle clips it into the last bucket instead)."""
    q = ids.shape[0]
    h = proj.shape[0]
    w = torch.where((ids >= 0) & (ids < h), weights.float(),
                    torch.zeros((), device=ids.device))
    idx = ids.long().clamp(0, h - 1)
    counts = torch.zeros((q, h), dtype=torch.float32, device=ids.device)
    counts.scatter_add_(1, idx, w)
    v = torch.log1p(counts) @ proj.float()
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(norm > 0.0, v / torch.clamp(norm, min=1e-30), v)
