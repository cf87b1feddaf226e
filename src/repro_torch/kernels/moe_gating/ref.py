"""Plain PyTorch version of the fused top-k gating kernel."""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30      # what a chosen logit is set to, as in the Pallas kernel


def topk_gating_ref(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) → (weights (T, k) fp32, indices (T, k) int32): k
    argmax sweeps, each taking the largest remaining logit with ties to the
    lowest index (``torch.argmax`` returns the first maximum) and setting
    it to ``NEG_INF``, then a softmax over the k chosen logits."""
    x = logits.float().clone()
    gates, idxs = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=-1, keepdim=True)
        gates.append(torch.gather(x, 1, i))
        idxs.append(i)
        x.scatter_(1, i, NEG_INF)
    g = torch.cat(gates, dim=-1)
    p = torch.exp(g - g[:, :1])                  # the first is the largest
    return (p / p.sum(dim=-1, keepdim=True),
            torch.cat(idxs, dim=-1).to(torch.int32))
