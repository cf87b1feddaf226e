"""Plain PyTorch version of the decode-attention kernel: one query token
per row against a KV cache, unblocked."""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, window, cache_len
                         ) -> torch.Tensor:
    """q: (B, 1, Hq, hd); caches: (B, S, Hk, hd); ``window`` and
    ``cache_len`` scalars (ints or 0-d tensors).  Attends to positions
    [max(0, cache_len - window), cache_len).  As the kernel: q upcast to
    fp32 and scaled before the product, masked positions zeroed in p, and
    the sum of p divided out after the product with v, so a row with
    nothing visible comes out 0."""
    b, _, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    group = hq // hk
    qf = q.reshape(b, hk, group, hd).float() * hd ** -0.5
    scores = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.float())
    pos = torch.arange(s, device=q.device)
    valid = (pos < cache_len) & (pos >= cache_len - window)
    scores = torch.where(valid, scores,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * valid
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p / l, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)
