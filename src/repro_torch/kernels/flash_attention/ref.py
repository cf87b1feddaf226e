"""Plain PyTorch version of the flash-attention prefill kernel: unblocked
O(S²) attention with GQA, causal masking and a sliding window."""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hk, hd).  ``window`` counts visible
    past positions including self (window >= Sk ⇒ full attention); q and k
    positions both start at 0.  As the kernel: scores in fp32 with q scaled
    first, masked pairs zeroed in p, and the sum of p divided out after
    the product with v, so a row with nothing visible comes out 0."""
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    group = hq // hk
    qf = (q.float() * hd ** -0.5).reshape(b, sq, hk, group, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = k_pos > q_pos - window
    if causal:
        mask &= k_pos <= q_pos
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1).clamp(min=1e-30)                   # (b, hk, g, q)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / l[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)
