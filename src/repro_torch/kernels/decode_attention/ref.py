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


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, window, cache_len,
                               lay) -> torch.Tensor:
    """The kernel's arithmetic in the kernel's order of work: per (row, kv
    head) segment, one (acc, m, l) partial per split of the visible range
    as ``lay`` (a ``kernel.Layout``) cuts it (an empty split: m = NEG_INF,
    l = 0, acc = 0), then the log-sum-exp merge of the partials in split
    order that the segment's last block performs: out = sum_i acc_i
    e^(m_i - m) / max(sum_i l_i e^(m_i - m), 1e-30), m the largest m_i."""
    b, _, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    group = hq // hk
    cache_len, window = int(cache_len), int(window)
    lo, hi = max(cache_len - window, 0), min(cache_len, s)
    qf = q.reshape(b * hk, group, hd).float() * hd ** -0.5
    kf, vf = (c.float().permute(0, 2, 1, 3).reshape(b * hk, s, hd)
              for c in (k_cache, v_cache))
    out = torch.empty(b * hk, group, hd)
    for seg in range(b * hk):
        accs, ms, ls = [], [], []
        for a, e in lay.splits(lo, hi):
            if e > a:
                sc = qf[seg] @ kf[seg, a:e].T                  # (group, n)
                m = sc.amax(dim=-1)
                p = torch.exp(sc - m[:, None])
                accs.append(p @ vf[seg, a:e])
                ms.append(m)
                ls.append(p.sum(dim=-1))
            else:
                accs.append(torch.zeros(group, hd))
                ms.append(torch.full((group,), NEG_INF))
                ls.append(torch.zeros(group))
        m_all = torch.stack(ms)                              # (splits, group)
        w = torch.exp(m_all - m_all.amax(dim=0))
        acc = (torch.stack(accs) * w[..., None]).sum(dim=0)
        l = (torch.stack(ls) * w).sum(dim=0).clamp(min=1e-30)
        out[seg] = acc / l[:, None]
    return out.reshape(b, 1, hq, hd).to(q.dtype)
