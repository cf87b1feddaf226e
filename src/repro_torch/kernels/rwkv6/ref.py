"""Plain PyTorch version of the RWKV6 WKV scan: the token-by-token
recurrence, in fp32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor,
            s0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, S, H, K); u: (H, K); s0: (B, H, K, K) or None.

        y_t = r_t · (S + u ⊙ k_t ⊗ v_t);  S ← S·exp(logw_t)[:, None] + k_t ⊗ v_t

    Returns (y (B, S, H, K) in r's dtype, final S (B, H, K, K) fp32)."""
    b, s, h, kd = r.shape
    rf, kf, vf, wf = (a.float() for a in (r, k, v, logw))
    uf = u.float()
    state = (torch.zeros((b, h, kd, kd), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    ys = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               state + uf[None, :, :, None] * kv))
        state = state * torch.exp(wf[:, t])[..., None] + kv
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros_like(rf))
    return y.to(r.dtype), state
