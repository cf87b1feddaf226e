"""Plain PyTorch version of the Mamba2 SSD scan: the token-by-token
recurrence, in fp32."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, A: torch.Tensor,
            h0: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h); B, C: (b, s, n); A: (h,) negative;
    h0: (b, h, p, n) or None.

        h ← h·exp(dt_t·A) + dt_t·x_t ⊗ B_t ;  y_t = C_t · h

    Returns (y (b, s, h, p) in x's dtype, final h (b, h, p, n) fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    xf, dtf, Bf, Cf, Af = (a.float() for a in (x, dt, B, C, A))
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None])[:, :, None, None]
        upd = torch.einsum("bhp,bn->bhpn", xf[:, t] * dtf[:, t, :, None],
                           Bf[:, t])
        state = state * decay + upd
        ys.append(torch.einsum("bn,bhpn->bhp", Cf[:, t], state))
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(xf)
    return y.to(x.dtype), state
