"""Public wrapper of the LinUCB scoring kernel: the JAX package's padding
(Q to a power of two), then the CUDA kernel for CUDA tensors or the plain
version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.featurize.ops import pad_pow2
from repro_torch.kernels.linucb import kernel
from repro_torch.kernels.linucb.ref import linucb_scores_ref

# kernel launches since the last reset (the plain CPU path never counts)
launches = 0


def linucb_scores(a_inv: torch.Tensor, theta: torch.Tensor, x: torch.Tensor,
                  alpha: float) -> torch.Tensor:
    """a_inv: (M, d, d); theta: (M, d); x: (d,) or (Q, d) → (M,) or (Q, M),
    on the inputs' device."""
    global launches
    if not (a_inv.device == theta.device == x.device):
        raise ValueError(f"linucb inputs on different devices: "
                         f"{a_inv.device}, {theta.device}, {x.device}")
    single = x.dim() == 1
    xq = (x[None] if single else x).to(torch.float32)
    q = xq.shape[0]
    q_pad = pad_pow2(q)
    if q_pad != q:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, q_pad - q))
    a_inv = a_inv.to(torch.float32).contiguous()
    theta = theta.to(torch.float32).contiguous()
    if xq.device.type == "cpu":
        out = linucb_scores_ref(a_inv, theta, xq, alpha)
    elif xq.device.type == "cuda":
        out = kernel.linucb_scores_fwd(a_inv, theta, xq.contiguous(), alpha)
        launches += 1
    else:
        raise ValueError(f"linucb runs on cuda or cpu, not {xq.device}")
    out = out[:q]
    return out[0] if single else out
