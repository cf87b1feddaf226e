"""Public wrapper of the Mamba2 SSD scan: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  The kernel takes the scan in
chunks of 64 tokens (the chunk factorization, its products on the tensor
cores, decays as products of factors <= 1 over 16-token tiles), one
launch a call; any S is taken as it is, the last chunk ragged (the
Pallas wrapper picks a chunk that divides S)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.mamba2 import kernel
from repro_torch.kernels.mamba2.ref import ssd_ref

# kernel launches since the last reset (the plain CPU path never counts)
launches = 0


def ssd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        A: torch.Tensor, h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, p); dt: (b, s, h) softplus'd step sizes; B, C: (b, s,
    n) shared across heads, of x's dtype; A: (h,) negative decay rates;
    h0: (b, h, p, n) initial state or None for zeros.  Returns (y (b, s,
    h, p) in x's dtype, final state (b, h, p, n) fp32).  dt, A and h0 are
    read in fp32, as the model gives them."""
    global launches
    b, s, h, p = x.shape
    n = B.shape[-1]
    tensors = (x, dt, B, C, A) + (() if h0 is None else (h0,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"ssd inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not (dt.shape == (b, s, h) and B.shape == C.shape == (b, s, n)
            and A.shape == (h,)
            and (h0 is None or h0.shape == (b, h, p, n))):
        raise ValueError(f"ssd shapes: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, A {tuple(A.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if not (x.dtype == B.dtype == C.dtype):
        raise ValueError(f"ssd x, B, C of different dtypes: {x.dtype}, "
                         f"{B.dtype}, {C.dtype}")
    if x.device.type == "cpu":
        return ssd_ref(x, dt, B, C, A, h0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd runs on cuda or cpu, not {x.device}")
    if x.dtype not in kernel.DTYPE_CODES:
        raise ValueError(f"ssd takes float32 or bfloat16, not {x.dtype}")
    out = kernel.ssd_fwd(
        x.contiguous(), dt.float().contiguous(), B.contiguous(),
        C.contiguous(), A.float().contiguous(),
        None if h0 is None else h0.float().contiguous())
    launches += 1
    return out
