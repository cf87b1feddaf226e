"""Public wrapper of the RWKV6 WKV scan: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  The kernel takes the scan in
chunks of 64 tokens (the chunk factorization, its products on the tensor
cores, decays as products of factors <= 1 over 8-token decay blocks), one
launch a call; any S is taken as it is, the last chunk ragged (the
Pallas wrapper picks a chunk that divides S)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rwkv6 import kernel
from repro_torch.kernels.rwkv6.ref import wkv_ref

# kernel launches since the last reset (the plain CPU path never counts)
launches = 0


def wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        logw: torch.Tensor, u: torch.Tensor,
        s0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, S, H, K) of one dtype; logw: (B, S, H, K) log decay
    (≤ 0); u: (H, K) bonus; s0: (B, H, K, K) initial state or None for
    zeros.  Returns (y (B, S, H, K) in r's dtype, final state (B, H, K, K)
    fp32).  logw, u and s0 are read in fp32, as the model gives them."""
    global launches
    b, s, h, kd = r.shape
    tensors = (r, k, v, logw, u) + (() if s0 is None else (s0,))
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"wkv inputs on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    if not (k.shape == v.shape == logw.shape == r.shape
            and u.shape == (h, kd)
            and (s0 is None or s0.shape == (b, h, kd, kd))):
        raise ValueError(f"wkv shapes: r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, s0 "
                         f"{None if s0 is None else tuple(s0.shape)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"wkv r, k, v of different dtypes: {r.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if r.device.type == "cpu":
        return wkv_ref(r, k, v, logw, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv runs on cuda or cpu, not {r.device}")
    if r.dtype not in kernel.DTYPE_CODES:
        raise ValueError(f"wkv takes float32 or bfloat16, not {r.dtype}")
    out = kernel.wkv_fwd(
        r.contiguous(), k.contiguous(), v.contiguous(),
        logw.float().contiguous(), u.float().contiguous(),
        None if s0 is None else s0.float().contiguous())
    launches += 1
    return out
