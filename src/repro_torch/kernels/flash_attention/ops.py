"""Public wrapper of the flash-attention prefill kernel: the CUDA kernel
for CUDA tensors (its tensor-core route for bf16 at hd a multiple of 8, the
scalar one otherwise: ``kernel.route``), the plain version for CPU
tensors.  The kernel masks ragged sequence lengths itself, so no block
size is picked here."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

# kernel launches since the last reset (the plain CPU path never counts),
# and of them those of the tensor-core route
launches = 0
wgmma_launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hk, hd), one dtype → (B, Sq, Hq,
    hd).  ``window`` counts visible past positions including self."""
    global launches, wgmma_launches
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention inputs on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention inputs of different dtypes: "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, window, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in kernel.DTYPE_CODES:
        raise ValueError(f"flash_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    out = kernel.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                     v.contiguous(), window, causal)
    launches += 1
    if kernel.route(q.dtype, q.shape[-1]) == "wgmma":
        wgmma_launches += 1
    return out
