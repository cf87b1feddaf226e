"""Public wrapper of the top-k gating kernel: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.moe_gating import kernel
from repro_torch.kernels.moe_gating.ref import topk_gating_ref

# kernel launches since the last reset (the plain CPU path never counts)
launches = 0


def topk_gating(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits: (T, E) → (weights (T, k) fp32 softmaxed over the chosen k,
    indices (T, k) int32, descending, ties to the lowest index)."""
    global launches
    logits = logits.to(torch.float32).contiguous()
    if logits.device.type == "cpu":
        return topk_gating_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"moe_gating runs on cuda or cpu, not "
                         f"{logits.device}")
    out = kernel.topk_gating_fwd(logits, k)
    launches += 1
    return out
