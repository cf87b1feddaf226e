"""ctypes launcher of the top-k gating kernel (``csrc/moe_gating.cu``)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build


def topk_gating_fwd(logits: torch.Tensor, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits fp32 (T, E), contiguous on a CUDA device → (weights fp32
    (T, k), indices int32 (T, k)), launched on the current stream.  A shape
    the kernel does not take (E > 256, k > 4 or k > E) is refused by the C
    launcher and raises."""
    t, e = logits.shape
    weights = torch.empty((t, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((t, k), dtype=torch.int32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    err = build.library().moe_gating_launch(
        logits.data_ptr(), weights.data_ptr(), idx.data_ptr(), t, e, k,
        stream)
    build.check(err, "moe_gating")
    return weights, idx
