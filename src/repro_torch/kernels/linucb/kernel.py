"""ctypes launcher of the LinUCB scoring kernel (``csrc/linucb.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def linucb_scores_fwd(a_inv: torch.Tensor, theta: torch.Tensor,
                      x: torch.Tensor, alpha: float) -> torch.Tensor:
    """a_inv fp32 (M, d, d), theta fp32 (M, d), x fp32 (Q, d), contiguous
    CUDA tensors on one device → fp32 (Q, M), launched on the current
    stream.  A shape the kernel does not take (d > 150, M > 65535) is
    refused by the C launcher and raises."""
    m, d, _ = a_inv.shape
    q = x.shape[0]
    out = torch.empty((q, m), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().linucb_launch(
        a_inv.data_ptr(), theta.data_ptr(), x.data_ptr(), out.data_ptr(),
        q, m, d, float(alpha), stream)
    build.check(err, "linucb")
    return out
