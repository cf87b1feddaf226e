"""ctypes launcher of the Mamba2 SSD kernel (``csrc/mamba2.cu``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p), B and C (b, s, n) of one dtype (fp32 or bf16), dt
    (b, s, h) fp32, A (h,) fp32, h0 (b, h, p, n) fp32 or None, all
    contiguous on one CUDA device → (y (b, s, h, p) in x's dtype, final
    state (b, h, p, n) fp32), launched on the current stream.  A shape the
    kernel does not take (p != 64, n not one of 16, 32, 64, 128) is
    refused by the C launcher and raises."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().mamba2_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_fin.data_ptr(), b, s, h, p, n, DTYPE_CODES[x.dtype], stream)
    build.check(err, "mamba2")
    return y, h_fin
