"""ctypes launcher of the RWKV6 WKV kernel (``csrc/rwkv6.cu``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def wkv_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, K) of one dtype (fp32 or bf16), logw (B, S, H, K)
    fp32, u (H, K) fp32, s0 (B, H, K, K) fp32 or None, all contiguous on
    one CUDA device → (y (B, S, H, K) in r's dtype, final state (B, H, K,
    K) fp32), launched on the current stream.  A shape the kernel does not
    take (K != 64) is refused by the C launcher and raises."""
    b, s, h, kd = r.shape
    y = torch.empty_like(r)
    s_fin = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = build.library().rwkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_fin.data_ptr(), b, s, h, kd, DTYPE_CODES[r.dtype], stream)
    build.check(err, "rwkv6")
    return y, s_fin
