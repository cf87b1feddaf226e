"""ctypes launcher of the flash-attention kernel
(``csrc/flash_attention.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int, causal: bool) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k/v (B, Sk, Hk, hd), contiguous CUDA tensors of
    one dtype (fp32 or bf16) on one device → (B, Sq, Hq, hd) in that
    dtype, launched on the current stream.  A shape the kernel does not
    take (hd > 256, Hq not a multiple of Hk) is refused by the C launcher
    and raises."""
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk,
        hq, hk, hd, int(window), int(causal), DTYPE_CODES[q.dtype], stream)
    build.check(err, "flash_attention")
    return out
