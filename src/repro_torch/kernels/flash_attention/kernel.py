"""ctypes launchers of the flash-attention kernels
(``csrc/flash_attention.cu``): the tensor-core kernel for bf16, the scalar
one for the rest, chosen by ``route`` before the launch."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def route(dtype: torch.dtype, hd: int) -> str:
    """``"wgmma"`` (bf16 tensor cores) for bf16 with ``hd`` a multiple of 8
    up to 256, else ``"scalar"`` (fp32 FMA: fp32, where TF32 tensor cores
    would break the checks' 2e-5, and any other bf16 ``hd``)."""
    if dtype == torch.bfloat16 and hd % 8 == 0 and 0 < hd <= 256:
        return "wgmma"
    return "scalar"


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int, causal: bool) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k/v (B, Sk, Hk, hd), contiguous CUDA tensors of
    one dtype (fp32 or bf16) on one device → (B, Sq, Hq, hd) in that
    dtype, launched on the current stream by the kernel ``route`` picks.
    A shape the kernel does not take (hd > 256, Hq not a multiple of Hk;
    on the tensor-core route also data not 16-byte aligned, which TMA
    needs) is refused by the C launcher and raises."""
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.library()
    if route(q.dtype, hd) == "wgmma":
        err = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hk, hd, int(window), int(causal), stream)
    else:
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hk, hd, int(window), int(causal), DTYPE_CODES[q.dtype],
            stream)
    build.check(err, "flash_attention")
    return out
