"""Public wrapper of the decode-attention kernel: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.  ``cache_len`` and ``window``
stay on the device — the kernel reads them through a pointer, as the
Pallas kernel reads them from SMEM — so no launch waits on the host."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

# kernel launches since the last reset (the plain CPU path never counts)
launches = 0


def _device_scalar(x, device: torch.device) -> torch.Tensor:
    """``x`` as a 0-d int32 tensor on ``device``.  A Python int is filled
    in on the device (``torch.tensor(x, device=...)`` would copy it from
    the host and wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, window, cache_len
                     ) -> torch.Tensor:
    """Drop-in for ``attention.decode_attend`` with a scalar length: q
    (B, 1, Hq, hd); caches (B, S, Hk, hd), one dtype; ``window`` and
    ``cache_len`` ints or 0-d int tensors.  Positions [cache_len - window,
    cache_len) are visible; a row with none comes out 0."""
    global launches
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError(f"decode_attention inputs on different devices: "
                         f"{q.device}, {k_cache.device}, {v_cache.device}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError(f"decode_attention inputs of different dtypes: "
                         f"{q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention takes one query token, not "
                         f"{q.shape[1]}")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, window, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in kernel.DTYPE_CODES:
        raise ValueError(f"decode_attention takes float32 or bfloat16, not "
                         f"{q.dtype}")
    out = kernel.decode_attention_fwd(
        q.contiguous(), k_cache.contiguous(), v_cache.contiguous(),
        _device_scalar(cache_len, q.device), _device_scalar(window, q.device))
    launches += 1
    return out
