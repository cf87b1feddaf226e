"""ctypes launcher of the decode-attention kernel
(``csrc/decode_attention.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# blocks the split over the cache aims for: a few per SM of an H100 (132)
TARGET_BLOCKS = 4 * 132
MIN_SPLIT = 256                 # fewest cache positions a split holds


def split_len(b: int, hk: int, s: int) -> int:
    """Cache positions per split: enough splits that the (split, kv head,
    row) grid fills the card, none shorter than ``MIN_SPLIT`` — chosen from
    the shapes alone, so the visible range (a device scalar) is never read
    on the host."""
    n_split = max(1, min(-(-TARGET_BLOCKS // max(b * hk, 1)),
                         -(-s // MIN_SPLIT)))
    return max(1, -(-s // n_split))


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         window: torch.Tensor) -> torch.Tensor:
    """q (B, 1, Hq, hd), caches (B, S, Hk, hd), contiguous CUDA tensors of
    one dtype (fp32 or bf16), ``cache_len`` and ``window`` 0-d int32 on
    the same device → (B, 1, Hq, hd) in q's dtype, launched on the current
    stream: a split kernel over the cache and a combine kernel.  A shape
    the kernel does not take (hd > 256 or not a multiple of 16 bytes, more
    than 8 query heads per kv head) is refused by the C launcher and
    raises."""
    b, _, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    length = split_len(b, hk, s)
    n_split = -(-s // length)
    group = hq // hk
    out = torch.empty_like(q)
    # per (row, kv head, split, head of the group): hd accumulator sums,
    # then the running max and sum
    part = torch.empty(b * hk * n_split * group * (hd + 2),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = build.library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        part.data_ptr(), cache_len.data_ptr(), window.data_ptr(), b, s, hq,
        hk, hd, length, n_split, DTYPE_CODES[q.dtype], stream)
    build.check(err, "decode_attention")
    return out
