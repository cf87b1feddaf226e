"""ctypes launcher of the RWKV6 WKV kernel (``csrc/rwkv6.cu``), and the
layout it runs: a pure function of the shapes and the dtype."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
K = 64                         # head size the kernel takes
CHUNK = 64                     # tokens per chunk (the last one ragged)
BLOCK = 8                      # tokens per decay block
COLS = 32                      # value columns per block
THREADS = 256                  # 8 warps
SMEM_LIMIT = 232448            # dynamic shared memory a block may have (H100)


def smem_bytes(elem: int) -> int:
    """Dynamic shared memory of a block (``Cfg::kBytes`` in the source):
    two stages of r and k (rows padded to K + 8), v (COLS + 8) in the
    input type and logw (fp32); r a, k z and the attention (rows of K + 8,
    4 bytes an element); the block totals and 29 rows of their products;
    u; two buffers of the state, 4 bytes an element (rows of K + 8)."""
    stage = 2 * CHUNK * (K + 8) * elem + CHUNK * (COLS + 8) * elem \
        + CHUNK * K * 4
    blocks = CHUNK // BLOCK
    return (2 * stage + 3 * CHUNK * (K + 8) * 4 + (blocks + 29) * K * 4
            + K * 4 + 2 * COLS * (K + 8) * 4)


@dataclasses.dataclass(frozen=True)
class Layout:
    """One block of ``threads`` per (batch row, head, ``cols`` value
    columns); ``smem`` bytes of dynamic shared memory."""
    cols: int
    threads: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def layout(b: int, h: int, elem: int) -> Layout:
    return Layout(cols=COLS, threads=THREADS, blocks=b * h * (K // COLS),
                  smem=smem_bytes(elem))


@dataclasses.dataclass(frozen=True)
class Info:
    """What the card reports for a kernel variant."""
    registers: int             # per thread
    local_bytes: int           # spilled, per thread
    static_smem: int
    dynamic_smem: int
    blocks_per_sm: int         # resident
    n_sm: int
    threads: int


@functools.lru_cache(maxsize=None)
def info(device_index: int, dtype_code: int) -> Info:
    """The variant's resources, asked of the library (host calls only)."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        err = build.library().rwkv6_info(dtype_code, ctypes.addressof(out))
    build.check(err, "rwkv6 (info)")
    return Info(*out)


def wkv_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            logw: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v (B, S, H, K) of one dtype (fp32 or bf16), logw (B, S, H, K)
    fp32, u (H, K) fp32, s0 (B, H, K, K) fp32 or None, all contiguous on
    one CUDA device → (y (B, S, H, K) in r's dtype, final state (B, H, K,
    K) fp32): one launch on the current stream.  A shape the kernel does
    not take (K != 64) is refused by the C launcher and raises."""
    b, s, h, kd = r.shape
    lay = layout(b, h, r.element_size())
    y = torch.empty_like(r)
    s_fin = torch.empty((b, h, kd, kd), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = build.library().rwkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_fin.data_ptr(), b, s, h, kd, lay.smem, DTYPE_CODES[r.dtype],
        stream)
    build.check(err, "rwkv6")
    return y, s_fin
