"""ctypes launcher of the Mamba2 SSD kernel (``csrc/mamba2.cu``), and the
layout it runs: a pure function of the shapes and the dtype."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
P = 64                         # head size the kernel takes
CHUNK = 64                     # tokens per chunk (the last one ragged)
STATE_SIZES = (16, 32, 64, 128)
SMEM_LIMIT = 232448            # dynamic shared memory a block may have (H100)
COLS = (64, 32)                # P columns a block may take, preferred first


def smem_bytes(n: int, cols: int, elem: int) -> int:
    """Dynamic shared memory of a block (``Cfg::kBytes`` in the source):
    two stages of x (rows padded to cols + 8), B and C (n + 8) in the
    input type and dt; M (fp32 rows of 72); the in-tile decays (rows of
    24); five fp32 decays per token; the tile totals; two buffers of the
    state, 4 bytes an element (rows of n + 8)."""
    stage = CHUNK * (cols + 8) * elem + 2 * CHUNK * (n + 8) * elem + CHUNK * 4
    return (2 * stage + CHUNK * (CHUNK + 8) * 4 + CHUNK * 24 * 4
            + 5 * CHUNK * 4 + 16 + 2 * cols * (n + 8) * 4)


@dataclasses.dataclass(frozen=True)
class Layout:
    """One block per (batch row, head, ``cols`` of the P columns), of 4
    warps per 16 columns; ``smem`` bytes of dynamic shared memory."""
    cols: int
    threads: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def layout(b: int, h: int, n: int, elem: int) -> Layout:
    """The widest column part whose block fits in shared memory: a whole
    head (64 columns, 16 warps) computes the chunk's C B^T once for all of
    P; fp32 at n = 128 takes halves."""
    if n not in STATE_SIZES:
        raise ValueError(f"ssd kernel: state size {n} not one of "
                         f"{STATE_SIZES}")
    cols = next(c for c in COLS if smem_bytes(n, c, elem) <= SMEM_LIMIT)
    return Layout(cols=cols, threads=128 * (cols // 16),
                  blocks=b * h * (P // cols), smem=smem_bytes(n, cols, elem))


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
def info(device_index: int, dtype_code: int, n: int, cols: int) -> Info:
    """The variant's resources, asked of the library (host calls only)."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        err = build.library().mamba2_info(dtype_code, n, cols,
                                          ctypes.addressof(out))
    build.check(err, "mamba2 (info)")
    return Info(*out)


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
            C: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, h, p), B and C (b, s, n) of one dtype (fp32 or bf16), dt
    (b, s, h) fp32, A (h,) fp32, h0 (b, h, p, n) fp32 or None, all
    contiguous on one CUDA device → (y (b, s, h, p) in x's dtype, final
    state (b, h, p, n) fp32): one launch on the current stream.  A shape
    the kernel does not take (p != 64, n not one of 16, 32, 64, 128) is
    refused by the C launcher and raises."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    # a state size the kernel does not take goes to the C launcher with no
    # layout (cols 0), which refuses it
    if n in STATE_SIZES:
        lay = layout(b, h, n, x.element_size())
        cols, smem = lay.cols, lay.smem
    else:
        cols = smem = 0
    y = torch.empty_like(x)
    h_fin = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().mamba2_launch(
        x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(),
        A.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
        h_fin.data_ptr(), b, s, h, p, n, cols, smem, DTYPE_CODES[x.dtype],
        stream)
    build.check(err, "mamba2")
    return y, h_fin
