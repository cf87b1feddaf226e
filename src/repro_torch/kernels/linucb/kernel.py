"""ctypes launcher of the LinUCB scoring kernel (``csrc/linucb.cu``), and
the layout it runs: a pure function of the shapes."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

SMALL_MAX_D = 32               # the small path: a group of <= 32 lanes
SMALL_THREADS = 128
BQ, BJ, BK = 128, 128, 32      # tiled path: queries a block, columns a
TILED_THREADS = 256            # pass, k-steps a slab; 16 x 16 threads
SMEM_LIMIT = 232448            # dynamic shared memory a block may have (H100)
MAX_GRID = 2 ** 31 - 1
PATHS = {"small": 0, "tiled": 1}


def tiled_smem(d: int) -> int:
    """Dynamic shared memory of a tiled block (``tiled_smem`` in the
    source): the query tile's X transposed (d rounded up to a slab, rows
    of 128 + 4 floats), two slabs of A, theta."""
    return 4 * (-(-d // BK) * BK * (BQ + 4) + 2 * BK * BJ + -(-d // 4) * 4)


@dataclasses.dataclass(frozen=True)
class Layout:
    """``path`` "small": ``group`` lanes an output, ``threads`` a block;
    "tiled": one block per (arm, tile of 128 queries), 256 threads of 8 x
    8 outputs.  ``grid`` blocks, ``smem`` bytes of dynamic shared memory
    each."""
    path: str
    grid: int
    threads: int
    group: int
    smem: int


@functools.lru_cache(maxsize=None)
def layout(q: int, m: int, d: int, path: Optional[str] = None) -> Layout:
    """The small path for d <= 32 (the router's contexts: d = 12), whose
    launch is one dependent load deep; the register-tiled product for
    larger d (the production shape: d = 128).  ``path`` names the other
    path for timing variants.  Raises ValueError for a shape neither
    takes: d <= 0, d > 32 on the small path, d > 352 (X's tile and the
    slabs beyond a block's shared memory) on the tiled path."""
    path = path or ("small" if d <= SMALL_MAX_D else "tiled")
    if q < 0 or m < 0 or d <= 0 or path not in PATHS:
        raise ValueError(f"linucb kernel: shape (q={q}, m={m}, d={d}), "
                         f"path {path} not taken")
    if path == "small":
        if d > SMALL_MAX_D:
            raise ValueError(f"linucb kernel: d={d} > {SMALL_MAX_D} on the "
                             f"small path")
        group = 1 << (d - 1).bit_length()
        grid = -(-q * m * group // SMALL_THREADS)
        lay = Layout(path, grid, SMALL_THREADS, group, 0)
    else:
        smem = tiled_smem(d)
        if smem > SMEM_LIMIT:
            raise ValueError(f"linucb kernel: d={d} needs {smem} bytes of "
                             f"shared memory, more than {SMEM_LIMIT}")
        lay = Layout(path, -(-q // BQ) * m, TILED_THREADS, 1, smem)
    if lay.grid > MAX_GRID:
        raise ValueError(f"linucb kernel: grid {lay.grid} too large")
    return lay


@dataclasses.dataclass(frozen=True)
class Info:
    """What the card and the C launcher report for a geometry."""
    registers: int             # per thread
    local_bytes: int           # spilled, per thread
    static_smem: int
    dynamic_smem: int
    blocks_per_sm: int         # resident
    n_sm: int
    threads: int
    grid: int
    per_block: int             # lanes an output (small) or queries (tiled)


def info(q: int, m: int, d: int, lay: Layout) -> Info:
    """The path's resources at (q, m, d), asked of the library (host calls
    only); its grid, threads and shared memory are the C launcher's own
    reckoning, to be held against ``lay``."""
    out = (ctypes.c_int * 9)()
    err = build.library().linucb_info(q, m, d, PATHS[lay.path],
                                      ctypes.addressof(out))
    build.check(err, "linucb (info)")
    return Info(*out)


def linucb_scores_fwd(a_inv: torch.Tensor, theta: torch.Tensor,
                      x: torch.Tensor, alpha: float,
                      lay: Optional[Layout] = None) -> torch.Tensor:
    """a_inv fp32 (M, d, d), theta fp32 (M, d), x fp32 (Q, d), contiguous
    CUDA tensors on one device → fp32 (Q, M): one launch on the current
    stream at ``lay`` (default: ``layout``).  A shape the kernel does not
    take is refused (``layout`` raises; the C launcher returns
    cudaErrorInvalidValue) and raises."""
    m, d, _ = a_inv.shape
    q = x.shape[0]
    lay = lay or layout(q, m, d)
    out = torch.empty((q, m), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = build.library().linucb_launch(
        a_inv.data_ptr(), theta.data_ptr(), x.data_ptr(), out.data_ptr(),
        q, m, d, float(alpha), PATHS[lay.path], stream)
    build.check(err, "linucb")
    return out
