"""ctypes launcher of the featurization kernel (``csrc/featurize.cu``), and
the layout it runs: a pure function of the shapes."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.kernels import build

TILE_COLS = 128                # columns of a tile: a float4 a lane of a warp
MAX_CLUSTER = 8                # the portable thread-block cluster size
THREADS = 512                  # a block: 16 warps, 16 groups of the list,
WAVE_BLOCKS = 264              # while 2 such blocks an SM of 132 (H100)
                               # hold the grid; past that 8 warps, 4 an SM
SMEM_LIMIT = 232448            # dynamic shared memory a block may have (H100)
MAX_GRID = 2 ** 31 - 1


def smem_bytes(hash_dim: int, threads: int) -> int:
    """Dynamic shared memory of a block (``smem_bytes`` in the source):
    the counts, the list's buckets and its values (``hash_dim`` 4-byte
    words each, rounded up to 16 bytes), then a float4 partial sum a
    thread."""
    return 3 * (-(-hash_dim // 4) * 4) * 4 + 16 * threads


@dataclasses.dataclass(frozen=True)
class Layout:
    """A row is a cluster of ``cluster`` blocks of ``threads`` threads,
    each block taking ``tiles`` tiles of 128 columns; ``grid`` blocks in
    all, ``smem`` bytes of dynamic shared memory each."""
    grid: int
    cluster: int
    threads: int
    tiles: int
    smem: int


@functools.lru_cache(maxsize=None)
def layout(q: int, seq_l: int, hash_dim: int, dim: int,
           cluster: Optional[int] = None,
           threads: Optional[int] = None) -> Layout:
    """One tile of 128 columns a block, as many blocks a row as the
    columns have tiles (the router's D = 384: clusters of 3 on three SMs;
    past 8 tiles, as many a block as 8 blocks need), 16 warps a block, so
    each warp's share of the list is a sixteenth; 8 warps where the grid
    is more than one wave of two 16-warp blocks an SM (Q = 64 "both": 384
    blocks), so that four blocks fit an SM (64 registers a thread).
    ``cluster`` and ``threads`` name another geometry for timing variants.
    Raises ValueError for a shape the kernel does not take: D not a
    multiple of 4, more tiles than 8 blocks of 32 warps take, counts and
    list beyond a block's shared memory."""
    if q < 0 or seq_l < 0 or hash_dim <= 0 or dim <= 0 or dim % 4:
        raise ValueError(f"featurize kernel: shape (q={q}, L={seq_l}, "
                         f"H={hash_dim}, D={dim}) not taken (D a multiple "
                         f"of 4)")
    col_tiles = -(-dim // TILE_COLS)
    if cluster is None:
        tiles = -(-col_tiles // MAX_CLUSTER)
        cluster = -(-col_tiles // tiles)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"featurize kernel: cluster {cluster} not in "
                         f"1..{MAX_CLUSTER}")
    tiles = -(-col_tiles // cluster)
    if threads is None:         # 16 warps (8 past a wave), or the most
        most = THREADS if q * cluster <= WAVE_BLOCKS else THREADS // 2
        threads = 32 * tiles * max(1, most // 32 // tiles)   # whole groups
    smem = smem_bytes(hash_dim, threads)
    if (threads % 32 or not 32 <= threads <= 1024
            or (threads // 32) % tiles or smem > SMEM_LIMIT
            or q * cluster > MAX_GRID):
        raise ValueError(f"featurize kernel: {threads} threads, cluster "
                         f"{cluster}, {tiles} tiles a block, {smem} bytes "
                         f"of shared memory not taken for D={dim}, "
                         f"H={hash_dim}, q={q}")
    return Layout(grid=q * cluster, cluster=cluster, threads=threads,
                  tiles=tiles, smem=smem)


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
    cluster: int


def info(q: int, hash_dim: int, dim: int, lay: Layout) -> Info:
    """The kernel's resources at ``lay``, asked of the library (host calls
    only); its grid, threads and shared memory are the C launcher's own
    reckoning, to be held against ``lay``."""
    out = (ctypes.c_int * 9)()
    err = build.library().featurize_info(q, hash_dim, dim, lay.threads,
                                         lay.cluster, ctypes.addressof(out))
    build.check(err, "featurize (info)")
    return Info(*out)


def hashed_embed_fwd(ids: torch.Tensor, weights: torch.Tensor,
                     proj: torch.Tensor,
                     lay: Optional[Layout] = None) -> torch.Tensor:
    """ids int32 (Q, L), weights fp32 (Q, L), proj fp32 (H, D), contiguous
    CUDA tensors on one device (proj 16-byte aligned) → fp32 (Q, D): one
    launch on the current stream at ``lay`` (default: ``layout``).  A
    shape the kernel does not take is refused (``layout`` raises; the C
    launcher returns cudaErrorInvalidValue) and raises."""
    q, seq_l = ids.shape
    hash_dim, dim = proj.shape
    lay = lay or layout(q, seq_l, hash_dim, dim)
    out = torch.empty((q, dim), dtype=torch.float32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = build.library().featurize_launch(
        ids.data_ptr(), weights.data_ptr(), proj.data_ptr(), out.data_ptr(),
        q, seq_l, hash_dim, dim, lay.threads, lay.cluster, stream)
    build.check(err, "featurize")
    return out
