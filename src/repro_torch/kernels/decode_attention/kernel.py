"""ctypes launcher of the decode-attention kernel
(``csrc/decode_attention.cu``), and the work layout it runs: a pure
function of the shapes and of two numbers of the card (its SMs and the
kernel's resident blocks per SM), never of ``cache_len``."""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
LANES_PER_KEY = 16             # lanes of a half-warp reading one row
# blocks an SM takes at most: at gemma3-12b's shape on an H100, 384 blocks
# at three an SM ran 3% slower than 256 at two (tools/decode_splits.py,
# in PERF.md)
MAX_BLOCKS_PER_SM = 2


def tile_len(hd: int, elem: int) -> int:
    """Positions per ring tile: 32, 16 or 8 for rows of at most 256, 512
    or 1024 bytes (each lane of a half-warp holding 1, 2 or 4 16-byte
    vectors of a row), so a tile of k and one of v fill 16 KB at most."""
    nvec = hd * elem // 16
    nv = -(-nvec // LANES_PER_KEY)
    return 32 // (1 if nv <= 1 else 2 if nv <= 2 else 4)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The kernel's work: the visible range of each of the ``n_seg`` = B Hk
    (row, kv head) segments, in tiles of ``tile`` positions from its first
    position (the last one ragged), is cut at the same tiles into
    ``n_split`` splits, the first ones a tile longer where the tiles do
    not divide; one block per (segment, split).  ``n_split`` is at most
    ``tiles``, the tiles of S."""
    tile: int
    tiles: int
    n_seg: int
    n_split: int

    @property
    def blocks(self) -> int:
        return self.n_seg * self.n_split

    def splits(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        """[first, end) positions of each split of the visible range [lo,
        hi), the same in every segment; as the kernel cuts them (empty
        where end <= first)."""
        tiles = -(-max(hi - lo, 0) // self.tile)
        base, rem = divmod(tiles, self.n_split)
        out = []
        for i in range(self.n_split):
            t0 = i * base + min(i, rem)
            t1 = t0 + base + (i < rem)
            out.append((lo + t0 * self.tile, min(lo + t1 * self.tile, hi)))
        return out


@functools.lru_cache(maxsize=None)
def layout(b: int, hk: int, s: int, hd: int, elem: int, n_sm: int,
           blocks_per_sm: int) -> Layout:
    """The layout of a launch at these shapes on a card of ``n_sm`` SMs
    holding ``blocks_per_sm`` of the kernel's blocks each, never a
    function of ``cache_len`` or the window (the kernel cuts the visible
    range it reads on the device).  Every (row, kv head) is cut into the
    same ``n_split`` splits, so the blocks of one row's kv heads read the
    same cache rows at about the same time.  The grid holds at most
    ``MAX_BLOCKS_PER_SM`` blocks an SM, and ``n_split`` fills its waves
    best (``wave_fill``; ties to the most splits): a block on an SM with
    more blocks than others streams slower and finishes last."""
    tile = tile_len(hd, elem)
    tiles = -(-s // tile)
    n_seg = max(b * hk, 1)
    most = max(1, min(tiles, n_sm * min(blocks_per_sm, MAX_BLOCKS_PER_SM)
                      // n_seg))
    n_split = max(range(1, most + 1),
                  key=lambda n: (wave_fill(n_seg * n, n_sm), n))
    return Layout(tile=tile, tiles=tiles, n_seg=b * hk, n_split=n_split)


def wave_fill(blocks: int, n_sm: int) -> float:
    """The share of the places that ``blocks`` take on ``n_sm`` SMs all
    filled to the fullest one's count: 1 for a whole number of waves."""
    return blocks / (n_sm * -(-blocks // n_sm))


@dataclasses.dataclass(frozen=True)
class Occupancy:
    """What the card reports for the kernel variant of a shape."""
    registers: int             # per thread
    blocks_per_sm: int         # resident
    n_sm: int
    tile: int


@functools.lru_cache(maxsize=None)
def occupancy(device_index: int, dtype_code: int, hd: int, hq: int,
              hk: int) -> Occupancy:
    """The variant's registers, resident blocks per SM and the card's SMs,
    asked of the library once per device and variant (host calls only: no
    launch, no sync)."""
    info = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        err = build.library().decode_attention_occupancy(
            dtype_code, hd, hq, hk, ctypes.addressof(info))
    build.check(err, "decode_attention (occupancy)")
    occ = Occupancy(*info)
    if occ.blocks_per_sm < 1:
        raise RuntimeError(f"decode_attention: no block of the kernel fits "
                           f"on an SM ({occ})")
    return occ


def plan(q: torch.Tensor, k_cache: torch.Tensor) -> Tuple[Occupancy, Layout]:
    """The occupancy and layout of a launch on these tensors."""
    b, _, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    occ = occupancy(q.device.index, DTYPE_CODES[q.dtype], hd, hq, hk)
    lay = layout(b, hk, s, hd, q.element_size(), occ.n_sm,
                 occ.blocks_per_sm)
    if lay.tile != occ.tile:
        raise RuntimeError(f"decode_attention: layout tile {lay.tile} != "
                           f"the kernel's {occ.tile}")
    return occ, lay


# per (device, stream): one int32 ticket counter per segment, zeroed once;
# every launch leaves them 0 (the last block of a segment resets its own)
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = _TICKETS[key] = torch.zeros(max(n, 1), dtype=torch.int32,
                                          device=device)
    return buf


def decode_attention_fwd(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor,
                         window: torch.Tensor) -> torch.Tensor:
    """q (B, 1, Hq, hd), caches (B, S, Hk, hd), contiguous CUDA tensors of
    one dtype (fp32 or bf16), ``cache_len`` and ``window`` 0-d int32 on
    the same device → (B, 1, Hq, hd) in q's dtype: one launch on the
    current stream.  A shape the kernel does not take (hd > 256 or not a
    multiple of 16 bytes, more than 8 query heads per kv head) is refused
    by the C launcher and raises."""
    b, _, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    _, lay = plan(q, k_cache)
    out = torch.empty_like(q)
    # per (segment, split): hd accumulator sums per head of the group, then
    # the running maxima and sums
    part = torch.empty(lay.blocks * (hq // hk) * (hd + 2),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = tickets(q.device, stream, lay.n_seg)
    err = build.library().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        part.data_ptr(), counters.data_ptr(), cache_len.data_ptr(),
        window.data_ptr(), b, s, hq, hk, hd, lay.tile, lay.n_split,
        DTYPE_CODES[q.dtype], stream)
    build.check(err, "decode_attention")
    return out
