"""The decode-attention kernel's work layout and arithmetic on the CPU: the
layout (``kernel.layout``, a function of the shapes and of the card's SMs
and resident blocks per SM) at gemma3-12b's, granite-3-8b's and
zamba2-7b's decode shapes and at ragged S, and the plain split-and-combine
version (``ref.decode_attention_split_ref``: a partial per split of the
layout, then the log-sum-exp merge that the kernel's last block performs)
against the unsplit plain version and the JAX package's decode attention
(the Pallas kernel in interpret mode and its jnp oracle), at
tests/test_kernels.py's tolerances: fp32 2e-5, bf16 3e-2.  The kernel
itself runs only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref)
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import kernel
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, decode_attention_split_ref)

pytestmark = pytest.mark.port

TOL = {np.float32: 2e-5, "bfloat16": 3e-2}
# (b, hk, s, hd, bytes per element): gemma3-12b's global layers in bf16
# and fp32, its ring layers, granite-3-8b, zamba2-7b, ragged S
SHAPES = [(4, 8, 32768, 256, 2), (4, 8, 32768, 256, 4), (4, 8, 1024, 256, 2),
          (4, 8, 4096, 128, 2), (1, 32, 4096, 112, 2), (2, 2, 5000, 128, 4),
          (3, 2, 1001, 64, 2)]
# (SMs, resident blocks per SM): an H100 at 3, 2 and 1 blocks, a smaller
# card, and cards too small to split every segment
CARDS = [(132, 3), (132, 2), (132, 1), (114, 2), (7, 1), (1, 1)]


@pytest.mark.parametrize("n_sm,per_sm", CARDS)
@pytest.mark.parametrize("b,hk,s,hd,elem", SHAPES)
def test_layout_splits_every_segment_alike_in_full_waves(b, hk, s, hd,
                                                           elem, n_sm,
                                                           per_sm):
    lay = kernel.layout(b, hk, s, hd, elem, n_sm, per_sm)
    # a tile of k and one of v fill at most the ring stage's 16 KB
    assert 2 * lay.tile * hd * elem <= 16384
    assert lay.tiles == -(-s // lay.tile) and lay.n_seg == b * hk
    # at most two blocks an SM (one segment a block where there are more
    # segments), in the number of splits that fills the grid's waves best
    per_sm = min(per_sm, kernel.MAX_BLOCKS_PER_SM)
    assert lay.blocks == lay.n_seg * lay.n_split
    assert lay.blocks <= max(lay.n_seg, n_sm * per_sm)
    most = max(1, min(lay.tiles, n_sm * per_sm // lay.n_seg))
    best = max(kernel.wave_fill(lay.n_seg * n, n_sm)
               for n in range(1, most + 1))
    assert kernel.wave_fill(lay.blocks, n_sm) == best
    # the splits of a visible range cover it in order in whole tiles from
    # its first position but its ragged end, their lengths in tiles
    # differing by at most one: the whole cache, a range that ends inside
    # it, a window's edge off the tile grid, one position, none
    for lo, hi in ((0, s), (0, s - 63), (s // 3 + 5, s // 2 + 7), (7, 8),
                   (9, 9)):
        splits = lay.splits(lo, hi)
        assert len(splits) == lay.n_split
        assert splits[0][0] == lo and splits[-1][1] == hi
        for (_, end), (start, _) in zip(splits, splits[1:]):
            assert start == min(end, hi) and (end - lo) % lay.tile == 0 \
                or start >= hi
        tiles = [-(-max(e - a, 0) // lay.tile) for a, e in splits]
        assert max(tiles) - min(tiles) <= 1
        assert sum(tiles) == -(-(hi - lo) // lay.tile)


def test_layout_of_gemma3_on_an_h100():
    """gemma3-12b's global layers on an H100 at 3 resident blocks per SM:
    32 (row, kv head) segments of 2048 tiles of 16 positions in 8 splits
    of 256 tiles, 256 blocks, two on each SM but 8; and the fill rule on
    its own: whole waves fill 1, 256 blocks on 132 SMs 256 / 264."""
    lay = kernel.layout(4, 8, 32768, 256, 2, 132, 3)
    assert (lay.tile, lay.tiles, lay.n_split, lay.blocks) == (16, 2048, 8,
                                                              256)
    assert {e - a for a, e in lay.splits(0, 32768)} == {256 * 16}
    # the main path's visible range: 2045 tiles, 5 splits of 256, 3 of 255
    assert [(e - a + 15) // 16 for a, e in lay.splits(0, 32705)] == \
        [256] * 5 + [255] * 3
    assert kernel.wave_fill(264, 132) == kernel.wave_fill(132, 132) == 1
    assert kernel.wave_fill(256, 132) == 256 / 264
    assert kernel.wave_fill(192, 132) == 192 / 264


def _qkv(b, s, hq, hk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, hq, hd)).astype(np.float32),
            rng.standard_normal((b, s, hk, hd)).astype(np.float32),
            rng.standard_normal((b, s, hk, hd)).astype(np.float32))


# (b, s, hq, hk, hd, cache_len, window, n_sm, per_sm)
SPLIT_CASES = [
    (2, 1024, 8, 2, 64, 700, 10_000, 4, 3),    # splits past cache_len see
                                               # nothing; cache_len inside one
    (2, 1024, 8, 2, 64, 1000, 100, 7, 2),      # a window far shorter than S:
                                               # its edge inside a split
    (1, 2048, 4, 4, 128, 2047, 256, 8, 3),
    (2, 1000, 4, 2, 256, 999, 10_000, 9, 2),   # ragged S, gemma3's hd 256
    (3, 1001, 6, 2, 64, 5, 10_000, 13, 3),     # one split of each segment
                                               # sees anything
    (2, 512, 16, 2, 64, 512, 512, 5, 2),       # 8 query heads a kv head
]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hk,hd,clen,win,n_sm,per_sm", SPLIT_CASES)
def test_split_and_combine_matches_plain_and_jax(dtype, b, s, hq, hk, hd,
                                                 clen, win, n_sm, per_sm):
    q, k, v = _qkv(b, s, hq, hk, hd, seed=s + clen)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    lay = kernel.layout(b, hk, s, hd, tq.element_size(), n_sm, per_sm)
    assert lay.n_split > 1
    out = decode_attention_split_ref(tq, tk, tv, win,
                                     torch.tensor(clen, dtype=torch.int32),
                                     lay)
    assert out.dtype == tdt and out.shape == (b, 1, hq, hd)
    out = out.float().numpy()
    plain = decode_attention_ref(tq, tk, tv, win, clen).float().numpy()
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    kern = np.asarray(jax_decode(jq, jk, jv, window=win, cache_len=clen,
                                 block_k=256, interpret=True)
                      .astype(jnp.float32))
    oracle = np.asarray(jax_decode_ref(jq, jk, jv, window=win,
                                       cache_len=clen).astype(jnp.float32))
    tol = TOL[dtype]
    for want in (plain, kern, oracle):
        np.testing.assert_allclose(out, want, atol=tol, rtol=tol)


def test_split_and_combine_of_an_empty_row_is_zero():
    """cache_len 0: every split's partial is empty (m = NEG_INF, l = 0);
    the merge gives 0, as the Pallas kernel does."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 512, 4, 2, 32, seed=3))
    lay = kernel.layout(2, 2, 512, 32, 4, 6, 2)
    assert lay.n_split == 3
    out = decode_attention_split_ref(q, k, v, 512, 0, lay).numpy()
    kern = np.asarray(jax_decode(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                                 window=512, cache_len=0, block_k=256,
                                 interpret=True))
    np.testing.assert_array_equal(out, 0.0)
    np.testing.assert_array_equal(kern, 0.0)


def test_source_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """A changed ``csrc/*.cuh`` changes the library's name, so a checkout
    rebuilds the kernels that include it."""
    for name in build.SOURCES + build.HEADERS:
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    assert sorted(build.HEADERS) == sorted(
        p.name for p in build.CSRC.glob("*.cuh"))
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.source_hash()
    with open(tmp_path / build.HEADERS[0], "a") as f:
        f.write("\n// changed\n")
    assert build.source_hash() != before
