"""The decompositions of the port's router kernels
(``kernels/csrc/featurize.cu``, ``kernels/csrc/linucb.cu``), rendered in
plain PyTorch on the CPU step by step and held against the JAX package's
Pallas kernels in interpret mode and its jnp references, and the two
kernels' ``layout`` functions.

featurize: the counts scattered per row; the compaction of the non-zero
buckets into a list by each thread's run of buckets and the prefix of the
runs' lengths (it must come out ascending and complete); the list split
over the block's groups of warps (entries g, g + G, ...), each group's
partial sums added in group order; the sum of squares reduced by warp
shuffles, then over the cluster's (block, warp) pairs in order.
LinUCB: the tiled path's W = X A_m as one FMA a k-step in ascending k
(the k-slabs only stage it), the epilogue's sums over each thread's 8
columns in order, then the butterfly over the 16 threads of a query; the
small path's lanes, each (A_m x)_i x_i beside theta_i x_i, added by a
butterfly over a group of next_pow2(d) lanes.  fp32 FMA is rendered as
the product and sum in float64 rounded once to float32.

Limits are those of tests/test_kernels.py (featurize 1e-5, LinUCB 1e-4);
the CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against the plain versions at the same limits."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.featurize.ops import hashed_embed as jax_hashed_embed
from repro.kernels.featurize.ref import hashed_embed_ref as jax_featurize_ref
from repro.kernels.linucb.ops import linucb_scores as jax_linucb_scores
from repro.kernels.linucb.ref import linucb_scores_ref as jax_linucb_ref
from repro_torch.kernels.featurize import kernel as fk
from repro_torch.kernels.linucb import kernel as lk

pytestmark = pytest.mark.port

FEATURIZE_TOL = 1e-5
LINUCB_TOL = 1e-4
H, D = 2048, 384               # the router's hash buckets and width


def fma(a, b, c):
    """fp32 fused multiply-add: a * b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def butterfly(v):
    """``__shfl_xor_sync`` sums over the last dim (a power of two): at
    each offset every lane adds its partner's value to its own."""
    n = v.shape[-1]
    lanes = torch.arange(n)
    off = n // 2
    while off:
        v = v + v[..., lanes ^ off]
        off //= 2
    return v


def shuffle_down_sum(v):
    """``__shfl_down_sync`` over 32 lanes, offsets 16 .. 1: lane 0's sum."""
    off = 16
    while off:
        v = v[..., :off] + v[..., off:2 * off]
        off //= 2
    return v[..., 0]


# ---------------------------------------------------------------------------
# featurize
# ---------------------------------------------------------------------------


def compact(counts, threads):
    """The kernel's list: thread t's run [t per, (t + 1) per), its non-zero
    buckets written at the prefix of the runs' lengths."""
    h = counts.shape[0]
    per = -(-h // threads)
    runs = [counts[min(t * per, h):min((t + 1) * per, h)]
            for t in range(threads)]
    lengths = torch.tensor([int((r != 0).sum()) for r in runs])
    offsets = torch.cumsum(lengths, 0) - lengths
    n = int(lengths.sum())
    list_h = torch.full((n,), -1, dtype=torch.long)
    for t, run in enumerate(runs):
        nz = torch.nonzero(run != 0)[:, 0]
        list_h[offsets[t]:offsets[t] + nz.numel()] = min(t * per, h) + nz
    return list_h


def featurize_kernel_form(ids, w, proj, lay):
    """(Q, L) ids and weights, (H, D) proj → (Q, D) as featurize.cu
    computes it at ``lay``."""
    q = ids.shape[0]
    h, dim = proj.shape
    warps = lay.threads // 32
    groups = warps // lay.tiles
    cols = lay.cluster * lay.tiles * fk.TILE_COLS
    proj_p = torch.nn.functional.pad(proj, (0, cols - dim))
    out = torch.empty((q, dim))
    for r in range(q):
        ok = (ids[r] >= 0) & (ids[r] < h)
        counts = torch.zeros(h).index_add_(0, ids[r][ok].long(), w[r][ok])
        list_h = compact(counts, lay.threads)
        assert torch.equal(list_h, torch.nonzero(counts != 0)[:, 0])
        list_t = torch.log1p(counts[list_h])
        n = list_h.numel()
        # group g takes entries g, g + G, ...: step k adds entry g + k G
        acc = torch.zeros((groups, cols))
        for k in range(-(-n // groups)):
            e = torch.arange(groups) + k * groups
            live = e < n
            e = e.clamp(max=max(n - 1, 0))
            t = torch.where(live, list_t[e] if n else 0.0, 0.0)
            p = proj_p[list_h[e]] if n else torch.zeros((groups, cols))
            acc = torch.where(live[:, None], fma(t[:, None], p, acc), acc)
        v = acc[0].clone()
        for g in range(1, groups):
            v = v + acc[g]
        # writer threads hold 4 columns, a warp a tile
        v4 = v.reshape(lay.cluster, lay.tiles, 32, 4)
        v4 = torch.where(
            (torch.arange(cols) < dim).reshape(v4.shape), v4, 0.0)
        ss = torch.zeros(v4.shape[:3])
        for c in range(4):
            ss = fma(v4[..., c], v4[..., c], ss)
        warp_ss = shuffle_down_sum(ss)                  # (cluster, tiles)
        total = torch.zeros(())
        for s_rw in warp_ss.reshape(-1):                # (rank, warp) order
            total = total + s_rw
        norm = torch.sqrt(total)
        v = v[:dim]
        out[r] = v / torch.clamp(norm, min=1e-30) if norm > 0 else v
    return out


def featurize_inputs(seed, q=6, seq_l=256):
    """Router-like rows: the router's weights, -1 padding, ids at and past
    H between them, one bucket repeated, a featureless row, a long row."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, H, (q, seq_l)).astype(np.int32)
    lens = rng.integers(1, seq_l + 1, q)
    lens[-1] = seq_l
    ids[np.arange(seq_l)[None] >= lens[:, None]] = -1
    ids[0, 1::3] = -1                                   # -1 interleaved
    ids[0, 2::7] = H + rng.integers(0, 100, ids[0, 2::7].shape)
    ids[1, :12] = 5                                     # count > 1
    ids[2] = -1                                         # featureless
    w = rng.choice(np.array([1.0, 0.5, 0.75], np.float32), (q, seq_l))
    w = np.where(ids >= 0, w, 0.0).astype(np.float32)
    proj = (rng.standard_normal((H, D)) / np.sqrt(H)).astype(np.float32)
    return ids, w, proj


@pytest.mark.parametrize("cluster,threads", [(None, None), (3, 256),
                                             (1, 384), (2, 512), (3, 1024)])
def test_featurize_kernel_form_matches_jax(cluster, threads):
    ids, w, proj = featurize_inputs(seed=7 + (threads or 0))
    lay = fk.layout(*ids.shape, H, D, cluster=cluster, threads=threads)
    out = featurize_kernel_form(torch.from_numpy(ids), torch.from_numpy(w),
                                torch.from_numpy(proj), lay).numpy()
    kern = np.asarray(jax_hashed_embed(jnp.asarray(ids), jnp.asarray(w),
                                       jnp.asarray(proj), interpret=True))
    # the jnp oracle clips ids past H into the last bucket; the Pallas
    # kernel (and the port) match none, so it sees them as padding
    padded = np.where(ids < H, ids, -1).astype(np.int32)
    ref = np.asarray(jax_featurize_ref(jnp.asarray(padded), jnp.asarray(w),
                                       jnp.asarray(proj)))
    np.testing.assert_allclose(out, kern, atol=FEATURIZE_TOL,
                               rtol=FEATURIZE_TOL)
    np.testing.assert_allclose(out, ref, atol=FEATURIZE_TOL,
                               rtol=FEATURIZE_TOL)
    assert np.all(out[2] == 0.0)
    np.testing.assert_allclose(np.linalg.norm(out[[0, 1, 3, 4, 5]], axis=1),
                               1.0, atol=1e-5)


@pytest.mark.parametrize("h,threads", [(2048, 512), (2048, 256),
                                       (300, 512), (5, 64), (2047, 1024)])
def test_featurize_compaction_is_ascending_and_complete(h, threads):
    rng = np.random.default_rng(h + threads)
    counts = torch.from_numpy(np.where(rng.random(h) < 0.1,
                                       rng.integers(1, 5, h), 0)
                              .astype(np.float32))
    counts[-1] = 1.0                        # the last bucket of the last run
    assert torch.equal(compact(counts, threads),
                       torch.nonzero(counts)[:, 0])


def test_featurize_all_padding_batch_is_zero():
    ids = np.full((4, 128), -1, np.int32)
    ids[1, :3] = [H, H + 1, 10 ** 6]        # only ids past H
    w = np.ones((4, 128), np.float32)
    proj = featurize_inputs(seed=3)[2]
    out = featurize_kernel_form(torch.from_numpy(ids), torch.from_numpy(w),
                                torch.from_numpy(proj),
                                fk.layout(4, 128, H, D))
    assert torch.equal(out, torch.zeros((4, D)))


def test_featurize_layout_of_the_router():
    lay = fk.layout(2, 512, H, D)
    assert (lay.cluster, lay.tiles, lay.threads) == (3, 1, 512)
    assert lay.grid == 2 * 3
    assert lay.smem == 3 * H * 4 + 16 * 512 == 32768
    # 16 warps while two blocks an SM hold the grid, then 8
    assert fk.layout(88, 512, H, D).threads == 512      # 264 blocks
    big = fk.layout(128, 1024, H, D)                     # Q = 64 "both"
    assert (big.grid, big.threads, big.smem) == (384, 256, 28672)


@pytest.mark.parametrize("q,dim,hash_dim,cluster,threads", [
    (1, 384, 2048, None, None), (512, 384, 2048, None, None),
    (3, 128, 2048, None, None), (2, 4, 16, None, None),
    (8, 1024, 2048, None, None), (4, 2048, 2048, None, None),
    (2, 1028, 2048, None, None), (2, 2600, 2048, None, None),
    (2, 384, 2048, 1, 768), (2, 384, 2048, 2, 512), (2, 384, 9000, 3, 1024),
])
def test_featurize_layout_covers_every_column_and_fits(q, dim, hash_dim,
                                                       cluster, threads):
    lay = fk.layout(q, 128, hash_dim, dim, cluster=cluster, threads=threads)
    assert 1 <= lay.cluster <= fk.MAX_CLUSTER and lay.grid == q * lay.cluster
    assert lay.threads % 32 == 0 and 32 <= lay.threads <= 1024
    assert (lay.threads // 32) % lay.tiles == 0       # whole groups a tile
    assert lay.cluster * lay.tiles * fk.TILE_COLS >= dim
    if cluster is None:                               # no block left idle
        assert (lay.cluster - 1) * lay.tiles * fk.TILE_COLS < dim
    assert lay.smem == fk.smem_bytes(hash_dim, lay.threads) <= fk.SMEM_LIMIT


@pytest.mark.parametrize("dim,hash_dim,cluster,threads", [
    (386, 2048, None, None),          # D not a multiple of 4
    (384, 20000, None, None),         # counts and list past 227 KB
    (384, 2048, 1, 256),              # 8 warps do not split over 3 tiles
    (384, 2048, 9, None),             # past the portable cluster size
    (384, 2048, None, 100),           # not whole warps
])
def test_featurize_layout_refuses(dim, hash_dim, cluster, threads):
    with pytest.raises(ValueError):
        fk.layout(1, 128, hash_dim, dim, cluster=cluster, threads=threads)


# ---------------------------------------------------------------------------
# LinUCB
# ---------------------------------------------------------------------------


def half_index(t, r):
    """A thread's 8 rows (or columns) of the tile: 4 from its group of 4
    in each half of 64."""
    return (0 if r < 4 else 64) + t * 4 + (r & 3)


def linucb_tiled_form(a_inv, theta, x, alpha):
    """(M, d, d), (M, d), (Q, d) → (Q, M) as the tiled path computes it."""
    m_total, d, _ = a_inv.shape
    q = x.shape[0]
    passes = -(-d // lk.BJ)
    xp = torch.nn.functional.pad(x, (0, passes * lk.BJ - d))
    out = torch.empty((q, m_total))
    # column j of the thread (tj, c) in pass p: p * 128 + half_index(tj, c)
    cols = torch.tensor([[[p * lk.BJ + half_index(tj, c) for c in range(8)]
                          for tj in range(16)] for p in range(passes)])
    for m in range(m_total):
        a = torch.nn.functional.pad(a_inv[m], (0, passes * lk.BJ - d))
        wmat = torch.zeros((q, passes * lk.BJ))
        for k in range(d):                       # slabs of 32, k ascending
            wmat = fma(x[:, k:k + 1], a[k:k + 1], wmat)
        thp = torch.nn.functional.pad(theta[m], (0, passes * lk.BJ - d))
        vsum = torch.zeros((q, 16))
        msum = torch.zeros((q, 16))
        for p in range(passes):
            for c in range(8):
                j = cols[p, :, c]                # (16,) one a thread
                live = j < d
                vsum = torch.where(live, fma(wmat[:, j], xp[:, j], vsum),
                                   vsum)
        for p in range(passes):
            for c in range(8):
                j = cols[p, :, c]
                live = j < d
                msum = torch.where(live, fma(thp[j], xp[:, j], msum), msum)
        vsum, msum = butterfly(vsum)[:, 0], butterfly(msum)[:, 0]
        out[:, m] = fma(torch.full_like(vsum, alpha),
                        torch.sqrt(torch.clamp(vsum, min=0.0)), msum)
    return out


def linucb_small_form(a_inv, theta, x, alpha):
    """(M, d, d), (M, d), (Q, d) → (Q, M) as the small path computes it:
    a group of next_pow2(d) lanes an output."""
    m_total, d, _ = a_inv.shape
    g = 1 << (d - 1).bit_length()
    ax = torch.zeros((x.shape[0], m_total, d))
    for j in range(d):
        ax = fma(a_inv[None, :, :, j], x[:, None, j:j + 1], ax)
    var = torch.nn.functional.pad(ax * x[:, None, :], (0, g - d))
    mean = torch.nn.functional.pad(theta[None] * x[:, None, :], (0, g - d))
    var, mean = butterfly(var)[..., 0], butterfly(mean)[..., 0]
    return fma(torch.full_like(var, alpha),
               torch.sqrt(torch.clamp(var, min=0.0)), mean)


def linucb_inputs(m, d, q, seed, indefinite=False):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((m, d, d)).astype(np.float32) * 0.2
    a_inv = (np.einsum("mij,mkj->mik", low, low)
             + np.eye(d, dtype=np.float32)[None]).astype(np.float32)
    if indefinite:
        a_inv = -a_inv
    theta = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((q, d)).astype(np.float32)
    return a_inv, theta, x


def hold_against_jax(form, m, d, q, alpha, indefinite=False):
    a_inv, theta, x = linucb_inputs(m, d, q, seed=m * d + q,
                                    indefinite=indefinite)
    out = form(torch.from_numpy(a_inv), torch.from_numpy(theta),
               torch.from_numpy(x), alpha).numpy()
    ref = np.asarray(jax_linucb_ref(jnp.asarray(a_inv), jnp.asarray(theta),
                                    jnp.asarray(x), alpha))
    kern = np.asarray(jax_linucb_scores(jnp.asarray(a_inv),
                                        jnp.asarray(theta), jnp.asarray(x),
                                        alpha, interpret=True))
    np.testing.assert_allclose(out, ref, atol=LINUCB_TOL, rtol=LINUCB_TOL)
    np.testing.assert_allclose(out, kern, atol=LINUCB_TOL, rtol=LINUCB_TOL)
    if indefinite:                              # every form clamps to 0
        np.testing.assert_allclose(out, x @ theta.T, atol=LINUCB_TOL)


@pytest.mark.parametrize("m,d,q,alpha,indefinite", [
    (4, 128, 130, 0.1, False),      # the production d, a ragged query tile
    (3, 150, 7, 0.5, False),        # two column passes
    (5, 40, 5, 0.1, False),         # the first d on the tiled path
    (4, 12, 3, 0.1, False),         # the router's d, on the tiled path
    (3, 128, 9, 0.1, True),         # an indefinite A^-1
])
def test_linucb_tiled_form_matches_jax(m, d, q, alpha, indefinite):
    hold_against_jax(linucb_tiled_form, m, d, q, alpha, indefinite)


@pytest.mark.parametrize("m,d,q,alpha,indefinite", [
    (4, 12, 1, 0.1, False),         # the served pool
    (64, 12, 16, 0.1, False),       # the batch path's arms
    (7, 32, 5, 0.5, False),         # the widest group
    (5, 17, 3, 0.1, False),         # d past a power of two: 32 lanes
    (3, 1, 2, 0.1, False),          # a group of one lane
    (6, 12, 4, 0.1, True),          # an indefinite A^-1
])
def test_linucb_small_form_matches_jax(m, d, q, alpha, indefinite):
    hold_against_jax(linucb_small_form, m, d, q, alpha, indefinite)


@pytest.mark.parametrize("q,m,d,path", [
    (1, 4, 12, "small"), (64, 64, 12, "small"), (1, 3, 1, "small"),
    (2, 5, 32, "small"), (1024, 64, 128, "tiled"), (1, 37, 128, "tiled"),
    (64, 16, 150, "tiled"), (4, 2, 33, "tiled"), (8, 3, 352, "tiled"),
])
def test_linucb_layout_picks_the_path_and_covers(q, m, d, path):
    lay = lk.layout(q, m, d)
    assert lay.path == path
    if path == "small":
        assert lay.group >= d and lay.group & (lay.group - 1) == 0
        assert lay.group <= 32 and lay.smem == 0
        assert lay.grid * lay.threads >= q * m * lay.group
        assert (lay.grid - 1) * lay.threads < q * m * lay.group
    else:
        assert lay.threads == 256
        assert lay.grid == -(-q // lk.BQ) * m
        assert lay.smem == lk.tiled_smem(d) <= lk.SMEM_LIMIT


def test_linucb_layout_of_the_production_shape():
    lay = lk.layout(1024, 64, 128)
    assert (lay.grid, lay.threads, lay.smem) == (512, 256, 100864)
    # two blocks an SM: twice the block's shared memory fits the SM's
    assert 2 * lay.smem <= 228 * 1024


@pytest.mark.parametrize("q,m,d,path", [
    (1, 4, 0, None), (1, 4, 353, None), (1, 4, 33, "small"),
    (1, -1, 64, "tiled"), (1, 4, 12, "other"),
])
def test_linucb_layout_refuses(q, m, d, path):
    with pytest.raises(ValueError):
        lk.layout(q, m, d, path=path)
