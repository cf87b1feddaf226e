"""The chunk arithmetic of the port's SSD and WKV kernels
(``kernels/csrc/mamba2.cu``, ``kernels/csrc/rwkv6.cu``), rendered in
plain PyTorch on the CPU and held against the JAX package's token-wise
``ssd_ref``/``wkv_ref`` and its Pallas kernels in interpret mode.

The renderings below follow the kernels step by step: the same chunk of 64
tokens (the last one ragged, its missing tokens zeros), the same tiles
(16 tokens for SSD, 8-token decay blocks for WKV), every decay a product
of w = exp(dt A) or exp(logw) <= 1 with the mask applied before it is
used, the same reference points across tiles, and every tensor-core
product as the kernels issue it: an operand that is bf16 already goes in
as it is, an fp32 operand as hi = bf16(x) and lo = bf16(x - hi), and a
product of split operands is hi hi + hi lo + lo hi, summed in fp32.  The
CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against the plain versions at the same limits as here.

Limits are ``chip_smoke.py``'s: y at one bf16 unit (2^-7 of |ref| plus
the output's RMS) when it is bf16, else 3e-4 (SSD) or 2e-4 (WKV) atol and
rtol; the fp32 final state at the same 3e-4 / 2e-4 in every case.  Heads
are the models' widths (P = 64 with N = 64, K = 64) at small S."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.mamba2.ops import ssd as jax_ssd
from repro.kernels.mamba2.ref import ssd_ref as jax_ssd_ref
from repro.kernels.rwkv6.ops import wkv as jax_wkv
from repro.kernels.rwkv6.ref import wkv_ref as jax_wkv_ref
from repro_torch.kernels.mamba2 import kernel as ssd_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

L = 64                         # tokens per chunk, both kernels
SSD_TILE = 16                  # SSD tokens per tile (4 a chunk)
WKV_BLOCK = 8                  # WKV tokens per decay block (8 a chunk)
SSD_TOL = 3e-4                 # chip_smoke.py's SSD_FP32_TOL
WKV_TOL = 2e-4                 # and WKV_FP32_TOL
BF16_REL = 2.0 ** -7           # one bf16 unit (chip_smoke.py FLASH_BF16_REL)


def parts(x, n):
    """An operand as the kernels carry it into a product: n bf16 parts
    whose sum is x (one part: x as it is, bf16 already)."""
    if n == 1:
        return [x]
    out = []
    for _ in range(n):
        out.append(x.to(torch.bfloat16).float())
        x = x - out[-1]
    return out


def mma(a, b, na, nb):
    """a @ b as ``mma_parts``: a in na parts, b in nb parts, the product
    of parts i and j issued where i + j < max(na, nb), summed in fp32."""
    pa, pb = parts(a, na), parts(b, nb)
    out = None
    for i, x in enumerate(pa):
        for j, y in enumerate(pb):
            if i + j < max(na, nb):
                out = x @ y if out is None else out + x @ y
    return out


def part_counts(dtype):
    """(parts of an input operand, parts of a computed fp32 operand): bf16
    inputs go in as they are and fp32 values as two parts; fp32 inputs
    make every operand three parts, which carry fp32's 24 bits."""
    return (1, 2) if dtype == torch.bfloat16 else (3, 3)


def pad_chunk(t, c0, n):
    """Tokens c0 .. c0 + n of t (dim 1), then zeros up to L."""
    piece = t[:, c0:c0 + n]
    if n == L:
        return piece
    shape = list(piece.shape)
    shape[1] = L - n
    return torch.cat([piece, piece.new_zeros(shape)], dim=1)


def excl_suffix(w):
    """prod_{m > i} w_m along the last dim (1 at the end)."""
    ones = torch.ones_like(w[..., :1])
    tail = torch.flip(torch.cumprod(torch.flip(w[..., 1:], [-1]), -1), [-1])
    return torch.cat([tail, ones], -1)


def ssd_kernel_form(x, dt, B, C, A, h0=None):
    """The SSD kernel's chunk arithmetic.  x (b, s, h, 64), B, C (b, s, n)
    of one dtype; dt (b, s, h), A (h,), h0 (b, h, 64, n) fp32 or None →
    (y in x's dtype, final state fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    ni, nc = part_counts(x.dtype)
    xf, Bf, Cf, dtf, Af = (t.float() for t in (x, B, C, dt, A))
    H = (torch.zeros(b, h, p, n) if h0 is None else h0.float().clone())
    tiles = L // SSD_TILE
    ys = []
    for c0 in range(0, s, L):
        nv = min(L, s - c0)
        X = pad_chunk(xf, c0, nv).permute(0, 2, 1, 3)       # (b, h, L, p)
        dc = pad_chunk(dtf, c0, nv).permute(0, 2, 1)        # (b, h, L)
        Bc, Cc = (pad_chunk(t, c0, nv)[:, None] for t in (Bf, Cf))
        w = torch.exp(dc * Af[None, :, None])               # <= 1
        wt = w.reshape(b, h, tiles, SSD_TILE)
        a = torch.cumprod(wt, -1)                  # inclusive, in the tile
        z = excl_suffix(wt)                        # exclusive, in the tile
        T = a[..., -1]                             # tile totals (b, h, 4)
        E = torch.zeros(b, h, L, L)
        for jt in range(tiles):
            rows = slice(SSD_TILE * jt, SSD_TILE * (jt + 1))
            for it in range(jt + 1):
                cols = slice(SSD_TILE * it, SSD_TILE * (it + 1))
                if it == jt:     # D[t][s] = prod_{m = s+1}^{t} w_m, s <= t
                    D = torch.zeros(b, h, SSD_TILE, SSD_TILE)
                    for sl in range(SSD_TILE):
                        D[..., sl, sl] = 1.0
                        D[..., sl + 1:, sl] = torch.cumprod(
                            wt[..., jt, sl + 1:], -1)
                    E[..., rows, cols] = D
                else:            # a_t (totals strictly between) z_s
                    between = torch.prod(T[..., it + 1:jt], -1)
                    E[..., rows, cols] = (a[..., jt, :, None]
                                          * between[..., None, None]
                                          * z[..., it, None, :])
        G = mma(Cc, Bc.transpose(-1, -2), ni, ni)           # (b, 1, L, L)
        M = G * E * dc[:, :, None, :]
        y_intra = mma(M, X, nc, ni)
        before = torch.cumprod(torch.cat([torch.ones(b, h, 1), T[..., :-1]],
                                         -1), -1)           # tiles before
        pre = (a * before[..., None]).reshape(b, h, L)      # E(t, -1)
        y_inter = mma(Cc, H.transpose(-1, -2), ni, nc) * pre[..., None]
        ys.append((y_intra + y_inter)[:, :, :nv].permute(0, 2, 1, 3))
        after = excl_suffix(T)                              # tiles after
        wts = (z * after[..., None]).reshape(b, h, L) * dc  # E(L-1, s) dt_s
        Xw = X * wts[..., None]
        H = (H * torch.prod(T, -1)[..., None, None]
             + mma(Xw.transpose(-1, -2), Bc, nc, ni))
    y = torch.cat(ys, dim=1) if ys else xf.clone()
    return y.to(x.dtype), H


def wkv_kernel_form(r, k, v, logw, u, s0=None):
    """The WKV kernel's chunk arithmetic.  r, k, v (B, S, H, 64) of one
    dtype; logw (B, S, H, 64), u (H, 64), s0 (B, H, 64, 64) fp32 or None
    → (y in r's dtype, final state fp32)."""
    b, s, h, kd = r.shape
    ni, nc = part_counts(r.dtype)
    rf, kf, vf, lwf = (t.float() for t in (r, k, v, logw))
    uf = u.float()
    S = (torch.zeros(b, h, kd, kd) if s0 is None else s0.float().clone())
    nb = L // WKV_BLOCK
    ys = []
    for c0 in range(0, s, L):
        nv = min(L, s - c0)
        R, K, V, LW = (pad_chunk(t, c0, nv).permute(0, 2, 1, 3)
                       for t in (rf, kf, vf, lwf))          # (b, h, L, K)
        w = torch.exp(LW)                                   # <= 1
        wb = w.reshape(b, h, nb, WKV_BLOCK, kd)
        ones = torch.ones_like(wb[..., :1, :])
        a = torch.cat([ones, torch.cumprod(wb[..., :-1, :], -2)], -2)
        z = torch.flip(torch.cat([ones, torch.cumprod(
            torch.flip(wb[..., 1:, :], [-2]), -2)], -2), [-2])
        T = torch.prod(wb, -2)                              # (b, h, 8, K)
        rd = R * a.reshape(b, h, L, kd)
        kz = K * z.reshape(b, h, L, kd)
        att = torch.zeros(b, h, L, L)
        for blk in range(nb):            # in-block part, summed in fp32
            for sl in range(WKV_BLOCK):
                si = WKV_BLOCK * blk + sl
                att[..., si, si] = (R[..., si, :] * uf * K[..., si, :]).sum(-1)
                q = K[..., si, :].clone()
                for ti in range(si + 1, WKV_BLOCK * (blk + 1)):
                    att[..., ti, si] = (R[..., ti, :] * q).sum(-1)
                    q = q * w[..., ti, :]
        for jj in range(L // 16):        # between blocks, tensor cores
            top = slice(16 * jj, 16 * jj + 8)
            bot = slice(16 * jj + 8, 16 * jj + 16)
            for i in range(2 * jj + 1):
                diag = i == 2 * jj
                ra = rd[..., top, :] * (0.0 if diag else 1.0)
                rb = rd[..., bot, :] * (1.0 if diag
                                        else T[..., 2 * jj, None, :])
                colf = torch.prod(T[..., i + 1:2 * jj, :], -2)
                kb = kz[..., WKV_BLOCK * i:WKV_BLOCK * (i + 1), :] \
                    * colf[..., None, :]
                piece = mma(torch.cat([ra, rb], -2), kb.transpose(-1, -2),
                            nc, nc)                     # (b, h, 16, 8)
                cols = slice(WKV_BLOCK * i, WKV_BLOCK * (i + 1))
                if diag:
                    att[..., bot, cols] = piece[..., 8:, :]
                else:
                    att[..., 16 * jj:16 * jj + 16, cols] = piece
        y_intra = mma(att, V, nc, ni)
        P = torch.cumprod(torch.cat([torch.ones_like(T[..., :1, :]),
                                     T[..., :-1, :]], -2), -2)
        rA = rd * P.repeat_interleave(WKV_BLOCK, -2)        # D(t, -1) r_t
        y_inter = mma(rA, S, nc, nc)
        ys.append((y_intra + y_inter)[:, :, :nv].permute(0, 2, 1, 3))
        Q = torch.flip(torch.cumprod(torch.cat(
            [torch.ones_like(T[..., :1, :]),
             torch.flip(T[..., 1:, :], [-2])], -2), -2), [-2])
        kZ = kz * Q.repeat_interleave(WKV_BLOCK, -2)        # D(L, s) k_s
        S = (S * torch.prod(T, -2)[..., :, None]
             + mma(kZ.transpose(-1, -2), V, nc, ni))
    y = torch.cat(ys, dim=1) if ys else rf.clone()
    return y.to(r.dtype), S


def hold(name, y, y_ref, st, st_ref, fp32_tol):
    """``chip_smoke.scan_errors``: y at one bf16 unit when bf16, else at
    fp32_tol (atol and rtol); the fp32 state at fp32_tol; all finite."""
    y_ref = torch.from_numpy(np.array(y_ref, dtype=np.float32))
    st_ref = torch.from_numpy(np.array(st_ref, dtype=np.float32))
    yf = y.float()
    assert torch.isfinite(yf).all() and torch.isfinite(st).all(), name
    if y.dtype == torch.bfloat16:
        rms = float(y_ref.pow(2).mean().sqrt())
        y_limit = BF16_REL * (y_ref.abs() + rms)
    else:
        y_limit = fp32_tol * (1 + y_ref.abs())
    y_ratio = float(((yf - y_ref).abs() / y_limit).max())
    st_ratio = float(((st - st_ref).abs()
                      / (fp32_tol * (1 + st_ref.abs()))).max())
    assert y_ratio <= 1 and st_ratio <= 1, (name, y_ratio, st_ratio)


def as_dtype(a, dtype):
    """A numpy array as a torch tensor of ``dtype`` and the fp32 numpy
    values of that tensor (what the references are fed)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    return t, t.float().numpy()


def ssd_case(b, s, h, n, seed, with_h0, a_max=16.0, dt_scale=1.0):
    """chip_smoke.py's SSD inputs: x, B, C ~ 0.5 N(0, 1), softplus'd steps
    (times dt_scale), A = -U[1, a_max)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, 64)).astype(np.float32) * 0.5
    B = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, s, n)).astype(np.float32) * 0.5
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h))))
          * dt_scale).astype(np.float32)
    A = -rng.uniform(1.0, a_max, h).astype(np.float32)
    h0 = (rng.standard_normal((b, h, 64, n)).astype(np.float32) * 0.1
          if with_h0 else None)
    return x, dt, B, C, A, h0


def wkv_case(b, s, h, seed, with_s0, dead=()):
    """chip_smoke.py's WKV inputs: r, k, v ~ 0.5 N(0, 1), logw = -exp(U[-8,
    -4) + N(0, 1)), u ~ 0.5 N(0, 1); ``dead`` lists (tokens, channels)
    slices set to logw = -1e30, whose decay must underflow to 0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, 64)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.uniform(-8.0, -4.0, (b, s, h, 64))
                   + rng.standard_normal((b, s, h, 64)))
    for toks, chans in dead:
        logw[:, toks, 0, chans] = -1e30
    u = rng.standard_normal((h, 64)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((b, h, 64, 64)).astype(np.float32) * 0.1
          if with_s0 else None)
    return r, k, v, logw.astype(np.float32), u, s0


def run_ssd(case, dtype):
    x, dt, B, C, A, h0 = case
    (xt, xn), (bt, bn), (ct, cn) = (as_dtype(t, dtype) for t in (x, B, C))
    h0t = None if h0 is None else torch.from_numpy(h0)
    y, st = ssd_kernel_form(xt, torch.from_numpy(dt), bt, ct,
                            torch.from_numpy(A), h0t)
    ry, rst = jax_ssd_ref(jnp.asarray(xn), jnp.asarray(dt), jnp.asarray(bn),
                          jnp.asarray(cn), jnp.asarray(A),
                          h0=None if h0 is None else jnp.asarray(h0))
    return y, st, ry, rst


def run_wkv(case, dtype):
    r, k, v, logw, u, s0 = case
    (rt, rn), (kt, kn), (vt, vn) = (as_dtype(t, dtype) for t in (r, k, v))
    s0t = None if s0 is None else torch.from_numpy(s0)
    y, st = wkv_kernel_form(rt, kt, vt, torch.from_numpy(logw),
                            torch.from_numpy(u), s0t)
    ry, rst = jax_wkv_ref(jnp.asarray(rn), jnp.asarray(kn), jnp.asarray(vn),
                          jnp.asarray(logw), jnp.asarray(u),
                          s0=None if s0 is None else jnp.asarray(s0))
    return y, st, ry, rst


DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


# (b, s, h, n, initial state): S = 1, S < chunk, S ragged past one and two
# chunks, S a whole number of chunks
SSD_SHAPES = [(2, 1, 3, 64, True), (1, 37, 2, 64, False),
              (1, 100, 3, 64, True), (2, 130, 2, 64, False),
              (1, 128, 2, 64, True), (1, 77, 2, 16, True),
              (1, 70, 2, 128, False)]


@pytest.mark.parametrize("b,s,h,n,with_h0", SSD_SHAPES)
@pytest.mark.parametrize("dt_name", ["bf16", "fp32"])
def test_ssd_kernel_form_matches_jax_ref(b, s, h, n, with_h0, dt_name):
    case = ssd_case(b, s, h, n, seed=s * 7 + n, with_h0=with_h0)
    y, st, ry, rst = run_ssd(case, DTYPES[dt_name])
    assert y.shape == (b, s, h, 64) and st.shape == (b, h, 64, n)
    hold(f"ssd {b, s, h, n} {dt_name}", y, ry, st, rst, SSD_TOL)


@pytest.mark.parametrize("dt_name", ["bf16", "fp32"])
def test_ssd_kernel_form_large_decays_stay_finite(dt_name):
    """A = -16 and steps up to ~15 (dt A down to ~-240 a token): every
    decay underflows to 0 in one or two tokens and none overflows; tokens
    with dt = 0 (no decay, no update) sit between them."""
    b, s, h = 1, 150, 4
    x, dt, B, C, A, h0 = ssd_case(b, s, h, 64, seed=5, with_h0=True,
                                  dt_scale=3.0)
    A[:] = -16.0
    dt[:, 40:44] = 0.0
    dt[:, 90] = 0.0
    y, st, ry, rst = run_ssd((x, dt, B, C, A, h0), DTYPES[dt_name])
    hold(f"ssd large decays {dt_name}", y, ry, st, rst, SSD_TOL)


@pytest.mark.parametrize("b,s,h,n,chunk", [(1, 64, 2, 64, 16),
                                           (2, 96, 1, 64, 32),
                                           (1, 192, 2, 64, 64)])
def test_ssd_kernel_form_matches_pallas_interpret(b, s, h, n, chunk):
    """Against the Pallas kernel run as tests/test_kernels.py runs it
    (interpret mode, a chunk that divides S, the mild decays it is safe
    with: A = -exp(U[0, 1.5)))."""
    x, dt, B, C, A, h0 = ssd_case(b, s, h, n, seed=s + n, with_h0=True)
    A = -np.exp(np.random.default_rng(7).uniform(0.0, 1.5, h)).astype(
        np.float32)
    y, st = ssd_kernel_form(*(torch.from_numpy(t)
                              for t in (x, dt, B, C, A, h0)))
    ky, kst = jax_ssd(*(jnp.asarray(t) for t in (x, dt, B, C, A)),
                      h0=jnp.asarray(h0), chunk=chunk, interpret=True)
    hold(f"ssd pallas {b, s, h, n}", y, ky, st, kst, SSD_TOL)


# (b, s, h, initial state, logw = -1e30 slices (tokens, channels))
WKV_SHAPES = [
    (2, 1, 3, True, ()),
    (1, 37, 2, False, ()),
    (1, 100, 3, True, ()),
    (2, 128, 2, False, ()),
    (1, 130, 2, True, ()),
    # -1e30 inside a chunk, away from block edges (tokens 19..21)
    (1, 100, 2, True, ((slice(19, 22), slice(0, 8)),)),
    # across a decay-block edge (tokens 6..9) and a tile edge (14..17)
    (1, 96, 2, True, ((slice(6, 10), slice(8, 24)),
                      (slice(14, 18), slice(40, 48)))),
    # across a chunk edge (tokens 62..65) and at the sequence's start
    (2, 140, 2, False, ((slice(62, 66), slice(0, 64)),
                        (slice(0, 4), slice(0, 8)))),
]


@pytest.mark.parametrize("b,s,h,with_s0,dead", WKV_SHAPES)
@pytest.mark.parametrize("dt_name", ["bf16", "fp32"])
def test_wkv_kernel_form_matches_jax_ref(b, s, h, with_s0, dead, dt_name):
    case = wkv_case(b, s, h, seed=s * 3 + b, with_s0=with_s0, dead=dead)
    y, st, ry, rst = run_wkv(case, DTYPES[dt_name])
    assert y.shape == (b, s, h, 64) and st.shape == (b, h, 64, 64)
    hold(f"wkv {b, s, h} {dead} {dt_name}", y, ry, st, rst, WKV_TOL)


@pytest.mark.parametrize("b,s,h,chunk", [(1, 64, 1, 16), (2, 96, 3, 32),
                                         (1, 128, 2, 64)])
def test_wkv_kernel_form_matches_pallas_interpret(b, s, h, chunk):
    """Against the Pallas kernel in interpret mode at tests/test_kernels.py's
    decays (logw = -exp(U[-6, -2))), where its exp(-cum) is safe."""
    r, k, v, _, u, s0 = wkv_case(b, s, h, seed=s + h, with_s0=True)
    logw = -np.exp(np.random.default_rng(b * s).uniform(
        -6.0, -2.0, (b, s, h, 64))).astype(np.float32)
    y, st = wkv_kernel_form(*(torch.from_numpy(t)
                              for t in (r, k, v, logw, u, s0)))
    ky, kst = jax_wkv(*(jnp.asarray(t) for t in (r, k, v, logw, u)),
                      s0=jnp.asarray(s0), chunk=chunk, interpret=True)
    hold(f"wkv pallas {b, s, h}", y, ky, st, kst, WKV_TOL)


def test_wkv_pallas_form_overflows_where_the_kernel_form_does_not():
    """Why the kernels factor their decays as they do: a channel whose
    decay reaches -1e30 makes the Pallas kernel's k exp(-cum) infinite,
    while the kernel form stays finite and within the limits."""
    r, k, v, logw, u, s0 = wkv_case(1, 64, 1, seed=3, with_s0=True,
                                    dead=((slice(20, 23), slice(0, 8)),))
    ky, _ = jax_wkv(*(jnp.asarray(t) for t in (r, k, v, logw, u)),
                    s0=jnp.asarray(s0), chunk=64, interpret=True)
    assert not np.isfinite(np.asarray(ky)).all()
    y, st, ry, rst = run_wkv((r, k, v, logw, u, s0), torch.float32)
    hold("wkv -1e30", y, ry, st, rst, WKV_TOL)


# layouts: every variant's block fits the card's shared memory, and the
# grid covers every (batch row, head, column part) once


@pytest.mark.parametrize("n", ssd_kernel.STATE_SIZES)
@pytest.mark.parametrize("elem", [2, 4])
def test_ssd_layout_fits_and_covers(n, elem):
    for b, h in ((1, 112), (2, 3), (4, 80)):
        lay = ssd_kernel.layout(b, h, n, elem)
        assert lay.smem == ssd_kernel.smem_bytes(n, lay.cols, elem)
        assert lay.smem <= ssd_kernel.SMEM_LIMIT
        assert lay.cols in ssd_kernel.COLS and ssd_kernel.P % lay.cols == 0
        assert lay.threads == 32 * 4 * (lay.cols // 16) <= 1024
        assert lay.blocks * lay.cols == b * h * ssd_kernel.P
    # the widest part that fits: whole heads wherever they fit
    wide = ssd_kernel.smem_bytes(n, 64, elem) <= ssd_kernel.SMEM_LIMIT
    assert ssd_kernel.layout(1, 1, n, elem).cols == (64 if wide else 32)


def test_ssd_layout_refuses_other_state_sizes():
    with pytest.raises(ValueError):
        ssd_kernel.layout(1, 2, 48, 2)


@pytest.mark.parametrize("elem", [2, 4])
def test_wkv_layout_fits_and_covers(elem):
    for b, h in ((2, 32), (1, 3)):
        lay = wkv_kernel.layout(b, h, elem)
        assert lay.smem == wkv_kernel.smem_bytes(elem) <= wkv_kernel.SMEM_LIMIT
        assert lay.threads == 32 * 4 * (lay.cols // 16)
        assert lay.blocks * lay.cols == b * h * wkv_kernel.K
