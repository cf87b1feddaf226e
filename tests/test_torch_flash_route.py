"""The flash-attention kernel's route and the exact mask probes.

``kernel.route`` picks the tensor-core kernel for bf16 at hd a multiple of
8 up to 256 and the scalar one for everything else, before the launch.
The card check (``chip_smoke.py``) holds both routes against the port's
plain version on probe inputs where the arithmetic is exact: q = 0, so
every visible key gets p = 1, and v small integers, so the output is the
mean of the visible rows of v rounded once.  The tests here pin that
semantics on the CPU: the port's plain version (what its wrapper runs for
CPU tensors) and the Pallas kernel in interpret mode give that mean
exactly on every row, a row that sees nothing included (0).  The jnp
oracle normalizes p before the product with v, so it gives the mean
exactly only where the visible count is a power of two; it is held
exactly there (its other rows are held at tolerance by
``tests/test_torch_prefill.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro_torch.kernels.flash_attention import kernel, ops

pytestmark = pytest.mark.port


@pytest.mark.parametrize("dtype,hd,want", [
    *[(torch.bfloat16, hd, "wgmma") for hd in (24, 64, 112, 120, 128, 256)],
    *[(torch.bfloat16, hd, "scalar") for hd in (20, 100)],
    *[(torch.float32, hd, "scalar") for hd in (128, 256)],
])
def test_route(dtype, hd, want):
    assert kernel.route(dtype, hd) == want


def _probe(b, sq, sk, hq, hk, hd, seed):
    """q = 0, k random, v integers in [-4, 4]: fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (np.zeros((b, sq, hq, hd), np.float32),
            rng.standard_normal((b, sk, hk, hd)).astype(np.float32),
            rng.integers(-4, 5, (b, sk, hk, hd)).astype(np.float32))


def _visible_mean(v, hq, sq, window, causal):
    """(B, Sq, Hq, hd): the fp32 mean of the visible rows of v (sums of
    small integers are exact), 0 where nothing is visible; and the visible
    count per query position."""
    b, sk, hk, hd = v.shape
    q_pos = np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    mask = k_pos > q_pos - window
    if causal:
        mask &= k_pos <= q_pos
    n = mask.sum(axis=1)
    sums = np.einsum("qk,bkhd->bqhd", mask.astype(np.float32), v)
    mean = np.where(n[None, :, None, None] > 0,
                    sums / np.maximum(n, 1).astype(np.float32)[None, :, None,
                                                               None],
                    np.float32(0)).astype(np.float32)
    return np.repeat(mean, hq // hk, axis=2), n


# (b, sq, sk, hq, hk, hd, window, causal): the card's probe families at a
# small size — a window across a causal diagonal with ragged ends, a
# non-causal window with Sk > Sq, trailing rows that see nothing, and full
# causal attention
PROBES = [
    (1, 33, 33, 4, 2, 40, 7, True),
    (1, 20, 33, 2, 1, 24, 15, False),
    (1, 33, 13, 2, 2, 16, 4, False),
    (2, 16, 16, 2, 2, 8, 16, True),
]


@pytest.mark.parametrize("b,sq,sk,hq,hk,hd,win,causal", PROBES)
def test_probe_gives_the_visible_mean_exactly(b, sq, sk, hq, hk, hd, win,
                                              causal):
    q, k, v = _probe(b, sq, sk, hq, hk, hd, seed=sq + hd)
    want, n = _visible_mean(v, hq, sq, win, causal)
    assert (n == 0).any() == (sq > sk + win - 1 and not causal)

    port = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               win, causal=causal).numpy()
    np.testing.assert_array_equal(port, want)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(jax_flash(jq, jk, jv, window=win, chunk=16,
                                  causal=causal, interpret=True))
    np.testing.assert_array_equal(pallas, want)

    oracle = np.asarray(jax_attn_ref(jq, jk, jv, window=win, causal=causal))
    pow2 = (n > 0) & ((n & (n - 1)) == 0)
    assert pow2.any()
    np.testing.assert_array_equal(oracle[:, pow2], want[:, pow2])


def test_cpu_path_counts_no_launch():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _probe(1, 8, 8, 2, 2, 64, seed=0))
    before = (ops.launches, ops.wgmma_launches)
    ops.flash_attention(q, k, v, 8)
    assert (ops.launches, ops.wgmma_launches) == before
