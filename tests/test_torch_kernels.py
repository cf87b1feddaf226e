"""The PyTorch port's router kernels on the CPU: the plain versions (what the
wrappers run for CPU tensors) against the JAX package's jnp oracles and its
Pallas kernels in interpret mode, over the shapes the serving path sees
plus padding, empty rows and 1-D contexts.  Tolerances are those of
tests/test_kernels.py: featurize 1e-5, LinUCB 1e-4."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.featurize.ops import hashed_embed as jax_hashed_embed
from repro.kernels.featurize.ref import hashed_embed_ref as jax_featurize_ref
from repro.kernels.linucb.ops import linucb_scores as jax_linucb_scores
from repro.kernels.linucb.ref import linucb_scores_ref as jax_linucb_ref
from repro_torch.core.bandits import NEG_INF
from repro_torch.kernels.featurize import ops as featurize_ops
from repro_torch.kernels.featurize.ref import hashed_embed_ref
from repro_torch.kernels.linucb import ops as linucb_ops
from repro_torch.kernels.linucb.ref import linucb_scores_ref

pytestmark = pytest.mark.port


def _featurize_inputs(q, l, h, d, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, h, (q, l)).astype(np.int32)
    lens = rng.integers(0, l + 1, (q, 1))
    lens[0] = 0                                   # an empty row
    mask = np.arange(l)[None, :] < lens
    ids = np.where(mask, ids, -1).astype(np.int32)
    # the router's weights (word 1.0, trigram 0.5, bigram 0.75)
    weights = np.where(mask, rng.choice([0.5, 0.75, 1.0], (q, l)),
                       0.0).astype(np.float32)
    proj = (rng.standard_normal((h, d)) / np.sqrt(h)).astype(np.float32)
    return ids, weights, proj, lens[:, 0] == 0


@pytest.mark.parametrize("q,l,h,d", [
    (1, 5, 256, 128),          # one query, short row
    (7, 37, 512, 128),         # non-power-of-two Q/L: pad + slice
    (16, 130, 2048, 384),      # serving widths, L padded past 128
    (12, 200, 2048, 384),
])
def test_featurize_plain_matches_jax(q, l, h, d):
    ids, weights, proj, empty = _featurize_inputs(q, l, h, d, seed=q + l)
    out = featurize_ops.hashed_embed(torch.from_numpy(ids),
                                     torch.from_numpy(weights),
                                     torch.from_numpy(proj)).numpy()
    ref = np.asarray(jax_featurize_ref(jnp.asarray(ids), jnp.asarray(weights),
                                       jnp.asarray(proj)))
    kern = np.asarray(jax_hashed_embed(jnp.asarray(ids), jnp.asarray(weights),
                                       jnp.asarray(proj), interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=1e-5)
    norms = np.linalg.norm(out, axis=1)
    np.testing.assert_allclose(norms[~empty], 1.0, atol=1e-5)
    assert np.all(out[empty] == 0.0)


def test_featurize_ids_past_hash_dim_clip_like_jax():
    """Ids at or past hash_dim match no bucket, as in the Pallas kernel the
    port replaces (its one-hot never matches them): the result equals the
    row with those ids turned into padding.  The JAX jnp oracle clips them
    into the last bucket instead; the port follows the kernel."""
    ids = np.array([[0, 5, 300, 999, -1], [255, 256, -1, -1, -1]], np.int32)
    weights = np.array([[1.0, 0.5, 0.75, 1.0, 1.0],
                        [0.5, 1.0, 1.0, 1.0, 1.0]], np.float32)
    proj = np.random.default_rng(0).standard_normal((256, 16)).astype(
        np.float32)
    out = hashed_embed_ref(torch.from_numpy(ids), torch.from_numpy(weights),
                           torch.from_numpy(proj)).numpy()
    kern = np.asarray(jax_hashed_embed(jnp.asarray(ids), jnp.asarray(weights),
                                       jnp.asarray(proj), interpret=True))
    padded = np.where(ids < 256, ids, -1).astype(np.int32)
    ref = np.asarray(jax_featurize_ref(jnp.asarray(padded),
                                       jnp.asarray(weights),
                                       jnp.asarray(proj)))
    np.testing.assert_allclose(out, kern, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def _linucb_inputs(m, d, q, seed):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((m, d, d)).astype(np.float32) * 0.2
    a_inv = (np.einsum("mij,mkj->mik", low, low)
             + np.eye(d, dtype=np.float32)[None]).astype(np.float32)
    theta = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((q, d)).astype(np.float32)
    return a_inv, theta, x


@pytest.mark.parametrize("m,d,q,alpha", [
    (64, 12, 1, 0.1), (64, 12, 16, 0.1), (64, 12, 64, 0.1),   # serving
    (16, 12, 7, 0.1), (8, 64, 50, 0.5),                       # Q padding
    (64, 128, 128, 0.1),                                      # wide d
])
def test_linucb_plain_matches_jax(m, d, q, alpha):
    a_inv, theta, x = _linucb_inputs(m, d, q, seed=m + d + q)
    out = linucb_ops.linucb_scores(torch.from_numpy(a_inv),
                                   torch.from_numpy(theta),
                                   torch.from_numpy(x), alpha).numpy()
    ref = np.asarray(jax_linucb_ref(jnp.asarray(a_inv), jnp.asarray(theta),
                                    jnp.asarray(x), alpha))
    kern = np.asarray(jax_linucb_scores(jnp.asarray(a_inv),
                                        jnp.asarray(theta), jnp.asarray(x),
                                        alpha, interpret=True))
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(out, kern, atol=1e-4, rtol=1e-4)


def test_linucb_one_dim_context_returns_per_arm_scores():
    a_inv, theta, x = _linucb_inputs(16, 12, 1, seed=3)
    out = linucb_ops.linucb_scores(torch.from_numpy(a_inv),
                                   torch.from_numpy(theta),
                                   torch.from_numpy(x[0]), 0.1).numpy()
    ref = np.asarray(jax_linucb_scores(jnp.asarray(a_inv), jnp.asarray(theta),
                                       jnp.asarray(x[0]), 0.1,
                                       interpret=True))
    assert out.shape == ref.shape == (16,)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_linucb_negative_quadratic_form_clamps_to_zero():
    """A (numerically) indefinite A⁻¹ gives var < 0; both packages clamp
    at 0 before the square root, so the score is the mean alone."""
    a_inv = -np.eye(4, dtype=np.float32)[None]
    theta = np.ones((1, 4), np.float32)
    x = np.ones((2, 4), np.float32)
    out = linucb_scores_ref(torch.from_numpy(a_inv), torch.from_numpy(theta),
                            torch.from_numpy(x), 0.5).numpy()
    ref = np.asarray(jax_linucb_ref(jnp.asarray(a_inv), jnp.asarray(theta),
                                    jnp.asarray(x), 0.5))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.full((2, 1), 4.0, np.float32))


def test_cpu_wrappers_never_count_a_launch():
    featurize_ops.launches = linucb_ops.launches = 0
    ids, weights, proj, _ = _featurize_inputs(4, 20, 256, 32, seed=1)
    featurize_ops.hashed_embed(torch.from_numpy(ids),
                               torch.from_numpy(weights),
                               torch.from_numpy(proj))
    a_inv, theta, x = _linucb_inputs(8, 12, 4, seed=1)
    linucb_ops.linucb_scores(torch.from_numpy(a_inv), torch.from_numpy(theta),
                             torch.from_numpy(x), 0.1)
    assert featurize_ops.launches == 0 and linucb_ops.launches == 0


def test_wrappers_reject_mixed_devices():
    with pytest.raises(ValueError):
        linucb_ops.linucb_scores(torch.zeros(2, 3, 3), torch.zeros(2, 3),
                                 torch.zeros(1, 3, device="meta"), 0.1)


@pytest.mark.parametrize("case", ["all_masked", "real_ties", "mixed"])
def test_argmax_ties_go_to_lowest_index_like_jnp(case):
    """The routing argmax: torch.argmax returns the first maximal index,
    as jnp.argmax does — for all-masked padding rows and for real ties."""
    m = 8
    scores = np.full((3, m), 0.25, np.float32)
    if case == "all_masked":
        scores[:] = NEG_INF
    elif case == "real_ties":
        scores[0, [2, 5]] = 1.0
        scores[1, [1, 3, 7]] = 0.5
        scores[2, :] = 0.5
    else:
        scores[0, :3] = NEG_INF
        scores[0, [4, 6]] = 0.9
        scores[1, [0, 7]] = NEG_INF
        scores[2, [3, 4, 5]] = 2.0
    got = torch.argmax(torch.from_numpy(scores), dim=1).numpy()
    ref = np.asarray(jnp.argmax(jnp.asarray(scores), axis=1))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.argmax(scores, axis=1))
