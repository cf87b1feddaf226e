"""The port's host copy of the JAX random stream (``core/prng.py``) against
``jax.random`` itself: ``split``, the scalar ``uniform`` and ``choice``
with a probability vector, bit for bit over a few hundred keys and masks.
The port copies the partitionable Threefry form, so these tests skip
where the installed jax runs the other one."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.core import prng
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = [
    pytest.mark.port,
    pytest.mark.skipif(not jax.config.jax_threefry_partitionable,
                       reason="the port reproduces jax's partitionable "
                              "Threefry stream; this jax runs the other"),
]

N_KEYS = 300


def _keys(seed: int, n: int = N_KEYS) -> np.ndarray:
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64)
    keys = keys.astype(np.uint32)
    keys[:4] = [[0, 0], [0, 7], [2 ** 32 - 1, 2 ** 32 - 1], [1, 0]]
    return keys


@pytest.mark.parametrize("n", [2, 3, 5])
def test_split_bit_equal(n):
    keys = _keys(n)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.split(k, n)))(
        jnp.asarray(keys)))
    got = np.stack([prng.split(k, n) for k in keys])
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_key_chain_follows_jax():
    """A key advanced 200 times by ``split(key)[0]`` (the batched LinUCB
    step) and 200 times by ``split(key, 3)[0]`` (the ε-greedy row)."""
    for n in (2, 3):
        jk, pk = jax.random.PRNGKey(11), np.array([0, 11], np.uint32)
        np.testing.assert_array_equal(pk, np.asarray(jk))
        for _ in range(200):
            jk = jax.random.split(jk, n)[0]
            pk = prng.split(pk, n)[0]
        np.testing.assert_array_equal(pk, np.asarray(jk))


def test_uniform_bit_equal():
    keys = _keys(1)
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(k)))(
        jnp.asarray(keys)), np.float32)
    got = np.array([prng.uniform(k) for k in keys], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


def _masks(seed: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dens = rng.random((N_KEYS, 1))
    masks = rng.random((N_KEYS, m)) < dens
    masks[0] = False                       # nothing feasible
    masks[1] = True                        # everything
    masks[2] = np.arange(m) == m - 1       # one arm, the last
    return masks


@pytest.mark.parametrize("m", [15, 16, 32, 64])
def test_choice_bit_equal(m):
    """``choice(k, M, p=mask / max(sum(mask), 1))`` as the ε-greedy
    policies call it: the bool mask divided by an int32 count (float32 in
    jnp), the float32 cumulative sum and its search."""
    keys, masks = _keys(100 + m), _masks(m, m)

    def jax_choice(k, mask):
        probs = mask / jnp.maximum(jnp.sum(mask), 1)
        return jax.random.choice(k, mask.shape[0], p=probs)

    want = np.asarray(jax.jit(jax.vmap(jax_choice))(jnp.asarray(keys),
                                                    jnp.asarray(masks)))
    got = np.array([
        prng.choice(k, m, mask.astype(np.float32)
                    / np.float32(max(int(mask.sum()), 1)))
        for k, mask in zip(keys, masks)])
    np.testing.assert_array_equal(got, want)
    live = masks[3:].any(axis=1)
    assert masks[3:][live][np.arange(live.sum()), got[3:][live]].all()


def test_choice_refuses_a_mismatched_p():
    with pytest.raises(ValueError):
        prng.choice(np.array([0, 1], np.uint32), 4, np.ones(3, np.float32))
