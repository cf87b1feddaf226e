"""The port's other policies on the CPU against the JAX package, on the
same inputs: ``core/prng.py``'s normal and shaped uniform against
``jax.random`` bit for bit (the normal over every uniform it can draw),
contextual Thompson sampling's and the Cholesky mode's scores at
``tests/test_bandits.py``'s 2e-4, their decisions and keys through
``route`` and ragged ``route_batch`` calls at T = 150, the
``ctx-thompson`` row at T = 750, and a JAX CTS state continuing its
stream in the port."""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from benchmarks import common as jax_common
from repro.core import bandits as jax_bandits
from repro.core.bandits import BanditPolicy as JaxBanditPolicy
from repro.core.types import Feedback as JaxFeedback
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro_torch.benchmarks import baselines, common
from repro_torch.core import bandits, prng
from repro_torch.core.bandits import BanditPolicy
from repro_torch.core.types import Feedback, RouterConfig
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

POLICIES = {"cts": dict(algorithm="cts"),
            "linucb-cholesky": dict(algorithm="linucb",
                                    solve_mode="cholesky")}
TOL = 2e-4                            # tests/test_bandits.py's tolerance


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def test_normal_bit_equal_over_every_uniform():
    """The uniform on [nextafter(-1, 0), 1) takes 2^23 values; each goes
    through the port's erf_inv and jax's (as ``jax.random.normal``
    applies it) to the same float32, bit for bit."""
    lo = np.nextafter(np.float32(-1), np.float32(0))

    @jax.jit
    def jax_normal(bits):
        f = jax.lax.bitcast_convert_type(
            (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32)
        u = jax.lax.max(jnp.float32(lo),
                        (f - 1) * (jnp.float32(1) - jnp.float32(lo))
                        + jnp.float32(lo))
        return jnp.float32(np.sqrt(2)) * jax.lax.erf_inv(u)

    chunk = 1 << 20
    for start in range(0, 1 << 23, chunk):
        bits = (np.arange(start, start + chunk, dtype=np.uint32)
                << np.uint32(9))
        want = np.asarray(jax_normal(jnp.asarray(bits)))
        f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
        u = np.maximum(lo, prng.fma(f - np.float32(1), np.float32(2), lo))
        got = np.float32(np.sqrt(2)) * prng.erf_inv(u)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape", [(), (5,), (32, 12), (16, 12), (3, 4, 5)])
def test_normal_and_uniform_bit_equal(shape):
    key = jax.random.PRNGKey(11)
    for _ in range(12):
        key, k = jax.random.split(key)
        kn = np.asarray(k)
        np.testing.assert_array_equal(
            _bits(prng.normal(kn, shape)),
            _bits(jax.random.normal(k, shape)))
        np.testing.assert_array_equal(
            _bits(prng.uniform(kn, shape)),
            _bits(jax.random.uniform(k, shape)))
        for lo, hi in ((-0.3, 1.7), (0.1, 0.37), (-5.0, 3.3)):
            np.testing.assert_array_equal(
                _bits(prng.uniform(kn, shape, lo, hi)),
                _bits(jax.random.uniform(k, shape, minval=lo, maxval=hi)))


def test_normal_of_a_key_stack_is_each_keys_draws():
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4), 7))
    got = prng.normal(keys, (32, 12))
    assert got.shape == (7, 32, 12)
    for k, g in zip(keys, got):
        np.testing.assert_array_equal(_bits(g), _bits(
            jax.random.normal(jnp.asarray(k), (32, 12))))


def test_log1p_bit_equal_on_its_domain():
    rng = np.random.default_rng(0)
    x = np.concatenate([-rng.random(200_000, np.float32),
                        rng.random(50_000, np.float32) * 0.5,
                        np.float32([0.0, -0.0, -0.41421354, 0.41421354])])
    np.testing.assert_array_equal(
        _bits(prng.log1p(x)), _bits(jax.jit(jnp.log1p)(x)))


def _states(seed: int, updates: int = 40):
    """The same seeded posterior in both packages (M = 8, d = 12)."""
    cfg = dict(max_arms=8, seed=seed)
    jp = JaxBanditPolicy(JaxRouterConfig(**cfg), n_arms=6)
    pp = BanditPolicy(RouterConfig(**cfg), n_arms=6, device="cpu")
    rng = np.random.default_rng(seed)
    d = RouterConfig().context_dim
    for _ in range(updates):
        x = (rng.random(d) < 0.4).astype(np.float32)
        x[-1] = 1.0
        a, r = int(rng.integers(6)), float(rng.normal())
        jp.update(a, x, r)
        pp.update(a, x, r)
    return jp, pp, rng


def test_thompson_scores_match_jax():
    jp, pp, rng = _states(1)
    d = RouterConfig().context_dim
    X = (rng.random((5, d)) < 0.4).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(9), 5))
    want = np.stack([np.asarray(jax_bandits.thompson_scores(
        jp.state, jnp.asarray(x), 0.5, jnp.asarray(k)))
        for x, k in zip(X, keys)])
    z = prng.normal(keys, tuple(pp.state.theta.shape))
    got = bandits.thompson_scores(pp.state, torch.from_numpy(X),
                                  torch.from_numpy(z), 0.5).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cholesky_linucb_scores_match_jax_and_sherman_morrison():
    jp, pp, rng = _states(2)
    d = RouterConfig().context_dim
    X = (rng.random((6, d)) < 0.4).astype(np.float32)
    want = np.stack([np.asarray(jax_bandits.linucb_scores(
        jp.state, jnp.asarray(x), 1.0, "cholesky")) for x in X])
    got = bandits.linucb_scores_cholesky(pp.state, torch.from_numpy(X),
                                         1.0).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    sm = bandits.linucb_scores_batch(pp.state, torch.from_numpy(X),
                                     1.0).numpy()
    np.testing.assert_allclose(got, sm, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_batched_selection_draws_and_key_bit_equal(name):
    """Ragged batches (Q = 1, 3, 5, 6: the JAX package pads its scan to a
    power of two with rows that never advance the key) and Q sequential
    selections: the same arms and key after every batch as the JAX
    package's scan and its sequential ``select``."""
    kw = dict(max_arms=8, seed=3, cts_sigma=0.3, **POLICIES[name])
    jb = JaxBanditPolicy(JaxRouterConfig(**kw), n_arms=6)
    js = JaxBanditPolicy(JaxRouterConfig(**kw), n_arms=6)
    pb = BanditPolicy(RouterConfig(**kw), n_arms=6, device="cpu")
    ps = BanditPolicy(RouterConfig(**kw), n_arms=6, device="cpu")
    rng = np.random.default_rng(0)
    d = RouterConfig().context_dim
    for _ in range(25):
        q = int(rng.choice([1, 3, 5, 6]))
        X = (rng.random((q, d)) < 0.4).astype(np.float32)
        X[:, -1] = 1.0
        F = rng.random((q, 6)) < 0.7
        F[0] = False                       # a row with no feasible arm
        ja, jm = jb.select_batch(X, F)
        pa, pm = pb.select_batch(X, F)
        np.testing.assert_array_equal(pa, ja)
        np.testing.assert_allclose(pm, jm, rtol=TOL, atol=TOL)
        seq = [(js.select(x, f)[0], ps.select_batch(x[None], f[None])[0][0])
               for x, f in zip(X, F)]
        assert [a for a, _ in seq] == [b for _, b in seq] == list(ja)
        for pol in (jb, js, pb, ps):
            np.testing.assert_array_equal(pol.state_dict()["key"],
                                          jb.state_dict()["key"])
        for a, x in zip(ja, X):
            r = float(rng.normal())
            for pol in (jb, js, pb, ps):
                pol.update(int(a), x, r)


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_run_policy_trace_and_key_identical_to_jax(name):
    """T = 150 through ``route()``: the same arms, outcomes and key."""
    kw = POLICIES[name]
    jq, pq = jax_common.stream(per_task=30), common.stream(per_task=30)
    jr = jax_common.make_router(lam=0.4, algorithm=kw["algorithm"], seed=0)
    pr = common.make_router(lam=0.4, algorithm=kw["algorithm"], seed=0,
                            device="cpu")
    for r in (jr, pr):
        r.config.solve_mode = kw.get("solve_mode", "sherman_morrison")
    assert not pr._device_featurize_active()
    want = jax_common.run_policy(jr, jq, jax_common.OutcomeSimulator(7), name)
    got = common.run_policy(pr, pq, common.OutcomeSimulator(7), name)
    np.testing.assert_array_equal(got.selection_trace, want.selection_trace)
    assert got.mean_accuracy == want.mean_accuracy
    assert got.total_energy_wh == want.total_energy_wh
    assert got.cumulative_regret == pytest.approx(want.cumulative_regret,
                                                  abs=1e-9)
    np.testing.assert_array_equal(pr.policy.state_dict()["key"],
                                  jr.policy.state_dict()["key"])


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_route_batch_ragged_identical_to_jax(name):
    """T = 150 in ragged ``route_batch`` calls with batched feedback."""
    kw = POLICIES[name]
    jr = jax_common.make_router(lam=0.4, algorithm=kw["algorithm"], seed=1)
    pr = common.make_router(lam=0.4, algorithm=kw["algorithm"], seed=1,
                            device="cpu")
    for r in (jr, pr):
        r.config.solve_mode = kw.get("solve_mode", "sherman_morrison")
    stream = common.stream(per_task=30, seed=5)
    sim = common.OutcomeSimulator(3)
    i, sizes = 0, [1, 7, 3, 16, 5, 2]
    while i < len(stream):
        qs = stream[i:i + sizes[i % len(sizes)]]
        i += len(qs)
        want = [d.model_index for d in jr.route_batch(
            [JaxQuery(uid=q.uid, text=q.text) for q in qs])]
        assert [d.model_index for d in pr.route_batch(qs)] == want
        out = [sim(q, pr.pool.names[a]) for q, a in zip(qs, want)]
        jr.feedback_batch([JaxFeedback(
            query_uid=q.uid, model_index=a, accuracy=o[0], energy_wh=o[1],
            latency_ms=o[2]) for q, a, o in zip(qs, want, out)])
        pr.feedback_batch([Feedback(
            query_uid=q.uid, model_index=a, accuracy=o[0], energy_wh=o[1],
            latency_ms=o[2]) for q, a, o in zip(qs, want, out)])
    np.testing.assert_array_equal(pr.policy.state_dict()["key"],
                                  jr.policy.state_dict()["key"])


def test_ctx_thompson_row_at_t750():
    """The JAX package's own row from ``run_policy`` at T = 750:
    accuracy 0.649612, 44.631218 Wh, regret 25.027433."""
    r = baselines.run(per_task=150, rows=["ctx-thompson"],
                      device="cpu")["ctx-thompson"]
    assert r.mean_accuracy == pytest.approx(0.649612, abs=1e-6)
    assert r.total_energy_wh == pytest.approx(44.631218, abs=1e-6)
    assert r.cumulative_regret == pytest.approx(25.027433, abs=1e-6)


def test_jax_cts_state_continues_its_stream():
    """A JAX CTS router's ``state_dict`` loaded into the port routes the
    next queries as the JAX router does, and leaves the same key."""
    stream = common.stream(per_task=12, seed=8)
    jr = jax_common.make_router(lam=0.4, algorithm="cts", seed=2)
    sim = common.OutcomeSimulator(5)
    for q in stream[:30]:
        d = jr.route(JaxQuery(uid=q.uid, text=q.text))
        o = sim(q, jr.pool.names[d.model_index])
        jr.feedback(JaxFeedback(query_uid=q.uid, model_index=d.model_index,
                                accuracy=o[0], energy_wh=o[1],
                                latency_ms=o[2]))
    pr = common.make_router(lam=0.4, algorithm="cts", seed=7, device="cpu")
    pr.load_state_dict(jr.state_dict())
    for q in stream[30:]:
        want = jr.route(JaxQuery(uid=q.uid, text=q.text)).model_index
        assert pr.route(q).model_index == want
        o = sim(q, pr.pool.names[want])
        jr.feedback(JaxFeedback(query_uid=q.uid, model_index=want,
                                accuracy=o[0], energy_wh=o[1],
                                latency_ms=o[2]))
        pr.feedback(Feedback(query_uid=q.uid, model_index=want,
                             accuracy=o[0], energy_wh=o[1], latency_ms=o[2]))
    np.testing.assert_array_equal(pr.policy.state_dict()["key"],
                                  jr.policy.state_dict()["key"])
