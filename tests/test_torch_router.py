"""The PyTorch port's routing loop on the CPU against the JAX package:
embedding features, the projection and the classifier's initial weights
bit for bit; the k-means scan, the Sherman–Morrison state and routing
decisions (labels, clusters, bins, arms) exactly, on both featurize
paths, from the same loaded state."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core.bandits import BanditPolicy as JaxBanditPolicy
from repro.core.context import ContextGenerator as JaxContextGenerator
from repro.core.context import kmeans_assign_batch as jax_kmeans_assign_batch
from repro.core.context import kmeans_update_scan as jax_kmeans_update_scan
from repro.core.embedding import EmbeddingModel as JaxEmbeddingModel
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Feedback as JaxFeedback
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data.stream import labeled_sample, make_stream
from repro_torch.core.bandits import BanditPolicy, init_state
from repro_torch.core.context import (ContextGenerator, OnlineKMeans,
                                      TaskClassifier,
                                      flesch_score_bin_device,
                                      kmeans_assign_batch,
                                      kmeans_update_scan)
from repro_torch.core.embedding import EmbeddingModel
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query, RouterConfig

pytestmark = pytest.mark.port

TEXTS = [
    "Answer the question.\nWhat is the boiling point of water?",
    " ",                                        # no features at all
    "héllo wörld — naïve café über straße",     # non-ASCII
    "x" * 300,                                  # one long token
    "the the the the the the",                  # duplicate features
    "Solve step by step.\n17 apples shared among 4 children leaves",
]


def test_embedding_features_and_projection_bit_equal():
    jm, pm = JaxEmbeddingModel(), EmbeddingModel()
    np.testing.assert_array_equal(pm._proj, jm._proj)
    j_ids, j_w = jm.hashed_features(TEXTS)
    p_ids, p_w = pm.hashed_features(TEXTS)
    np.testing.assert_array_equal(p_ids, j_ids)
    np.testing.assert_array_equal(p_w, j_w)
    np.testing.assert_array_equal(pm.encode_batch(TEXTS),
                                  jm.encode_batch(TEXTS))
    # the device path (the plain version on the CPU) within 1e-5
    np.testing.assert_allclose(pm.encode_batch_device(TEXTS, "cpu"),
                               jm.encode_batch(TEXTS), atol=1e-5)


def test_classifier_initial_weights_and_flesch_bins_bit_equal():
    cfg = RouterConfig(seed=7)
    jctx = JaxContextGenerator(JaxRouterConfig(seed=7))
    pctx = ContextGenerator(cfg, device="cpu")
    np.testing.assert_array_equal(pctx.task_classifier.w.numpy(),
                                  np.asarray(jctx.task_classifier.w))
    texts = [q.text for q in make_stream(per_task=4, seed=3)] + TEXTS
    host = [pctx.complexity(t) for t in texts]
    assert host == [jctx.complexity(t) for t in texts]
    counts = torch.from_numpy(pctx.complexity_counts_batch(texts))
    scores, bins = flesch_score_bin_device(
        counts, torch.tensor(np.float32(pctx.complexity.lo)),
        torch.tensor(pctx.complexity.bin_width32), cfg.n_complexity_bins)
    assert [b for _, b in host] == bins.tolist()
    np.testing.assert_array_equal(scores.numpy(),
                                  np.asarray([s for s, _ in host], np.float32))


def test_kmeans_scan_equals_jax():
    rng = np.random.default_rng(0)
    embs = rng.standard_normal((40, 16)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    embs[7] = embs[0]                      # exact duplicate (seed dedup)
    embs[11] = 0.0                         # zero embedding
    valid = np.arange(40) < 37             # padding rows at the end
    k = 3
    args = (np.zeros((k, 16), np.float32), np.zeros(k, np.float32),
            np.int32(0), embs, valid)
    jc, jn, ji, jcl = jax_kmeans_update_scan(*(jnp.asarray(a) for a in args))
    pc, pn, pi, pcl = kmeans_update_scan(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(pcl.numpy(), np.asarray(jcl))
    assert int(pi) == int(ji)
    np.testing.assert_array_equal(pn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=1e-6)
    # and the device rows replay the host Eq. 10 updates
    km, km_dev = OnlineKMeans(k, 16, "cpu"), OnlineKMeans(k, 16, "cpu")
    host = [km.update(e) for e in embs[:37]]
    assert host == pcl.numpy()[:37].tolist()
    assert host == km_dev.update_batch_device(embs[:37]).tolist()
    np.testing.assert_array_equal(km.counts, km_dev.counts)
    # read-only assignment over the final centroids
    probe = rng.standard_normal((9, 16)).astype(np.float32)
    got = kmeans_assign_batch(pc, pi, torch.from_numpy(probe)).numpy()
    ref = np.asarray(jax_kmeans_assign_batch(jc, ji, jnp.asarray(probe)))
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [km.assign(e) for e in probe]


def test_sherman_morrison_state_after_random_stream():
    cfg_kw = dict(max_arms=8, lambda_reg=0.05)
    jp = JaxBanditPolicy(JaxRouterConfig(**cfg_kw), n_arms=5)
    pp = BanditPolicy(RouterConfig(**cfg_kw), n_arms=5, device="cpu")
    rng = np.random.default_rng(1)
    d = RouterConfig().context_dim
    for _ in range(60):
        arm = int(rng.integers(0, 5))
        x = (rng.random(d) < 0.4).astype(np.float32)
        x[-1] = 1.0
        r = float(rng.normal())
        jp.update(arm, x, r)
        pp.update(arm, x, r)
    js, ps = jp.state_dict(), pp.state_dict()
    for name in ("A", "A_inv", "b", "theta", "reward_sum", "counts", "eps"):
        np.testing.assert_allclose(ps[name], js[name], atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert int(ps["t"]) == int(js["t"]) == 60
    np.testing.assert_array_equal(ps["active"], js["active"])


def _profiles(n, cls):
    return [cls(name=f"m{i}", family="t", params_b=float(i + 1),
                ms_per_token=float(i + 1), prefill_ms=10.0) for i in range(n)]


def _jax_router(featurize="host"):
    return JaxRouter(JaxRouterConfig(max_arms=16, featurize=featurize,
                                     energy_scale_wh=0.3),
                     JaxModelPool(_profiles(4, JaxModelProfile)))


def _port_router(featurize="host"):
    return GreenServRouter(RouterConfig(max_arms=16, featurize=featurize,
                                        energy_scale_wh=0.3),
                           ModelPool(_profiles(4, ModelProfile)), device="cpu")


def _outcome(uid, arm):
    return 0.2 + 0.25 * ((uid + arm) % 3), 0.01 * (arm + 1) + 0.001 * (uid % 5)


@pytest.fixture(scope="module")
def warmed_jax_state():
    """A JAX router with a fitted classifier, warmed on a stream: its
    ``state_dict`` is the common starting point of every parity run."""
    r = _jax_router("host")
    texts, labels = labeled_sample(n_per_task=8, seed=1)
    r.context.task_classifier.fit(texts, labels, steps=60)
    for q in make_stream(per_task=6, seed=5):
        d = r.route(JaxQuery(uid=q.uid, text=q.text))
        acc, wh = _outcome(q.uid, d.model_index)
        r.feedback(JaxFeedback(query_uid=q.uid, model_index=d.model_index,
                               accuracy=acc, energy_wh=wh, latency_ms=5.0))
    return r.state_dict()


def _drive(router, feedback_cls, query_cls, stream, batch=10):
    """Route the stream in batches with identical feedback; returns the
    per-query (arm, label, cluster, bin) and the final scores."""
    out = []
    for i in range(0, len(stream), batch):
        qs = [query_cls(uid=10_000 + q.uid, text=q.text)
              for q in stream[i:i + batch]]
        ds = router.route_batch(qs)
        for q, d in zip(qs, ds):
            out.append((d.model_index, d.context.task_label,
                        d.context.cluster, d.context.complexity_bin))
        router.feedback_batch([
            feedback_cls(query_uid=q.uid, model_index=d.model_index,
                         accuracy=_outcome(q.uid, d.model_index)[0],
                         energy_wh=_outcome(q.uid, d.model_index)[1],
                         latency_ms=5.0) for q, d in zip(qs, ds)])
    return out


def test_route_batch_matches_jax_from_same_loaded_state(warmed_jax_state):
    stream = make_stream(per_task=12, seed=11)            # 60 queries
    ref = _jax_router("host")
    ref.load_state_dict(warmed_jax_state)
    expected = _drive(ref, JaxFeedback, JaxQuery, stream)
    assert len({e[0] for e in expected}) > 1               # not one arm only
    for featurize in ("host", "device"):
        port = _port_router(featurize)
        port.load_state_dict(warmed_jax_state)
        assert port._device_featurize_active() == (featurize == "device")
        got = _drive(port, Feedback, Query, stream)
        assert got == expected, featurize
        np.testing.assert_allclose(port.policy.state_dict()["theta"],
                                   ref.policy.state_dict()["theta"],
                                   atol=1e-5)


def test_jax_device_path_agrees_on_a_batch(warmed_jax_state):
    """The JAX fused pipeline (interpret-mode Pallas) and the port's fused
    pipeline (plain versions on the CPU) decide one batch identically."""
    stream = make_stream(per_task=2, seed=12)
    ref = _jax_router("device")
    ref.load_state_dict(warmed_jax_state)
    port = _port_router("device")
    port.load_state_dict(warmed_jax_state)
    assert (_drive(port, Feedback, Query, stream)
            == _drive(ref, JaxFeedback, JaxQuery, stream))


@pytest.mark.parametrize("featurize", ["host", "device"])
def test_route_batch_tilts_and_vetoes_like_jax(warmed_jax_state, featurize):
    """Prefix-cache discounts, cost-model predictions, per-row vetoes and
    the arm-health mask change decisions identically on both packages."""
    stream = make_stream(per_task=2, seed=18)
    rng = np.random.default_rng(4)
    n = len(stream)
    kw = dict(energy_discounts_wh=rng.random((n, 4)) * 0.2,
              energy_costs_wh=rng.random((n, 4)) * 0.3,
              blocked=rng.random((n, 4)) < 0.3)
    health = np.array([True, True, False, True])
    out = []
    for r, qcls in ((_jax_router("host"), JaxQuery),
                    (_port_router(featurize), Query)):
        r.load_state_dict(warmed_jax_state)
        r.set_arm_health(lambda: health)
        for _ in range(2):                # the cost baseline evolves
            ds = r.route_batch([qcls(uid=q.uid, text=q.text) for q in stream],
                               **kw)
            for q in stream:
                r._pending.pop(q.uid)
        out.append([(d.model_index, float(d.ucb_scores.max())) for d in ds])
    assert [a for a, _ in out[0]] == [a for a, _ in out[1]]
    np.testing.assert_allclose([s for _, s in out[0]], [s for _, s in out[1]],
                               rtol=1e-4)
    assert 2 not in {a for a, _ in out[1]}


def test_forwarded_features_equal_recomputed(warmed_jax_state):
    """Embeddings and labels a caller already computed, forwarded into
    route_batch, decide exactly as recomputing them does."""
    stream = make_stream(per_task=2, seed=19)
    a, b = _port_router("device"), _port_router("device")
    a.load_state_dict(warmed_jax_state)
    b.load_state_dict(warmed_jax_state)
    texts = [q.text for q in stream]
    embs = b.context.embedder.encode_batch_device(texts, "cpu")
    labels = np.asarray([int(torch.argmax(
        torch.from_numpy(e) @ b.context.task_classifier.w
        + b.context.task_classifier.b)) for e in b.context.embedder.
        encode_batch_device([b.context.task_classifier.instruction_text(t)
                             for t in texts], "cpu")])
    da = a.route_batch(stream)
    db = b.route_batch(stream, embeddings=embs, task_labels=labels)
    assert ([(d.model_index, d.context.task_label, d.context.cluster)
             for d in da]
            == [(d.model_index, d.context.task_label, d.context.cluster)
                for d in db])


def test_set_lambda_rescalarizes_like_jax(warmed_jax_state):
    ref = _jax_router("host")
    ref.load_state_dict(warmed_jax_state)
    port = _port_router("host")
    port.load_state_dict(warmed_jax_state)
    for r in (ref, port):
        r.set_lambda(0.8)
    js, ps = ref.policy.state_dict(), port.policy.state_dict()
    for name in ("b", "theta", "reward_sum"):
        np.testing.assert_allclose(ps[name], js[name], atol=1e-5, err_msg=name)
    assert port.config.lam == 0.8
    stream = make_stream(per_task=3, seed=13)
    assert (_drive(port, Feedback, Query, stream)
            == _drive(ref, JaxFeedback, JaxQuery, stream))


def test_state_dict_round_trip_routes_identically(warmed_jax_state):
    a = _port_router("device")
    a.load_state_dict(warmed_jax_state)
    _drive(a, Feedback, Query, make_stream(per_task=2, seed=14))
    sd = a.state_dict()
    b = _port_router("device")
    b.load_state_dict(sd)
    for k, v in sd["bandit"].items():
        np.testing.assert_array_equal(b.state_dict()["bandit"][k], v)
    stream = make_stream(per_task=3, seed=15)
    assert (_drive(b, Feedback, Query, stream)
            == _drive(a, Feedback, Query, stream))


def test_device_path_moves_no_state_in_steady_state(warmed_jax_state):
    r = _port_router("device")
    r.load_state_dict(warmed_jax_state)
    _drive(r, Feedback, Query, make_stream(per_task=1, seed=16))
    km = r.context.kmeans.transfers.snapshot()
    bandit = r.policy.transfers.snapshot()
    _drive(r, Feedback, Query, make_stream(per_task=2, seed=17))
    assert r.context.kmeans.transfers.snapshot() == km
    assert r.policy.transfers.snapshot() == bandit


def test_unported_policies_raise():
    for kw in (dict(algorithm="cts"), dict(solve_mode="cholesky")):
        with pytest.raises(NotImplementedError):
            GreenServRouter(RouterConfig(**kw), ModelPool(), device="cpu")


def test_classifier_fit_learns_the_tasks():
    ctx = ContextGenerator(RouterConfig(), device="cpu")
    texts, labels = labeled_sample(n_per_task=8, seed=1)
    assert ctx.task_classifier.fit(texts, labels, steps=100) > 0.9


# the router's public constructors, each taking ``device``
ROUTER_CONSTRUCTORS = {
    "init_state": lambda **kw: init_state(RouterConfig(), 3, **kw),
    "BanditPolicy": lambda **kw: BanditPolicy(RouterConfig(), 3, **kw),
    "TaskClassifier": lambda **kw: TaskClassifier(EmbeddingModel(), **kw),
    "OnlineKMeans": lambda **kw: OnlineKMeans(4, 16, **kw),
    "ContextGenerator": lambda **kw: ContextGenerator(RouterConfig(), **kw),
}


@pytest.mark.parametrize("name", sorted(ROUTER_CONSTRUCTORS))
def test_router_constructors_default_to_the_card(name, monkeypatch):
    """``device=None`` means the card, as for the model API: with no CUDA
    device visible a constructor called without a device raises instead
    of quietly running on the CPU, and ``device="cpu"`` runs there."""
    make = ROUTER_CONSTRUCTORS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    made = make(device="cpu")
    tensors = ([made.A, made.b] if name == "init_state" else
               [made.state.A] if name == "BanditPolicy" else
               [made.w] if name == "TaskClassifier" else
               list(made.device_state()) if name == "OnlineKMeans" else
               [made.task_classifier.w, *made.kmeans.device_state()])
    assert all(t.device.type == "cpu" for t in tensors)
