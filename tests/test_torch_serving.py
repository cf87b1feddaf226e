"""The PyTorch port's serving loop on the CPU against the JAX package, in
float32 at smoke sizes: LM logits within 1e-4 with the JAX weights carried
by ``params_from_jax``, greedy generations token-identical, and one
``PoolServer`` run answering the same queries on the same arms with the
same tokens and the same Wh (the port's energy constants set to the JAX
package's for the comparison)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.core.energy as jax_energy
import repro_torch.core.energy as port_energy
from repro.configs import get_config as jax_get_config
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data.stream import make_stream
from repro.models import api as jax_api
from repro.models import lm as jax_lm
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro.serving import Request as JaxRequest
from repro_torch.configs import for_mode, get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.models import api, lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import LivelockError, PoolServer

pytestmark = pytest.mark.port


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and torch's default pool (a thread
    per core in each) oversubscribes the cores — a launcher test took 245
    s of wall time beside five copies of itself with the default threads
    and 13 s with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["granite-3-8b", "h2o-danube-3-4b"]
MAX_LEN = 64          # ≤ the smoke danube window: a full-depth KV cache
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")


@pytest.fixture
def equal_energy_constants(monkeypatch):
    """Set the port's H100 constants to the JAX package's values."""
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "CHIP_TDP_W", "CHIP_IDLE_W",
                 "E_PER_FLOP", "E_PER_HBM_BYTE"):
        monkeypatch.setattr(port_energy, name, getattr(jax_energy, name))
    monkeypatch.setattr(port_energy, "LINK_BW",
                        jax_energy.ICI_BW_PER_LINK * jax_energy.ICI_LINKS)
    monkeypatch.setattr(port_energy, "E_PER_LINK_BYTE",
                        jax_energy.E_PER_ICI_BYTE)


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    arch = request.param
    jcfg = jax_get_config(arch, **F32)
    pcfg = get_config(arch, **F32)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(3))
    return arch, jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def _close(a, b, atol=1e-4):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=atol,
                               rtol=1e-4)


def test_prefill_chunk_and_decode_logits_match_jax(model_pair):
    _, jcfg, pcfg, params, model = model_pair
    rng = np.random.default_rng(0)
    jcache = jax_lm.init_cache(jcfg, 2, MAX_LEN)
    pcache = lm.init_cache(pcfg, 2, MAX_LEN, device="cpu")
    for step in range(3):                          # two slabs, then decode
        tokens = rng.integers(3, tok.VOCAB_SIZE, (2, 8)).astype(np.int32)
        n_active = np.array([8, 5 - step], np.int32)
        jl, jcache = jax_lm.prefill_chunk_step(
            params, jnp.asarray(tokens), jcache, jcfg, jnp.asarray(n_active))
        pl, pcache = lm.prefill_chunk_step(
            model, torch.from_numpy(tokens), pcache, pcfg,
            torch.from_numpy(n_active))
        for b, n in enumerate(n_active):      # padding logits are garbage
            _close(pl.numpy()[b, :n], np.asarray(jl)[b, :n])
        np.testing.assert_array_equal(pcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
    for _ in range(3):
        token = rng.integers(3, tok.VOCAB_SIZE, (2, 1)).astype(np.int32)
        jl, jcache = jax_lm.decode_step(params, jnp.asarray(token), jcache,
                                        jcfg)
        pl, pcache = lm.decode_step(model, torch.from_numpy(token), pcache,
                                    pcfg)
        _close(pl.numpy(), jl)
        np.testing.assert_array_equal(pl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))
    _close(pcache["k"].numpy(), jcache["k"])
    _close(pcache["v"].numpy(), jcache["v"])


def test_chunk_of_one_equals_decode_step(model_pair):
    """With C == 1 and n_active == 1 the chunk step computes exactly what
    the decode step computes (the engine's mixed ticks rely on it)."""
    _, _, pcfg, _, model = model_pair
    token = torch.tensor([[7], [9]], dtype=torch.int32)
    c1 = lm.init_cache(pcfg, 2, MAX_LEN, device="cpu")
    c2 = lm.init_cache(pcfg, 2, MAX_LEN, device="cpu")
    a, _ = lm.prefill_chunk_step(model, token, c1, pcfg,
                                 torch.ones(2, dtype=torch.int32))
    b, _ = lm.decode_step(model, token, c2, pcfg)
    _close(a.numpy(), b.numpy(), atol=1e-5)


def _requests(cls, query_cls):
    prompts = [[1] + list(range(10, 14)), [1] + list(range(20, 40)),
               [1] + [5 + (i % 200) for i in range(70)]]   # overflows 64
    return [cls(query=query_cls(uid=i, text=f"q{i}"), prompt_tokens=p,
                max_new_tokens=6) for i, p in enumerate(prompts)]


def _drain(engine, n):
    done = []
    for _ in range(200):
        done += engine.step()
        if len(done) == n:
            return {r.uid: r for r in done}
    raise AssertionError("engine did not drain")


def test_model_engine_generations_token_identical(model_pair,
                                                  equal_energy_constants):
    arch, jcfg, pcfg, params, model = model_pair
    jeng = JaxModelEngine(arch, jcfg, jax.random.PRNGKey(0), max_batch=2,
                          max_len=MAX_LEN, params=params, prefill_chunk=8)
    peng = ModelEngine(arch, pcfg, max_batch=2, max_len=MAX_LEN,
                       params=model, prefill_chunk=8, device="cpu")
    for e, reqs in ((jeng, _requests(JaxRequest, JaxQuery)),
                    (peng, _requests(Request, Query))):
        e.submit_many(reqs)
    jout, pout = _drain(jeng, 3), _drain(peng, 3)
    for uid in jout:
        assert pout[uid].tokens == jout[uid].tokens
        assert pout[uid].output_tokens == jout[uid].output_tokens
        assert pout[uid].energy_wh == pytest.approx(jout[uid].energy_wh,
                                                    rel=1e-12)
    assert peng.nonfinite_ticks == 0
    assert peng.cumulative_joules() == pytest.approx(jeng.cumulative_joules(),
                                                     rel=1e-12)
    assert peng.modeled_time_s() == pytest.approx(jeng.modeled_time_s(),
                                                  rel=1e-12)


def test_pool_server_run_matches_jax(equal_energy_constants):
    queries = [dataclasses.replace(q, max_new_tokens=6)
               for q in make_stream(per_task=2, seed=4)[:6]]
    jengines, pengines = {}, {}
    for i, arch in enumerate(ARCHS):
        jcfg, pcfg = jax_get_config(arch, **F32), get_config(arch, **F32)
        jeng = JaxModelEngine(arch, jcfg, jax.random.PRNGKey(i),
                              max_batch=2, max_len=MAX_LEN, prefill_chunk=8)
        jengines[arch] = jeng
        pengines[arch] = ModelEngine(
            arch, pcfg, max_batch=2, max_len=MAX_LEN, prefill_chunk=8,
            params=params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                   pcfg, device="cpu"), device="cpu")
    jrouter = JaxRouter(JaxRouterConfig(lam=0.4, energy_scale_wh=0.05),
                        JaxModelPool([e.profile for e in jengines.values()]))
    prouter = GreenServRouter(
        RouterConfig(lam=0.4, energy_scale_wh=0.05),
        ModelPool([e.profile for e in pengines.values()]), device="cpu")
    runs = []
    for server, qcls in ((JaxPoolServer(jrouter, jengines, prefill_chunk=8),
                          JaxQuery),
                         (PoolServer(prouter, pengines, prefill_chunk=8),
                          Query)):
        for q in queries:
            server.enqueue(qcls(uid=q.uid, text=q.text,
                                max_new_tokens=q.max_new_tokens))
            server.step()
        server.run_until_drained(max_steps=500)
        runs.append(server.responses)
    jresp, presp = runs
    assert sorted(presp) == sorted(jresp) == sorted(q.uid for q in queries)
    for uid in jresp:
        assert presp[uid].model_name == jresp[uid].model_name
        assert presp[uid].tokens == jresp[uid].tokens
        assert presp[uid].energy_wh == pytest.approx(jresp[uid].energy_wh,
                                                     rel=1e-12)
    np.testing.assert_allclose(prouter.policy.state_dict()["theta"],
                               jrouter.policy.state_dict()["theta"],
                               atol=1e-5)


def test_unported_serving_options_raise():
    """The fleet's device meshes are built (two shards sharing the CPU
    share its id), and a decoder-only model refuses the encoder-decoder
    layout (that is ``encdec.EncDecLM``, which ``lm.init_lm`` builds); the
    reliability and disaggregation options of ``PoolServer`` are taken."""
    from repro_torch.fleet import plan_fleet
    from repro_torch.serving import BreakerConfig
    pcfg = get_config("granite-3-8b", **F32)
    encdec_cfg = dataclasses.replace(pcfg, layout="encdec")
    with pytest.raises(ValueError, match="EncDecLM"):
        lm.DecoderLM(encdec_cfg, torch.device("cpu"))
    assert "cross_k" in lm.init_cache(encdec_cfg, 1, 128, device="cpu")
    mesh = plan_fleet(2, ["g"], devices=[torch.device("cpu")]).fleet_mesh()
    assert mesh.shape == {"data": 2, "model": 1}
    eng = ModelEngine("g", pcfg, max_len=32, device="cpu")
    twin = ModelEngine("g", pcfg, max_len=32, params=eng.params,
                       role="decode", device="cpu")
    router = GreenServRouter(RouterConfig(), ModelPool([eng.profile]),
                             device="cpu")
    server = PoolServer(router, {"g": eng}, max_retries=1, deadline_s=1.0,
                        decode_engines={"g": twin},
                        breaker_config=BreakerConfig())
    assert (server.max_retries, server.deadline_s) == (1, 1.0)
    assert server.decode_engines == {"g": twin} and eng.role == "prefill"
    assert set(server.breakers) == {"g", "g#decode"}
    with pytest.raises(ValueError):
        eng.set_role("encoder")


def test_livelock_is_raised_with_a_snapshot():
    pcfg = get_config("granite-3-8b", **F32)
    eng = ModelEngine("g", pcfg, max_len=32, device="cpu")
    server = PoolServer(GreenServRouter(RouterConfig(), ModelPool([eng.profile]),
                                        device="cpu"), {"g": eng})
    server.enqueue(Query(uid=0, text="a question that takes a while"))
    with pytest.raises(LivelockError, match="engine g"):
        server.run_until_drained(max_steps=2)


def test_engine_failure_restarts_and_replays():
    pcfg = get_config("granite-3-8b", **F32)
    engines = {n: ModelEngine(n, pcfg, seed=i, max_len=48, prefill_chunk=8,
                              device="cpu") for i, n in enumerate("ab")}
    router = GreenServRouter(RouterConfig(),
                             ModelPool([e.profile for e in engines.values()]),
                             device="cpu")
    server = PoolServer(router, engines, prefill_chunk=8)
    for q in make_stream(per_task=1, seed=2):
        server.submit(q)
    server.step()
    engines["a"].inject_failure()
    server.run_until_drained(max_steps=400)
    assert len(server.responses) == 5 and server.stats["restarts"] == 1


def test_runtime_model_addition_grows_the_router():
    """Zero-calibration addition (paper §6.3.4): a late engine becomes a
    fresh bandit arm, and the loop explores it."""
    pcfg = get_config("granite-3-8b", **F32)
    first = ModelEngine("a", pcfg, seed=0, max_len=48, prefill_chunk=8,
                        device="cpu")
    router = GreenServRouter(RouterConfig(max_arms=4),
                             ModelPool([first.profile]), device="cpu")
    server = PoolServer(router, {"a": first}, prefill_chunk=8)
    late = ModelEngine("b", pcfg, seed=1, max_len=48, device="cpu")
    server.add_engine(late.profile, late)
    assert late.prefill_chunk == 8 and router.policy.n_arms == 2
    for q in make_stream(per_task=1, seed=3):
        server.submit(q)                  # one at a time: each completion
        server.run_until_drained(max_steps=200)   # feeds the next decision
    assert len(server.responses) == 5
    assert router.selection_counts()[1] > 0


def test_splice_kv_matches_jax():
    from repro.models.attention import splice_kv as jax_splice_kv
    from repro_torch.models.attention import splice_kv
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((2, 3, 16, 2, 4)).astype(np.float32)
    block = rng.standard_normal((2, 5, 2, 4)).astype(np.float32)
    jk, _ = jax_splice_kv(jnp.asarray(cache), jnp.asarray(cache), 1,
                          block, block)
    pk, _ = splice_kv(torch.from_numpy(cache.copy()),
                      torch.from_numpy(cache.copy()), 1, block, block)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))


def test_engine_tick_counters_add_up():
    """Per tick kind: every tick is counted once, and the decode tokens
    plus one first token per answered prompt are all tokens generated."""
    pcfg = get_config("granite-3-8b", **F32)
    eng = ModelEngine("g", pcfg, max_batch=2, max_len=MAX_LEN,
                      prefill_chunk=8, device="cpu")
    eng.submit_many(_requests(Request, Query))
    out = _drain(eng, 3)
    assert sum(eng.tick_counts.values()) == eng.n_steps
    assert eng.tick_counts["chunk"] > 0 and eng.tick_counts["decode"] > 0
    assert all(s > 0 for s in eng.tick_seconds.values())
    generated = sum(len(r.tokens) for r in out.values())
    assert sum(eng.decode_tokens.values()) + len(out) == generated
    assert eng.decode_tokens["decode"] > 0


def test_serve_mode_stores_bf16_and_serves():
    pcfg = for_mode(get_config("granite-3-8b", smoke=True,
                               vocab_size=tok.VOCAB_SIZE), "serve")
    model = api.init_params(pcfg, seed=0, device="cpu")
    assert model.layers[0].mlp.wo.dtype == torch.bfloat16
    cache = api.init_cache(pcfg, 1, 16, device="cpu")
    logits, cache = api.prefill_chunk(model, torch.tensor([[1, 5, 9, 0]]),
                                      cache, pcfg, torch.tensor([3]))
    assert logits.dtype == torch.bfloat16 and torch.isfinite(logits).all()
    assert int(cache["length"][0]) == 3


def test_model_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means the card: with no CUDA device visible, every
    model entry point raises instead of quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = get_config("granite-3-8b", **F32)
    for call in (lambda: api.init_params(pcfg),
                 lambda: api.init_cache(pcfg, 1, 16),
                 lambda: lm.init_lm(pcfg),
                 lambda: lm.init_cache(pcfg, 1, 16),
                 lambda: params_from_jax({}, pcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
