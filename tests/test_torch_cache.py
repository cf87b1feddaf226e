"""GreenCache in the port on the CPU against the JAX package, in float32 at
smoke sizes: every case of ``tests/test_cache.py`` that needs no
telemetry, run through both packages with equal results — splice vs
cold prefill (dense and MoE, chunks of 1 to 8, several prefix lengths),
ragged slots, warm == cold generation through ``ModelEngine``, the
layout gate, the radix trie's LRU and seeded eviction chains, the block
pool's capacity, the semantic cache's guards, threshold, TTL and LRU,
the semantic short-circuit, late joiners, the prefix discount's tilt,
``features_batch`` against per-query ``features`` and one probe per
``submit_batch``; then the cache workload (``benchmarks/cache.py``, the
JAX package's ``bench_cache.make_workload``) through ``PoolServer`` on
``SimEngine``s and on small ``ModelEngine``s in every cache mode: the
same hits, prefix hits, tokens per uid and joules.

The governor's avoided-energy credit (``test_cache.py::
test_governor_avoided_energy_credit_and_inflight_discount``) waits for
the port's telemetry slice (ROADMAP A.5), which has the governor.
"""
import functools
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.cache as jax_cache
import repro.core.energy as jax_energy
import repro_torch.cache as port_cache
import repro_torch.core.energy as port_energy
from repro.configs import get_config as jax_get_config
from repro.configs import pool as jax_pool
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data import OutcomeSimulator as JaxOutcomeSimulator
from repro.data import tokenizer as jax_tok
from repro.models import api as jax_api
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro.serving import Request as JaxRequest
from repro.serving.engine import SimEngine as JaxSimEngine
from repro_torch.benchmarks import cache as cache_bench
from repro_torch.configs import get_config
from repro_torch.configs import pool
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import ModelProfile, Query, RouterConfig
from repro_torch.data import OutcomeSimulator
from repro_torch.data import tokenizer as tok
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ModelEngine, PoolServer, Request, SimEngine
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.port, pytest.mark.cache]

MAX_LEN = 48
PROMPT = list(range(3, 17))       # 14 tokens
RTOL = ATOL = 3e-4                # test_cache.py's: batched-vs-stepped fp32
PARITY = 1e-4                     # port vs JAX logits (test_torch_serving)
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")
DENSE, MOE = "granite-3-8b", "qwen2-moe-a2.7b"

# the two packages' cache modules and classes, for cases run through each
PACKAGES = {
    "jax": types.SimpleNamespace(
        GreenCache=jax_cache.GreenCache, KVBlockPool=jax_cache.KVBlockPool,
        PrefixCache=jax_cache.PrefixCache,
        SemanticCache=jax_cache.SemanticCache,
        SemanticEntry=jax_cache.SemanticEntry),
    "port": types.SimpleNamespace(
        GreenCache=port_cache.GreenCache, KVBlockPool=port_cache.KVBlockPool,
        PrefixCache=port_cache.PrefixCache,
        SemanticCache=port_cache.SemanticCache,
        SemanticEntry=port_cache.SemanticEntry),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


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


@functools.lru_cache(maxsize=None)
def _pair(arch: str, seed: int):
    """(JAX config, port config, JAX params, the same weights in the
    port) for a smoke fp32 model."""
    jcfg = jax_get_config(arch, kv_update="where", **F32)
    pcfg = get_config(arch, kv_update="where", **F32)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                            device="cpu")
    return jcfg, pcfg, params, model


# ---------------------------------------------------------------------------
# Splice equivalence
# ---------------------------------------------------------------------------


def _prefill(port: bool, params, cfg, prompts, batch, chunk, cache=None,
             fed0=None):
    """Chunk-prefill per-slot prompts through one package (optionally
    resuming mid-prompt from a spliced cache); returns (per-slot last
    logits, cache)."""
    if cache is None:
        cache = (api.init_cache(cfg, batch, MAX_LEN, device="cpu") if port
                 else jax_api.init_cache(cfg, batch, MAX_LEN))
    fed = list(fed0) if fed0 is not None else [0] * batch
    last = [None] * batch
    while any(fed[b] < len(p) for b, p in enumerate(prompts)):
        toks = np.zeros((batch, chunk), np.int32)
        n_active = np.zeros((batch,), np.int32)
        for b, p in enumerate(prompts):
            n = min(chunk, len(p) - fed[b])
            if n > 0:
                toks[b, :n] = p[fed[b]:fed[b] + n]
                n_active[b] = n
        if port:
            logits, cache = api.prefill_chunk(
                params, torch.from_numpy(toks), cache, cfg,
                torch.from_numpy(n_active))
        else:
            logits, cache = jax_api.prefill_chunk(
                params, jnp.asarray(toks), cache, cfg,
                jnp.asarray(n_active))
        for b, p in enumerate(prompts):
            n = int(n_active[b])
            if n and fed[b] + n == len(p):
                last[b] = np.asarray(logits[b, n - 1])
            fed[b] += n
    return last, cache


def _splice(port: bool, cfg, batch, slot, k, v):
    if port:
        cache = api.init_cache(cfg, batch, MAX_LEN, device="cpu")
        return api.splice_prefix(cache, slot, torch.from_numpy(k),
                                 torch.from_numpy(v))
    return jax_api.splice_prefix(jax_api.init_cache(cfg, batch, MAX_LEN),
                                 slot, k, v)


def _np(cache, leaf):
    x = cache[leaf]
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("arch", [DENSE, MOE])
@pytest.mark.parametrize("chunk,prefix_len", [
    (1, 5), (2, 13), (4, 8), (5, 8), (8, 3), (8, 13)])
def test_spliced_prefix_matches_cold_prefill(arch, chunk, prefix_len):
    """Warm == cold in each package (the first ``prefix_len`` tokens' KV,
    captured from a cold run, spliced into a fresh slot, only the suffix
    prefilled: the same first-token logits and prompt-region cache), and
    the port's warm run == the JAX package's."""
    jcfg, pcfg, params, model = _pair(arch, 0)
    warm = {}
    for port, p, cfg in ((False, params, jcfg), (True, model, pcfg)):
        cold_logits, cold = _prefill(port, p, cfg, [PROMPT], 1, chunk)
        k = _np(cold, "k")[:, 0, :prefix_len].copy()
        v = _np(cold, "v")[:, 0, :prefix_len].copy()
        spliced = _splice(port, cfg, 1, 0, k, v)
        assert int(spliced["length"][0]) == prefix_len
        logits, cache = _prefill(port, p, cfg, [PROMPT], 1, chunk,
                                 cache=spliced, fed0=[prefix_len])
        np.testing.assert_allclose(logits[0], cold_logits[0], rtol=RTOL,
                                   atol=ATOL)
        n_p = len(PROMPT)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_np(cache, leaf)[:, 0, :n_p],
                                       _np(cold, leaf)[:, 0, :n_p],
                                       rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(_np(cache, "length"),
                                      _np(cold, "length"))
        warm[port] = logits[0]
    np.testing.assert_allclose(warm[True], warm[False], rtol=PARITY,
                               atol=PARITY)


def test_spliced_prefix_ragged_batch_slots():
    """A spliced slot and a cold slot share a batch: the splice does not
    leak into the neighbour, both match their cold references, in both
    packages alike."""
    jcfg, pcfg, params, model = _pair(DENSE, 1)
    short = list(range(40, 45))                       # 5 tokens, cold
    warm = {}
    for port, p, cfg in ((False, params, jcfg), (True, model, pcfg)):
        cold_logits, cold = _prefill(port, p, cfg, [PROMPT, short], 2, 4)
        k = _np(cold, "k")[:, 0, :8].copy()
        v = _np(cold, "v")[:, 0, :8].copy()
        logits, cache = _prefill(port, p, cfg, [PROMPT, short], 2, 4,
                                 cache=_splice(port, cfg, 2, 0, k, v),
                                 fed0=[8, 0])
        for b in range(2):
            np.testing.assert_allclose(logits[b], cold_logits[b], rtol=RTOL,
                                       atol=ATOL)
        np.testing.assert_allclose(_np(cache, "k"), _np(cold, "k"),
                                   rtol=RTOL, atol=ATOL)
        warm[port] = logits
    for b in range(2):
        np.testing.assert_allclose(warm[True][b], warm[False][b],
                                   rtol=PARITY, atol=PARITY)


def _serve_twice(eng, req_cls, query_cls, prompt):
    """The same prompt served twice on a one-request engine: (cold
    response, its TTFT in steps, warm response, its TTFT, warm request)."""
    out = []
    for uid in range(2):
        req = req_cls(query=query_cls(uid=uid, text="x"),
                      prompt_tokens=list(prompt), max_new_tokens=4)
        eng.submit(req)
        steps, done = 0, []
        while not req.generated and steps < 80:
            done += eng.step()
            steps += 1
        ttft = steps
        while not done and steps < 120:
            done += eng.step()
            steps += 1
        out += [done[0], ttft]
    return out + [req]


@pytest.mark.parametrize("arch", [DENSE, MOE])
def test_engine_warm_generation_matches_cold(arch, equal_energy_constants):
    """Through ``ModelEngine``: the second serving of a prompt splices two
    whole 8-token blocks, decodes the cold run's tokens, reaches its
    first token in fewer steps and banks avoided joules — in the port as
    in the JAX package, with equal tokens, Wh and avoided joules."""
    jcfg, pcfg, params, model = _pair(arch, 2)
    prompt = list(range(7, 27))                       # 20 tokens
    runs = {}
    for port in (False, True):
        if port:
            eng = ModelEngine(arch, pcfg, max_batch=2, max_len=64,
                              params=model, prefill_chunk=4, device="cpu")
            eng.set_prefix_cache(port_cache.PrefixCache(32, 8))
            got = _serve_twice(eng, Request, Query, prompt)
        else:
            eng = JaxModelEngine(arch, jcfg, jax.random.PRNGKey(0),
                                 max_batch=2, max_len=64, params=params,
                                 prefill_chunk=4)
            eng.set_prefix_cache(jax_cache.PrefixCache(32, 8))
            got = _serve_twice(eng, JaxRequest, JaxQuery, prompt)
        cold, cold_ttft, warm, warm_ttft, warm_req = got
        assert cold.tokens == warm.tokens
        assert warm_req.prefix_reused == warm.prefix_reused == 16
        assert warm_ttft < cold_ttft
        assert eng.prefix_hit_count() == 1
        assert eng.cumulative_joules_avoided() > 0.0
        assert warm.energy_wh < cold.energy_wh
        runs[port] = (cold, warm, eng.cumulative_joules_avoided(),
                      eng.cumulative_joules())
    (jc, jw, ja, jj), (pc, pw, pa, pj) = runs[False], runs[True]
    assert pc.tokens == jc.tokens and pw.tokens == jw.tokens
    for got, want in ((pc.energy_wh, jc.energy_wh),
                      (pw.energy_wh, jw.energy_wh), (pa, ja), (pj, jj)):
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch,max_len,attached", [
    ("rwkv6-1.6b", 32, False),          # recurrent state
    ("h2o-danube-3-4b", 96, False),     # ring buffers past its window 64
    ("h2o-danube-3-4b", 64, True),      # full-depth within its window
    (DENSE, 32, True)])
def test_engine_without_full_depth_cache_ignores_prefix_cache(
        arch, max_len, attached):
    """Only a full-depth positional KV cache takes a splice: elsewhere the
    attach is a silent no-op (the chunked-prefill gate), as in the JAX
    package."""
    jeng = JaxModelEngine("m", jax_get_config(arch, **F32),
                          jax.random.PRNGKey(0), max_batch=1,
                          max_len=max_len)
    peng = ModelEngine("m", get_config(arch, **F32), max_batch=1,
                       max_len=max_len, device="cpu")
    jeng.set_prefix_cache(jax_cache.PrefixCache(max_blocks=4))
    peng.set_prefix_cache(port_cache.PrefixCache(max_blocks=4))
    assert (jeng.prefix_cache is not None) == attached
    assert (peng.prefix_cache is not None) == attached


# ---------------------------------------------------------------------------
# Eviction: bounded, leaf-first, deterministic
# ---------------------------------------------------------------------------


def _fake_kv(n_tokens, tag=0.0):
    k = np.full((2, n_tokens, 1, 4), tag, np.float32)
    return k, k.copy()


def test_lru_leaf_eviction_keeps_chains_contiguous(pkg):
    pc = pkg.PrefixCache(max_blocks=3, block_tokens=4)
    a = list(range(8))                  # 2 blocks
    b = list(range(100, 104))           # 1 block
    pc.insert(a, *_fake_kv(8))
    pc.insert(b, *_fake_kv(4))
    assert pc.stats()["blocks"] == 3
    n, _ = pc.index.lookup(a)           # touch A's chain (B becomes LRU)
    assert n == 8
    c = list(range(200, 204))
    pc.insert(c, *_fake_kv(4))          # full: must evict B's leaf, not A's
    assert pc.peek_len(a) == 8          # A's chain survived intact
    assert pc.peek_len(b) == 0
    assert pc.peek_len(c) == 4
    assert pc.pool.evictions == 1


def _eviction_run(cls):
    rng = np.random.default_rng(7)
    pc = cls(max_blocks=16, block_tokens=4)
    trace = []
    for _ in range(200):
        toks = [int(t) for t in rng.integers(0, 6, size=rng.integers(4, 17))]
        if rng.random() < 0.5:
            n, blocks = pc.index.lookup(toks)
            trace.append(("l", n, sum(float(np.asarray(b[0]).sum())
                                      for b in blocks)))
        else:
            pc.insert(toks, *_fake_kv((len(toks) // 4) * 4, len(trace)))
            trace.append(("i", len(pc.index)))
    return trace, pc.stats()


def test_eviction_is_deterministic_under_seeded_workload():
    """The seeded churn replays to the same trace in each package, and
    the port's trace (hit lengths, the blocks' contents, index sizes,
    evictions) is the JAX package's."""
    runs = {name: (_eviction_run(p.PrefixCache), _eviction_run(p.PrefixCache))
            for name, p in PACKAGES.items()}
    for first, second in runs.values():
        assert first == second
    assert runs["port"][0] == runs["jax"][0]
    stats = runs["port"][0][1]
    assert stats["evictions"] > 0       # the workload actually churned
    assert stats["blocks"] <= 16


def test_kvpool_refuses_puts_past_capacity(pkg):
    pool_ = pkg.KVBlockPool(max_blocks=2, block_tokens=4)
    k, v = _fake_kv(4)
    b0, b1 = pool_.put(k, v), pool_.put(k, v)
    assert pool_.put(k, v) is None and pool_.full
    pool_.free(b0)
    assert pool_.put(k, v) is not None
    assert pool_.lru_order()[0] == b1   # oldest surviving block is LRU
    assert pool_.stats()["nbytes"] == 2 * 2 * k.nbytes


def test_port_kv_blocks_keep_the_engine_dtype():
    """A bf16 capture is pooled as bf16 CPU tensors (numpy has no bf16;
    fp32 would double the pool's memory), each block a copy of its own."""
    pc = port_cache.PrefixCache(max_blocks=4, block_tokens=4)
    k = torch.randn(2, 9, 1, 4).to(torch.bfloat16)
    assert pc.insert(list(range(9)), k, k.clone()) == 2
    n, kb, vb = pc.match(list(range(9)), max_tokens=8)
    assert n == 8 and kb.dtype == torch.bfloat16
    assert torch.equal(kb, k[:, :8])
    assert pc.stats()["nbytes"] == 2 * 2 * (2 * 4 * 1 * 4 * 2)


# ---------------------------------------------------------------------------
# Semantic cache guards and TTL (the port's copy against the JAX package's)
# ---------------------------------------------------------------------------


def _entry(pkg, task, cluster=0, model="m", wh=0.01):
    return pkg.SemanticEntry(text="t", task_label=task, cluster=cluster,
                             model_name=model, tokens=[1], text_out="out",
                             energy_wh=wh, accuracy=1.0, input_tokens=4,
                             output_tokens=1)


def test_semantic_cache_never_crosses_task_types(pkg):
    sc = pkg.SemanticCache(dim=4, threshold=0.5, max_entries=8)
    e = np.array([1.0, 0, 0, 0], np.float32)
    sc.insert(e, _entry(pkg, task=0))
    assert sc.lookup(e, task_label=0, cluster=0) is not None
    assert sc.lookup(e, task_label=1, cluster=0) is None
    assert sc.lookup(e, task_label=0, cluster=3) is None


def test_semantic_threshold_and_lru_eviction(pkg):
    sc = pkg.SemanticCache(dim=2, threshold=0.9, max_entries=2)
    e0 = np.array([1.0, 0.0], np.float32)
    e1 = np.array([0.0, 1.0], np.float32)
    sc.insert(e0, _entry(pkg, 0, model="a"))
    sc.insert(e1, _entry(pkg, 0, model="b"))
    near = np.array([0.95, 0.312], np.float32)
    near /= np.linalg.norm(near)
    assert sc.lookup(near, 0, 0).model_name == "a"    # cos ≈ 0.95 ≥ 0.9
    far = np.array([0.7, 0.714], np.float32)
    far /= np.linalg.norm(far)
    assert sc.lookup(far, 0, 0) is None               # under threshold
    sc.insert(e0 * -1.0, _entry(pkg, 0, model="c"))   # evicts LRU e1
    assert sc.lookup(e1, 0, 0) is None
    assert sc.lookup(e0, 0, 0).model_name == "a"
    assert sc.evictions == 1


def test_semantic_ttl_expires_entries_on_virtual_clock(pkg):
    clk = {"t": 0.0}
    sc = pkg.SemanticCache(dim=2, threshold=0.9, max_entries=4, ttl_s=10.0,
                           clock=lambda: clk["t"])
    e = np.array([1.0, 0.0], np.float32)
    sc.insert(e, _entry(pkg, 0, model="a"))
    clk["t"] = 9.0
    assert sc.lookup(e, 0, 0).model_name == "a"
    clk["t"] = 10.5
    assert sc.lookup(e, 0, 0) is None
    assert sc.expirations == 1 and len(sc) == 0
    assert sc.stats()["ttl_s"] == 10.0


def test_semantic_ttl_refreshes_on_reinsert_not_on_hit(pkg):
    clk = {"t": 0.0}
    sc = pkg.SemanticCache(dim=2, threshold=0.9, max_entries=4, ttl_s=10.0,
                           clock=lambda: clk["t"])
    e = np.array([0.0, 1.0], np.float32)
    sc.insert(e, _entry(pkg, 0, model="a"))
    clk["t"] = 8.0
    assert sc.lookup(e, 0, 0) is not None
    clk["t"] = 11.0
    assert sc.lookup(e, 0, 0) is None
    sc.insert(e, _entry(pkg, 0, model="b"))
    clk["t"] = 20.0
    assert sc.lookup(e, 0, 0).model_name == "b"


def test_semantic_ttl_expired_slots_reused_before_lru_eviction(pkg):
    clk = {"t": 0.0}
    sc = pkg.SemanticCache(dim=2, threshold=0.9, max_entries=2, ttl_s=5.0,
                           clock=lambda: clk["t"])
    sc.insert(np.array([1.0, 0.0], np.float32), _entry(pkg, 0, model="old"))
    clk["t"] = 4.0
    sc.insert(np.array([0.0, 1.0], np.float32), _entry(pkg, 0, model="live"))
    clk["t"] = 6.0
    sc.insert(np.array([-1.0, 0.0], np.float32), _entry(pkg, 0, model="new"))
    assert sc.evictions == 0 and sc.expirations == 1
    assert sc.lookup(np.array([0.0, 1.0], np.float32), 0, 0) is not None


def test_greencache_plumbs_ttl_and_clock(pkg):
    clk = {"t": 0.0}
    cache = pkg.GreenCache(mode="semantic", semantic_ttl_s=7.0,
                           clock=lambda: clk["t"])
    assert cache.semantic.ttl_s == 7.0
    e = np.zeros(384, np.float32)
    e[0] = 1.0
    cache.semantic.insert(e, _entry(pkg, 0, model="x"))
    clk["t"] = 8.0
    assert cache.semantic.lookup(e, 0, 0) is None
    assert cache.semantic.stats()["expirations"] == 1


def test_ttl_rejects_nonpositive(pkg):
    with pytest.raises(ValueError):
        pkg.SemanticCache(ttl_s=0.0)
    with pytest.raises(ValueError):
        pkg.GreenCache(mode="sometimes")


# ---------------------------------------------------------------------------
# Scheduler integration
# ---------------------------------------------------------------------------


def _small_servers(cache_mode="full", seed=0, **kw):
    """A one-engine granite server in each package on the same weights."""
    jcfg, pcfg, params, model = _pair(DENSE, seed)
    jeng = JaxModelEngine(DENSE, jcfg, jax.random.PRNGKey(0), max_batch=2,
                          max_len=64, params=params)
    peng = ModelEngine(DENSE, pcfg, max_batch=2, max_len=64, params=model,
                       device="cpu")
    jserver = JaxPoolServer(
        JaxRouter(JaxRouterConfig(lam=0.4, energy_scale_wh=0.05),
                  JaxModelPool([jeng.profile])), {DENSE: jeng},
        tokenizer=jax_tok.encode, prefill_chunk=4,
        cache=jax_cache.GreenCache(mode=cache_mode, kv_cache_blocks=32,
                                   semantic_threshold=0.99), **kw)
    pserver = PoolServer(
        GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                        ModelPool([peng.profile]), device="cpu"),
        {DENSE: peng}, tokenizer=tok.encode, prefill_chunk=4,
        cache=port_cache.GreenCache(mode=cache_mode, kv_cache_blocks=32,
                                    semantic_threshold=0.99), **kw)
    return (jserver, jeng), (pserver, peng)


def test_semantic_hit_short_circuits_routing_and_engines():
    text = "Answer the question about entropy now"
    tokens = {}
    for (server, eng), qcls in zip(_small_servers(), (JaxQuery, Query)):
        server.submit_batch([qcls(uid=0, text=text, max_new_tokens=3)])
        server.run_until_drained()
        routed = server.router.n_routed
        reqs = server.submit_batch([qcls(uid=1, text=text, max_new_tokens=3)])
        assert reqs[0].done                           # already answered
        assert server.responses[1].tokens == server.responses[0].tokens
        assert server.responses[1].energy_wh == 0.0
        assert server.router.n_routed == routed       # no bandit pull
        assert eng.pending == 0                       # no engine work
        assert server.stats["cache_hits"] == 1
        tokens[qcls] = server.responses[1].tokens
    assert tokens[Query] == tokens[JaxQuery]


def test_configure_engine_applies_all_knobs_to_late_joiners():
    """``add_engine`` goes through ``_configure_engine``: a late engine
    gets the pool-level prefill chunk and its prefix-cache handle."""
    _, (server, _) = _small_servers(cache_mode="prefix")
    late = ModelEngine(MOE, get_config(MOE, **F32), max_batch=2, max_len=64,
                       device="cpu")                  # engine default: 1
    assert late.prefill_chunk == 1 and late.prefix_cache is None
    server.add_engine(late.profile, late)
    assert late.prefill_chunk == 4
    assert late.prefix_cache is server.cache.prefix_for(MOE)
    assert server.cache.prefix_for(DENSE) is server.engines[DENSE].prefix_cache


def test_prefix_discount_tilts_routing_toward_warm_arm():
    """Two identical-profile arms; arm 1 holds a cached prefix for the
    query → the energy discount flips the decision to it, in both."""
    got = []
    for router_cls, cfg_cls, pool_cls, prof_cls, q_cls, kw in (
            (JaxRouter, JaxRouterConfig, JaxModelPool, JaxModelProfile,
             JaxQuery, {}),
            (GreenServRouter, RouterConfig, ModelPool, ModelProfile, Query,
             dict(device="cpu"))):
        router = router_cls(cfg_cls(lam=0.5, energy_scale_wh=0.01),
                            pool_cls([prof_cls(name=f"m{i}", family="dense",
                                               params_b=1.0)
                                      for i in range(2)]), **kw)
        base = router.route_batch([q_cls(uid=0, text="discount probe")])[0]
        other = 1 - base.model_index
        disc = np.zeros((1, 2))
        disc[0, other] = 1.0                          # 1 Wh expected saving
        tilted = router.route_batch([q_cls(uid=1, text="discount probe")],
                                    energy_discounts_wh=disc)[0]
        assert tilted.model_index == other
        got.append((base.model_index, tilted.model_index))
    assert got[0] == got[1]


TEXTS = ["Answer the question about entropy now",
         "Summarize the committee filing on item alpha",
         "Solve the word problem with held value beta",
         "Answer the exam question about topic x: gamma"]


@pytest.mark.parametrize("featurize", ["host", "device"])
def test_features_batch_matches_per_query_features(featurize):
    """``features_batch`` (one ``probe_batch`` pass: on the device path
    the featurize wrapper over the stacked rows — its plain version for
    CPU tensors — then the logits and the read-only assignment) equals
    per-query ``features`` and the JAX package's ``features_batch``, and
    moves no routing state."""
    profiles = [ModelProfile(name="m0", family="d", params_b=1.0)]
    router = GreenServRouter(
        RouterConfig(lam=0.4, energy_scale_wh=0.05, featurize=featurize),
        ModelPool(profiles), device="cpu")
    jrouter = JaxRouter(JaxRouterConfig(lam=0.4, energy_scale_wh=0.05),
                        JaxModelPool([JaxModelProfile(name="m0", family="d",
                                                      params_b=1.0)]))
    # seed the clusters by routing a few queries through both
    warm = [Query(uid=i, text=t + " first") for i, t in enumerate(TEXTS)]
    router.route_batch(warm)
    jrouter.route_batch([JaxQuery(uid=q.uid, text=q.text) for q in warm])
    assert router.context.device_active == (featurize == "device")
    cache = port_cache.GreenCache(mode="semantic")
    cache.bind_context(router.context)
    jcache = jax_cache.GreenCache(mode="semantic")
    jcache.bind_context(jrouter.context)
    before = router.context.kmeans.state_dict()
    labels, clusters, embs = cache.features_batch(TEXTS)
    jl, jc, je = jcache.features_batch(TEXTS)
    for i, t in enumerate(TEXTS):
        task, cluster, emb = cache.features(t)
        assert int(labels[i]) == task and int(clusters[i]) == cluster
        np.testing.assert_allclose(embs[i], emb, atol=1e-5)
    np.testing.assert_array_equal(labels, jl)
    np.testing.assert_array_equal(clusters, jc)
    np.testing.assert_allclose(embs, je, atol=1e-5)
    after = router.context.kmeans.state_dict()
    np.testing.assert_array_equal(after["centroids"], before["centroids"])
    np.testing.assert_array_equal(after["counts"], before["counts"])


def test_submit_batch_uses_one_probe_pass(monkeypatch):
    _, (server, _) = _small_servers()
    cache = server.cache
    calls = {"batch": 0, "single": 0}
    real_batch, real_single = cache.features_batch, cache.features
    monkeypatch.setattr(
        cache, "features_batch",
        lambda texts: calls.__setitem__("batch", calls["batch"] + 1)
        or real_batch(texts))
    monkeypatch.setattr(
        cache, "features",
        lambda text: calls.__setitem__("single", calls["single"] + 1)
        or real_single(text))
    qs = [Query(uid=i, text=f"Probe batching question {i}",
                max_new_tokens=2) for i in range(3)]
    server.submit_batch(qs)
    assert calls["batch"] == 1                 # one pass for the admission
    assert calls["single"] == 0                # no per-query re-encode
    server.run_until_drained()
    assert calls["single"] == 0                # completion reuses the probe


# ---------------------------------------------------------------------------
# The cache workload through PoolServer, both packages
# ---------------------------------------------------------------------------

SIM_MODELS = (("qwen2.5-7b", "qwen", 7.0), ("gemma-3-12b", "gemma", 12.0),
              ("llama-3.1-8b", "llama", 8.0))


def _sim_servers(mode: str, n_queries: int):
    out = []
    for port in (False, True):
        profile = pool.make_profile if port else jax_pool.make_profile
        sim = (OutcomeSimulator if port else JaxOutcomeSimulator)(seed=3)
        engine_cls = SimEngine if port else JaxSimEngine
        engines = {name: engine_cls(profile(name, fam, b), sim,
                                    steps_per_query=2, concurrency=2)
                   for name, fam, b in SIM_MODELS}
        out.append(_server(port, engines, mode))
    return out


def _server(port: bool, engines, mode: str):
    cfg = dict(lam=0.4, energy_scale_wh=0.05)
    kw = dict(kv_cache_blocks=512, semantic_threshold=0.92)
    if port:
        router = GreenServRouter(RouterConfig(**cfg), ModelPool(
            [e.profile for e in engines.values()]), device="cpu")
        return PoolServer(router, engines, tokenizer=tok.encode,
                          prefill_chunk=4,
                          cache=port_cache.GreenCache(mode=mode, **kw))
    router = JaxRouter(JaxRouterConfig(**cfg), JaxModelPool(
        [e.profile for e in engines.values()]))
    return JaxPoolServer(router, engines, tokenizer=jax_tok.encode,
                         prefill_chunk=4,
                         cache=jax_cache.GreenCache(mode=mode, **kw))


def _model_servers(mode: str):
    out = []
    for port in (False, True):
        engines = {}
        for i, arch in enumerate((DENSE, MOE)):
            jcfg, pcfg, params, model = _pair(arch, 10 + i)
            engines[arch] = (
                ModelEngine(arch, pcfg, max_batch=4, max_len=96,
                            params=model, device="cpu") if port else
                JaxModelEngine(arch, jcfg, jax.random.PRNGKey(0),
                               max_batch=4, max_len=96, params=params))
        out.append(_server(port, engines, mode))
    return out


def _drive_both(servers, n_queries: int):
    queries, arrivals = cache_bench.make_workload(n_queries, seed=0)
    jqueries = [JaxQuery(uid=q.uid, text=q.text,
                         max_new_tokens=q.max_new_tokens) for q in queries]
    (jserver, pserver) = servers
    want = cache_bench.drive(jserver, jqueries, arrivals)
    got = cache_bench.drive(pserver, queries, arrivals)
    assert got["completed"] == want["completed"] == n_queries
    for key in ("semantic_hits", "prefix_hits", "prefix_tokens_reused",
                "steps", "admission_batches", "ttft_steps_mean"):
        assert got[key] == want[key], key
    for key in ("joules", "avoided_joules"):
        assert got[key] == pytest.approx(want[key], rel=1e-9), key
    jr, pr = jserver.responses, pserver.responses
    assert sorted(pr) == sorted(jr)
    for uid in jr:
        assert pr[uid].model_name == jr[uid].model_name
        assert pr[uid].tokens == jr[uid].tokens
        assert pr[uid].prefix_reused == jr[uid].prefix_reused
        assert pr[uid].energy_wh == pytest.approx(jr[uid].energy_wh,
                                                  rel=1e-9)
    assert pserver.stats["cache_hits"] == jserver.stats["cache_hits"]
    return got


def test_cache_workload_workload_is_the_jax_benchs():
    from benchmarks import bench_cache
    want = bench_cache.make_workload(60, seed=0)
    got = cache_bench.make_workload(60, seed=0)
    assert [q.text for q in got[0]] == [q.text for q in want[0]]
    assert got[1] == want[1]


@pytest.mark.parametrize("mode", ["off", "prefix", "semantic", "full"])
def test_cache_workload_on_sim_engines_matches_jax(mode,
                                                   equal_energy_constants):
    got = _drive_both(_sim_servers(mode, 60), 60)
    if mode in ("semantic", "full"):
        assert got["semantic_hits"] > 0
    if mode in ("prefix", "full"):
        assert got["prefix_hits"] > 0


@pytest.mark.parametrize("mode", ["off", "full"])
def test_cache_workload_on_model_engines_matches_jax(mode,
                                                     equal_energy_constants):
    got = _drive_both(_model_servers(mode), 60)
    if mode == "full":
        assert got["semantic_hits"] > 0 and got["prefix_hits"] > 0
