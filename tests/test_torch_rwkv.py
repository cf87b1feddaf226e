"""The PyTorch port's RWKV6 family on the CPU against the JAX package, in
float32 at smoke sizes: the WKV kernel's plain version (what its wrapper
runs for CPU tensors) against the Pallas kernel in interpret mode and the
jnp oracle at tests/test_kernels.py's 2e-4, a ragged S and a nonzero
initial state included; the chunked ``wkv_chunked``, ``rwkv_time_mix``
and ``rwkv_channel_mix`` on weights carried by ``params_from_jax``;
``api.forward``/``api.prefill`` with each ``use_pallas`` on both sides
(logits within 1e-4 of their range, as tests/test_torch_prefill.py);
token-wise ``serve_step`` with every cache entry; a one-slot
``ModelEngine`` that serves the same prompt twice (the recurrent state
carries over between requests in both packages); and a ``PoolServer``
over the launcher's default pool (granite-3-8b, rwkv6-1.6b,
qwen2-moe-a2.7b), decision for decision and token for token."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data.stream import make_stream
from repro.kernels.rwkv6.ops import wkv as jax_wkv
from repro.kernels.rwkv6.ref import wkv_ref as jax_wkv_ref
from repro.models import api as jax_api
from repro.models import rwkv as jax_rwkv
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.kernels.rwkv6 import ops as wkv_ops
from repro_torch.models import api, rwkv
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import PoolServer
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

ARCH = "rwkv6-1.6b"
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")
WKV_TOL = 2e-4                 # tests/test_kernels.py's WKV tolerance


def _wkv_inputs(b, s, h, kd, seed, with_s0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, kd)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.uniform(-6.0, -2.0, (b, s, h, kd))).astype(np.float32)
    u = rng.standard_normal((h, kd)).astype(np.float32) * 0.5
    s0 = (rng.standard_normal((b, h, kd, kd)).astype(np.float32) * 0.1
          if with_s0 else None)
    return r, k, v, logw, u, s0


def _torch(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(arrays):
    return [None if a is None else jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("b,s,h,kd,chunk", [
    (1, 64, 1, 64, 16), (2, 96, 3, 64, 32),      # tests/test_kernels.py
    (1, 100, 2, 64, 32),                         # ragged: no chunk divides
])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv_plain_matches_jax(b, s, h, kd, chunk, with_s0):
    ins = _wkv_inputs(b, s, h, kd, seed=s + h, with_s0=with_s0)
    y, s_fin = wkv_ops.wkv(*_torch(ins))
    j = _jax(ins)
    ky, ks = jax_wkv(*j[:5], s0=j[5], chunk=chunk, interpret=True)
    ry, rs = jax_wkv_ref(*j[:5], s0=j[5])
    assert y.dtype == torch.float32 and s_fin.shape == (b, h, kd, kd)
    for got, want in ((y, ky), (s_fin, ks), (y, ry), (s_fin, rs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=WKV_TOL, rtol=WKV_TOL)


def test_wkv_plain_takes_the_models_dtypes():
    """r, k, v in bf16 with logw, u and s0 in fp32, as ``rwkv_time_mix``
    gives them: y comes back in bf16 within one bf16 unit of the jnp
    oracle's (both accumulate in fp32 and round y once), the state fp32
    at the kernel tolerance."""
    r, k, v, logw, u, s0 = _wkv_inputs(2, 40, 2, 64, seed=1, with_s0=True)
    rkv = [torch.from_numpy(a).to(torch.bfloat16) for a in (r, k, v)]
    y, s_fin = wkv_ops.wkv(*rkv, *_torch((logw, u, s0)))
    jr, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (r, k, v))
    ry, rs = jax_wkv_ref(jr, jk, jv, *_jax((logw, u)), s0=jnp.asarray(s0))
    assert y.dtype == torch.bfloat16 and s_fin.dtype == torch.float32
    want = np.asarray(ry.astype(jnp.float32))
    rms = float(np.sqrt((want ** 2).mean()))
    np.testing.assert_allclose(y.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * rms)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(rs), atol=WKV_TOL,
                               rtol=WKV_TOL)


def test_wkv_wrapper_counts_no_launch_on_cpu_and_checks_inputs():
    ins = _torch(_wkv_inputs(1, 8, 2, 64, seed=0, with_s0=False))
    before = wkv_ops.launches
    wkv_ops.wkv(*ins)
    assert wkv_ops.launches == before
    r, k, v, logw, u, _ = ins
    with pytest.raises(ValueError, match="shapes"):
        wkv_ops.wkv(r, k, v[:, :4], logw, u)
    with pytest.raises(ValueError, match="dtypes"):
        wkv_ops.wkv(r, k.double(), v, logw, u)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wkv_ops.wkv(*(t.to("meta") for t in (r, k, v, logw, u)))


@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 128), (100, 32)])
def test_wkv_chunked_matches_jax(s, chunk):
    """Four chunks; one chunk shorter than ``chunk``; and 100 % 32 != 0,
    where both fall back to a single chunk of S."""
    ins = _wkv_inputs(2, s, 2, 64, seed=s, with_s0=True)
    y, s_fin = rwkv.wkv_chunked(*_torch(ins[:5]), chunk=chunk,
                                s0=torch.from_numpy(ins[5]))
    j = _jax(ins)
    jy, js = jax_rwkv.wkv_chunked(*j[:5], chunk=chunk, s0=j[5])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(s_fin.numpy(), np.asarray(js), atol=WKV_TOL,
                               rtol=WKV_TOL)


@pytest.fixture(scope="module")
def rwkv_pair():
    jcfg = jax_get_config(ARCH, **F32)
    pcfg = get_config(ARCH, **F32)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def test_params_from_jax_carries_the_rwkv_tree(rwkv_pair):
    _, pcfg, params, model = rwkv_pair
    layers = params["layers"]
    n = 0
    for i, block in enumerate(model.layers):
        for name in ("ln1", "ln2"):
            np.testing.assert_array_equal(getattr(block, name).numpy(),
                                          np.asarray(layers[name][i]))
            n += 1
        for name, leaf in layers["rwkv"].items():
            np.testing.assert_array_equal(
                getattr(block.rwkv, name).numpy(), np.asarray(leaf[i]))
            n += 1
    assert n == len(jax.tree.leaves(layers)) * pcfg.n_layers
    assert block.rwkv.decay_base.dtype == torch.float32
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["tok"]["embed"]))


def _state(rng, b, d, h):
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((b, h, 64, 64)).astype(np.float32) * 0.1)


@pytest.mark.parametrize("s,use_pallas", [(24, False), (24, True), (1, False)])
def test_time_and_channel_mix_match_jax(rwkv_pair, s, use_pallas):
    """One layer's time-mix (from a nonzero state: the shifts and the WKV
    state) and channel-mix, prefill (S = 24, each WKV path) and the
    one-token decode step, outputs and every state entry at 1e-5."""
    jcfg, pcfg, params, model = rwkv_pair
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    pcfg = dataclasses.replace(pcfg, use_pallas=use_pallas)
    rng = np.random.default_rng(s)
    h, _ = rwkv.rwkv_dims(pcfg)
    x = rng.standard_normal((2, s, pcfg.d_model)).astype(np.float32)
    st = _state(rng, 2, pcfg.d_model, h)
    lp = jax.tree.map(lambda a: a[1], params["layers"])["rwkv"]
    decode = s == 1
    jst = jax_rwkv.RwkvLayerState(*_jax(st))
    pst = rwkv.RwkvLayerState(*_torch(st))
    jo, jst = jax_rwkv.rwkv_time_mix(lp, jnp.asarray(x), jst, jcfg,
                                     decode=decode)
    po, pst = rwkv.rwkv_time_mix(model.layers[1].rwkv, torch.from_numpy(x),
                                 pst, pcfg, decode=decode)
    jc, jst = jax_rwkv.rwkv_channel_mix(lp, jo, jst, jcfg)
    pc, pst = rwkv.rwkv_channel_mix(model.layers[1].rwkv, po, pst, pcfg)
    for got, want in ((po, jo), (pc, jc)) + tuple(zip(pst, jst)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def _close_in_range(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(3, tok.VOCAB_SIZE, (b, s)).astype(np.int32)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_and_prefill_match_jax(rwkv_pair, use_pallas, monkeypatch):
    """B = 2, S = 64: full logits and the one-shot prefill's last-position
    logits within 1e-4 of the JAX package's with the same kernel switch;
    ``use_pallas=True`` sends every layer's scan through the WKV wrapper,
    ``False`` through none."""
    jcfg, pcfg, params, model = rwkv_pair
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    pcfg = dataclasses.replace(pcfg, use_pallas=use_pallas)
    calls = []
    real = wkv_ops.wkv
    monkeypatch.setattr(wkv_ops, "wkv",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    tokens = _tokens(2, 64, seed=3)
    jout = jax_api.forward(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    pout = api.forward(model, {"tokens": torch.from_numpy(tokens)}, pcfg)
    _close_in_range(pout.logits.numpy(), jout.logits)
    assert float(pout.aux_loss) == 0.0
    assert len(calls) == (pcfg.n_layers if use_pallas else 0)
    jlast = jax_api.prefill(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    plast = api.prefill(model, {"tokens": torch.from_numpy(tokens)}, pcfg)
    assert plast.shape == (2, tok.VOCAB_SIZE)
    _close_in_range(plast.numpy(), jlast)


def test_serve_step_logits_and_cache_match_jax(rwkv_pair):
    """Six token-wise steps on two slots: logits within 1e-4 and every
    cache entry (shifts, WKV state) within 1e-5 of its range; lengths
    equal."""
    jcfg, pcfg, params, model = rwkv_pair
    jcache = jax_api.init_cache(jcfg, 2, 32)
    pcache = api.init_cache(pcfg, 2, 32, device="cpu")
    assert sorted(pcache) == sorted(jcache)
    tokens = _tokens(2, 6, seed=4)
    for t in range(6):
        jl, jcache = jax_api.serve_step(
            params, jnp.asarray(tokens[:, t:t + 1]), jcache, jcfg)
        pl, pcache = api.serve_step(
            model, torch.from_numpy(tokens[:, t:t + 1]), pcache, pcfg)
        _close_in_range(pl.numpy(), jl)
    for name in ("shift_tm", "shift_cm", "wkv"):
        assert pcache[name].dtype == torch.float32
        assert jcache[name].dtype == jnp.float32
        _close_in_range(pcache[name].numpy(), jcache[name], rel=1e-5)
    np.testing.assert_array_equal(pcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    np.testing.assert_array_equal(pcache["length"].numpy(), [6, 6])


@pytest.mark.parametrize("use_pallas", [True, False])
def test_one_shot_prefill_matches_token_wise(rwkv_pair, use_pallas):
    """The port's one-shot ``api.prefill`` (through the WKV wrapper or the
    chunked form) gives the last-position logits of feeding the prompt
    token by token through ``serve_step``, within 1e-4 of their range."""
    _, pcfg, _, model = rwkv_pair
    pcfg = dataclasses.replace(pcfg, use_pallas=use_pallas)
    tokens = torch.from_numpy(_tokens(2, 40, seed=5))
    one = api.prefill(model, {"tokens": tokens}, pcfg)
    cache = api.init_cache(pcfg, 2, 48, device="cpu")
    for t in range(tokens.shape[1]):
        step, cache = api.serve_step(model, tokens[:, t:t + 1], cache, pcfg)
    _close_in_range(step[:, 0].numpy(), one.numpy())


def test_chunked_prefill_is_refused():
    pcfg = get_config(ARCH, **F32)
    model = api.init_params(pcfg, seed=0, device="cpu")
    cache = api.init_cache(pcfg, 1, 16, device="cpu")
    assert not api.supports_chunked_prefill(pcfg)
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        api.prefill_chunk(model, torch.ones((1, 4), dtype=torch.int32), cache,
                          pcfg, torch.tensor([4]))


@pytest.fixture
def equal_energy_constants(monkeypatch):
    """Set the port's H100 constants to the JAX package's values."""
    import repro.core.energy as jax_energy
    import repro_torch.core.energy as port_energy
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "CHIP_TDP_W", "CHIP_IDLE_W",
                 "E_PER_FLOP", "E_PER_HBM_BYTE"):
        monkeypatch.setattr(port_energy, name, getattr(jax_energy, name))
    monkeypatch.setattr(port_energy, "LINK_BW",
                        jax_energy.ICI_BW_PER_LINK * jax_energy.ICI_LINKS)
    monkeypatch.setattr(port_energy, "E_PER_LINK_BYTE",
                        jax_energy.E_PER_ICI_BYTE)


def _drain(engine, n):
    done = []
    for _ in range(400):
        done += engine.step()
        if len(done) == n:
            return done
    raise AssertionError("engine did not drain")


def test_one_slot_engine_carries_state_like_jax(rwkv_pair,
                                                equal_energy_constants):
    """``max_batch=1``, the prompt "the quick brown fox" twice, 6 new
    tokens each, served one request after the other.  Admission resets only
    the slot's length, so the second request starts from the first one's
    recurrent state (a fault of the reference, ROADMAP C) and generates
    other tokens; the port reproduces both requests token for token."""
    jcfg, pcfg, params, model = rwkv_pair
    prompt = tok.encode("the quick brown fox")
    jeng = JaxModelEngine(ARCH, jcfg, jax.random.PRNGKey(0), max_batch=1,
                          max_len=96, params=params, prefill_chunk=8)
    peng = ModelEngine(ARCH, pcfg, max_batch=1, max_len=96, params=model,
                       prefill_chunk=8, device="cpu")
    assert peng.prefill_chunk == 1 == jeng.prefill_chunk
    outs = []
    for eng, req_cls, q_cls in ((jeng, JaxRequest, JaxQuery),
                                (peng, Request, Query)):
        done = []
        for uid in range(2):
            eng.submit(req_cls(query=q_cls(uid=uid, text="fox"),
                               prompt_tokens=list(prompt), max_new_tokens=6))
            done += _drain(eng, 1)
        outs.append(done)
    jout, pout = outs
    assert jout[0].tokens != jout[1].tokens
    for j, p in zip(jout, pout):
        assert p.tokens == j.tokens
        assert p.energy_wh == pytest.approx(j.energy_wh, rel=1e-12)
    assert peng.tick_counts["chunk"] == 0
    assert peng.tick_counts["decode"] == peng.n_steps == jeng.n_steps
    assert peng.nonfinite_ticks == 0


def test_default_pool_server_matches_jax(equal_energy_constants):
    """The serving launcher's default pool — granite-3-8b, rwkv6-1.6b,
    qwen2-moe-a2.7b smoke engines, ``use_pallas=True`` — behind one
    router: the same arm, tokens and Wh per query, with rwkv6 answering
    some of them token-wise (first in the pool: untried arms tie, and ties
    go to arm 0)."""
    archs = [ARCH, "granite-3-8b", "qwen2-moe-a2.7b"]
    queries = [dataclasses.replace(q, max_new_tokens=6)
               for q in make_stream(per_task=2, seed=4)[:8]]
    jengines, pengines = {}, {}
    for i, arch in enumerate(archs):
        jcfg = jax_get_config(arch, **F32, use_pallas=True)
        pcfg = get_config(arch, **F32, use_pallas=True)
        jeng = JaxModelEngine(arch, jcfg, jax.random.PRNGKey(i),
                              max_batch=2, max_len=64, prefill_chunk=8)
        jengines[arch] = jeng
        pengines[arch] = ModelEngine(
            arch, pcfg, max_batch=2, max_len=64, prefill_chunk=8,
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
        server.run_until_drained(max_steps=2000)
        runs.append(server.responses)
    jresp, presp = runs
    assert sorted(presp) == sorted(jresp) == sorted(q.uid for q in queries)
    for uid in jresp:
        assert presp[uid].model_name == jresp[uid].model_name
        assert presp[uid].tokens == jresp[uid].tokens
        assert presp[uid].energy_wh == pytest.approx(jresp[uid].energy_wh,
                                                     rel=1e-12)
    assert ARCH in {r.model_name for r in presp.values()}
    assert pengines[ARCH].prefill_chunk == 1
