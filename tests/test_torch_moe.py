"""The PyTorch port's MoE family on the CPU against the JAX package, in
float32 at smoke sizes: the gating kernel's plain version (what its
wrapper runs for CPU tensors) against the Pallas kernel in interpret mode
and the jnp oracle — indices exactly equal, ties included, weights within
1e-6 (tests/test_kernels.py) — ``moe_block`` (decode group, per-row chunk
groups with padding rows, capacity overflow) within 1e-5 with the aux
loss equal, the moe parameter tree carried by ``params_from_jax``, and a
qwen2-moe ``ModelEngine`` plus a three-engine ``PoolServer`` run with
``use_pallas=True`` on both sides, token for token."""
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
from repro.kernels.moe_gating.ops import topk_gating as jax_topk_gating
from repro.kernels.moe_gating.ref import topk_gating_ref as jax_gating_ref
from repro.models import api as jax_api
from repro.models import moe as jax_moe
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.kernels.moe_gating import ops as gate_ops
from repro_torch.kernels.moe_gating.ref import topk_gating_ref
from repro_torch.models import moe
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import PoolServer
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

MOE = "qwen2-moe-a2.7b"
MAX_LEN = 64          # ≤ the smoke danube window: a full-depth KV cache
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")


def _logits(t, e, seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, e)).astype(np.float32)
    if ties:
        # quantized logits: many exact ties inside each row, and rows whose
        # k largest values are all equal.  "+ 0.0" turns -0.0 into 0.0:
        # lax.top_k orders -0.0 below 0.0, while the Pallas kernel (and the
        # port) treats them as a tie
        x = np.round(x * 2) / 2 + 0.0
        x[0] = 1.0
        x[1, ::3] = 2.0
    return x


@pytest.mark.parametrize("t,e,k", [(4, 60, 4), (32, 60, 4), (256, 8, 2),
                                   (64, 16, 1), (100, 64, 4), (7, 3, 3)])
@pytest.mark.parametrize("ties", [False, True])
def test_gating_plain_matches_jax(t, e, k, ties):
    logits = _logits(t, e, seed=t + e, ties=ties)
    w, i = gate_ops.topk_gating(torch.from_numpy(logits), k)
    jw, ji = jax_topk_gating(jnp.asarray(logits), k, block_t=64,
                             interpret=True)
    rw, ri = jax_gating_ref(jnp.asarray(logits), k)
    assert i.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)
    # the use_pallas=False counterpart (lax.top_k + softmax in the JAX
    # package) picks the same experts
    pw, pi = moe.top_k_gating(torch.from_numpy(logits), k)
    jpw, jpi = jax_moe.top_k_gating(jnp.asarray(logits), k)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(jpi))
    np.testing.assert_allclose(pw.numpy(), np.asarray(jpw), atol=1e-6)


def test_gating_wrapper_on_cpu_counts_no_launch():
    gate_ops.launches = 0
    w, i = gate_ops.topk_gating(torch.zeros((5, 8)), 2)
    assert gate_ops.launches == 0
    np.testing.assert_array_equal(i.numpy(), [[0, 1]] * 5)   # ties → lowest
    np.testing.assert_allclose(w.numpy(), 0.5)
    w2, i2 = topk_gating_ref(torch.zeros((5, 8)), 2)
    assert torch.equal(i, i2) and torch.equal(w, w2)


@pytest.fixture(scope="module")
def moe_pair():
    jcfg = jax_get_config(MOE, **F32)
    pcfg = get_config(MOE, **F32)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def test_params_from_jax_carries_the_moe_tree(moe_pair):
    _, pcfg, params, model = moe_pair
    tree = params["layers"]["moe"]
    assert len(model.layers) == pcfg.n_layers
    for i, block in enumerate(model.layers):
        for name in ("router", "wi_gate", "wi_up", "wo"):
            got = getattr(block.moe, name)
            assert got.shape == tree[name].shape[1:]
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(tree[name][i]))
        for name in ("wi_gate", "wi_up", "wo"):
            got = getattr(block.moe.shared, name)
            assert got.shape == tree["shared"][name].shape[1:]
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(tree["shared"][name][i]))
    assert not hasattr(model.layers[0], "mlp")


def _moe_case(case, d, seed):
    rng = np.random.default_rng(seed)
    if case == "decode":                 # S == 1: one group of B tokens
        return rng.standard_normal((4, 1, d)).astype(np.float32)
    if case == "chunk_padding":          # per-row groups of a chunk tick:
        x = rng.standard_normal((3, 8, d)).astype(np.float32)
        x[1, 5:] = x[1, 4]               # row 1: 5 real tokens + padding
        x[2, 1:] = 0.0                   # row 2: a decode rider + padding
        return x
    return rng.standard_normal((2, 64, d)).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("case", ["decode", "chunk_padding", "overflow"])
def test_moe_block_matches_jax(moe_pair, case, use_pallas):
    jcfg, pcfg, params, model = moe_pair
    jparams = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    pmoe = model.layers[0].moe
    x = _moe_case(case, pcfg.d_model, seed=len(case))
    if case == "overflow":
        # tilt the router toward expert 0 so its group capacity binds
        bias = np.zeros((pcfg.d_model, pcfg.n_experts), np.float32)
        bias[:, 0] = 0.5 * np.sign(x.mean(axis=(0, 1)))
        jparams = dict(jparams, router=jparams["router"] + bias)
        pmoe = moe.MoE(pcfg, torch.device("cpu"))
        pmoe.load_state_dict(model.layers[0].moe.state_dict())
        with torch.no_grad():
            pmoe.router.add_(torch.from_numpy(bias))
    jout, jaux = jax_moe.moe_block(jparams, jnp.asarray(x), jcfg,
                                   use_pallas=use_pallas)
    pout, paux = moe.moe_block(pmoe, torch.from_numpy(x), pcfg,
                               use_pallas=use_pallas)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(paux), float(jaux), rtol=1e-6)
    if case == "overflow":
        logits = x @ np.asarray(jparams["router"])
        _, idx = jax.lax.top_k(jnp.asarray(logits), pcfg.top_k)
        cap = moe.expert_capacity(x.shape[1], pcfg.n_experts, pcfg.top_k,
                                  pcfg.capacity_factor)
        per_row = [np.bincount(np.asarray(r).ravel(),
                               minlength=pcfg.n_experts) for r in idx]
        assert max(c.max() for c in per_row) > cap     # tokens were dropped


def test_chunk_padding_never_evicts_real_tokens(moe_pair):
    """Real tokens are a prefix of each row and the capacity sort is
    stable, so whatever the padding holds, the real tokens' outputs do
    not change."""
    _, pcfg, _, model = moe_pair
    x = torch.from_numpy(_moe_case("chunk_padding", pcfg.d_model, seed=3))
    y = x.clone()
    y[1, 5:] = torch.randn(3, pcfg.d_model)
    y[2, 1:] = torch.randn(7, pcfg.d_model)
    a, _ = moe.moe_block(model.layers[0].moe, x, pcfg)
    b, _ = moe.moe_block(model.layers[0].moe, y, pcfg)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[1, :5], b[1, :5], rtol=0, atol=0)
    torch.testing.assert_close(a[2, :1], b[2, :1], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,t,k,e", [(3, 37, 4, 60), (1, 4, 4, 60),
                                     (2, 8, 2, 3), (1, 512, 4, 8)])
def test_combine_is_a_sequential_scatter_add(dtype, g, t, k, e):
    """The combine (``moe._combine``) gives what a sequential scatter-add
    gives — ``index_add_`` on the CPU, fp32 sums rounded once — bit for
    bit, many tokens sharing experts included.  It replaced
    ``index_add_``, whose CUDA atomics add in the order they land, so
    that the same input gives the same output on the card (found by
    ``chip_smoke.py``'s warm == cold check on qwen2-moe-a2.7b)."""
    gen = torch.Generator().manual_seed(g * t + k)
    expert = torch.randint(0, e, (g, t * k), generator=gen)
    order = torch.argsort(expert, dim=-1, stable=True)
    contrib = (torch.randn(g, t * k, 64, generator=gen) * 10).to(dtype)
    sorted_token = torch.arange(t).repeat_interleave(k)[order]
    rows = sorted_token + torch.arange(g)[:, None] * t
    want = torch.zeros((g * t, 64), dtype=dtype).index_add_(
        0, rows.reshape(-1), contrib.reshape(-1, 64)).reshape(g, t, 64)
    got = moe._combine(contrib, order, t, k)
    assert got.dtype == dtype
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def test_moe_block_scatters_without_atomics(moe_pair, monkeypatch):
    """No ``index_add_`` (or ``index_put_`` with accumulation) on the
    MoE path: both add with atomics on CUDA."""
    _, pcfg, _, model = moe_pair

    def refuse(*args, **kwargs):
        raise AssertionError("an atomic scatter-add on the MoE path")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "index_put_", refuse)
    x = torch.from_numpy(_moe_case("chunk_padding", pcfg.d_model, seed=3))
    for use_pallas in (True, False):
        out, _ = moe.moe_block(model.layers[0].moe, x, pcfg,
                               use_pallas=use_pallas)
        assert torch.isfinite(out).all()


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


def test_moe_engine_generations_token_identical(moe_pair,
                                                equal_energy_constants):
    """Chunk ticks (per-row dispatch groups, padding rows, decode riders)
    and decode ticks (one group of all slots), gating through the kernel
    wrappers on both sides; Wh charged on the active parameters."""
    jcfg, pcfg, params, model = moe_pair
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    pcfg = dataclasses.replace(pcfg, use_pallas=True)
    jeng = JaxModelEngine(MOE, jcfg, jax.random.PRNGKey(0), max_batch=2,
                          max_len=MAX_LEN, params=params, prefill_chunk=8)
    peng = ModelEngine(MOE, pcfg, max_batch=2, max_len=MAX_LEN,
                       params=model, prefill_chunk=8, device="cpu")
    assert peng.cost_params.n_active_params == pcfg.active_param_count()
    assert pcfg.active_param_count() < pcfg.param_count()
    for e, reqs in ((jeng, _requests(JaxRequest, JaxQuery)),
                    (peng, _requests(Request, Query))):
        e.submit_many(reqs)
    jout, pout = _drain(jeng, 3), _drain(peng, 3)
    assert peng.tick_counts["chunk"] > 0 and peng.tick_counts["decode"] > 0
    for uid in jout:
        assert pout[uid].tokens == jout[uid].tokens
        assert pout[uid].energy_wh == pytest.approx(jout[uid].energy_wh,
                                                    rel=1e-12)
    assert peng.nonfinite_ticks == 0
    assert peng.cumulative_joules() == pytest.approx(jeng.cumulative_joules(),
                                                     rel=1e-12)


def test_three_engine_pool_server_matches_jax(equal_energy_constants):
    """granite, danube and qwen2-moe smoke engines (``use_pallas=True``)
    behind one router: the same arms, tokens and Wh per query."""
    archs = [MOE, "granite-3-8b", "h2o-danube-3-4b"]   # ties → arm 0
    queries = [dataclasses.replace(q, max_new_tokens=6)
               for q in make_stream(per_task=2, seed=4)[:8]]
    jengines, pengines = {}, {}
    for i, arch in enumerate(archs):
        jcfg = jax_get_config(arch, **F32, use_pallas=True)
        pcfg = get_config(arch, **F32, use_pallas=True)
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
    assert MOE in {r.model_name for r in presp.values()}
