"""The encoder-decoder layout (whisper-medium) in the port on the CPU
against the JAX package, smoke size in float32, the JAX weights carried
by ``params_from_jax``:

  * the parameter tree against ``encdec_shapes``;
  * ``encode`` and the cross K/V; the attention layer's cross branches
    (chunked prefill and decode over static encoder K/V, ``kv_override``)
    and the non-causal ``flash_prefill``, on random and on zero K/V (the
    serving engine's stub frontend: a uniform softmax over zero values,
    0 out, never NaN);
  * ``api.forward`` with ``frames`` and ``api.prefill`` with each
    ``use_pallas``; ``serve_step`` from a seeded filled cache, per-slot
    and lockstep;
  * chunked prefill == token-wise ``serve_step`` in each package and
    across them (``tests/test_prefill_chunk.py``'s whisper case);
  * ``tests/test_cache.py``'s six whisper splice cases through both
    packages;
  * a whisper ``ModelEngine`` beside a granite one in ``PoolServer``:
    the JAX package's tokens, Wh and router state.

Tolerances.  Operations are held at 2e-5 (``test_torch_prefill.py``'s
float32 limit), cache runs at ``test_cache.py``'s 3e-4.  Whole-model
logits with random frames are held at 2e-3 of the logit range, not
1e-4: the smoke stack's random cross-attention is chaotic — a relative
perturbation of 1e-7 of the JAX weights alone moves the JAX package's own
logits by ~3.3e-4 of their range (~3,300× the perturbation), as the smoke
hybrid's stack does (``test_torch_mamba.py``).  With zero cross K/V (the
serving engine's) the stack is a plain decoder, and tokens are exact.
"""
import dataclasses
import functools

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
from repro.models import api as jax_api
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.data.stream import make_stream
from repro_torch.models import api, attention, encdec
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ModelEngine, PoolServer
from test_torch_cache import PROMPT, _np, _prefill, _splice
from test_torch_costmodel import one_torch_thread  # noqa: F401
from test_torch_serving import equal_energy_constants  # noqa: F401

pytestmark = pytest.mark.port

ARCH = "whisper-medium"
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           kv_update="where")
OP_TOL = 2e-5                     # test_torch_prefill.py's float32 limit
CACHE_TOL = 3e-4                  # test_cache.py's: batched vs stepped
WHOLE = 2e-3                      # of the logit range (module docstring)
MAX_LEN = 48


@functools.lru_cache(maxsize=None)
def _pair(seed: int = 0, **overrides):
    """(JAX config, port config, JAX params, the same weights in the
    port)."""
    jcfg = jax_get_config(ARCH, **F32, **overrides)
    pcfg = get_config(ARCH, **F32, **overrides)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def _batch(cfg, b: int, s: int, seed: int):
    """numpy tokens and stub frames (N(0, 1), as test_models_smoke's
    ``_batch``)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(3, tok.VOCAB_SIZE, (b, s)).astype(np.int32),
            "frames": rng.normal(size=(b, cfg.n_frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)}


def _in_range(got, want, rel):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err,
                                                    float(np.abs(want).max()))


def _port(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The tree, the encoder, the attention branches
# ---------------------------------------------------------------------------


def test_param_tree_matches_encdec_shapes():
    """Every leaf of ``encdec_shapes`` is a parameter of the port's model
    at the same path and shape, and nothing else is."""
    jcfg, pcfg, params, model = _pair()
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jax_encdec.encdec_shapes(jcfg))
    want = {}
    for path, leaf in leaves:
        keys = [p.key for p in path]
        if keys[0] == "tok":
            keys = keys[1:]
        want[".".join(keys)] = tuple(leaf.shape)
    got = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc_layers", "dec_layers"):   # stacked layer axis
            parts = [parts[0]] + parts[2:]
            n = pcfg.n_encoder_layers if parts[0] == "enc_layers" \
                else pcfg.n_layers
            shape = (n,) + tuple(p.shape)
            assert got.setdefault(".".join(parts), shape) == shape
        else:
            got[name] = tuple(p.shape)
    assert got == want
    assert isinstance(api.init_params(pcfg, 0, "cpu"), encdec.EncDecLM)


def test_encode_and_cross_kv_match_jax():
    jcfg, pcfg, params, model = _pair()
    frames = _batch(pcfg, 2, 4, seed=1)["frames"]
    jout = jax_encdec.encode(params, jnp.asarray(frames), jcfg)
    pout = encdec.encode(model, torch.from_numpy(frames), pcfg)
    _in_range(pout.numpy(), jout, 1e-4)
    jk, jv = jax_encdec.cross_kv(params, jout, jcfg)
    enc = torch.from_numpy(np.array(jout))
    for l, layer in enumerate(model.dec_layers):
        k, v = encdec.cross_kv(layer, enc, pcfg)
        np.testing.assert_allclose(k.numpy(), jk[l], atol=OP_TOL, rtol=OP_TOL)
        np.testing.assert_allclose(v.numpy(), jv[l], atol=OP_TOL, rtol=OP_TOL)


def _layer_inputs(cfg, zero_kv: bool, seed: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, 2, cfg.n_frontend_tokens, cfg.n_kv_heads,
                          cfg.head_dim)).astype(np.float32)
    return x, kv * (0.0 if zero_kv else 1.0)


@pytest.mark.parametrize("zero_kv", [False, True])
@pytest.mark.parametrize("branch", ["prefill_chunk", "decode",
                                    "kv_override"])
def test_cross_attention_branches_match_jax(branch, zero_kv):
    """The cross branches of ``attention_prefill_chunk`` and
    ``attention_decode`` and ``attention_prefill``'s ``kv_override``
    against the JAX package's on the first decoder layer's cross
    weights; the caches stay as they were, and zero K/V give 0."""
    jcfg, pcfg, params, model = _pair()
    x, (k, v) = _layer_inputs(pcfg, zero_kv)
    jlayer = jax.tree.map(lambda a: a[0], params["dec_layers"]["cross_attn"])
    player = model.dec_layers[0].cross_attn
    lengths = np.array([3, 9], np.int32)
    n_f = pcfg.n_frontend_tokens
    pk, pv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    if branch == "prefill_chunk":
        active = np.ones((2, 6), bool)
        want, _ = jax_attn.attention_prefill_chunk(
            jlayer, x, k, v, n_f, lengths, active, jcfg, rope=False,
            cross=True)
        got = attention.attention_prefill_chunk(
            player, torch.from_numpy(x), pk, pv, n_f,
            torch.from_numpy(lengths), torch.from_numpy(active), pcfg,
            rope=False, cross=True)
    elif branch == "decode":
        want, _ = jax_attn.attention_decode(
            jlayer, x[:, :1], k, v, n_f, lengths, jcfg, rope=False,
            cross=True)
        got = attention.attention_decode(
            player, torch.from_numpy(x[:, :1]), pk, pv, n_f,
            torch.from_numpy(lengths), pcfg, rope=False, cross=True)
    else:
        pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
        want, _ = jax_attn.attention_prefill(
            jlayer, x, pos, n_f, jcfg, rope=False,
            kv_override=(jnp.asarray(k), jnp.asarray(v)))
        got = attention.attention_prefill(
            player, torch.from_numpy(x), torch.from_numpy(pos.copy()), n_f,
            pcfg, rope=False, kv_override=(pk, pv))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=OP_TOL)
    assert torch.equal(pk, torch.from_numpy(k)) and torch.equal(
        pv, torch.from_numpy(v))
    if zero_kv:
        assert not got.any()


@pytest.mark.parametrize("sq,sk,window", [(24, 16, 16), (16, 16, 16),
                                          (37, 37, 37)])
def test_noncausal_flash_prefill_matches_jax(sq, sk, window):
    """The encoder's (window = S) and the cross-attention's (window = the
    frames, fewer than the queries: rows past it see only the last keys)
    non-causal masks."""
    rng = np.random.default_rng(sq + sk)
    q = rng.normal(size=(2, sq, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, sk, 2, 32)).astype(np.float32)
            for _ in range(2))
    want = jax_attn.flash_prefill(q, k, v, window, 16, causal=False)
    got = attention.flash_prefill(*map(torch.from_numpy, (q, k, v)), window,
                                  16, causal=False)
    np.testing.assert_allclose(got.numpy(), want, atol=OP_TOL, rtol=OP_TOL)


# ---------------------------------------------------------------------------
# The model API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_and_prefill_match_jax(use_pallas):
    """Full logits with ``frames`` and the last position of the one-shot
    prefill at 2e-3 of the logit range (module docstring); the aux loss
    0.  ``use_pallas`` sends the decoder's self-attention through the
    flash kernel's wrapper on both sides."""
    jcfg, pcfg, params, model = _pair()
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    pcfg = dataclasses.replace(pcfg, use_pallas=use_pallas)
    batch = _batch(pcfg, 2, 24, seed=3)
    jout = jax_api.forward(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg)
    pout = api.forward(model, _port(batch), pcfg)
    assert pout.logits.shape == (2, 24, tok.VOCAB_SIZE)
    _in_range(pout.logits.numpy(), jout.logits, WHOLE)
    assert float(pout.aux_loss) == float(jout.aux_loss) == 0.0
    jlast = jax_api.prefill(params, batch, jcfg)
    plast = api.prefill(model, _port(batch), pcfg)
    _in_range(plast.numpy(), jlast, WHOLE)


def _filled_cache(cfg, seed: int = 9):
    rng = np.random.default_rng(seed)
    shapes = jax_api.cache_shapes(cfg, 2, MAX_LEN)
    return {k: (rng.normal(size=s.shape).astype(np.float32)
                if k != "length" else np.array([5, 17], np.int32))
            for k, s in shapes.items()}


@pytest.mark.parametrize("lockstep", [False, True])
def test_serve_step_from_filled_cache_matches_jax(lockstep):
    """One ``serve_step`` from a seeded cache (self and cross K/V random):
    logits at 2e-3 of the range, the self K/V appended where the JAX
    package appends, the cross K/V untouched, lengths advanced."""
    jcfg, pcfg, params, model = _pair()
    cache = _filled_cache(pcfg)
    if lockstep:
        cache["length"] = np.array(11, np.int32)
    token = np.array([[7], [42]], np.int32)
    jlog, jcache = jax_api.serve_step(params, jnp.asarray(token),
                                      {k: jnp.asarray(v)
                                       for k, v in cache.items()}, jcfg)
    pcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    plog, pcache = api.serve_step(model, torch.from_numpy(token), pcache,
                                  pcfg)
    _in_range(plog.numpy(), jlog, WHOLE)
    for leaf in ("k", "v", "cross_k", "cross_v"):
        np.testing.assert_allclose(pcache[leaf].numpy(), jcache[leaf],
                                   atol=OP_TOL, rtol=OP_TOL)
    np.testing.assert_array_equal(pcache["cross_k"].numpy(),
                                  cache["cross_k"])
    np.testing.assert_array_equal(pcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    assert pcache["length"].ndim == (0 if lockstep else 1)


def _token_wise(model, cfg, prompt):
    cache = api.init_cache(cfg, 1, MAX_LEN, device="cpu")
    for t in prompt:
        logits, cache = api.serve_step(
            model, torch.tensor([[t]], dtype=torch.int32), cache, cfg)
    return logits[0, 0].numpy(), cache


@pytest.mark.parametrize("chunk", [5, 14])
def test_chunked_matches_one_shot(chunk):
    """``tests/test_prefill_chunk.py``'s whisper case: chunked prefill
    (zero cross K/V, as the serving engine keeps them) == the prompt fed
    token-wise through ``serve_step`` in each package (3e-4), and the
    port's == the JAX package's."""
    jcfg, pcfg, params, model = _pair(2)
    want, jcache = _prefill(False, params, jcfg, [PROMPT], 1, chunk)
    got, pcache = _prefill(True, model, pcfg, [PROMPT], 1, chunk)
    one, ocache = _token_wise(model, pcfg, PROMPT)
    for a, b in ((got[0], one), (got[0], want[0])):
        np.testing.assert_allclose(a, b, rtol=CACHE_TOL, atol=CACHE_TOL)
    for c in (ocache, jcache):
        np.testing.assert_allclose(_np(pcache, "k"), _np(c, "k"),
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
    np.testing.assert_array_equal(_np(pcache, "length"), [len(PROMPT)])


@pytest.mark.parametrize("chunk,prefix_len", [
    (2, 4), (2, 13), (5, 8), (8, 3), (8, 13), (14, 7)])
def test_spliced_prefix_matches_cold_prefill(chunk, prefix_len):
    """``tests/test_cache.py``'s whisper cases: in each package the first
    ``prefix_len`` tokens' self K/V from a cold run, spliced into a fresh
    slot, then only the suffix prefilled, give the cold run's first-token
    logits and prompt-region cache (3e-4); the port's warm run == the JAX
    package's."""
    jcfg, pcfg, params, model = _pair()
    warm = {}
    for port, p, cfg in ((False, params, jcfg), (True, model, pcfg)):
        cold_logits, cold = _prefill(port, p, cfg, [PROMPT], 1, chunk)
        k = _np(cold, "k")[:, 0, :prefix_len].copy()
        v = _np(cold, "v")[:, 0, :prefix_len].copy()
        spliced = _splice(port, cfg, 1, 0, k, v)
        assert int(spliced["length"][0]) == prefix_len
        assert not _np(spliced, "cross_k").any()
        logits, cache = _prefill(port, p, cfg, [PROMPT], 1, chunk,
                                 cache=spliced, fed0=[prefix_len])
        np.testing.assert_allclose(logits[0], cold_logits[0],
                                   rtol=CACHE_TOL, atol=CACHE_TOL)
        n_p = len(PROMPT)
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_np(cache, leaf)[:, 0, :n_p],
                                       _np(cold, leaf)[:, 0, :n_p],
                                       rtol=CACHE_TOL, atol=CACHE_TOL)
        warm[port] = logits[0]
    np.testing.assert_allclose(warm[True], warm[False], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def test_pool_server_with_whisper_matches_jax(equal_energy_constants):
    """whisper-medium beside granite-3-8b in ``PoolServer`` (chunked
    prefill of 8, two slots each): every query answered with the JAX
    package's arm, tokens and Wh (1e-12), whisper among the arms, and the
    same router state."""
    queries = [dataclasses.replace(q, max_new_tokens=5)
               for q in make_stream(per_task=2, seed=6)[:8]]
    jengines, pengines = {}, {}
    for i, arch in enumerate((ARCH, "granite-3-8b")):
        jcfg, pcfg = jax_get_config(arch, **F32), get_config(arch, **F32)
        jeng = JaxModelEngine(arch, jcfg, jax.random.PRNGKey(i),
                              max_batch=2, max_len=MAX_LEN, prefill_chunk=8)
        jengines[arch] = jeng
        pengines[arch] = ModelEngine(
            arch, pcfg, max_batch=2, max_len=MAX_LEN, prefill_chunk=8,
            params=params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                   pcfg, device="cpu"), device="cpu")
    assert isinstance(pengines[ARCH].params, encdec.EncDecLM)
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
    assert ARCH in {r.model_name for r in presp.values()}
    for uid in jresp:
        assert presp[uid].model_name == jresp[uid].model_name
        assert presp[uid].tokens == jresp[uid].tokens
        assert presp[uid].energy_wh == pytest.approx(jresp[uid].energy_wh,
                                                     rel=1e-12)
    np.testing.assert_allclose(prouter.policy.state_dict()["theta"],
                               jrouter.policy.state_dict()["theta"],
                               atol=1e-5)
