"""Lockstep decode and ring-buffer caches in the PyTorch port on the CPU,
against the JAX package, in float32 at smoke sizes: the decode-attention
kernel's plain version (what its wrapper runs for CPU tensors) against
the Pallas kernel in interpret mode and the jnp oracle
(tests/test_kernels.py's tolerances: fp32 2e-5, bf16 3e-2);
``attention_decode`` with a 0-d length in both ``kv_update`` modes, the
``dynamic_update_slice`` clamp at length == S included; ``serve_step``
with a 0-d length on a dense, a local:global (gemma3-12b's layout, rings
and a global layer), a sliding-window (rings only) and a hybrid smoke
model from the same filled caches; a ring-wrapping token-wise feed; the
windowed cache shapes; the tied gemma3 parameter tree; and a gemma3
``ModelEngine`` whose cache is deeper than the window.

The JAX side runs ``use_pallas=True`` under ``jax.jit`` (the Pallas
decode kernel in interpret mode at caches of S = 2048, which is where the
JAX package takes it).  Logits and cache entries are held within 1e-4 of
their range: from caches filled with random values the smoke stacks'
attention is peaky, and the two packages' fp32 sums in other orders leave
gaps of up to 4e-5 of the range (2.8e-5 in the cache entries the steps
write); which cache positions a step writes must agree exactly."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.core.types import Query as JaxQuery
from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import (
    decode_attention_ref as jax_decode_ref)
from repro.models import api as jax_api
from repro.models import attention as jax_attention
from repro.models import lm as jax_lm
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.core.types import Query
from repro_torch.data import tokenizer as tok
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import api, attention
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.engine import ModelEngine
from repro_torch.serving.request import Request

pytestmark = pytest.mark.port

F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")
TOL = {np.float32: 2e-5, "bfloat16": 3e-2}
REL = 1e-4                     # logits and cache entries (module docstring)
S_KERNEL = 2048                # the JAX package's gate for the decode kernel
# (arch, config overrides): dense, local:global (one group of 5 rings and a
# global layer, then two trailing rings), sliding-window, hybrid
SERVE_CASES = [("granite-3-8b", {}), ("gemma3-12b", dict(n_layers=8)),
               ("h2o-danube-3-4b", {}), ("zamba2-7b", {})]


def _qkv(b, s, hq, hk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, hq, hd)).astype(np.float32),
            rng.standard_normal((b, s, hk, hd)).astype(np.float32),
            rng.standard_normal((b, s, hk, hd)).astype(np.float32))


# (b, s, hq, hk, hd, cache_len, window)
DECODE_CASES = [
    (2, 1024, 8, 2, 64, 700, 10_000),       # tests/test_kernels.py's three
    (1, 2048, 4, 4, 128, 2047, 256),
    (3, 512, 6, 2, 64, 5, 10_000),
    (2, 1024, 4, 2, 256, 900, 10_000),      # gemma3's hd 256, group 2
    (2, 1024, 8, 2, 64, 1000, 100),         # a window far shorter than S
    (1, 512, 4, 2, 64, 1, 10_000),          # one visible position
]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hk,hd,clen,win", DECODE_CASES)
def test_decode_attention_plain_matches_jax(dtype, b, s, hq, hk, hd, clen,
                                            win):
    q, k, v = _qkv(b, s, hq, hk, hd, seed=s + clen)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out = da_ops.decode_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), win,
        torch.tensor(clen, dtype=torch.int32))
    assert out.dtype == tdt and out.shape == (b, 1, hq, hd)
    out = out.float().numpy()
    kern = np.asarray(jax_decode(jq, jk, jv, window=win, cache_len=clen,
                                 block_k=256, interpret=True)
                      .astype(jnp.float32))
    ref = np.asarray(jax_decode_ref(jq, jk, jv, window=win, cache_len=clen)
                     .astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(out, kern, atol=tol, rtol=tol)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_decode_attention_empty_row_is_zero_like_the_kernel():
    """cache_len 0: nothing is visible.  The Pallas kernel skips every
    block and gives 0 (l clamped at 1e-30); the plain version follows the
    kernel (the jnp oracle would average v instead)."""
    q, k, v = _qkv(2, 512, 4, 2, 32, seed=3)
    out = da_ops.decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  512, 0).numpy()
    kern = np.asarray(jax_decode(*(jnp.asarray(a) for a in (q, k, v)),
                                 window=512, cache_len=0, block_k=256,
                                 interpret=True))
    np.testing.assert_array_equal(out, 0.0)
    np.testing.assert_array_equal(kern, 0.0)


def test_decode_attention_wrapper_counts_no_launch_on_cpu_and_checks_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 64, 2, 1, 16, seed=5))
    before = da_ops.launches
    da_ops.decode_attention(q, k, v, 64, 10)
    assert da_ops.launches == before
    with pytest.raises(ValueError, match="dtypes"):
        da_ops.decode_attention(q, k.bfloat16(), v, 64, 10)
    with pytest.raises(ValueError, match="one query token"):
        da_ops.decode_attention(torch.cat([q, q], 1), k, v, 64, 10)


@pytest.fixture(scope="module")
def attn_pair():
    """One attention layer's weights (smoke granite) in both packages."""
    jcfg = jax_get_config("granite-3-8b", **F32)
    pcfg = get_config("granite-3-8b", **F32)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                            device="cpu")
    jlayer = jax.tree.map(lambda a: a[0], params["layers"])["attn"]
    return jcfg, pcfg, jlayer, model.layers[0].attn


def _filled(shape, rng):
    return (rng.standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("length", [1500, S_KERNEL])
@pytest.mark.parametrize("kv_update", ["dus", "where"])
def test_attention_decode_lockstep_matches_jax(attn_pair, kv_update, length,
                                               use_pallas, monkeypatch):
    """A 0-d length at S = 2048: the output within 2e-5 and the caches as
    the JAX package leaves them.  At length == S the ``dus`` append is
    clamped to position S - 1 and the ``where`` append writes nothing, in
    both packages.  ``use_pallas`` sends the attention through the
    decode-attention wrapper, once."""
    jcfg, pcfg, jlayer, player = attn_pair
    jcfg = dataclasses.replace(jcfg, kv_update=kv_update,
                               use_pallas=use_pallas)
    pcfg = dataclasses.replace(pcfg, kv_update=kv_update,
                               use_pallas=use_pallas)
    rng = np.random.default_rng(length)
    b, hk, hd = 2, pcfg.n_kv_heads, pcfg.head_dim
    x = rng.standard_normal((b, 1, pcfg.d_model)).astype(np.float32)
    kc, vc = (_filled((b, S_KERNEL, hk, hd), rng) for _ in range(2))
    calls = []
    real = da_ops.decode_attention
    monkeypatch.setattr(da_ops, "decode_attention",
                        lambda *a: calls.append(1) or real(*a))
    jout, (jk, jv) = jax_attention.attention_decode(
        jlayer, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(S_KERNEL), jnp.int32(length), jcfg)
    pk, pv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    pout = attention.attention_decode(
        player, torch.from_numpy(x), pk, pv, S_KERNEL,
        torch.tensor(length, dtype=torch.int32), pcfg)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)
    assert len(calls) == int(use_pallas)
    for got, want, before in ((pk, jk, kc), (pv, jv, vc)):
        want = np.asarray(want)
        written = np.flatnonzero((want != before).any(axis=(0, 2, 3)))
        np.testing.assert_array_equal(
            np.flatnonzero((got.numpy() != before).any(axis=(0, 2, 3))),
            written)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        expect = ([] if kv_update == "where" and length == S_KERNEL
                  else [min(length, S_KERNEL - 1)])
        assert written.tolist() == expect


def test_attention_decode_vector_lengths_skip_the_kernel(attn_pair,
                                                         monkeypatch):
    """Per-slot (B,) lengths at S = 2048 with ``use_pallas``: the JAX
    package attends through ``decode_attend`` and so does the port — the
    kernel takes one length for every row."""
    jcfg, pcfg, jlayer, player = attn_pair
    jcfg = dataclasses.replace(jcfg, use_pallas=True)
    pcfg = dataclasses.replace(pcfg, use_pallas=True)
    monkeypatch.setattr(da_ops, "decode_attention", None)
    rng = np.random.default_rng(8)
    b, hk, hd = 2, pcfg.n_kv_heads, pcfg.head_dim
    x = rng.standard_normal((b, 1, pcfg.d_model)).astype(np.float32)
    kc, vc = (_filled((b, S_KERNEL, hk, hd), rng) for _ in range(2))
    lengths = np.array([1500, 2047], np.int32)
    jout, _ = jax_attention.attention_decode(
        jlayer, jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(S_KERNEL), jnp.asarray(lengths), jcfg)
    pout = attention.attention_decode(
        player, torch.from_numpy(x), torch.from_numpy(kc),
        torch.from_numpy(vc), S_KERNEL, torch.from_numpy(lengths), pcfg)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)


def _pair(arch, seed, **overrides):
    jcfg = jax_get_config(arch, **F32, **overrides)
    pcfg = get_config(arch, **F32, **overrides)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def _close_in_range(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(3, tok.VOCAB_SIZE, (b, s)).astype(np.int32)


def _jax_step(cfg):
    return jax.jit(functools.partial(jax_api.serve_step, cfg=cfg))


@pytest.mark.parametrize("arch,overrides", SERVE_CASES,
                         ids=[a for a, _ in SERVE_CASES])
def test_lockstep_serve_step_matches_jax(arch, overrides, monkeypatch):
    """Three ``serve_step``s with a 0-d length of 1500 from caches filled
    with the same seeded values, ``use_pallas=True`` on both sides:
    logits and every cache entry within ``REL`` of their range, the same
    positions written, and the length 0-d and equal.  The decode kernel's
    wrapper runs at every full-depth attention layer of S ≥ 2048 (dense:
    every layer; local:global: the global layer; the hybrid: each site)
    and nowhere else."""
    jcfg, pcfg, params, model = _pair(arch, 9, use_pallas=True, **overrides)
    jcache = jax_api.init_cache(jcfg, 2, S_KERNEL)
    pcache = api.init_cache(pcfg, 2, S_KERNEL, device="cpu")
    assert sorted(pcache) == sorted(jcache)
    rng = np.random.default_rng(10)
    filled = {}
    for name in jcache:
        if name != "length":
            filled[name] = _filled(jcache[name].shape, rng)
            jcache[name] = jnp.asarray(filled[name])
            pcache[name] = torch.from_numpy(filled[name].copy())
    jcache["length"] = jnp.int32(1500)
    pcache["length"] = torch.tensor(1500, dtype=torch.int32)
    calls = []
    real = da_ops.decode_attention
    monkeypatch.setattr(da_ops, "decode_attention",
                        lambda *a: calls.append(1) or real(*a))
    step = _jax_step(jcfg)
    tokens = _tokens(2, 3, seed=11)
    for t in range(3):
        jl, jcache = step(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        pl, pcache = api.serve_step(
            model, torch.from_numpy(tokens[:, t:t + 1]), pcache, pcfg)
        _close_in_range(pl.numpy(), jl)
    for name, before in filled.items():
        got, want = pcache[name].numpy(), np.asarray(jcache[name])
        _close_in_range(got, want)
        np.testing.assert_array_equal(got != before, want != before)
    assert pcache["length"].ndim == 0 and int(pcache["length"]) == 1503
    assert int(jcache["length"]) == 1503
    per_step = {"granite-3-8b": pcfg.n_layers, "gemma3-12b": 1,
                "h2o-danube-3-4b": 0,
                "zamba2-7b": pcfg.n_layers // pcfg.attn_every}[arch]
    assert len(calls) == 3 * per_step


@pytest.mark.parametrize("lengths", [5, 71, (5, 71)],
                         ids=["warm-up", "wrapped", "per-slot"])
def test_ring_decode_matches_jax(attn_pair, lengths):
    """``attention_decode_ring`` on a 64-slot ring filled with seeded
    values: a 0-d length before the ring is full (entries past the length
    masked), one past a wrap, and per-slot lengths — the output within
    2e-5 and the ring written at slot length % W, as in the JAX package."""
    jcfg, pcfg, jlayer, player = attn_pair
    rng = np.random.default_rng(17)
    b, w, hk, hd = 2, 64, pcfg.n_kv_heads, pcfg.head_dim
    x = rng.standard_normal((b, 1, pcfg.d_model)).astype(np.float32)
    kr, vr = (_filled((b, w, hk, hd), rng) for _ in range(2))
    length = np.asarray(lengths, np.int32)
    jout, (jk, jv) = jax_attention.attention_decode_ring(
        jlayer, jnp.asarray(x), jnp.asarray(kr), jnp.asarray(vr),
        jnp.asarray(length), jcfg)
    pk, pv = torch.from_numpy(kr.copy()), torch.from_numpy(vr.copy())
    pout = attention.attention_decode_ring(
        player, torch.from_numpy(x), pk, pv, torch.from_numpy(length), pcfg)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=2e-5)
    for got, want, before in ((pk, jk, kr), (pv, jv, vr)):
        want = np.asarray(want)
        np.testing.assert_array_equal(got.numpy() != before, want != before)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
        slots = [np.flatnonzero((want[i] != before[i]).any(axis=(1, 2)))
                 for i in range(b)]
        assert [s.tolist() for s in slots] == [
            [int(n) % w] for n in np.broadcast_to(length, (b,))]


# The smoke gemma3 amplifies fp32 rounding: perturbing every JAX weight
# by 1e-7 of itself (about one fp32 unit) moves the 6-layer, window-16
# stack's logits over a 24-token feed by 2.1e-4 to 4.7e-4 of their range
# (three perturbation seeds).  The port and the JAX package fed the same
# tokens differ by 1.3e-4, and the port's token-wise and one-shot paths
# by 4.3e-4 (the JAX package's own by 1e-4), so the feed is held at
# FEED_REL; a ring slot or a mask off by one moves logits by the order of
# the range.  ``test_ring_decode_matches_jax`` holds the ring layer itself
# at 2e-5.
FEED_REL = 2e-3


def test_ring_wrap_feed_matches_jax_and_one_shot_forward():
    """gemma3 with 6 layers and a window of 16 (5 rings of 16, one global
    layer at S = 2048) fed 24 tokens one at a time in lockstep, so the
    rings wrap and the global layer attends through the decode wrapper
    every step: every step's logits against the JAX package's, the last
    against the port's own one-shot ``api.forward`` (windowed flash
    prefill), and the caches against the JAX package's."""
    jcfg, pcfg, params, model = _pair("gemma3-12b", 12, n_layers=6,
                                      window=16, use_pallas=True)
    n = 24
    tokens = _tokens(1, n, seed=13)
    jcache = jax_api.init_cache(jcfg, 1, S_KERNEL)
    pcache = api.init_cache(pcfg, 1, S_KERNEL, device="cpu")
    jcache["length"] = jnp.int32(0)
    pcache["length"] = torch.tensor(0, dtype=torch.int32)
    assert pcache["k_local"].shape[2] == pcfg.window < n
    step = _jax_step(jcfg)
    for t in range(n):
        jl, jcache = step(params, jnp.asarray(tokens[:, t:t + 1]), jcache)
        pl, pcache = api.serve_step(
            model, torch.from_numpy(tokens[:, t:t + 1]), pcache, pcfg)
        _close_in_range(pl.numpy(), jl, FEED_REL)
    for name in ("k_local", "v_local", "k_global", "v_global"):
        _close_in_range(pcache[name].numpy(), jcache[name], FEED_REL)
    assert int(pcache["length"]) == n
    one = api.forward(model, {"tokens": torch.from_numpy(tokens)}, pcfg)
    _close_in_range(pl[:, 0].numpy(), one.logits[:, -1].numpy(), FEED_REL)


@pytest.mark.parametrize("arch,overrides,max_len", [
    ("gemma3-12b", dict(n_layers=12), 128),     # rings and global caches
    ("gemma3-12b", dict(n_layers=8), 128),      # trailing rings
    ("gemma3-12b", {}, 128),                    # 3 layers: rings only
    ("gemma3-12b", dict(n_layers=6), 64),       # max_len = window: full
    ("h2o-danube-3-4b", {}, 128),               # swa: rings only
])
def test_windowed_cache_shapes_match_jax(arch, overrides, max_len):
    jcfg = jax_get_config(arch, smoke=True, **overrides)
    pcfg = get_config(arch, smoke=True, **overrides)
    want = jax_lm.cache_shapes(jcfg, 3, max_len)
    got = api.init_cache(pcfg, 3, max_len, device="cpu")
    assert sorted(got) == sorted(want)
    for name, sds in want.items():
        assert tuple(got[name].shape) == tuple(sds.shape), name
        assert str(got[name].dtype).removeprefix("torch.") == str(sds.dtype)


def test_params_from_jax_carries_the_tied_gemma3_tree():
    """The tied tree has one embedding table, used as the LM head; every
    leaf is carried, and the full logits match the JAX package's within
    ``FEED_REL`` (the same chaotic stack as the feed's)."""
    jcfg, pcfg, params, model = _pair("gemma3-12b", 14, n_layers=6,
                                      window=16)
    assert pcfg.tie_embeddings and "unembed" not in params["tok"]
    assert model.unembed is None
    np.testing.assert_array_equal(model.embed.numpy(),
                                  np.asarray(params["tok"]["embed"]))
    assert (sum(p.numel() for p in model.parameters())
            == sum(a.size for a in jax.tree.leaves(params)))
    tokens = _tokens(2, 24, seed=15)
    jout = jax_api.forward(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    pout = api.forward(model, {"tokens": torch.from_numpy(tokens)}, pcfg)
    _close_in_range(pout.logits.numpy(), jout.logits, FEED_REL)


def _requests(req_cls, q_cls):
    prompts = [tok.encode("the quick brown fox jumps over the lazy dog and "
                          "then some more"), tok.encode("jumps"),
               tok.encode("over the lazy dog, twice over the lazy dog")]
    return [req_cls(query=q_cls(uid=i, text=f"q{i}"), prompt_tokens=p,
                    max_new_tokens=12) for i, p in enumerate(prompts)]


def test_gemma3_engine_with_rings_generates_jax_tokens():
    """A 6-layer gemma3 (5 rings of 64 and a global layer) served by a
    ``ModelEngine`` at ``max_len`` 96: prompts go token-wise (no ``k``
    entry), a 58-token prompt plus 12 new tokens wraps its ring, and the
    three requests on two slots give the JAX engine's tokens."""
    jcfg, pcfg, params, model = _pair("gemma3-12b", 16, n_layers=6)
    jeng = JaxModelEngine("gemma3", jcfg, jax.random.PRNGKey(0), max_batch=2,
                          max_len=96, params=params, prefill_chunk=8)
    peng = ModelEngine("gemma3", pcfg, max_batch=2, max_len=96, params=model,
                       prefill_chunk=8, device="cpu")
    assert "k_local" in peng.cache and "k" not in peng.cache
    assert peng.prefill_chunk == 1
    outs = []
    for eng, reqs in ((jeng, _requests(JaxRequest, JaxQuery)),
                      (peng, _requests(Request, Query))):
        eng.submit_many(reqs)
        done = []
        for _ in range(400):
            done += eng.step()
            if len(done) == 3:
                break
        outs.append({r.uid: r.tokens for r in done})
    assert outs[1] == outs[0] and len(outs[0]) == 3
    assert peng.tick_counts["chunk"] == 0 and peng.nonfinite_ticks == 0
