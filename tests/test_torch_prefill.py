"""The PyTorch port's one-shot prefill path on the CPU against the JAX
package: the flash-attention kernel's plain version (what its wrapper runs
for CPU tensors) against the Pallas kernel in interpret mode and the jnp
oracle (tests/test_kernels.py's tolerances: fp32 2e-5, bf16 3e-2), the
blocked ``flash_prefill`` against the jnp one, and ``api.forward`` /
``api.prefill`` against the JAX package's with the same ``use_pallas`` on
both sides.  Logits are held within 1e-4 of their range (max |logit|):
over a 64-token sequence fp32 rounding in the two frameworks' products
moves a few logits by up to 2e-4 where the range is 4 (5e-5 of it); the
JAX package's own two attention paths differ by 3e-5 of it.  The two
``use_pallas`` paths are never compared with each other across packages:
the Pallas kernel scales q before the product and the jnp path after."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models import api as jax_api
from repro.models.attention import flash_prefill as jax_flash_prefill
from repro_torch.configs import get_config
from repro_torch.data import tokenizer as tok
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import api
from repro_torch.models.attention import flash_prefill
from repro_torch.models.convert import params_from_jax

pytestmark = pytest.mark.port

F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           param_dtype="float32")
TOL = {np.float32: 2e-5, "bfloat16": 3e-2}


def _qkv(b, sq, sk, hq, hk, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hk, hd)).astype(np.float32),
            rng.standard_normal((b, sk, hk, hd)).astype(np.float32))


# (b, sq, sk, hq, hk, hd, window, causal)
ATTN_CASES = [
    (2, 64, 64, 4, 2, 64, 64, True),          # GQA, full causal
    (1, 128, 128, 4, 4, 32, 48, True),        # MHA, window < S
    (2, 64, 192, 4, 4, 64, 192, False),       # non-causal, Sk > Sq
    (1, 128, 128, 6, 2, 128, 10_000, True),   # GQA group 3, window > S
    (1, 100, 100, 4, 2, 24, 37, True),        # ragged S, window < S
    (1, 72, 72, 4, 1, 120, 72, True),         # hd 120 (danube), ragged S
    (1, 50, 90, 2, 2, 40, 30, False),         # non-causal window, ragged
    (1, 96, 96, 4, 2, 256, 40, True),         # hd 256 (gemma3), window < S
]


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("b,sq,sk,hq,hk,hd,win,causal", ATTN_CASES)
def test_flash_attention_plain_matches_jax(dtype, b, sq, sk, hq, hk, hd,
                                           win, causal):
    q, k, v = _qkv(b, sq, sk, hq, hk, hd, seed=sq + hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    out = fa_ops.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), win,
        causal=causal).float().numpy()
    # the Pallas wrapper picks block sizes that divide S (the port's
    # kernel masks ragged tiles instead)
    kern = np.asarray(jax_flash(jq, jk, jv, window=win, chunk=64,
                                causal=causal, interpret=True)
                      .astype(jnp.float32))
    ref = np.asarray(jax_attn_ref(jq, jk, jv, window=win, causal=causal)
                     .astype(jnp.float32))
    tol = TOL[dtype]
    np.testing.assert_allclose(out, kern, atol=tol, rtol=tol)
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)


def test_flash_attention_empty_rows_are_zero_like_the_kernel():
    """Non-causal with window 4 and Sq > Sk + 4: the last rows see no key.
    The Pallas kernel gives 0 there (masked p zeroed, l clamped at 1e-30);
    the plain version follows the kernel, finite and 0."""
    q, k, v = _qkv(1, 24, 8, 2, 2, 16, seed=1)
    out = fa_ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 4, causal=False).numpy()
    kern = np.asarray(jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                window=4, chunk=8, causal=False,
                                interpret=True))
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[:, 12:], 0.0)
    np.testing.assert_allclose(out, kern, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("b,s,hq,hk,hd,win,chunk", [
    (2, 128, 4, 2, 32, 128, 32),      # four key blocks
    (1, 96, 4, 4, 24, 40, 32),        # window < S, fully masked blocks
    (1, 70, 2, 1, 16, 70, 32),        # 32 does not divide 70: one block
])
def test_flash_prefill_matches_jax(b, s, hq, hk, hd, win, chunk):
    q, k, v = _qkv(b, s, s, hq, hk, hd, seed=s)
    out = flash_prefill(*(torch.from_numpy(a) for a in (q, k, v)), win,
                        chunk).numpy()
    ref = np.asarray(jax_flash_prefill(*(jnp.asarray(a) for a in (q, k, v)),
                                       win, chunk))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


ARCHS = ["granite-3-8b", "qwen2-moe-a2.7b"]


@pytest.fixture(scope="module", params=ARCHS)
def pallas_pair(request):
    """The same weights in both packages, ``use_pallas=True`` on both."""
    jcfg = jax_get_config(request.param, **F32, use_pallas=True)
    pcfg = get_config(request.param, **F32, use_pallas=True)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(7))
    return jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def _close_in_range(got, want, rel=1e-4):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _tokens(b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(3, tok.VOCAB_SIZE, (b, s)).astype(np.int32)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_forward_and_prefill_match_jax(pallas_pair, use_pallas):
    """B = 2, S = 64 (the smoke window, so danube-style and full stacks
    see the same mask): full logits and aux loss, and the last-position
    logits of the one-shot prefill, within 1e-4 of the JAX package's with
    the same kernel switch (of the logits' range, module docstring)."""
    jcfg, pcfg, params, model = pallas_pair
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    pcfg = dataclasses.replace(pcfg, use_pallas=use_pallas)
    tokens = _tokens(2, 64, seed=3)
    jout = jax_api.forward(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    pout = api.forward(model, {"tokens": torch.from_numpy(tokens)}, pcfg)
    _close_in_range(pout.logits.numpy(), jout.logits)
    np.testing.assert_allclose(float(pout.aux_loss), float(jout.aux_loss),
                               rtol=1e-5, atol=1e-6)
    if pcfg.layout == "dense":
        assert float(pout.aux_loss) == 0.0
    jlast = jax_api.prefill(params, {"tokens": jnp.asarray(tokens)}, jcfg)
    plast = api.prefill(model, {"tokens": torch.from_numpy(tokens)}, pcfg)
    assert plast.shape == (2, tok.VOCAB_SIZE)
    _close_in_range(plast.numpy(), jlast)


def test_pallas_switch_routes_through_the_wrappers(pallas_pair, monkeypatch):
    """``use_pallas=True`` sends every layer's attention through the flash
    wrapper (and, for MoE, every layer's gate through the gating
    wrapper); ``False`` through neither."""
    from repro_torch.kernels.moe_gating import ops as gate_ops
    _, pcfg, _, model = pallas_pair
    calls = {"flash": 0, "gate": 0}
    real_fa, real_gate = fa_ops.flash_attention, gate_ops.topk_gating

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fa_ops, "flash_attention", count("flash", real_fa))
    monkeypatch.setattr(gate_ops, "topk_gating", count("gate", real_gate))
    tokens = {"tokens": torch.from_numpy(_tokens(1, 16, seed=5))}
    api.prefill(model, tokens, pcfg)
    moe = pcfg.layout == "moe"
    assert calls == {"flash": pcfg.n_layers,
                     "gate": pcfg.n_layers if moe else 0}
    api.prefill(model, tokens, dataclasses.replace(pcfg, use_pallas=False))
    assert calls == {"flash": pcfg.n_layers,
                     "gate": pcfg.n_layers if moe else 0}


PROMPT = list(range(3, 17))       # 14 tokens


@pytest.mark.parametrize("arch,chunk", [
    ("granite-3-8b", 2), ("granite-3-8b", 5), ("granite-3-8b", 8),
    ("granite-3-8b", len(PROMPT)),
    ("qwen2-moe-a2.7b", 2), ("qwen2-moe-a2.7b", 5), ("qwen2-moe-a2.7b", 8),
    ("qwen2-moe-a2.7b", len(PROMPT)),
])
def test_chunked_prefill_matches_one_shot(arch, chunk):
    """The port's chunked prefill (``api.prefill_chunk`` into the decode
    cache) gives the one-shot ``api.prefill``'s last-position logits, at
    3e-4 as tests/test_prefill_chunk.py (fp32, batched-vs-blocked
    products), with ``use_pallas=False``.  MoE capacity is set to E/k so
    that no dispatch group can drop a token: capacity is per group, and a
    14-token group may overflow an expert that 2-token groups never do."""
    pcfg = get_config(arch, **F32, use_pallas=False)
    if pcfg.layout == "moe":
        pcfg = dataclasses.replace(
            pcfg, capacity_factor=pcfg.n_experts / pcfg.top_k)
    model = api.init_params(pcfg, seed=1, device="cpu")
    ref = api.prefill(model, {"tokens": torch.tensor([PROMPT])}, pcfg)
    cache = api.init_cache(pcfg, 1, 48, device="cpu")
    for start in range(0, len(PROMPT), chunk):
        slab = PROMPT[start:start + chunk]
        toks = torch.zeros((1, chunk), dtype=torch.int32)
        toks[0, :len(slab)] = torch.tensor(slab)
        logits, cache = api.prefill_chunk(model, toks, cache, pcfg,
                                          torch.tensor([len(slab)]))
    assert int(cache["length"][0]) == len(PROMPT)
    np.testing.assert_allclose(logits[0, len(slab) - 1].numpy(),
                               ref[0].numpy(), atol=3e-4, rtol=3e-4)
