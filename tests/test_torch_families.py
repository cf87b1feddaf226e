"""The last three decoder-only configs (llava-next-34b with its stub vision
frontend and 56 → 64 padded query heads, grok-1-314b's 8 experts top-2,
gemma3-27b's local:global at head_dim 128), the registry and the assigned
pool in the port on the CPU against the JAX package:

  * at smoke size in float32, the JAX weights carried by
    ``params_from_jax``: ``api.forward`` and ``api.prefill`` (llava with
    ``frontend_embeddings``, as ``test_models_smoke.py``'s ``_batch``
    gives them) at 1e-4 of the logit range, with each ``use_pallas``, and
    six ``serve_step``s from an empty cache (gemma3-27b on full-depth and
    on ring caches) against the JAX package's jitted ``serve_step``.  Two
    smoke stacks are chaotic: a relative perturbation of 1e-7 of the JAX
    weights moves the JAX package's own logits by 1.1e-3 of their range
    for grok (four MoE layers, no shared expert) and 1.4e-4 for
    gemma3-27b (llava's: 7.9e-6, qwen2-moe's: 6.3e-5).  So grok's
    four-layer logits are held at 3e-3 and a one-layer cut of the same
    weights at 1e-4, and gemma3-27b's at ``test_torch_gemma3.py``'s 2e-3;
  * all ten configs' ``param_count`` / ``active_param_count`` at full size
    (computed, nothing allocated), and the figures of the configs this
    slice adds;
  * ``ARCH_IDS`` in the JAX package's order, and the launcher's
    ``--pool`` choices;
  * ``cost_model_params`` and ``build_assigned_pool`` field by field.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.configs as jax_configs
from repro.configs import pool as jax_pool
from repro.models import api as jax_api
from repro_torch import configs
from repro_torch.configs import pool
from repro_torch.data import tokenizer as tok
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.models.convert import params_from_jax
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

ARCHS = ["llava-next-34b", "grok-1-314b", "gemma3-27b"]
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32")
REL = 1e-4                        # of the logit range (test_torch_prefill)
CHAOTIC = {"grok-1-314b": 3e-3,   # their smoke stacks (module docstring)
           "gemma3-27b": 2e-3}
STEPS = 6

# billions of parameters, all and active, as the JAX package counts them
FULL_SIZE_B = {"whisper-medium": (0.959, 0.959),
               "llava-next-34b": (34.389, 34.389),
               "grok-1-314b": (316.489, 84.561),
               "gemma3-27b": (27.008, 27.008)}


@functools.lru_cache(maxsize=None)
def _pair(arch: str, **overrides):
    jcfg = jax_configs.get_config(arch, **F32, **overrides)
    pcfg = configs.get_config(arch, **F32, **overrides)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(11))
    return jcfg, pcfg, params, params_from_jax(
        jax.tree.map(np.asarray, params), pcfg, device="cpu")


def _batch(cfg, b: int = 2, s: int = 32, seed: int = 0) -> dict:
    """numpy tokens, and for a vision frontend N(0, 1) patch embeddings
    (``test_models_smoke.py``'s ``_batch`` rule)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(3, tok.VOCAB_SIZE, (b, s)
                                    ).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["frontend_embeddings"] = rng.normal(
            size=(b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _in_range(got, want, rel=REL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= rel * float(np.abs(want).max()), (err,
                                                    float(np.abs(want).max()))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch,n_layers", [(a, None) for a in ARCHS]
                         + [("grok-1-314b", 1)])
def test_forward_and_prefill_match_jax(arch, n_layers, use_pallas):
    """Full logits (frontend positions included), the aux loss and the
    one-shot prefill's last position; llava's 64 computed query heads."""
    cut = {} if n_layers is None else {"n_layers": n_layers}
    rel = REL if n_layers else CHAOTIC.get(arch, REL)
    jcfg, pcfg, params, model = _pair(arch, **cut)
    jcfg = dataclasses.replace(jcfg, use_pallas=use_pallas)
    pcfg = dataclasses.replace(pcfg, use_pallas=use_pallas)
    batch = _batch(pcfg)
    jout = jax_api.forward(params, {k: jnp.asarray(v)
                                    for k, v in batch.items()}, jcfg)
    pbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pout = api.forward(model, pbatch, pcfg)
    s = 32 + (pcfg.n_frontend_tokens if pcfg.frontend == "vision" else 0)
    assert pout.logits.shape == (2, s, tok.VOCAB_SIZE)
    _in_range(pout.logits.numpy(), jout.logits, rel)
    np.testing.assert_allclose(float(pout.aux_loss), float(jout.aux_loss),
                               rtol=1e-5, atol=1e-6)
    _in_range(api.prefill(model, pbatch, pcfg).numpy(),
              jax_api.prefill(params, batch, jcfg), rel)
    if arch == "llava-next-34b":
        assert pcfg.compute_heads == 64 and pcfg.n_heads == 4
        assert model.layers[0].attn.wq.shape[1] == 64


@pytest.mark.parametrize("arch,max_len", [("llava-next-34b", 48),
                                          ("grok-1-314b", 48),
                                          ("gemma3-27b", 48),
                                          ("gemma3-27b", 96)])
def test_serve_step_matches_jax(arch, max_len):
    """``STEPS`` tokens fed one at a time from an empty cache of
    ``max_len`` (gemma3-27b at 96: rings of its smoke window 64): each
    step's logits at 1e-4 of the range, the same cache entries, lengths
    advanced."""
    jcfg, pcfg, params, model = _pair(arch, kv_update="where")
    step = jax.jit(functools.partial(jax_api.serve_step, cfg=jcfg))
    jcache = jax_api.init_cache(jcfg, 2, max_len)
    pcache = api.init_cache(pcfg, 2, max_len, device="cpu")
    assert sorted(pcache) == sorted(jcache)
    rng = np.random.default_rng(3)
    for t in range(STEPS):
        token = rng.integers(3, tok.VOCAB_SIZE, (2, 1)).astype(np.int32)
        jlog, jcache = step(params, jnp.asarray(token), jcache)
        plog, pcache = api.serve_step(model, torch.from_numpy(token), pcache,
                                      pcfg)
        _in_range(plog.numpy(), jlog, CHAOTIC.get(arch, REL))
    np.testing.assert_array_equal(pcache["length"].numpy(), [STEPS] * 2)
    for name in pcache:
        np.testing.assert_allclose(pcache[name].numpy(), jcache[name],
                                   atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The registry and the assigned pool
# ---------------------------------------------------------------------------


def test_arch_ids_in_the_jax_order():
    assert configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert len(configs.ARCH_IDS) == 10
    # the JAX launcher's --pool takes choices=ARCH_IDS
    port_choices = next(a for a in serve.build_parser()._actions
                        if a.dest == "pool").choices
    assert list(port_choices) == jax_configs.ARCH_IDS


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_full_size_configs_match_jax(arch):
    """Every field of the config, and the parameter counts computed from
    it (nothing allocated), equal the JAX package's; the configs this
    slice adds at the counts the JAX package gives."""
    jcfg, pcfg = jax_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert pcfg.param_count() == jcfg.param_count()
    assert pcfg.active_param_count() == jcfg.active_param_count()
    if arch in FULL_SIZE_B:
        got = (pcfg.param_count() / 1e9, pcfg.active_param_count() / 1e9)
        assert got == pytest.approx(FULL_SIZE_B[arch], abs=5e-4)
    smoke = dataclasses.asdict(configs.get_config(arch, smoke=True))
    assert smoke == dataclasses.asdict(jax_configs.get_config(arch,
                                                              smoke=True))


@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_cost_model_params_match_jax(arch):
    got = pool.cost_model_params(configs.get_config(arch))
    want = jax_pool.cost_model_params(jax_configs.get_config(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_assigned_pool_matches_jax():
    got, want = pool.build_assigned_pool(), jax_pool.build_assigned_pool()
    assert got.names == want.names == jax_configs.ARCH_IDS
    for g, w in zip((got[i] for i in range(len(got))),
                    (want[i] for i in range(len(want)))):
        fields = [f.name for f in dataclasses.fields(w)
                  if f.name != "arch_config"]
        assert ({f: getattr(g, f) for f in fields}
                == {f: getattr(w, f) for f in fields})
        assert dataclasses.asdict(g.arch_config) == dataclasses.asdict(
            w.arch_config)
