"""The port's training substrate on the CPU against the JAX package:
``cosine_lr`` over the reference test's schedule; ``adamw_update`` on a
stacked tree with fp32 and bf16 moments and a clipped gradient; int8
quantization and 30 steps of error feedback, bit-equal; ``loss_fn`` and
its gradient tree against ``jax.value_and_grad`` (rwkv6 and qwen2-moe,
whose MoE covers the aux loss), ``loss_fn`` alone on a dense and the
encoder-decoder model; ``make_train_step`` against the JAX bundle under
``jax.jit`` (3 steps, ``n_micro=2``, error feedback); the parameter tree
both ways, bit-exact, for every layout; serving that records no graph; and
the kernel wrappers' refusal of gradients they cannot give.

Both packages get the same weights: the JAX package's init rule applied
to its stacked tree, drawn from a seed.  Tolerances: losses 1e-5
relative (measured ≤ 5.4e-6); a gradient leaf's relative L2 1e-4
(measured 2.1e-6 on rwkv6, 6.3e-5 on qwen2-moe: fp32 rounding carried
through the softmax of its attention scores); after the steps, every
parameter leaf, and without error feedback every moment leaf, 2e-4
relative L2 (measured 6.4e-5 at
``tok/embed`` after 3 steps, 4.3e-6 at ``n_micro=2``, 1.5e-8 with error
feedback): each Adam step divides an element's update by that element's
own magnitude, so an element whose gradient cancels to near zero, and so
differs in its low bits between XLA's sums and PyTorch's, takes another
update of up to lr in each package — tok/embed's N(0, 0.02) values make
that show most.  With error feedback the step's residuals are held
bit-equal to ``ef_compress`` on the port's own gradients (the JAX
package's residuals are bit-equal to it on equal gradients: the
quantization test; inside ``jax.jit`` XLA fuses the residual's multiply
and subtract)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import train as jax_train
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.train import synthetic_batches as jax_batches
from repro.models import api as jax_api
from repro_torch import train as port_train
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.featurize import ops as featurize_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.linucb import ops as linucb_ops
from repro_torch.kernels.mamba2 import ops as mamba2_ops
from repro_torch.kernels.moe_gating import ops as gating_ops
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import api, convert
from repro_torch.models.layers import init_leaf_
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

F32 = dict(smoke=True, dtype="float32")
RWKV, MOE = "rwkv6-1.6b", "qwen2-moe-a2.7b"
LOSS_REL = 1e-5
GRAD_REL = 1e-4
PARAM_REL = MOMENT_REL = 2e-4


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _assert_rel(got, want, rel):
    """Every element within ``rel`` of the leaf's largest |value| (a
    moment's sum of signed gradients cancels: element by element its
    rounding is relative to the leaf, not to itself)."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rel,
                               atol=rel * np.abs(want).max())


def _assert_tree_close(got, want, rel, what):
    for path, leaf in _leaves(want):
        r = _rel_l2(convert.tree_get(got, path), leaf)
        assert r <= rel, f"{what} {'/'.join(path)}: rel L2 {r:.3g} > {rel}"


def _same_weights(arch, seed=1):
    """(JAX config, port config, JAX params, the port's model on them):
    the JAX package's init rule applied leaf by leaf to its stacked tree
    (a per-layer vector's fan-in is then the layer count, as in its
    ``materialize``), drawn from a seeded generator on the CPU — its own
    eager draws would cost an XLA compile a leaf shape — and given to
    both packages."""
    jcfg, pcfg = jax_get_config(arch, **F32), get_config(arch, **F32)
    gen = torch.Generator().manual_seed(seed)

    def draw(path, meta):
        leaf = torch.empty(meta.shape, dtype=torch.float32)
        with torch.no_grad():
            init_leaf_(path[-1], leaf, gen)
        return leaf.numpy()

    tree = {}
    for path, meta in convert.tree_items(api.param_shapes(pcfg)):
        convert.tree_set(tree, path, draw(path, meta))
    model = convert.params_from_jax(tree, pcfg, device="cpu")
    return jcfg, pcfg, jax.tree.map(jnp.asarray, tree), model


def _batches(jcfg, pcfg, b=2, s=33):
    return (jax_batches(jcfg, b, s), synthetic_batches(pcfg, b, s,
                                                       device="cpu"))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def test_cosine_lr_matches_jax():
    """The reference test's schedule, step by step, and its assertions."""
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg, pcfg = jax_train.OptConfig(**kw), port_train.OptConfig(**kw)
    for step in range(0, 101):
        want = float(jax_train.cosine_lr(jcfg, jnp.int32(step)))
        got = float(port_train.cosine_lr(pcfg, torch.tensor(step,
                                                            dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0.0)
    lrs = [float(port_train.cosine_lr(pcfg, s)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(1e-3, rel=1e-4)
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-2)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))


def _stacked_tree(rng, L=3, d=8):
    """A stacked tree: (L, d) norm gains and (L, d, d) matrices under
    ``layers``, a top-level (d,) final norm and a (d, 2d) matrix."""
    return {"layers": {"norm": 1.0 + 0.1 * rng.standard_normal((L, d)),
                       "w": rng.standard_normal((L, d, d))},
            "norm_f": 1.0 + 0.1 * rng.standard_normal(d),
            "w_out": rng.standard_normal((d, 2 * d))}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(moments):
    """Three clipped steps (the gradients' norm ~100, the clip 1.0) with
    weight decay: the stacked (L, d) norm leaf is decayed, the top-level
    (d,) one is not, in both packages — parameters and fp32 moments at
    1e-6 of each leaf's largest value, bf16 moments bit-equal."""
    rng = np.random.default_rng(0)
    tree = _stacked_tree(rng)
    kw = dict(lr=0.05, weight_decay=0.3, warmup_steps=1, total_steps=10,
              moment_dtype=moments)
    jcfg, pcfg = jax_train.OptConfig(**kw), port_train.OptConfig(**kw)
    to_j = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), t)
    to_t = lambda t: convert.tree_map(
        lambda a: torch.tensor(a, dtype=torch.float32), t)
    jp, pp = to_j(tree), to_t(tree)
    jopt = jax_train.init_opt_state(jp, jcfg)
    popt = port_train.init_opt_state(pp, pcfg)
    update = jax.jit(jax_train.adamw_update, static_argnums=3)
    for _ in range(3):
        grads = jax.tree.map(lambda a: 30.0 * rng.standard_normal(a.shape),
                             tree)
        jp, jopt, jm = update(to_j(grads), jopt, jp, jcfg)
        pp, popt, pm = port_train.adamw_update(to_t(grads), popt, pp, pcfg)
        assert float(pm["grad_norm"]) > 50.0          # the clip is active
        for k in ("lr", "grad_norm"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        assert int(popt["step"]) == int(jopt["step"])
    for path, leaf in _leaves(jp):
        _assert_rel(convert.tree_get(pp, path), leaf, 1e-6)
    for key in ("m", "v"):
        for path, leaf in _leaves(jopt[key]):
            got = convert.tree_get(popt[key], path)
            assert str(got.dtype).removeprefix("torch.") == moments
            if moments == "bfloat16":
                assert np.array_equal(_np(got), _np(leaf)), (key, path)
            else:
                _assert_rel(got, leaf, 1e-6)
    # decay by the stacked rank: the (L, d) gains moved by more than the
    # (d,) one, whose update has no decay term
    no_decay = dataclasses.replace(pcfg, weight_decay=0.0)
    flat, _, _ = port_train.adamw_update(
        to_t(grads), port_train.init_opt_state(to_t(tree), pcfg),
        to_t(tree), pcfg)
    bare, _, _ = port_train.adamw_update(
        to_t(grads), port_train.init_opt_state(to_t(tree), no_decay),
        to_t(tree), no_decay)
    assert not torch.equal(flat["layers"]["norm"], bare["layers"]["norm"])
    assert torch.equal(flat["norm_f"], bare["norm_f"])


def test_adamw_reference_cases():
    """The reference test's optimizer cases on the port: a quadratic
    converges, bf16 moments stay bf16, the clip reads the global norm."""
    cfg = port_train.OptConfig(lr=0.2, weight_decay=0.0, total_steps=200,
                               warmup_steps=0, min_lr_frac=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    opt = port_train.init_opt_state(params, cfg)
    for _ in range(150):
        params, opt, _ = port_train.adamw_update({"w": 2 * params["w"]}, opt,
                                                 params, cfg)
    assert float(params["w"].abs().max()) < 0.05
    bf = port_train.OptConfig(moment_dtype="bfloat16")
    p = {"w": torch.ones(4, 4)}
    o = port_train.init_opt_state(p, bf)
    assert o["m"]["w"].dtype == torch.bfloat16
    _, o2, _ = port_train.adamw_update({"w": torch.ones(4, 4)}, o, p, bf)
    assert o2["v"]["w"].dtype == torch.bfloat16
    clip = port_train.OptConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0,
                                warmup_steps=0, total_steps=10,
                                min_lr_frac=1.0)
    z = {"w": torch.zeros(3)}
    _, _, m = port_train.adamw_update({"w": torch.tensor([30.0, 40.0, 0.0])},
                                      port_train.init_opt_state(z, clip), z,
                                      clip)
    assert float(m["grad_norm"]) == pytest.approx(50.0, rel=1e-5)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_quantize_and_error_feedback_bit_equal():
    """``quantize_leaf`` on random values and on the int8 grid itself, and
    30 steps of ``ef_compress`` (the reference test's stream): every
    dequantized gradient and residual bit-equal to the JAX package's; the
    reference test's bounds hold on the port."""
    rng = np.random.default_rng(0)
    for x in (rng.standard_normal((16, 24)).astype(np.float32),
              np.linspace(-127, 127, 255, dtype=np.float32),
              np.zeros(5, np.float32)):
        jq, js = jax_train.quantize_leaf(jnp.asarray(x))
        pq, ps = port_train.quantize_leaf(torch.from_numpy(x))
        assert np.array_equal(pq.numpy(), np.asarray(jq))
        assert pq.dtype == torch.int8
        assert ps.item() == float(js)
        assert np.array_equal(
            port_train.dequantize_leaf(pq, ps).numpy(),
            np.asarray(jax_train.dequantize_leaf(jq, js)))
    grads = [rng.standard_normal(64).astype(np.float32) for _ in range(30)]
    shaped = rng.standard_normal((3, 5, 7)).astype(np.float32)
    jef = jax_train.ef_init({"w": jnp.zeros(64), "m": jnp.zeros((3, 5, 7))})
    pef = port_train.ef_init({"w": torch.zeros(64),
                              "m": torch.zeros(3, 5, 7)})
    total_c, total_t = np.zeros(64), np.zeros(64)
    for i, g in enumerate(grads):
        m = shaped * (i + 1) / 7
        jg, jef = jax_train.ef_compress({"w": jnp.asarray(g),
                                         "m": jnp.asarray(m)}, jef)
        pg, pef = port_train.ef_compress({"w": torch.from_numpy(g),
                                          "m": torch.from_numpy(m)}, pef)
        for k in ("w", "m"):
            assert np.array_equal(pg[k].numpy(), np.asarray(jg[k])), (i, k)
            assert np.array_equal(pef[k].numpy(), np.asarray(jef[k])), (i, k)
        total_c += pg["w"].numpy()
        total_t += g
    np.testing.assert_allclose(total_c + pef["w"].numpy(), total_t,
                               atol=1e-4)
    assert np.abs(total_c - total_t).max() < 0.05


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [RWKV, MOE])
def test_loss_and_gradients_match_jax(arch):
    """``loss_fn`` (two loss chunks, so the backward pass recomputes each)
    and every gradient leaf against ``jax.value_and_grad`` of the
    reference's, on the same weights and batch."""
    jcfg, pcfg, params, model = _same_weights(arch)
    jdata, pdata = _batches(jcfg, pcfg)
    jb, pb = next(jdata), next(pdata)
    for k in jb:
        assert np.array_equal(np.asarray(jb[k]), pb[k].numpy())
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_api.loss_fn(p, b, jcfg, loss_chunk=16),
        has_aux=True))(params, jb)
    named = convert.jax_paths(model)
    ps = [p for _, _, p in named]
    for p in ps:
        p.requires_grad_(True)
    loss, metrics = api.loss_fn(model, pb, pcfg, loss_chunk=16)
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    loss = loss.detach()
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_REL)
    for k in ("ce", "aux"):
        assert float(metrics[k].detach()) == pytest.approx(
            float(jm[k]), rel=LOSS_REL, abs=1e-7)
    if arch == MOE:
        assert float(metrics["aux"].detach()) > 0
    _assert_tree_close(convert.to_jax_tree(model, grads), jg,
                       GRAD_REL, f"{arch} gradient")


@pytest.mark.parametrize("arch", ["granite-3-8b", "whisper-medium"])
def test_loss_fn_matches_jax(arch):
    """The loss alone on a dense model and the encoder-decoder (its stub
    frames in the batch), with grad mode off."""
    jcfg, pcfg, params, model = _same_weights(arch)
    jdata, pdata = _batches(jcfg, pcfg)
    jb, pb = next(jdata), next(pdata)
    jl, jm = jax.jit(lambda p, b: jax_api.loss_fn(p, b, jcfg,
                                                  loss_chunk=16))(params, jb)
    with torch.no_grad():
        loss, metrics = api.loss_fn(model, pb, pcfg, loss_chunk=16)
    assert float(loss) == pytest.approx(float(jl), rel=LOSS_REL)
    assert float(metrics["ce"]) == pytest.approx(float(jm["ce"]),
                                                 rel=LOSS_REL)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

STEP_CASES = {"three steps": (dict(), 3), "n_micro=2": (dict(n_micro=2), 1),
              "error feedback": (dict(use_ef_compress=True), 1)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax(case):
    """rwkv6 smoke, fp32 compute, lr 1e-3, batch 4: each step's loss, lr
    and grad norm (and ce/aux at n_micro 1), then the parameters and the
    optimizer state, against the JAX bundle under ``jax.jit``.  The
    stacked norm gains are decayed in both (by their JAX rank)."""
    kw, n = STEP_CASES[case]
    ef = kw.get("use_ef_compress", False)
    jcfg, pcfg, params, model = _same_weights(RWKV)
    okw = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jo, po = jax_train.OptConfig(**okw), port_train.OptConfig(**okw)
    jdata, pdata = _batches(jcfg, pcfg, b=4)
    jbund = jax_train.make_train_step(jcfg, jax_host_mesh(), next(jdata), jo,
                                      loss_chunk=16, **kw)
    pbund = port_train.make_train_step(pcfg, make_host_mesh("cpu"),
                                       next(pdata), po, loss_chunk=16, **kw)
    assert pbund.describe == jbund.describe
    jopt = jax_train.make_opt_state(jcfg, params, jo, ef)
    popt = port_train.make_opt_state(pcfg, model, po, ef)
    fn = jax.jit(jbund.fn)
    for _ in range(n):
        jb, pb = next(jdata), next(pdata)
        if ef:      # the step's residuals: ef_compress on its gradients
            ps = [p for _, _, p in convert.jax_paths(model)]
            for p in ps:
                p.requires_grad_(True)
            loss, _ = api.loss_fn(model, pb, pcfg, loss_chunk=16)
            g = convert.to_jax_tree(model, torch.autograd.grad(loss, ps))
            for p in ps:
                p.requires_grad_(False)
            _, want_ef = port_train.ef_compress(g, popt["ef"])
        params, jopt, jm = fn(params, jopt, jb)
        model, popt, pm = pbund.fn(model, popt, pb)
        assert sorted(pm) == sorted(jm)
        for k in jm:
            rel = 1e-6 if k == "lr" else LOSS_REL
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=rel,
                                                 abs=1e-7), k
        assert int(popt["step"]) == int(jopt["step"])
        if ef:
            for path, leaf in _leaves(want_ef):
                assert torch.equal(convert.tree_get(popt["ef"], path), leaf)
    assert not any(p.requires_grad for p in model.parameters())
    _assert_tree_close(convert.params_to_jax(model, pcfg), params,
                       PARAM_REL, "parameter")
    if not ef:
        for key in ("m", "v"):
            _assert_tree_close(popt[key], jopt[key], MOMENT_REL, key)


# ---------------------------------------------------------------------------
# the parameter tree, serving, the kernels' refusal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_params_round_trip_every_layout(arch):
    """``params_to_jax(params_from_jax(t)) == t`` bit for bit, on seeded
    values in the JAX tree's shapes (the layer axis stacked, the hybrid's
    unstacked shared block, tied embeddings, encoder and decoder stacks);
    ``api.param_shapes`` has the JAX tree's paths, shapes and dtypes."""
    jcfg = jax_get_config(arch, smoke=True)
    shapes = jax_api.param_shapes(jcfg)
    rng = np.random.default_rng(3)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape)
                        .astype(np.float32), shapes)
    pcfg = get_config(arch, smoke=True)
    back = convert.params_to_jax(
        convert.params_from_jax(tree, pcfg, device="cpu"), pcfg)
    meta = api.param_shapes(pcfg)
    want = list(_leaves(tree))
    assert sorted(p for p, _ in _leaves(back)) == sorted(p for p, _ in want)
    for path, leaf in want:
        assert np.array_equal(convert.tree_get(back, path).numpy(), leaf)
        m = convert.tree_get(meta, path)
        s = convert.tree_get(shapes, path)
        assert m.is_meta and tuple(m.shape) == tuple(s.shape)
        assert str(m.dtype).removeprefix("torch.") == str(s.dtype)
    with pytest.raises(KeyError):
        convert.params_from_jax({**tree, "extra": np.zeros(1)}, pcfg,
                                device="cpu")


def test_serving_records_no_graph():
    """With every parameter requiring grad, ``api.forward``, ``prefill``,
    ``serve_step`` and ``prefill_chunk`` still return tensors without a
    graph, and ``loss_fn`` records one."""
    cfg = get_config("granite-3-8b", **F32)
    model = api.init_params(cfg, 0, "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    toks = torch.arange(8, dtype=torch.int32).reshape(1, 8)
    assert not api.prefill(model, {"tokens": toks}, cfg).requires_grad
    assert not api.forward(model, {"tokens": toks}, cfg).logits.requires_grad
    cache = api.init_cache(cfg, 1, 16, "cpu")
    logits, cache = api.prefill_chunk(model, toks, cache, cfg,
                                      torch.tensor([8], dtype=torch.int32))
    assert not logits.requires_grad
    logits, _ = api.serve_step(model, toks[:, :1], cache, cfg)
    assert not logits.requires_grad
    loss, _ = api.loss_fn(model, {"tokens": toks, "labels": toks}, cfg)
    assert loss.requires_grad


def _wrapper_calls(x):
    """Each kernel wrapper called on tensors of which ``x``-made ones may
    require grad (small shapes, CPU)."""
    q = x((1, 4, 2, 8))
    return {
        "featurize": lambda: featurize_ops.hashed_embed(
            torch.zeros(1, 4, dtype=torch.int32), x((1, 4)), x((16, 8))),
        "linucb": lambda: linucb_ops.linucb_scores(
            x((3, 4, 4)), x((3, 4)), x((4,)), 1.0),
        "moe_gating": lambda: gating_ops.topk_gating(x((4, 8)), 2),
        "flash_attention": lambda: flash_ops.flash_attention(
            q, q, q, 4, True),
        "rwkv6": lambda: rwkv6_ops.wkv(q, q, q, -torch.ones(1, 4, 2, 8),
                                       x((2, 8))),
        "mamba2": lambda: mamba2_ops.ssd(
            x((1, 4, 2, 8)), torch.ones(1, 4, 2), x((1, 4, 4)),
            x((1, 4, 4)), -torch.ones(2)),
        "decode_attention": lambda: decode_ops.decode_attention(
            x((1, 1, 2, 8)), x((1, 6, 2, 8)), x((1, 6, 2, 8)), 6, 5),
    }


def test_kernel_wrappers_refuse_gradients():
    """No kernel has a backward pass: every wrapper raises on an input
    that requires grad under grad mode (on the CPU as on the card), runs
    under ``torch.no_grad``, and a ``use_pallas`` model under training
    raises rather than train with missing gradients."""
    grad = lambda s: torch.rand(s).requires_grad_(True)  # noqa: E731
    for name, call in _wrapper_calls(grad).items():
        with pytest.raises(RuntimeError, match="no backward pass"):
            call()
        with torch.no_grad():
            call()
    for name, call in _wrapper_calls(lambda s: torch.rand(s)).items():
        call()
    cfg = dataclasses.replace(get_config(RWKV, **F32), use_pallas=True)
    model = api.init_params(cfg, 0, "cpu")
    bundle = port_train.make_train_step(
        cfg, make_host_mesh("cpu"), {}, port_train.OptConfig())
    batch = next(synthetic_batches(cfg, 1, 9, device="cpu"))
    with pytest.raises(RuntimeError, match="no backward pass"):
        bundle.fn(model, port_train.make_opt_state(cfg, model), batch)
    assert not any(p.requires_grad for p in model.parameters())
