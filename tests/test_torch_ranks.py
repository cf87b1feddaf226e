"""The port's training over ranks on the CPU against the JAX package's
GSPMD step: gloo ranks, one process each, spawned twice
(``distributed/ranks.py::spawn``, a ``file://`` rendezvous) — 2 ranks for
every train step case and the launcher, 4 for ``compressed_psum`` — and
the JAX side once, in one subprocess with 8 fake CPU devices.

- The train step on the rank mesh (2, 1) against the JAX bundle under
  ``jax.jit`` on ``make_mesh((2, 1))``, 3 steps: rwkv6 smoke in fp32, lr
  1e-3, B = 4, ``n_micro`` 1 and 2, with and without error feedback;
  qwen2-moe smoke at ``n_micro`` 1 (the aux loss).  At
  ``tests/test_torch_train.py``'s tolerances: the first step's metrics
  (1e-5 relative), every parameter
  and, without error feedback, every moment leaf after it (2e-4 relative
  L2); the loss of every step (1e-5).  The later steps' states are not
  held to the JAX package's: after an Adam step each element whose
  gradient cancels near zero, and so differs in its low bits between
  XLA's sums and PyTorch's, takes another update of up to lr in each
  package, and XLA's sums over the (2, 1) mesh differ from its sums on
  one device.  Measured after 3 steps against (2, 1): rwkv6's moments
  4.6e-4, qwen2-moe's parameters 1.2e-3 and moments 1.4e-2 (MoE routing
  follows the moved weights).
- The same 2 ranks against the port's own step in one process on the
  whole batch, where both sum in PyTorch: every step's metrics (1e-5),
  every parameter and, without error feedback, every moment leaf after
  the third step (2e-4; measured 5.3e-7 and 8.1e-5).  qwen2-moe's grad
  norm is held at the first step only: at the third it parts by 4.8e-5
  while its parameters stay within 5.3e-7.  Both ranks hold bit-equal
  metrics and states at every step; with error feedback at ``n_micro`` 1
  each step's residuals are bit-equal to ``ef_compress`` on the port's
  own reduced gradients.  rwkv6 at B = 3, which "data" does not divide,
  is replicated: each rank steps on the whole batch, bit-equal to the
  one process.
- ``compressed_psum`` over 4 ranks × 2 replicas bit-equal to the JAX
  package's 8-device ``shard_map`` all-reduce on
  ``tests/test_torch_train_loop.py``'s inputs, and to the one-device form.
- The launcher at 2 ranks (``main``, inside the group): an injected
  failure at step 4, restored on the same mesh; then ``lost_chips=1``,
  which re-meshes to one training rank before the first step and
  resumes from the 2-rank run's checkpoint.  Step counts, restore lines,
  the checkpoints on disk and every rank's returned dict exact, the
  losses within 2e-3 relative of the one-process launcher's (rwkv6's
  smoke config computes in bf16: one bf16 unit is 3.9e-3 of a value).
- ``main`` on a host of n > 1 cards starts n ranks; with torchrun's
  environment it joins that group.

The ranks import this module, so it imports neither JAX nor the test
modules that do."""
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from repro_torch import train as port_train
from repro_torch.configs import get_config
from repro_torch.distributed import ranks
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_launch
from repro_torch.launch.train import synthetic_batches
from repro_torch.models import api, convert

pytestmark = pytest.mark.port

ROOT = pathlib.Path(__file__).resolve().parents[1]
RWKV, MOE = "rwkv6-1.6b", "qwen2-moe-a2.7b"
LOSS_REL = 1e-5                 # tests/test_torch_train.py's tolerances
PARAM_REL = MOMENT_REL = 2e-4
LAUNCH_LOSS_REL = 2e-3          # tests/test_torch_train_loop.py's
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=1)
SEQ = 33
# name: (arch, global batch, make_train_step kwargs, steps)
CASES = {"rwkv6": (RWKV, 4, {}, 3),
         "rwkv6 n_micro=2": (RWKV, 4, {"n_micro": 2}, 3),
         "rwkv6 error feedback": (RWKV, 4, {"use_ef_compress": True}, 3),
         "rwkv6 n_micro=2 error feedback": (
             RWKV, 4, {"n_micro": 2, "use_ef_compress": True}, 3),
         "qwen2-moe": (MOE, 4, {}, 3),
         "rwkv6 B=3 replicated": (RWKV, 3, {}, 3)}
# the cases the JAX side runs on (2, 1): every one but the replicated,
# which is held to the one process bit for bit instead
REPLICATED = "rwkv6 B=3 replicated"
JAX_CASES = [name for name in CASES if name != REPLICATED]
LAUNCH = ["--arch", RWKV, "--smoke", "--steps", "6", "--batch", "2",
          "--seq", "32", "--ckpt-every", "2", "--fail-at-step", "4",
          "--device", "cpu"]
RESUMED_STEPS = 8               # the run on fewer ranks continues to here

_JAX = textwrap.dedent("""
    import json, os, sys
    from concurrent.futures import ThreadPoolExecutor
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat, train as jt
    from repro.configs import get_config
    from repro.launch.mesh import make_mesh
    from repro.launch.train import synthetic_batches
    from repro.train.compress import compressed_psum
    cases, opt, seq, work = json.loads(sys.argv[1])

    def nest(flat):
        tree = {}
        for path, leaf in flat.items():
            *head, last = path.split("/")
            node = tree
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(leaf)
        return tree

    def flat(prefix, tree):
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        return {prefix + "/".join(str(k.key) for k in path): np.asarray(x)
                for path, x in leaves}

    mesh = make_mesh((2, 1), ("data", "model"))

    # each case's jitted step, lowered and compiled: XLA compiles the
    # cases side by side (it lets go of the GIL), nearly all of this
    # side's time
    def compiled(name):
        arch, batch, kw, steps = cases[name]
        cfg = get_config(arch, smoke=True, dtype="float32")
        with np.load(os.path.join(work, arch + ".npz")) as z:
            params = nest(dict(z))
        o = jt.OptConfig(**opt)
        data = synthetic_batches(cfg, batch, seq)
        first = next(data)
        b = jt.make_train_step(cfg, mesh, first, o, loss_chunk=16, **kw)
        state = jt.make_opt_state(cfg, params, o,
                                  kw.get("use_ef_compress", False))
        with compat.set_mesh(mesh):
            params = jax.device_put(params, b.in_shardings[0])
            state = jax.device_put(state, b.in_shardings[1])
            fn = jax.jit(b.fn, in_shardings=b.in_shardings,
                         out_shardings=b.out_shardings).lower(
                params, state, first).compile()
        return fn, b, params, state, data, steps

    with ThreadPoolExecutor(len(cases)) as pool:
        built = dict(zip(cases, pool.map(compiled, cases)))
    out = {}
    for name, (fn, b, params, state, data, steps) in built.items():
        metrics = []
        with compat.set_mesh(mesh):
            for _ in range(steps):
                params, state, m = fn(params, state, jax.device_put(
                    next(data), b.in_shardings[2]))
                metrics.append({k: float(v) for k, v in m.items()})
                if len(metrics) == 1:       # the state after the first step
                    np.savez(os.path.join(work, f"jax {name}.npz"),
                             **flat("p/", params), **flat("m/", state["m"]),
                             **flat("v/", state["v"]))
        out[name] = metrics
    with np.load(os.path.join(work, "psum.npz")) as z:
        g = dict(z)
    mesh8 = make_mesh((8,), ("data",))
    with compat.set_mesh(mesh8):
        got = compressed_psum({k: jnp.asarray(v) for k, v in g.items()},
                              "data", mesh8)
    out["psum"] = {k: np.asarray(v).tolist() for k, v in got.items()}
    with open(os.path.join(work, "jax.json"), "w") as f:
        json.dump(out, f)
    print("OK")
""")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """test_torch_serving.py's fixture (one intra-op thread while this
    module runs, as the suite runs in several worker processes), here
    because the ranks import this module and must not pay for that one's
    JAX imports."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(prefix, tree) -> dict:
    """Copies of the leaves (the step updates the state in place)."""
    return {prefix + "/".join(path): leaf.detach().float().numpy().copy()
            for path, leaf in convert.tree_items(tree)}


def _weights(arch):
    """The same weights on every rank and in the JAX subprocess: the
    port's init at seed 1, as the JAX package's tree."""
    cfg = get_config(arch, smoke=True, dtype="float32")
    return cfg, convert.params_to_jax(api.init_params(cfg, 1, "cpu"), cfg)


# ---------------------------------------------------------------------------
# what the ranks run (module-level: the spawned processes import it)
# ---------------------------------------------------------------------------


def _own_reduced_grads(model, cfg, batch, mesh):
    """This rank's gradients on its rows, averaged over the ranks one
    tensor at a time: the reference for the step's residuals."""
    n, i = mesh.shape["data"], mesh.index("data")
    rows = batch["tokens"].shape[0] // n
    mine = {k: x[i * rows:(i + 1) * rows] for k, x in batch.items()}
    ps = [p for _, _, p in convert.jax_paths(model)]
    for p in ps:
        p.requires_grad_(True)
    loss, _ = api.loss_fn(model, mine, cfg, loss_chunk=16)
    grads = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    for g in grads:
        dist.all_reduce(g)
    return convert.to_jax_tree(model, [port_train.optim.divide(g, n)
                                       for g in grads])


def _step_case(name, mesh) -> dict:
    arch, batch, kw, steps = CASES[name]
    cfg, tree = _weights(arch)
    model = convert.params_from_jax(tree, cfg, device="cpu")
    ocfg = port_train.OptConfig(**OPT)
    data = synthetic_batches(cfg, batch, SEQ, device="cpu")
    bundle = port_train.make_train_step(cfg, mesh, next(data), ocfg,
                                        loss_chunk=16, **kw)
    ef = kw.get("use_ef_compress", False)
    opt = port_train.make_opt_state(cfg, model, ocfg, ef)
    out = {"metrics": [], "residuals_equal": []}
    residuals = ef and kw.get("n_micro", 1) == 1 and mesh.spans_ranks
    for _ in range(steps):
        b = next(data)
        if residuals:
            _, want = port_train.ef_compress(
                _own_reduced_grads(model, cfg, b, mesh), opt["ef"])
        model, opt, m = bundle.fn(model, opt, b)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        # a metric holds its own value, not the reduced gradients' buffer
        out["metric_bytes"] = max(v.untyped_storage().nbytes()
                                  for v in m.values())
        if residuals:
            out["residuals_equal"].append(all(
                torch.equal(convert.tree_get(opt["ef"], path), leaf)
                for path, leaf in convert.tree_items(want)))
        # the state after the first step and after the last
        out["first" if "first" not in out else "last"] = {
            **_flat("p/", convert.params_to_jax(model, cfg)),
            **_flat("m/", opt["m"]), **_flat("v/", opt["v"])}
    out["step"] = int(opt["step"])
    return out


def _two_ranks(r: ranks.Ranks, ckpt_dir: str) -> dict:
    """Every step case, then the launcher: 6 steps with a failure at step
    4 through ``main``, then on one rank (``lost_chips=1``) to step 8."""
    torch.set_num_threads(1)
    mesh = port_mesh.make_host_mesh("cpu")
    out = {"rank": r.rank, "world": r.world, "backend": r.backend,
           "mesh": [mesh.shape, str(mesh.device), mesh.spans_ranks,
                    mesh.index("data")],
           "cases": {name: _step_case(name, mesh) for name in CASES}}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["launch"] = port_launch.main(LAUNCH + ["--ckpt-dir", ckpt_dir])
        out["resumed"] = port_launch.train(
            RWKV, True, RESUMED_STEPS, 2, 32, ckpt_dir, 2, lost_chips=1,
            device="cpu")
    out["lines"] = [ln for ln in buf.getvalue().splitlines()
                    if ln.startswith("[train]")]
    return out


def _psum_inputs() -> dict:
    """tests/test_torch_train_loop.py's 8 replicas."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((8, 32, 16)).astype(np.float32),
            "b": (rng.standard_normal((8, 5)) * 1e3).astype(np.float32)}


def _four_ranks(r: ranks.Ranks, given: dict) -> dict:
    """``compressed_psum`` on this rank's 2 of the 8 replicas."""
    mesh = port_mesh.make_host_mesh("cpu")
    block = {k: torch.from_numpy(v[2 * r.rank:2 * r.rank + 2])
             for k, v in given.items()}
    got = port_train.compressed_psum(block, "data", mesh)
    return {k: v.numpy() for k, v in got.items()}


# ---------------------------------------------------------------------------
# the runs: the JAX subprocess beside the two spawns
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("ranks")
    for arch in (RWKV, MOE):
        cfg, tree = _weights(arch)
        np.savez(work / f"{arch}.npz", **_flat("", tree))
    np.savez(work / "psum.npz", **_psum_inputs())
    jax_side = subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps([
            {name: CASES[name] for name in JAX_CASES}, OPT, SEQ,
            str(work)])],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    try:
        # while the JAX side runs: the port in this one process, on the
        # whole batch
        one = port_mesh.make_mesh((1, 1), ("data", "model"), "cpu")
        alone = {name: _step_case(name, one) for name in CASES}
        two = ranks.spawn(_two_ranks, 2, str(work / "ckpt"), device="cpu",
                          timeout=240)
        four = ranks.spawn(_four_ranks, 4, _psum_inputs(), device="cpu",
                           timeout=120)
        stdout, stderr = jax_side.communicate(timeout=300)
        assert "OK" in stdout, stderr[-3000:]
    finally:
        if jax_side.poll() is None:
            jax_side.kill()
            jax_side.communicate()
    return {"work": work, "two": two, "four": four, "one": alone,
            "jax": json.loads((work / "jax.json").read_text())}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_the_rank_mesh(runs):
    """Each rank's host mesh is the (2, 1) mesh of ranks, on its own
    device, at its own "data" index, over gloo on the CPU."""
    for r, out in enumerate(runs["two"]):
        assert out["rank"] == r and out["world"] == 2
        assert out["backend"] == "gloo"
        assert out["mesh"] == [{"data": 2, "model": 1}, "cpu", True, r]


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_rank_step_matches_the_jax_step_on_a_2x1_mesh(runs, name):
    arch, batch, kw, steps = CASES[name]
    want_m = runs["jax"][name]
    got, other = (out["cases"][name] for out in runs["two"])
    assert got["step"] == other["step"] == steps
    assert got["metrics"] == other["metrics"]
    assert len(got["metrics"]) == len(want_m) == steps
    pm, jm = got["metrics"][0], want_m[0]
    assert sorted(pm) == sorted(jm)
    for k in jm:
        rel = 1e-6 if k == "lr" else LOSS_REL
        assert pm[k] == pytest.approx(jm[k], rel=rel, abs=1e-7), k
    for pm, jm in zip(got["metrics"], want_m):
        assert pm["loss"] == pytest.approx(jm["loss"], rel=LOSS_REL)
    if arch == MOE:
        assert got["metrics"][0]["aux"] > 0
    for when in ("first", "last"):
        assert got[when].keys() == other[when].keys()
        for key, leaf in got[when].items():
            assert np.array_equal(leaf, other[when][key]), (when, key)
    with np.load(runs["work"] / f"jax {name}.npz") as z:
        want = dict(z)
    assert want.keys() == got["first"].keys()
    ef = kw.get("use_ef_compress", False)
    for key, leaf in want.items():
        if key.startswith("p/") or not ef:
            rel = PARAM_REL if key.startswith("p/") else MOMENT_REL
            r = _rel_l2(got["first"][key], leaf)
            assert r <= rel, f"{name} {key}: rel L2 {r:.3g} > {rel}"
    if ef and kw.get("n_micro", 1) == 1:
        assert got["residuals_equal"] == [True] * steps
        assert other["residuals_equal"] == [True] * steps


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_matches_one_process_on_the_whole_batch(runs, name):
    """The 2 ranks against the port's step in one process on the whole
    batch, at every step: each metric, then every parameter leaf and,
    without error feedback, every moment leaf after the last step, at the
    same tolerances.  A metric holds a 4-byte value of its own in both,
    not a view that would keep the reduced gradients' buffer alive."""
    ef = CASES[name][2].get("use_ef_compress", False)
    got, want = runs["two"][0]["cases"][name], runs["one"][name]
    assert got["step"] == want["step"] == CASES[name][3]
    assert got["metric_bytes"] == want["metric_bytes"] == 4
    for i, (pm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        assert sorted(pm) == sorted(wm)
        for k in wm:
            if k == "grad_norm" and i and CASES[name][0] == MOE:
                continue        # the module's docstring
            rel = 1e-6 if k == "lr" else LOSS_REL
            assert pm[k] == pytest.approx(wm[k], rel=rel, abs=1e-7), (i, k)
    assert got["last"].keys() == want["last"].keys()
    for key, leaf in want["last"].items():
        if key.startswith("p/") or not ef:
            rel = PARAM_REL if key.startswith("p/") else MOMENT_REL
            r = _rel_l2(got["last"][key], leaf)
            assert r <= rel, f"{name} {key}: rel L2 {r:.3g} > {rel}"


def test_replicated_batch_is_the_one_process_step(runs):
    """A batch of 3 rows, which "data" does not divide, is replicated:
    each rank steps on the whole of it and reduces nothing, so both ranks
    hold the one process's metrics and states bit for bit."""
    want = runs["one"][REPLICATED]
    for out in runs["two"]:
        got = out["cases"][REPLICATED]
        assert got["step"] == want["step"] == CASES[REPLICATED][3]
        assert got["metrics"] == want["metrics"]
        for when in ("first", "last"):
            assert got[when].keys() == want[when].keys()
            for key, leaf in want[when].items():
                assert np.array_equal(got[when][key], leaf), (when, key)


def test_compressed_psum_over_four_ranks_bit_equal(runs):
    """Each rank's sum of the 8 replicas, 2 of them its own, equals the
    JAX package's 8-device all-reduce and the one-device form."""
    given = {k: torch.from_numpy(v) for k, v in _psum_inputs().items()}
    one = port_train.compressed_psum(given, "data", port_mesh.make_mesh(
        (8,), ("data",)))
    for got in runs["four"]:
        for k, want in runs["jax"]["psum"].items():
            assert np.array_equal(got[k], np.asarray(want, np.float32))
            assert np.array_equal(got[k], one[k].numpy())


def _steps_on_disk(d):
    return sorted(p.name for p in pathlib.Path(d).glob("step_*"))


def test_launcher_over_two_ranks_restarts_and_resumes_on_one(runs,
                                                             tmp_path):
    """The 2-rank launcher against the one-process launcher: the failure
    at step 4 restored on the same mesh, then the run resumed from its
    checkpoint on one of the 2 ranks; the other rank took no step and
    returns the same dict."""
    d = tmp_path / "one"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        want = port_launch.main(LAUNCH + ["--ckpt-dir", str(d)])
        want_resumed = port_launch.train(RWKV, True, RESUMED_STEPS, 2, 32,
                                         str(d), 2, device="cpu")
    want_lines = [ln for ln in buf.getvalue().splitlines()
                  if ln.startswith("[train]")]
    lead, other = runs["two"]
    got_dir = runs["work"] / "ckpt"
    norm = lambda lines, dd: [ln.replace(str(dd), "<dir>")  # noqa: E731
                              for ln in lines if "restor" in ln]
    assert norm(lead["lines"], got_dir) == norm(want_lines, d) == [
        "[train] step 4 failed (injected failure); restoring",
        "[train] restored step 6 from <dir>"]
    assert other["lines"] == []
    for key, ref in (("launch", want), ("resumed", want_resumed)):
        assert lead[key] == other[key]
        got = lead[key]
        assert got["steps"] == ref["steps"]
        assert len(got["losses"]) == len(ref["losses"])
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LAUNCH_LOSS_REL)
    assert want_resumed["steps"] == RESUMED_STEPS
    assert len(want_resumed["losses"]) == RESUMED_STEPS - 6
    assert _steps_on_disk(got_dir) == _steps_on_disk(d)
    assert (port_launch.ckpt.latest_step(str(got_dir))
            == port_launch.ckpt.latest_step(str(d)) == RESUMED_STEPS)


def test_main_starts_a_rank_a_card(monkeypatch):
    """On a host of 4 cards and outside a group, ``main`` starts 4 ranks
    (``ranks.spawn``) and returns rank 0's result."""
    calls = []

    def fake_spawn(fn, world, *args, device=None, **kw):
        calls.append((fn, world, args, device))
        return [{"rank": r} for r in range(world)]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    monkeypatch.setattr(ranks, "spawn", fake_spawn)
    argv = ["--arch", RWKV, "--smoke", "--steps", "2"]
    assert port_launch.main(argv) == {"rank": 0}
    assert calls == [(port_launch._rank_main, 4, (argv,), None)]


def test_main_under_torchrun_joins_its_group(monkeypatch, tmp_path):
    """With torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK) ``main``
    joins that group — here a world of one, through a ``file://``
    rendezvous in place of torchrun's store — trains on its mesh of
    ranks and leaves the group after."""
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "1"),
                       ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    seen = []
    joined = ranks.joined

    @contextlib.contextmanager
    def file_rendezvous(device=None, **kw):
        with joined(device, init_method=f"file://{tmp_path / 'rv'}",
                    **kw) as r:
            seen.append((r, port_mesh.make_host_mesh(device).spans_ranks))
            yield r

    monkeypatch.setattr(ranks, "joined", file_rendezvous)
    with contextlib.redirect_stdout(io.StringIO()):
        out = port_launch.main(["--arch", RWKV, "--smoke", "--steps", "2",
                                "--batch", "2", "--seq", "16", "--device",
                                "cpu"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert seen == [(ranks.Ranks(0, 1, torch.device("cpu"), "gloo"), True)]
    assert ranks.current() is None
