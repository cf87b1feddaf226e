"""The port's fault and checkpoint primitives on the CPU against the JAX
package: every case of ``tests/test_distributed.py`` that needs no device
mesh run through both packages with equal observations — the checkpoint
round trip (a bf16 leaf included), LATEST and prune, an interrupted
write, a shape mismatch, an explicit step, a missing leaf, the heartbeat
monitor, the straggler detector, the training watchdog, and router and
cost-model state on the same machinery — and checkpoints crossing
between the packages: one written by either restores in the other with
equal leaves, and the same tree gives the same manifest and the same
leaf files byte for byte.  The re-mesh cases, which need the device
meshes, are ``tests/test_torch_train_loop.py``'s."""
import json
import pathlib
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.costmodel as jax_costmodel
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Feedback as JaxFeedback
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.distributed import checkpoint as jax_ckpt
from repro.distributed import fault as jax_fault
import repro_torch.costmodel as port_costmodel
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query, RouterConfig
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import fault
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.port, pytest.mark.fleet]


def _values(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal(8).astype(np.float32))


def _jax_tree(seed=0):
    w, b = _values(seed)
    return {"layer": {"w": jnp.asarray(w), "b": jnp.asarray(b, jnp.bfloat16)},
            "step_count": jnp.int32(7)}


def _port_tree(seed=0):
    w, b = _values(seed)
    return {"layer": {"w": torch.from_numpy(w),
                      "b": torch.from_numpy(b).to(torch.bfloat16)},
            "step_count": torch.tensor(7, dtype=torch.int32)}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _port_leaves(tree):
    """[(dtype name, values as float64)] in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _port_leaves(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [(str(tree.dtype).removeprefix("torch."),
                 tree.float().numpy().astype(np.float64).tolist())]
    arr = np.asarray(tree)
    return [(str(arr.dtype), arr.astype(np.float64).tolist())]


def _jax_leaves(tree):
    return [(str(np.asarray(x).dtype),
             np.asarray(x).astype(np.float64).tolist())
            for x in jax.tree.leaves(tree)]


JAX = types.SimpleNamespace(
    ckpt=jax_ckpt, fault=jax_fault, tree=_jax_tree,
    zeros_like=lambda t: jax.tree.map(jnp.zeros_like, t),
    np_zeros_like=lambda t: jax.tree.map(np.zeros_like, t),
    leaves=_jax_leaves, full=lambda shape, v: jnp.full(shape, v,
                                                       jnp.float32),
    Router=JaxRouter, RouterConfig=JaxRouterConfig, ModelPool=JaxModelPool,
    ModelProfile=JaxModelProfile, Query=JaxQuery, Feedback=JaxFeedback,
    EnergyCostModel=jax_costmodel.EnergyCostModel, router_kw={})
PORT = types.SimpleNamespace(
    ckpt=ckpt, fault=fault, tree=_port_tree,
    zeros_like=lambda t: _tree_map(torch.zeros_like, t),
    np_zeros_like=lambda t: _tree_map(np.zeros_like, t),
    leaves=_port_leaves, full=lambda shape, v: torch.full(shape, v),
    Router=GreenServRouter, RouterConfig=RouterConfig, ModelPool=ModelPool,
    ModelProfile=ModelProfile, Query=Query, Feedback=Feedback,
    EnergyCostModel=port_costmodel.EnergyCostModel,
    router_kw=dict(device="cpu"))


def _both(case, tmp_path):
    """Run ``case(ns, dir)`` in each package, each in its own directory;
    the observations must be equal."""
    want = case(JAX, tmp_path / "jax")
    got = case(PORT, tmp_path / "port")
    assert_close(got, want, 1e-12)
    return got


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def _roundtrip(ns, d):
    t = ns.tree()
    ns.ckpt.save(d, 10, t, extra={"step": 10, "note": "hi"})
    restored, extra = ns.ckpt.restore(d, ns.zeros_like(t))
    assert extra["note"] == "hi"
    assert ns.leaves(restored) == ns.leaves(t)
    return [ns.leaves(restored), extra]


def _latest_and_prune(ns, d):
    t = ns.tree()
    for s in (1, 2, 3, 4):
        ns.ckpt.save(d, s, t)
    assert ns.ckpt.latest_step(d) == 4
    ns.ckpt.prune(d, keep=2)
    dirs = sorted(p.name for p in pathlib.Path(d).glob("step_*"))
    assert len(dirs) == 2
    assert ns.ckpt.latest_step(d) == 4
    return [dirs, ns.ckpt.latest_step(d)]


def _interrupted_write(ns, d):
    t = ns.tree()
    ns.ckpt.save(d, 1, t)
    # a crash mid-write of step 2: a stray tmp dir with partial data
    tmp = pathlib.Path(d) / "step_000000002.tmp"
    tmp.mkdir()
    (tmp / "leaf_00000.npy").write_bytes(b"garbage")
    assert ns.ckpt.latest_step(d) == 1          # LATEST untouched
    restored, _ = ns.ckpt.restore(d, ns.zeros_like(t))
    assert ns.leaves(restored) == ns.leaves(t)
    return ns.leaves(restored)


def _shape_mismatch(ns, d):
    ns.ckpt.save(d, 1, {"w": ns.full((2, 2), 0.0)})
    with pytest.raises(ValueError) as err:
        ns.ckpt.restore(d, {"w": ns.full((3, 3), 0.0)})
    return str(err.value)


def _explicit_step(ns, d):
    ns.ckpt.save(d, 1, {"w": ns.full((2,), 1.0)})
    ns.ckpt.save(d, 2, {"w": ns.full((2,), 9.0)})
    assert ns.ckpt.latest_step(d) == 2
    old, _ = ns.ckpt.restore(d, {"w": ns.full((2,), 0.0)}, step=1)
    new, _ = ns.ckpt.restore(d, {"w": ns.full((2,), 0.0)})
    return [ns.leaves(old), ns.leaves(new)]


def _missing_leaf(ns, d):
    ns.ckpt.save(d, 1, {"w": ns.full((2,), 0.0)})
    with pytest.raises(KeyError) as err:
        ns.ckpt.restore(d, {"w": ns.full((2,), 0.0),
                            "extra": ns.full((3,), 0.0)})
    return str(err.value).replace(str(d), "<dir>")


def _watchdog(ns, d):
    wd = ns.fault.TrainWatchdog(checkpoint_dir=str(d), max_restarts=2)
    with pytest.raises(RuntimeError):            # before the first save
        wd.on_failure()
    ns.ckpt.save(d, 3, {"w": ns.full((2,), 0.0)})
    assert wd.should_restart()
    step = wd.on_failure()                       # the newest step
    return [step, wd.should_restart(), wd.restarts]


def _router_state(ns, d):
    pool = ns.ModelPool([ns.ModelProfile(name=f"m{i}", family="x",
                                         params_b=1.0) for i in range(3)])
    r = ns.Router(ns.RouterConfig(max_arms=8), pool, **ns.router_kw)
    for uid in range(5):
        q = ns.Query(uid=uid, text=f"Answer the question.\nQ{uid}?")
        dec = r.route(q)
        r.feedback(ns.Feedback(query_uid=uid, model_index=dec.model_index,
                               accuracy=0.7, energy_wh=0.02,
                               latency_ms=9.0))
    bandit = r.state_dict()["bandit"]
    ns.ckpt.save(d, 5, bandit, extra={"n_routed": r.n_routed})
    blob, extra = ns.ckpt.restore(d, ns.np_zeros_like(bandit))
    assert extra["n_routed"] == 5
    np.testing.assert_allclose(np.asarray(blob["counts"]), bandit["counts"])
    return [{k: np.asarray(v).astype(np.float64).tolist()
             for k, v in blob.items() if k != "key"}, extra]


def _cost_model_state(ns, d):
    cm = ns.EnergyCostModel()
    for name in ("m0", "m1"):
        cm.register_engine(name)
    state = cm.state_dict()
    ns.ckpt.save(d, 1, state)
    blob, _ = ns.ckpt.restore(d, ns.np_zeros_like(state))
    cm2 = ns.EnergyCostModel()
    cm2.load_state_dict(blob)
    assert set(cm2.engines) == {"m0", "m1"}
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(cm2.state_dict())):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-6)
    # the JAX package restores into jnp arrays, float32 without x64
    flat = [np.asarray(x).astype(np.float32).tolist()
            for x in jax.tree.leaves(cm2.state_dict())]
    return flat


@pytest.mark.parametrize("case", [
    _roundtrip, _latest_and_prune, _interrupted_write, _shape_mismatch,
    _explicit_step, _missing_leaf, _watchdog, _router_state,
    _cost_model_state], ids=lambda f: f.__name__.strip("_"))
def test_checkpoint(case, tmp_path):
    _both(case, tmp_path)


def test_restore_keeps_each_leafs_form(tmp_path):
    """A numpy leaf comes back as numpy, a tensor leaf as a tensor on its
    device, a bf16 entry under a numpy leaf as a CPU tensor (numpy cannot
    hold it), and ``shardings`` places every leaf as a tensor."""
    t = {"a": np.arange(3, dtype=np.int64), "b": torch.ones(2, 2),
         "c": torch.full((2,), 1.5, dtype=torch.bfloat16), "n": None,
         "s": 2.5}
    ckpt.save(tmp_path, 1, t)
    like = {"a": np.zeros(3, np.int64), "b": torch.zeros(2, 2),
            "c": np.zeros(2, np.float32), "n": None, "s": 0.0}
    got, _ = ckpt.restore(tmp_path, like)
    assert isinstance(got["a"], np.ndarray) and got["a"].tolist() == [0, 1, 2]
    assert isinstance(got["b"], torch.Tensor) and bool((got["b"] == 1).all())
    assert got["c"].dtype == torch.bfloat16 and got["c"].tolist() == [1.5, 1.5]
    assert got["n"] is None and float(got["s"]) == 2.5
    cpu = torch.device("cpu")
    placed, _ = ckpt.restore(tmp_path, like, shardings={
        "a": cpu, "b": cpu, "c": cpu, "n": None, "s": cpu})
    assert all(isinstance(placed[k], torch.Tensor) for k in "abcs")
    assert placed["a"].dtype == torch.int64


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    t = _jax_tree(3)
    jax_ckpt.save(tmp_path, 4, t, extra={"from": "jax"})
    got, extra = ckpt.restore(tmp_path, _tree_map(torch.zeros_like,
                                                  _port_tree()))
    assert extra == {"from": "jax"}
    assert got["layer"]["b"].dtype == torch.bfloat16
    assert _port_leaves(got) == _jax_leaves(t)


def test_port_checkpoint_restores_in_jax(tmp_path):
    t = _port_tree(4)
    ckpt.save(tmp_path, 4, t, extra={"from": "port"})
    got, extra = jax_ckpt.restore(tmp_path, jax.tree.map(jnp.zeros_like,
                                                         _jax_tree()))
    assert extra == {"from": "port"}
    assert got["layer"]["b"].dtype == jnp.bfloat16
    assert _jax_leaves(got) == _port_leaves(t)


def test_both_packages_write_the_same_files(tmp_path):
    """The same tree (a bf16 leaf, a Python scalar, a None subtree and a
    list among its nodes) gives the same manifest and leaf files."""
    w, b = _values(5)
    jt = {"z": [jnp.asarray(w), None, jnp.asarray(b, jnp.bfloat16)],
          "a": {"k": 3, "v": jnp.int32(2)}}
    pt = {"z": [torch.from_numpy(w), None,
                torch.from_numpy(b).to(torch.bfloat16)],
          "a": {"k": 3, "v": torch.tensor(2, dtype=torch.int32)}}
    jdir = jax_ckpt.save(tmp_path / "jax", 9, jt, extra={"x": 1})
    pdir = ckpt.save(tmp_path / "port", 9, pt, extra={"x": 1})
    files = sorted(p.name for p in jdir.iterdir())
    assert files == sorted(p.name for p in pdir.iterdir())
    for name in files:
        assert (jdir / name).read_bytes() == (pdir / name).read_bytes(), name
    names = [e["name"] for e in json.loads(
        (pdir / ckpt.MANIFEST).read_text())["leaves"]]
    assert names == ["a/k", "a/v", "z/0", "z/2"]
    assert ((tmp_path / "jax" / "LATEST").read_text()
            == (tmp_path / "port" / "LATEST").read_text())


# ---------------------------------------------------------------------------
# fault detection
# ---------------------------------------------------------------------------


def _heartbeat_monitor(ns):
    mon = ns.fault.HeartbeatMonitor(timeout_s=0.0)
    mon.register("w0")
    mon2 = ns.fault.HeartbeatMonitor(timeout_s=60.0)
    mon2.register("w1")
    t = {"now": 0.0}
    mon3 = ns.fault.HeartbeatMonitor(timeout_s=5.0, clock=lambda: t["now"])
    for name in ("s0", "s1", "s2"):
        mon3.register(name)
    t["now"] = 4.0
    mon3.beat("s1")
    t["now"] = 6.0
    stale = [mon.stale(), mon2.stale(), mon3.stale()]
    mon3.deregister("s0")
    mon3.deregister("missing")
    return stale + [mon3.stale()]


def _straggler_detector(ns):
    det = ns.fault.StragglerDetector(k=2.0)
    for w in ("a", "b", "c", "d"):
        det.record(w, 1.0)
    det.record("d", 5.0)
    det2 = ns.fault.StragglerDetector(k=2.0)       # global slowdown
    for w in ("a", "b", "c", "d"):
        det2.record(w, 10.0)
    det3 = ns.fault.StragglerDetector(window=3, k=1.0)
    rng = np.random.default_rng(0)
    for step in range(20):
        for w in ("a", "b", "c", "d", "e"):
            det3.record(w, float(rng.exponential(1.0)))
    return [det.stragglers(), det2.stragglers(), det3.stragglers(),
            det3._times]


@pytest.mark.parametrize("case", [_heartbeat_monitor, _straggler_detector],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault(case):
    want, got = case(JAX), case(PORT)
    assert got == want
    assert got[0] == (["w0"] if case is _heartbeat_monitor else ["d"])
