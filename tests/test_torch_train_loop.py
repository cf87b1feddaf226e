"""The port's training loop and device meshes on the CPU against the JAX
package: the meshes (``launch/mesh.py``), ``plan_remesh``'s records on a
(4, 2) mesh and a pod mesh (``distributed/elastic.py``), the int8
``compressed_psum`` over 8 replicas, bit-equal, and a fleet's fail-over
``remesh`` record (``build_fleet(build_meshes=True)``), each against the
JAX package on 8 fake CPU devices in one subprocess (the 8-device
fleet's record as its controller computes it: ``plan_remesh`` over the
fleet mesh); the record of both packages' controllers on a fleet whose
two shards share one device, in this process; the launcher's
data stream; and the launcher itself (``launch/train.py``), both packages
resuming from one step-0 checkpoint the JAX package wrote, with an
injected failure at step 4, as the README's CLI call drives it.

The launcher runs rwkv6's smoke config in bf16 compute, the config's own:
the losses are held step by step at 2e-3 relative (one bf16 unit is 3.9e-3
of a value; measured ≤ 4.7e-4), the step counts, restore points and the
checkpoints left on disk exactly."""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.configs import get_config as jax_get_config
from repro.distributed import checkpoint as jax_ckpt
from repro.launch import train as jax_launch
from repro.models import api as jax_api
from repro import train as jax_train
from repro_torch.configs import get_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import ranks
from repro_torch.distributed.elastic import (RemeshPlan, build_mesh,
                                             plan_remesh)
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import train as port_launch
from repro_torch.train import compressed_psum
from test_torch_costmodel import one_torch_thread  # noqa: F401
from test_torch_fleet import JAX, PORT, SMALL_EXCLUDE, _FakeDevice

pytestmark = [pytest.mark.port, pytest.mark.fleet]

ROOT = pathlib.Path(__file__).resolve().parents[1]
RWKV = "rwkv6-1.6b"
LAUNCH_LOSS_REL = 2e-3
# (mesh shape, axes, lost chips, batch policy); None where plan_remesh
# must raise
REMESH_CASES = [((4, 2), ("data", "model"), 2, "hold"),
                ((4, 2), ("data", "model"), 2, "shrink"),
                ((4, 2), ("data", "model"), 3, "hold"),
                ((2, 2, 2), ("pod", "data", "model"), 2, "hold"),
                ((2, 2, 2), ("pod", "data", "model"), 5, "hold"),
                ((4, 2), ("data", "model"), 7, "hold")]

_SUBPROCESS = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from repro import compat
    from repro.distributed.elastic import plan_remesh
    from repro.fleet.plan import plan_fleet
    from repro.launch.mesh import make_mesh
    from repro.train.compress import compressed_psum
    cases, out_path = json.loads(sys.argv[1])
    out = {"remesh": []}
    for shape, axes, lost, policy in cases:
        try:
            plan = plan_remesh(make_mesh(tuple(shape), tuple(axes)), lost,
                               policy)
            out["remesh"].append(dataclasses.asdict(plan))
        except ValueError:
            out["remesh"].append(None)
    mesh = make_mesh((8,), ("data",))
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((8, 32, 16)).astype(np.float32),
         "b": (rng.standard_normal((8, 5)) * 1e3).astype(np.float32)}
    with compat.set_mesh(mesh):
        got = compressed_psum({k: jnp.asarray(v) for k, v in g.items()},
                              "data", mesh)
    out["psum_in"] = {k: v.tolist() for k, v in g.items()}
    out["psum"] = {k: np.asarray(v).tolist() for k, v in got.items()}
    # a two-shard fleet over the 8 devices: its meshes, and the re-mesh
    # its controller records when shard 1 (4 devices) dies
    # (FleetController._remesh_record: plan_remesh over the fleet mesh)
    plan = plan_fleet(2, ["m"], devices=jax.devices())
    meshes = [plan.shard_mesh(spec) for spec in plan.shards]
    out["shard_meshes"] = [[list(m.devices.shape),
                            [d.id for d in m.devices.flat]] for m in meshes]
    out["fleet_remesh"] = dataclasses.asdict(plan_remesh(
        plan.fleet_mesh(), lost_chips=plan.shards[1].n_devices))
    with open(out_path, "w") as f:
        json.dump(out, f)
    print("OK")
""")


def _json(x):
    return json.loads(json.dumps(x, default=float))


@pytest.fixture(scope="module")
def jax_on_8_devices(tmp_path_factory):
    """Every JAX reference that needs 8 fake devices, from one
    subprocess."""
    path = tmp_path_factory.mktemp("eight") / "out.json"
    arg = json.dumps([REMESH_CASES, str(path)])
    r = subprocess.run([sys.executable, "-c", _SUBPROCESS, arg], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert "OK" in r.stdout, r.stderr[-3000:]
    return json.loads(path.read_text())


# ---------------------------------------------------------------------------
# meshes and the elastic plan
# ---------------------------------------------------------------------------


def test_meshes(monkeypatch, tmp_path):
    """The host mesh (the CPU's (1, 1); inside a process group the mesh
    of its ranks, on this rank's device; the card's, refused on a host of
    more than one card outside a group, or where there is none), the
    production plans and the degraded meshes."""
    host = port_mesh.make_host_mesh("cpu")
    jhost = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 1),
                              ("data", "model"))
    assert host.shape == dict(jhost.shape) == {"data": 1, "model": 1}
    assert host.device == torch.device("cpu")
    assert not host.spans_ranks and host.holds_this_rank
    with ranks.joined("cpu", rank=0, world=1,
                      init_method=f"file://{tmp_path / 'rendezvous'}") as r:
        assert (r.rank, r.world, r.backend) == (0, 1, "gloo")
        assert ranks.current() == (0, 1)
        mesh = port_mesh.make_host_mesh("cpu")
        assert mesh.spans_ranks and mesh.holds_this_rank
        assert mesh.shape == {"data": 1, "model": 1}
        assert mesh.device == torch.device("cpu") and mesh.index("data") == 0
    assert ranks.current() is None
    assert not port_mesh.make_host_mesh("cpu").spans_ranks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    with pytest.raises(RuntimeError, match="2 ranks.*torchrun"):
        port_mesh.make_host_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_host_mesh()
    prod = port_mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert prod.device == torch.device("meta")
    pods = port_mesh.make_production_mesh(multi_pod=True)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert sorted(pods.devices.flat) == list(range(512))
    assert port_mesh.degraded_mesh(16).shape == {"data": 15, "model": 16}
    assert port_mesh.degraded_mesh(16, multi_pod=True).shape == {
        "pod": 1, "data": 31, "model": 16}
    with pytest.raises(ValueError, match="cannot remesh"):
        port_mesh.degraded_mesh(250)


def test_plan_remesh_matches_jax(jax_on_8_devices):
    """Each case's ``RemeshPlan`` field by field (the pod axis, "hold"
    and "shrink"), the unsatisfiable model axis raising in both, and the
    plan's mesh."""
    for case, want in zip(REMESH_CASES, jax_on_8_devices["remesh"]):
        shape, axes, lost, policy = case
        mesh = port_mesh.make_mesh(shape, axes)
        if want is None:
            with pytest.raises(ValueError):
                plan_remesh(mesh, lost, policy)
            continue
        plan = plan_remesh(mesh, lost, policy)
        assert _json(dataclasses.asdict(plan)) == want, case
        built = build_mesh(plan)
        assert tuple(built.devices.shape) == tuple(want["new_shape"])
        assert built.axis_names == tuple(axes)
        assert plan.new_data_parallel == want["new_shape"][-2]
    assert RemeshPlan.__dataclass_fields__.keys() == set(
        jax_on_8_devices["remesh"][0])


def test_compressed_psum_matches_jax(jax_on_8_devices):
    """The int8 sum over 8 replicas bit-equal to the JAX package's
    ``shard_map`` all-reduce over 8 devices, and within the reference
    test's 2% of the fp32 sum."""
    given = {k: torch.tensor(v, dtype=torch.float32)
             for k, v in jax_on_8_devices["psum_in"].items()}
    got = compressed_psum(given, "data", port_mesh.make_mesh((8,),
                                                             ("data",)))
    for k, want in jax_on_8_devices["psum"].items():
        assert np.array_equal(got[k].numpy(), np.asarray(want, np.float32))
        exact = given[k].sum(0).numpy()
        rel = np.abs(got[k].numpy() - exact).max() / np.abs(exact).max()
        assert rel < 0.02
    with pytest.raises(ValueError, match="replicas"):
        compressed_psum(given, "data", port_mesh.make_mesh((4, 2),
                                                           ("data", "m")))


def _mesh_fleet(ns, devices):
    """A two-shard fleet of ``SimEngine``s with meshes; shard 1 killed and
    timed out.  Returns (plan, controller)."""
    clk = {"t": 0.0}
    names = [p.name for p in ns.build_paper_pool(exclude=SMALL_EXCLUDE)]
    plan = ns.fleet.plan_fleet(2, names, devices=devices)
    sim = ns.OutcomeSimulator(seed=0)
    ctrl = ns.fleet.build_fleet(
        plan, lambda spec: ns.Router(
            ns.RouterConfig(max_arms=16, seed=spec.index),
            ns.ModelPool(ns.build_paper_pool(exclude=SMALL_EXCLUDE)),
            **ns.router_kw),
        lambda p, spec: ns.SimEngine(p, lambda q, m: sim(q, m),
                                     clock=lambda: clk["t"]),
        heartbeat_timeout_s=0.3, clock=lambda: clk["t"], build_meshes=True)
    ctrl.kill_shard("shard1")
    clk["t"] = 1.0
    ctrl.step()
    return plan, ctrl


def test_fleet_meshes_and_remesh_record(jax_on_8_devices):
    """``build_fleet(build_meshes=True)`` over 8 devices: the shards'
    meshes and the fail-over's ``remesh`` record equal the JAX package's
    on 8 fake devices; two shards sharing the one CPU device record the
    same re-mesh in both packages (this process); without meshes the
    record is None, as in the JAX package."""
    plan, ctrl = _mesh_fleet(PORT, [_FakeDevice(i) for i in range(8)])
    assert [[list(s.mesh.devices.shape), s.mesh.devices.flatten().tolist()]
            for s in ctrl.shards.values()] == jax_on_8_devices["shard_meshes"]
    assert plan.fleet_mesh().size == 8
    assert _json(ctrl.events[0]["remesh"]) == jax_on_8_devices["fleet_remesh"]
    assert ctrl.events[0]["remesh"]["new_shape"] == (4, 1)
    _, jctrl = _mesh_fleet(JAX, jax.devices())
    _, pctrl = _mesh_fleet(PORT, [torch.device("cpu")])
    want = _json(jctrl.events[0]["remesh"])
    assert _json(pctrl.events[0]["remesh"]) == want
    assert want["old_shape"] == [2, 1] and want["n_micro_multiplier"] == 2
    assert pctrl.fleet_mesh.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_synthetic_batches_match_jax():
    """The same numpy stream: tokens, labels and (encoder-decoder) frames
    equal batch for batch."""
    for arch in (RWKV, "whisper-medium"):
        jcfg = jax_get_config(arch, smoke=True, dtype="float32")
        pcfg = get_config(arch, smoke=True, dtype="float32")
        jd = jax_launch.synthetic_batches(jcfg, 3, 17, seed=4)
        pd = port_launch.synthetic_batches(pcfg, 3, 17, seed=4, device="cpu")
        for _ in range(3):
            jb, pb = next(jd), next(pd)
            assert sorted(jb) == sorted(pb)
            for k in jb:
                assert pb[k].dtype == getattr(torch, str(jb[k].dtype))
                assert np.array_equal(pb[k].numpy(), np.asarray(jb[k]))


def _run(fn):
    """(result, the [train] lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("[train]")]


def _steps_on_disk(d):
    return sorted(p.name for p in pathlib.Path(d).glob("step_*"))


def test_train_resumes_from_a_jax_checkpoint_with_a_failure(tmp_path):
    """The JAX package writes its initial (params, opt) at step 0; both
    launchers resume from it (the port through ``main``, the README's CLI
    call: --steps 6 --batch 2 --seq 32 --ckpt-every 2
    --fail-at-step 4) and fail at step 4: the same restore lines, steps,
    checkpoints kept on disk and losses step by step; the port's final
    checkpoint restores in the JAX package."""
    cfg = jax_get_config(RWKV, smoke=True)
    params = jax_api.init_params(cfg, jax.random.PRNGKey(0))
    opt = jax_train.make_opt_state(cfg, params, jax_train.OptConfig(
        moment_dtype=cfg.moment_dtype))
    seed_dir = tmp_path / "seed"
    jax_ckpt.save(str(seed_dir), 0, (params, opt),
                  extra={"step": 0, "arch": RWKV})
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(seed_dir, jdir)
    shutil.copytree(seed_dir, pdir)
    want, jlines = _run(lambda: jax_launch.train(
        RWKV, smoke=True, steps=6, batch=2, seq=32, ckpt_dir=str(jdir),
        ckpt_every=2, fail_at_step=4))
    got, plines = _run(lambda: port_launch.main([
        "--arch", RWKV, "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "32", "--ckpt-dir", str(pdir), "--ckpt-every", "2",
        "--fail-at-step", "4", "--device", "cpu"]))
    norm = lambda lines, d: [ln.replace(str(d), "<dir>")  # noqa: E731
                             for ln in lines[:2]]
    assert norm(plines, pdir) == norm(jlines, jdir) == [
        "[train] restored step 0 from <dir>",
        "[train] step 4 failed (injected failure); restoring"]
    assert got["steps"] == want["steps"] == 6
    assert len(got["losses"]) == len(want["losses"]) == 6
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LAUNCH_LOSS_REL)
    assert _steps_on_disk(pdir) == _steps_on_disk(jdir)
    assert ckpt.latest_step(str(pdir)) == jax_ckpt.latest_step(str(jdir))
    tree, extra = jax_ckpt.restore(str(pdir), (params, opt))
    assert extra == {"step": 6, "arch": RWKV}
    assert int(tree[1]["step"]) == 6


def test_train_refusals(monkeypatch, tmp_path):
    """As the JAX package on a one-device host: the production mesh and a
    lost chip both refuse (ValueError); the card is the default device,
    in the launcher and its example twin."""
    for ns, kw in ((jax_launch, {}), (port_launch, {"device": "cpu"})):
        for bad in (dict(production_mesh=True), dict(lost_chips=1)):
            with pytest.raises(ValueError):
                ns.train(RWKV, smoke=True, steps=2, batch=1, seq=8,
                         ckpt_dir=None, **bad, **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_launch.train(RWKV, smoke=True, steps=2, batch=1, seq=8,
                          ckpt_dir=None)
    spec = importlib.util.spec_from_file_location(
        "torch_train_100m", ROOT / "examples" / "torch_train_100m.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with pytest.raises(RuntimeError, match="CUDA"):
        twin.main(["--steps", "2", "--ckpt", str(tmp_path)])
