"""The port's cost walk on the CPU against the JAX package's dry run
(``configs/shapes.py``, ``models/sharding.py``, ``launch/hlo.py``,
``launch/hlo_walker.py``, ``launch/dryrun.py``, ``benchmarks/roofline.py``):

  * the shape cells, ``cell_applicable`` and every cell's ``input_specs``
    (shapes, dtypes, a decode cache's key paths) for the ten configs;
  * the ``ShardingPolicy`` specs of every parameter, cache entry and batch
    input, the activation specs and ``kv_update_mode``, equal to the JAX
    policy's on ``jax.sharding.AbstractMesh`` for every config in both
    modes on the 16×16 and 2×16×16 plans;
  * ``arg_bytes_per_dev`` of each config's train_4k, prefill_32k and
    decode_32k on 16×16, equal to the sum the JAX specs give;
  * the op walker's FLOPs against ``hlo_walker.module_cost`` of the JAX
    package's compiled step on one device (smoke configs, B = 2, S = 64):
    equal, or the difference asserted exactly from the config's shapes
    with the op that makes it named;
  * the ring collective model (the reference test's 49,152 B), a
    production cell and an FSDP layer counted by hand, and a bytes chain;
  * ``dryrun.main`` writing a record that ``roofline.table`` reads, and the
    reference's table lines from the same records;
  * the random init: every leaf's std is the JAX rule's for the stacked
    leaf (per-layer vectors N(0, 1/L)).
"""
import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh

from benchmarks import roofline as jax_roofline
from repro import compat
from repro.configs import for_mode as jax_for_mode
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shapes as jax_shapes
from repro.launch.hlo_walker import module_cost
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models.sharding import ShardingPolicy as JaxPolicy
from repro.train import make_prefill_step as jax_prefill_step
from repro.train import make_serve_step as jax_serve_step
from repro.train import make_train_step as jax_train_step
from repro.train.step import opt_state_shapes as jax_opt_shapes
from repro_torch.benchmarks import roofline
from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell,
                                 cell_applicable, get_config, input_specs,
                                 text_len)
from repro_torch.launch import dryrun, op_walker
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import api, convert, encdec, layers, lm
from repro_torch.models.rwkv import rwkv_dims
from repro_torch.models.sharding import ShardingPolicy
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

PLANS = {"16x16": ((16, 16), ("data", "model")),
         "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
SMOKE_B, SMOKE_S = 2, 64


def _dtype(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return jnp.dtype(x.dtype).name


def _jax_leaves(tree) -> dict:
    leaves, _ = compat.tree_flatten_with_path(tree)
    return {compat.path_str(p): v for p, v in leaves}


def _jax_specs(tree) -> dict:
    leaves, _ = compat.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {compat.path_str(p): tuple(v) for p, v in leaves}


def _port_leaves(tree) -> dict:
    if not isinstance(tree, dict):
        return {"": tree}
    return {"/".join(p): v for p, v in convert.tree_items(tree)}


# -- shape cells ---------------------------------------------------------------


def test_shape_cells_match_jax():
    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_shapes.SHAPES.items()}
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for cell, jcell in zip(SHAPES.values(), jax_shapes.SHAPES.values()):
            assert (cell_applicable(cfg, cell)
                    == jax_shapes.cell_applicable(jcfg, jcell)), (arch, cell)
            assert text_len(cfg, cell.seq_len) == jax_shapes.text_len(
                jcfg, jcell.seq_len)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_match_jax(arch):
    """Every cell's inputs: keys, shapes and dtypes; a decode cell's cache
    against ``repro.models.api.cache_shapes``, key path by key path."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, cell in SHAPES.items():
        got = input_specs(cfg, cell)
        want = jax_input_specs(jcfg, jax_shapes.SHAPES[name])
        if cell.kind == "decode":
            assert set(got["cache"]) == set(
                jax_api.cache_shapes(jcfg, cell.global_batch, cell.seq_len))
        g, w = _port_leaves(got), _jax_leaves(want)
        assert sorted(g) == sorted(w), (arch, name)
        for key, leaf in g.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(w[key].shape), (arch, key)
            assert _dtype(leaf) == _dtype(w[key]), (arch, key)


# -- the sharding policy -------------------------------------------------------


@pytest.mark.parametrize("plan", list(PLANS))
def test_sharding_specs_match_jax(plan):
    """Parameter, cache, batch and activation specs, leaf by leaf, and
    ``kv_update_mode`` over a grid, for every config in both modes."""
    shape, axes = PLANS[plan]
    jmesh = AbstractMesh(shape, axes)
    mesh = make_mesh(shape, axes)
    for arch in ARCH_IDS:
        for mode in ("train", "serve"):
            cfg = get_config(arch)
            jcfg = jax_get_config(arch)
            if mode == "serve":
                cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
                jcfg = jax_for_mode(jcfg, "serve")
            pol, jpol = ShardingPolicy(cfg, mesh, mode), JaxPolicy(
                jcfg, jmesh, mode)
            got = _port_leaves(pol.param_specs(api.param_shapes(cfg)))
            want = _jax_specs(jpol.param_specs(jax_api.param_shapes(jcfg)))
            assert got == want, (arch, mode, plan)
            for name in ("decode_32k", "long_500k"):
                cell = SHAPES[name]
                cache = api.cache_shapes(cfg, cell.global_batch,
                                         cell.seq_len)
                jcache = jax_api.cache_shapes(jcfg, cell.global_batch,
                                              cell.seq_len)
                assert (_port_leaves(pol.cache_specs(cache))
                        == _jax_specs(jpol.cache_specs(jcache))), (arch,
                                                                   name)
            for name in ("train_4k", "prefill_32k"):
                for key, leaf in input_specs(cfg, SHAPES[name]).items():
                    assert (pol.batch_spec(key, tuple(leaf.shape))
                            == tuple(jpol.batch_spec(key, tuple(leaf.shape))))
            b = SHAPES["decode_32k"].global_batch
            for name, act in (("act_btd", (b, 4096, cfg.d_model)),
                              ("act_btv", (b, 4096, cfg.vocab_size)),
                              ("act_bshd", (b, 4096, cfg.compute_heads, 128)),
                              ("act_bskd", (b, 4096, cfg.n_kv_heads, 128)),
                              ("dec_btd", (b, 1, cfg.d_model)),
                              ("dec_btv", (b, 1, cfg.vocab_size)),
                              ("other", (b, 3))):
                assert pol.act_spec(name, act) == tuple(
                    jpol.act_spec(name, act)), (arch, name)
            assert pol.batch_spec("token", (b, 1)) == tuple(
                jpol.batch_spec("token", (b, 1)))
    for batch in (1, 2, 16, 31, 32, 128, 256, 512):
        for heads in (1, 4, 8, 16, 32, 48):
            assert (pol.kv_update_mode(batch, heads)
                    == jpol.kv_update_mode(batch, heads)), (batch, heads)


def _jax_shard_count(shape: dict, spec) -> int:
    n = 1
    for axis in spec:
        for a in ((axis,) if isinstance(axis, str) else axis or ()):
            n *= shape[a]
    return n


def _jax_tree_bytes(tree, specs, mesh_shape) -> int:
    leaves, sp = _jax_leaves(tree), _jax_specs(specs)
    return sum(int(np.prod(v.shape)) * jnp.dtype(v.dtype).itemsize
               // _jax_shard_count(mesh_shape, sp[k])
               for k, v in leaves.items())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_match_jax_specs(arch):
    """``arg_bytes_per_dev`` of train_4k, prefill_32k and decode_32k on
    16×16 equals Σ bytes ÷ shards over the JAX package's trees and specs
    (parameters, the optimizer state of train cells, the inputs)."""
    mshape = dict(zip(*reversed(PLANS["16x16"])))
    jmesh = AbstractMesh(*PLANS["16x16"])
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        cell = jax_shapes.SHAPES[name]
        jcfg = jax_get_config(arch)
        if cell.kind != "train":
            jcfg = jax_for_mode(jcfg, "serve")
        jpol = JaxPolicy(jcfg, jmesh, "train" if cell.kind == "train"
                         else "serve")
        params = jax_api.param_shapes(jcfg)
        pspecs = jpol.param_specs(params)
        want = _jax_tree_bytes(params, pspecs, mshape)
        inputs = jax_input_specs(jcfg, cell)
        if cell.kind == "train":
            opt = jax_opt_shapes(jcfg)
            want += _jax_tree_bytes(opt, {"m": pspecs, "v": pspecs,
                                          "step": jax.sharding.PartitionSpec()},
                                    mshape)
        if cell.kind == "decode":
            want += _jax_tree_bytes(inputs["cache"],
                                    jpol.cache_specs(inputs["cache"]), mshape)
            tok = inputs["token"]
            want += (int(np.prod(tok.shape)) * 4 // _jax_shard_count(
                mshape, jpol.batch_spec("token", tok.shape)))
        else:
            want += sum(int(np.prod(v.shape)) * jnp.dtype(v.dtype).itemsize
                        // _jax_shard_count(mshape, jpol.batch_spec(
                            k, v.shape)) for k, v in inputs.items())
        lowered, meta = dryrun.lower_cell(arch, name)
        assert dryrun.arg_bytes(lowered, meta) == want, (arch, name)


# -- FLOPs against the HLO walker ---------------------------------------------

PREFILL = ShapeCell("smoke_prefill", "prefill", SMOKE_S, SMOKE_B)
DECODE = ShapeCell("smoke_decode", "decode", SMOKE_S, SMOKE_B)
TRAIN = ShapeCell("smoke_train", "train", SMOKE_S, SMOKE_B)
SERVE_ARCHS = ("granite-3-8b", "rwkv6-1.6b", "gemma3-12b")
TRAIN_ARCHS = ("granite-3-8b", "qwen2-moe-a2.7b")


def _jax_lowered(arch: str, cell: ShapeCell):
    """The JAX dry run's step for one smoke cell, lowered for one
    device."""
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    cfg = jax_get_config(arch, smoke=True)
    jcell = jax_shapes.ShapeCell(cell.name, cell.kind, cell.seq_len,
                                 cell.global_batch)
    if cell.kind != "train":
        cfg = jax_for_mode(cfg, "serve")
    params = jax_api.param_shapes(cfg)
    if cell.kind == "train":
        batch = jax_input_specs(cfg, jcell)
        bundle = jax_train_step(cfg, mesh, batch, n_micro=1)
        args = (params, jax_opt_shapes(cfg), batch)
    elif cell.kind == "prefill":
        batch = jax_input_specs(cfg, jcell)
        bundle = jax_prefill_step(cfg, mesh, batch)
        args = (params, batch)
    else:
        spec = jax_input_specs(cfg, jcell)
        bundle = jax_serve_step(cfg, mesh, cell.global_batch, cell.seq_len)
        args = (params, spec["cache"], spec["token"])
    fn = jax.jit(bundle.fn, in_shardings=bundle.in_shardings,
                 out_shardings=bundle.out_shardings)
    with compat.set_mesh(mesh):
        return fn.lower(*args)


# LLVM's own optimizations off: they shape the executable, which never
# runs here, and leave the optimized HLO that the walker reads as it is
# (the same text for all 15 cells); they take ~40% of the compile time
LLVM_OFF = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def jax_costs():
    """module_cost of every cell's compiled step."""
    cells = ([(a, PREFILL) for a in ARCH_IDS]
             + [(a, DECODE) for a in SERVE_ARCHS]
             + [(a, TRAIN) for a in TRAIN_ARCHS])
    return {(a, c.kind): module_cost(_jax_lowered(a, c).compile(
        compiler_options=LLVM_OFF).as_text(), 1) for a, c in cells}


@pytest.fixture
def smoke_dryrun(monkeypatch):
    real = dryrun.get_config
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch, **kw: real(arch, smoke=True, **kw))

    def run(arch, cell):
        return dryrun.run_cell(arch, cell, mesh=make_mesh(
            (1, 1), ("data", "model")), n_micro=1)
    return run


def _attn_block_flops(cfg, b: int, s: int) -> int:
    """One dense block over (b, s) tokens: the q/k/v/o projections, q·k
    and p·v over the whole s×s square (one key block at s = attn_chunk),
    the SwiGLU MLP."""
    t, d = b * s, cfg.d_model
    hq, hk, hd = cfg.compute_heads, cfg.n_kv_heads, cfg.head_dim
    return (2 * t * d * (hq + 2 * hk) * hd + 2 * t * hq * hd * d
            + 2 * 2 * b * hq * s * s * hd + 3 * 2 * t * d * cfg.d_ff)


def _expected_gap(arch: str, kind: str) -> int:
    """JAX walker FLOPs − the port's, from the config's shapes."""
    cfg = get_config(arch, smoke=True)
    b, s = SMOKE_B, SMOKE_S
    if (arch, kind) == ("rwkv6-1.6b", "prefill"):
        # y_diag = einsum("blhk,blhk,blhv->blhv"): a dot contracting k
        # in XLA (2·B·S·H·K a layer), an elementwise product and sum here
        h, kd = rwkv_dims(cfg)
        return cfg.n_layers * 2 * b * s * h * kd
    if (arch, kind) == ("zamba2-7b", "prefill"):
        # the shared attention block sits in a lax.cond, whose two
        # branches the HLO walker averages ("conditional branch costs
        # averaged"): half a block on each of the n_layers layers, where
        # the block runs after every attn_every-th layer
        sites = cfg.n_layers // cfg.attn_every
        return (_attn_block_flops(cfg, b, s) * cfg.n_layers // 2
                - _attn_block_flops(cfg, b, s) * sites)
    if kind == "train":
        # torch.utils.checkpoint recomputes each loss chunk's LM-head
        # product (aten.mm, 2·B·S·d·V) in the backward pass; the
        # reference's scan keeps the chunk's logits
        return -2 * b * s * cfg.d_model * cfg.vocab_size
    return 0


@pytest.mark.parametrize("arch,kind", [(a, "prefill") for a in ARCH_IDS]
                         + [(a, "decode") for a in SERVE_ARCHS]
                         + [(a, "train") for a in TRAIN_ARCHS])
def test_walked_flops_match_the_hlo_walker(arch, kind, jax_costs,
                                           smoke_dryrun):
    cell = {"prefill": PREFILL, "decode": DECODE, "train": TRAIN}[kind]
    rec = smoke_dryrun(arch, cell)
    want = jax_costs[(arch, kind)]
    assert want.flops - rec["flops"] == _expected_gap(arch, kind)
    assert rec["flops_per_dev"] == rec["flops"]          # one device
    assert rec["collective_bytes_per_dev"] == 0
    if arch == "zamba2-7b":
        assert "conditional branch costs averaged" in want.warnings


# -- collectives and bytes -----------------------------------------------------


def test_ring_model_reproduces_the_reference_case():
    """tests/test_hlo_walker.py's case: 8 layers × an all-reduce of (4,
    256) f32 over k = 4 (each layer's weight read as the port reads one,
    ``x @ w.to(dt)``, its contracted dim over "model"):
    2·(k-1)/k·4096 = 6144 B a layer → 49,152 B."""
    mesh = make_mesh((2, 4), ("data", "model"))
    ws = [torch.empty((256, 256), device="meta") for _ in range(8)]
    x = torch.empty((4, 256), device="meta")

    def f(x, *ws):
        for w in ws:
            x = torch.tanh(x @ w.to(x.dtype))
        return x

    _, cost = op_walker.walk(f, x, *ws, mesh=mesh,
                             weights=[(w, ("model", None)) for w in ws])
    assert cost.coll_bytes == 49152
    assert cost.coll_by_kind == {"all-reduce": 49152}
    assert cost.n_collectives == 8
    assert cost.flops == 8 * 2 * 4 * 256 * 256
    for kind, k, n, want in (("all-reduce", 4, 4096, 6144),
                             ("all-gather", 16, 1600, 1500),
                             ("reduce-scatter", 8, 800, 700),
                             ("all-to-all", 2, 100, 50),
                             ("collective-permute", 4, 300, 300)):
        assert op_walker.wire_bytes(kind, k, n) == want


def test_production_decode_collectives_by_hand():
    """granite-3-8b decode_32k on 16×16, cut to 4 of its 40 layers:
    attention's and the MLP's wo contract a "model"-sharded dim, so each
    layer all-reduces two (128 / 16, 1, 4096) bf16 outputs over k = 16;
    the vocabulary (49,155) does not divide 16, so the embedding is
    replicated: 4 · 2 · 2·15/16 · 65,536 B."""
    rec = dryrun.run_cell("granite-3-8b", "decode_32k",
                          overrides={"n_layers": 4})
    assert rec["collective_by_kind"] == {"all-reduce": 4 * 2 * 122880}
    assert rec["collective_ops"] == 8
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["fits_hbm"] and rec["bottleneck"] == "memory"


def test_fsdp_layer_collectives_by_hand():
    """A column- then a row-parallel product with FSDP storage on a (2, 4)
    plan, forward and backward: each weight all-gathered once over
    "data" where its bf16 copy is made (fp32, a quarter of it a device);
    the row-parallel output all-reduced forward, the column-parallel
    input gradient backward, over "model"; then the gradients'
    reduce-scatters over "data"."""
    mesh = make_mesh((2, 4), ("data", "model"))
    w1 = torch.empty((64, 128), device="meta", requires_grad=True)
    w2 = torch.empty((128, 64), device="meta", requires_grad=True)
    x = torch.empty((8, 64), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    specs = [(w1, ("data", "model")), (w2, ("model", "data"))]

    def step(w1, w2, x):
        h = x @ w1.to(torch.bfloat16)
        y = torch.relu(h) @ w2.to(torch.bfloat16)
        return torch.autograd.grad(y.float().sum(), (w1, w2, x))

    _, cost = op_walker.walk(step, w1, w2, x, mesh=mesh, weights=specs,
                             act_div=2)
    gather = 2 * (2 - 1) / 2 * (64 * 128 * 4 / 4)
    reduce = 2 * 2 * (4 - 1) / 4 * (8 * 64 * 2 / 2)
    assert cost.coll_by_kind == {"all-gather": gather, "all-reduce": reduce}
    grads = op_walker.grad_sync_cost(specs, mesh, "data", n_micro=3)
    assert grads.coll_by_kind == {"reduce-scatter": 3 * 2 * (1 / 2) * 8192}
    pods = make_mesh((2, 2, 4), ("pod", "data", "model"))
    grads = op_walker.grad_sync_cost([(w1, (None, "model"))], pods,
                                     ("pod", "data"))
    assert grads.coll_by_kind == {"all-reduce": 2 * 3 / 4 * 64 * 128}


def test_tied_head_collectives_by_hand():
    """A vocab-sharded embedding (64, 16) over "model" on a (1, 4) plan,
    read twice as the port reads a tied table: the lookup
    ``table.to(dt)[tokens]`` contracts the sharded vocabulary (an
    all-reduce of its (6, 16) bf16 rows forward), and the head
    ``einsum(h, table.to(dt).T)`` keeps it (an all-reduce of the head's
    input gradient, the same bytes, backward)."""
    mesh = make_mesh((1, 4), ("data", "model"))
    table = torch.empty((64, 16), device="meta", requires_grad=True)
    tokens = torch.empty((6,), dtype=torch.int64, device="meta")

    def step(table):
        h = table.to(torch.bfloat16)[tokens] * 2
        logits = torch.einsum("td,dv->tv", h, table.to(torch.bfloat16).T)
        return torch.autograd.grad(logits.float().sum(), table)

    _, cost = op_walker.walk(step, table, mesh=mesh,
                             weights=[(table, ("model", None))])
    assert cost.coll_by_kind == {"all-reduce": 2 * 2 * 3 / 4 * 6 * 16 * 2}
    assert cost.n_collectives == 2


def test_bytes_chain_by_hand():
    """add (read 4,000 + write 4,000), a view (nothing), mul (8,000), sum
    (4,000 + 4), an index_copy_ of 10 rows into a (100, 10) buffer (2 ×
    400 + the 80-byte index), a row gather (2 × 200 + the 40-byte
    index).  The peak temp is x + 1 and the product, live together; the
    sum and the rows come after the first is freed."""
    x = torch.empty((1000,), device="meta")
    buf = torch.empty((100, 10), device="meta")
    idx = torch.empty((10,), dtype=torch.int64, device="meta")
    src = torch.empty((10, 10), device="meta")
    rows = torch.empty((5,), dtype=torch.int64, device="meta")

    def chain(x, buf):
        y = (x + 1).view(10, 100) * 2
        buf.index_copy_(0, idx, src)
        return y.sum(), buf[rows]

    _, cost = op_walker.walk(chain, x, buf)
    assert cost.bytes == 8000 + 8000 + 4004 + 880 + 440
    assert cost.peak_temp == 4000 + 4000


# -- the CLI and the table -----------------------------------------------------


def test_dryrun_main_and_the_roofline_table(tmp_path):
    out = str(tmp_path / "records")
    assert dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                        "--out", out]) == 0
    rec = json.loads((tmp_path / "records"
                      / "rwkv6-1.6b__long_500k__16x16.json").read_text())
    assert rec["fits_hbm"] and rec["flops_per_dev"] > 0
    assert rec["temp_bytes_per_dev_min"] == rec["temp_bytes_per_dev"] // 16
    assert rec["collective_by_kind"]["all-reduce"] > 0
    lines = roofline.table(out)
    assert lines[0] == jax_roofline.table(str(tmp_path / "none"))[0]
    assert lines[1] == ("granite-3-8b,long_500k,16x16,"
                        "SKIP(sub-quadratic-only),,,,,,,,,")
    assert lines[2].startswith("rwkv6-1.6b,long_500k,16x16,OK,")
    assert lines[2].split(",")[5] == "" and len(lines) == 3


def test_roofline_lines_match_the_reference(tmp_path):
    """The same OK, OOM, SKIP and ERROR records through both tables: equal
    lines, the port's ``tpu_est_GiB`` empty where the reference writes
    0.00."""
    ok = {"arch": "a", "shape": "prefill_32k", "mesh": "16x16",
          "fits_hbm": True, "peak_bytes_per_dev": 3 * 2**30,
          "t_compute_s": 0.125, "t_memory_s": 0.5, "t_collective_s": 0.01,
          "bottleneck": "memory", "roofline_fraction": 0.25,
          "model_vs_hlo": 0.75, "energy_wh_per_step": 1.5}
    records = {"1": ok, "2": dict(ok, arch="b", fits_hbm=False),
               "3": {"arch": "c", "shape": "long_500k", "mesh": "16x16",
                     "skipped": True},
               "4": {"arch": "d", "shape": "train_4k", "mesh": "16x16",
                     "error": "ValueError: x"}}
    for name, rec in records.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
    want = jax_roofline.table(str(tmp_path))
    got = roofline.table(str(tmp_path))
    assert [w.replace(",0.00,", ",,", 1) if w.split(",")[5] == "0.00"
            else w for w in want] == got
    assert [line.split(",")[3] for line in got[1:]] == [
        "OK", "OOM", "SKIP(sub-quadratic-only)", "ERROR"]


# -- the random init -----------------------------------------------------------


def test_init_std_is_the_jax_rule_for_every_stacked_leaf(monkeypatch):
    """Every leaf of the ten configs at full size, from shapes only: the
    std the port draws each parameter with (``layers.leaf_shapes`` →
    ``init_std``) equals what ``repro.models.layers._init_leaf`` gives the
    stacked leaf (its normal draw replaced by a 0-d one)."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.ones((), dtype))
    key = jax.random.PRNGKey(0)
    changed = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = (encdec.EncDecLM if cfg.layout == "encdec"
                 else lm.DecoderLM)(cfg, torch.device("meta"))
        port = {}
        for (path, _, p), (name, shape) in zip(convert.jax_paths(model),
                                               layers.leaf_shapes(model)):
            port["/".join(path)] = (name, shape, layers.init_std(name, shape))
            if port["/".join(path)][2] != layers.init_std(name, p.shape):
                changed.add(path[-1])
        leaves = _jax_leaves(jax_api.param_shapes(jax_get_config(arch)))
        assert sorted(port) == sorted(leaves)
        for path, sds in leaves.items():
            name, shape, std = port[path]
            assert tuple(shape) == tuple(sds.shape), (arch, path)
            if std is None:
                assert name.startswith(("norm", "scale", "ln", "bias",
                                        "dt_bias", "a_log", "decay"))
                continue
            got = jax_layers._init_leaf(key, path, sds)
            assert got.shape == () and np.float32(std) == np.float32(
                got), (arch, path)
    # the leaves whose std the stacking changes: rwkv6's and zamba2's
    # per-layer vectors
    assert changed == {"bonus_u", "mu_ck", "mu_cr", "mu_g", "mu_k", "mu_r",
                       "mu_v", "mu_w", "conv_bias", "d_skip"}


def test_init_params_draws_per_layer_vectors_at_the_stacked_std():
    """A smoke rwkv6 on the CPU: its (L, d) ``mu_r`` leaf has the sample
    std of N(0, 1/L), not of N(0, 1/d)."""
    cfg = get_config("rwkv6-1.6b", smoke=True, n_layers=16)
    tree = convert.params_to_jax(api.init_params(cfg, 0, "cpu"), cfg)
    mu = tree["layers"]["rwkv"]["mu_r"].float()
    assert mu.shape == (16, cfg.d_model)
    assert abs(float(mu.std()) * math.sqrt(16) - 1.0) < 0.1
