"""Dry run: the cost of every (arch × shape × mesh) cell, walked on meta
tensors — the port of the JAX package's ``launch/dryrun.py``.

For every cell this builds the step the cell names (``train/step.py``:
the train, prefill or serve bundle) on the meta device, with the
production plan's sharding policy (``models/sharding.py``), and walks one
call of it (``launch/op_walker.py``).  No device is touched, so a 314B
model walks on a CPU host.  The record holds what the JAX dry run's
holds, from the walk instead of a compiled HLO module:

  * ``arg_bytes_per_dev`` exact — Σ over the parameters, the optimizer
    state (train cells) and the inputs of each leaf's bytes over its
    spec's shard count;
  * ``temp_bytes_per_dev`` — the walk's peak of live allocated bytes over
    the batch axes' shard count alone, an upper bound: the activations and
    gathered weights the plan cuts over "model" (heads, d_ff, vocab) are
    not divided by it — and ``peak_bytes_per_dev`` = arg + temp, against
    ``HBM_PER_CHIP``, so ``fits_hbm`` is conservative (an ``OOM`` may fit);
    ``temp_bytes_per_dev_min`` divides every live tensor by the "model"
    axis too, a lower bound;
  * ``flops_per_dev``, ``bytes_per_dev`` (eager traffic),
    ``collective_bytes_per_dev`` (the plan's ring-model collectives) and
    the roofline and energy terms of ``core/energy.py``'s H100 constants;
  * ``model_vs_hlo`` — model FLOPs over the walked FLOPs (the column keeps
    the reference's name).

Meta tensors keep bf16, so there is no XLA:CPU bf16-emulation correction
and no ``peak_bytes_tpu_est``.  The production plans are plans
(``launch/mesh.py``): no placeholder devices and no ``XLA_FLAGS``.  The
model config keeps ``use_pallas=False``, so no kernel is on the path.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Union

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeCell,
                                 cell_applicable, for_mode, get_config,
                                 input_specs)
from repro_torch.core import energy as energy_lib
from repro_torch.launch import op_walker
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import api, convert, encdec, lm
from repro_torch.models.sharding import shard_count
from repro_torch.train import make_prefill_step, make_serve_step, \
    make_train_step
from repro_torch.train.step import opt_state_shapes

# NVIDIA H100 80GB HBM3: torch.cuda.get_device_properties(0).total_memory,
# as read on the card
HBM_PER_CHIP = 85_017_493_504
META = torch.device("meta")


def mesh_tag(mesh: Mesh) -> str:
    return "x".join(str(s) for s in mesh.devices.shape)


def _leaf_bytes(tree, specs, mesh: Mesh) -> int:
    """Σ over leaves of the bytes one device holds (a spec's shards); a
    lone tensor is a tree of one leaf."""
    total = 0
    for path, leaf in convert.tree_items(tree):
        spec = convert.tree_get(specs, path) if path else specs
        total += (leaf.numel() * leaf.element_size()
                  // shard_count(mesh, spec))
    return total


def lower_cell(arch: str, shape: Union[str, ShapeCell],
               multi_pod: bool = False,
               overrides: Optional[Dict[str, Any]] = None, n_micro: int = 1,
               mesh: Optional[Mesh] = None, lockstep: bool = False):
    """Build one cell's step on meta tensors: (lowered, meta), where
    ``lowered`` is a dict with the bundle, its arguments and the model's
    per-layer weights with their specs, or None for a skipped cell.
    ``mesh`` defaults to the production plan; ``lockstep`` gives a decode
    cell's cache a 0-d length (every row at one depth) in place of the
    reference's per-slot (B,) lengths."""
    cell = SHAPES[shape] if isinstance(shape, str) else shape
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    if cell.kind != "train":
        cfg = for_mode(cfg, "serve")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if not cell_applicable(cfg, cell):
        return None, {"skipped": True,
                      "reason": "long_500k needs sub-quadratic attention"}
    model = (encdec.EncDecLM if cfg.layout == "encdec"
             else lm.DecoderLM)(cfg, META)
    if cell.kind == "train":
        if n_micro == 0:
            # default: 2 sequences/device/microbatch; 1 for 314B grok —
            # capped so every microbatch keeps ≥1 row per data shard
            dp = mesh.devices.size // mesh.shape["model"]
            rows_per_dev = max(cell.global_batch // dp, 1)
            target = 16 if cfg.param_count() > 1e11 else 8
            n_micro = max(min(target, rows_per_dev), 1)
        batch = input_specs(cfg, cell)
        bundle = make_train_step(cfg, mesh, batch, n_micro=n_micro)
        opt = opt_state_shapes(cfg)
        args = (model, opt, batch)
        trees = (api.param_shapes(cfg), opt, batch)
        act = batch["tokens"]
    elif cell.kind == "prefill":
        batch = input_specs(cfg, cell)
        bundle = make_prefill_step(cfg, mesh, batch)
        args = (model, batch)
        trees = (api.param_shapes(cfg), batch)
        act = batch["tokens"]
    else:
        spec = input_specs(cfg, cell)
        bundle = make_serve_step(cfg, mesh, cell.global_batch, cell.seq_len)
        cache = spec["cache"]
        if lockstep:
            cache["length"] = torch.empty((), dtype=torch.int32, device=META)
        args = (model, cache, spec["token"])
        trees = (api.param_shapes(cfg), cache, spec["token"])
        act = spec["token"]
    policy = bundle.policy
    weights = [(p, policy.param_spec("/".join(path), tuple(p.shape)))
               for path, _, p in convert.jax_paths(model)]
    act_div = shard_count(mesh, policy.batch_spec(
        "tokens", tuple(act.shape))[:1])
    lowered = {"bundle": bundle, "args": args, "trees": trees,
               "weights": weights, "act_div": act_div, "n_micro": n_micro}
    meta = {"cfg": cfg, "mesh": mesh, "cell": cell, "bundle": bundle}
    return lowered, meta


def arg_bytes(lowered, meta) -> int:
    """Exact per-device argument bytes: parameters, optimizer state and
    inputs, each leaf over its spec's shard count."""
    return sum(_leaf_bytes(tree, specs, meta["mesh"]) for tree, specs
               in zip(lowered["trees"], lowered["bundle"].specs))


def analyse(lowered, meta, compile_it: bool = True) -> Dict[str, Any]:
    """The cell's record: argument bytes, and with ``compile_it`` (the
    reference's name) one walked call's costs and roofline terms."""
    cfg, mesh, cell = meta["cfg"], meta["mesh"], meta["cell"]
    chips = mesh.devices.size
    rec: Dict[str, Any] = {
        "arch": cfg.name, "shape": cell.name, "kind": cell.kind,
        "mesh": mesh_tag(mesh), "chips": chips,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "arg_bytes_per_dev": arg_bytes(lowered, meta),
    }
    if not compile_it:
        return rec
    t0 = time.time()
    _, cost = op_walker.walk(lowered["bundle"].fn, *lowered["args"],
                             mesh=mesh, weights=lowered["weights"],
                             act_div=lowered["act_div"])
    if cell.kind == "train":
        cost.add(op_walker.grad_sync_cost(
            lowered["weights"], mesh, lowered["bundle"].policy.batch_axes,
            lowered["n_micro"]))
    rec["walk_s"] = round(time.time() - t0, 1)
    rec["temp_bytes_per_dev"] = int(cost.peak_temp // lowered["act_div"])
    rec["temp_bytes_per_dev_min"] = int(
        cost.peak_temp // (lowered["act_div"] * mesh.shape.get("model", 1)))
    peak = rec["arg_bytes_per_dev"] + rec["temp_bytes_per_dev"]
    rec["peak_bytes_per_dev"] = int(peak)
    rec["fits_hbm"] = bool(peak <= HBM_PER_CHIP)
    rec["flops"] = cost.flops
    rec["flops_per_dev"] = cost.flops / chips
    rec["bytes_per_dev"] = cost.bytes / chips
    rec["collective_bytes_per_dev"] = cost.coll_bytes
    rec["collective_ops"] = cost.n_collectives
    rec["collective_by_kind"] = {k: round(v) for k, v in
                                 cost.coll_by_kind.items()}
    if cost.warnings:
        rec["walker_warnings"] = cost.warnings
    terms = energy_lib.roofline(rec["flops_per_dev"], rec["bytes_per_dev"],
                                cost.coll_bytes, chips=1)
    rec["t_compute_s"] = terms.t_compute
    rec["t_memory_s"] = terms.t_memory
    rec["t_collective_s"] = terms.t_collective
    rec["bottleneck"] = terms.bottleneck
    rec["roofline_fraction"] = terms.roofline_fraction
    rec["model_flops"] = model_flops(cfg, cell)
    rec["model_vs_hlo"] = (rec["model_flops"] / cost.flops
                           if cost.flops else 0.0)
    rec["energy_wh_per_step"] = energy_lib.energy_wh(energy_lib.roofline(
        cost.flops, rec["bytes_per_dev"] * chips, cost.coll_bytes * chips,
        chips=chips))
    return rec


def model_flops(cfg, cell) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for train; 2·N·D for inference."""
    n = cfg.active_param_count()
    if cell.kind == "train":
        return 6.0 * n * cell.global_batch * cell.seq_len
    if cell.kind == "prefill":
        return 2.0 * n * cell.global_batch * cell.seq_len
    return 2.0 * n * cell.global_batch   # decode: one token per sequence


def run_cell(arch: str, shape: Union[str, ShapeCell], multi_pod: bool = False,
             compile_it: bool = True, n_micro: int = 0,
             overrides: Optional[Dict[str, Any]] = None,
             mesh: Optional[Mesh] = None,
             lockstep: bool = False) -> Dict[str, Any]:
    """One cell's record (``mesh`` and a ``ShapeCell`` for cells outside
    the production set, e.g. one card's)."""
    lowered, meta = lower_cell(arch, shape, multi_pod, overrides=overrides,
                               n_micro=n_micro, mesh=mesh, lockstep=lockstep)
    name = shape if isinstance(shape, str) else shape.name
    if lowered is None:
        tag = (mesh_tag(mesh) if mesh is not None
               else "2x16x16" if multi_pod else "16x16")
        return {"arch": arch, "shape": name, "mesh": tag, **meta}
    return analyse(lowered, meta, compile_it=compile_it)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--no-compile", action="store_true",
                    help="build the step only (argument bytes, no walk)")
    ap.add_argument("--n-micro", type=int, default=0,
                    help="microbatches for train cells (0 = auto: 8)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    tag_mesh = "2x16x16" if args.multi_pod else "16x16"
    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{tag_mesh}"
        try:
            rec = run_cell(arch, shape, args.multi_pod,
                           compile_it=not args.no_compile,
                           n_micro=args.n_micro)
            status = ("SKIP" if rec.get("skipped")
                      else "OK" if rec.get("fits_hbm", True) else "OOM")
            print(f"[{status}] {tag}: "
                  f"peak={rec.get('peak_bytes_per_dev', 0) / 2**30:.2f}GiB "
                  f"flops/dev={rec.get('flops_per_dev', 0):.3g} "
                  f"coll={rec.get('collective_bytes_per_dev', 0) / 1e6:.1f}MB "
                  f"bottleneck={rec.get('bottleneck', '-')} "
                  f"walk={rec.get('walk_s', '-')}s", flush=True)
            if status == "OOM":
                failures += 1
        except Exception as e:  # noqa: BLE001 — report and continue the sweep
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": tag_mesh,
                   "error": f"{type(e).__name__}: {e}"}
            print(f"[FAIL] {tag}: {e}", flush=True)
            failures += 1
        (outdir / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    print(f"done: {len(cells)} cells, {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
