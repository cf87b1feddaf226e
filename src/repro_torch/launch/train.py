"""Training launcher: data → train loop → checkpoints → recovery.

The JAX package's ``launch/train.py`` on this package: the same data
stream, schedule, checkpoints and recovery, on the card unless the caller
names another device.  Fault tolerance: periodic atomic checkpoints
(``distributed/checkpoint.py``, the JAX package's format and names, so a
run resumes from either package's checkpoint), a step-time watchdog,
restart from ``LATEST`` on the same mesh; ``lost_chips`` re-meshes once,
before the first step, through ``distributed/elastic.py``.

The reference trains on the host mesh, ``(n, 1)`` over every local
device.  Here that is one process a device, the ranks of a process group
(``distributed/ranks.py``): every rank draws the same global batches and
the step takes its rows (``train/step.py``); rank 0 writes the
checkpoints, behind a barrier, and every rank restores ``LATEST``; a
failure is met on every rank, which restores on the same mesh.  A
degraded mesh keeps the first ranks; the others take no step.  Every
rank returns rank 0's result.  ``main`` on a host of n > 1 cards starts
n ranks itself; under ``torchrun`` it joins the group that is there.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
        --smoke --steps 50 --batch 8 --seq 128 --ckpt-dir <dir> \\
        [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node N -m repro_torch.launch.train \\
        --arch rwkv6-1.6b --smoke ...
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import ranks
from repro_torch.distributed.elastic import build_mesh, plan_remesh
from repro_torch.distributed.fault import StragglerDetector, TrainWatchdog
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api, convert
from repro_torch.train import (OptConfig, make_opt_state, make_train_step,
                               opt_state_shapes)


def synthetic_batches(cfg, batch: int, seq: int, seed: int = 0,
                      device=None) -> Iterator[dict]:
    """Deterministic LM data: next-token prediction over structured noise
    — the JAX package's numpy stream, as tensors on ``device`` (the card
    unless the caller names another)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    while True:
        # Markov-ish stream so there is real signal to learn
        start = rng.integers(0, cfg.vocab_size - 1, size=(batch, 1))
        steps = rng.integers(1, 7, size=(batch, seq))
        toks = (start + np.cumsum(steps, axis=1)) % cfg.vocab_size
        b = {"tokens": put(toks[:, :-1], torch.int32),
             "labels": put(toks[:, 1:], torch.int32)}
        if cfg.layout == "encdec" or cfg.frontend == "audio":
            b["frames"] = put(rng.standard_normal(
                (batch, cfg.n_frontend_tokens, cfg.d_model)),
                cfg.torch_dtype())
        elif cfg.frontend == "vision":
            b["frontend_embeddings"] = put(rng.standard_normal(
                (batch, cfg.n_frontend_tokens, cfg.d_model)),
                cfg.torch_dtype())
        yield b


def _mesh_device(mesh) -> torch.device:
    """The device this process trains on: its rank's on a mesh of ranks,
    else the mesh's first, if this host has every device of the mesh (a
    production plan it never has)."""
    have = (mesh.size if mesh.spans_ranks
            else torch.cuda.device_count() if mesh.platform == "cuda"
            else 1 if mesh.platform == "cpu" else 0)
    if mesh.size > have:
        raise ValueError(f"the mesh {mesh.shape} needs {mesh.size} "
                         f"{mesh.platform} devices; this host has {have}")
    return mesh.device


# how long a rank that a degraded mesh leaves out waits for rank 0's
# result: the whole run, longer than a collective's default deadline
IDLE_WAIT = datetime.timedelta(days=7)


def _from_rank0(result, mesh, group=None):
    """Rank 0's result on every rank of the world (a rank outside a
    degraded mesh has none of its own)."""
    if not mesh.spans_ranks:
        return result
    box = [result]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def train(arch: str, smoke: bool, steps: int, batch: int, seq: int,
          ckpt_dir: Optional[str], ckpt_every: int = 20,
          n_micro: int = 1, use_ef_compress: bool = False,
          production_mesh: bool = False, lost_chips: int = 0,
          fail_at_step: Optional[int] = None, lr: float = 3e-4,
          log_every: int = 10, device=None) -> dict:
    cfg = get_config(arch, smoke=smoke)
    mesh = (make_production_mesh() if production_mesh
            else make_host_mesh(device))
    handoff = None
    if lost_chips:
        mesh = build_mesh(plan_remesh(mesh, lost_chips), mesh)
        if mesh.spans_ranks:
            handoff = dist.new_group(backend="gloo", timeout=IDLE_WAIT)
    if not mesh.holds_this_rank:
        return _from_rank0(None, mesh, handoff)
    dev = _mesh_device(mesh)
    lead = not mesh.spans_ranks or dist.get_rank() == 0
    opt_cfg = OptConfig(lr=lr, total_steps=max(steps, 2), warmup_steps=min(
        20, steps // 5 + 1), moment_dtype=cfg.moment_dtype)

    data = synthetic_batches(cfg, batch, seq + 1, device=dev)
    example = next(data)
    bundle = make_train_step(cfg, mesh, example, opt_cfg, n_micro=n_micro,
                             use_ef_compress=use_ef_compress,
                             loss_chunk=min(512, seq))
    like = (api.param_shapes(cfg),
            opt_state_shapes(cfg, opt_cfg, use_ef_compress))

    def restore():
        (tree, opt), extra = ckpt.restore(
            ckpt_dir, like, shardings=bundle.in_shardings[:2])
        convert.load_params_(model, tree)
        return opt, extra

    def save(step, prune):
        if lead:
            ckpt.save(ckpt_dir, step, (convert.params_to_jax(model, cfg),
                                       opt),
                      extra={"step": step, "arch": arch})
            if prune:
                ckpt.prune(ckpt_dir, keep=3)
        if mesh.spans_ranks:
            dist.barrier(group=mesh.group)

    model = api.init_params(cfg, 0, dev)
    opt = make_opt_state(cfg, model, opt_cfg, use_ef_compress)
    start_step = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        opt, extra = restore()
        start_step = int(extra.get("step", 0))
        if lead:
            print(f"[train] restored step {start_step} from {ckpt_dir}")

    watchdog = TrainWatchdog(ckpt_dir)
    straggle = StragglerDetector()
    losses, norms, step_ms = [], [], []
    step = start_step
    while step < steps:
        t0 = time.monotonic()
        batch_data = next(data)
        try:
            if fail_at_step is not None and step == fail_at_step:
                fail_at_step = None
                raise RuntimeError("injected failure")
            model, opt, metrics = bundle.fn(model, opt, batch_data)
        except RuntimeError as e:
            if not ckpt_dir or not watchdog.should_restart():
                raise
            if lead:
                print(f"[train] step {step} failed ({e}); restoring")
            restore_step = watchdog.on_failure()
            opt, extra = restore()
            step = int(extra.get("step", restore_step))
            continue
        straggle.record("host0", time.monotonic() - t0)
        loss = float(metrics["loss"])
        step_ms.append((time.monotonic() - t0) * 1e3)
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        step += 1
        if lead and (step % log_every == 0 or step == steps):
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {norms[-1]:.2f}")
        if ckpt_dir and step % ckpt_every == 0:
            save(step, prune=True)
    if ckpt_dir:
        save(step, prune=False)
    return _from_rank0(
        {"final_loss": losses[-1] if losses else float("nan"),
         "first_loss": losses[0] if losses else float("nan"),
         "steps": step, "losses": losses, "grad_norms": norms,
         "step_ms": step_ms}, mesh, handoff)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="rwkv6-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ef-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure (tests recovery)")
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: the card)")
    args = ap.parse_args(argv)
    if ranks.current() is not None:
        return _train_args(args)
    if "RANK" in os.environ:            # started by torchrun
        with ranks.joined(args.device):
            return _train_args(args)
    if (resolve_device(args.device) == torch.device("cuda")
            and torch.cuda.device_count() > 1):
        return ranks.spawn(_rank_main, torch.cuda.device_count(),
                           sys.argv[1:] if argv is None else argv,
                           device=args.device)[0]
    return _train_args(args)


def _train_args(args) -> dict:
    out = train(args.arch, args.smoke, args.steps, args.batch, args.seq,
                args.ckpt_dir, args.ckpt_every, args.n_micro,
                args.ef_compress, fail_at_step=args.fail_at_step,
                lr=args.lr, device=args.device)
    if ranks.current() is None or dist.get_rank() == 0:
        print(f"[train] done: loss {out['first_loss']:.3f} -> "
              f"{out['final_loss']:.3f} over {out['steps']} steps")
    return out


def _rank_main(r: ranks.Ranks, argv) -> dict:
    """A rank of the group ``main`` starts over this host's cards."""
    return main(argv)


if __name__ == "__main__":
    main()
