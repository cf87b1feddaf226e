"""The process group: one process a device, the ranks of the host mesh.

The JAX package drives every local device from one process
(``jax.devices()``) and lets GSPMD place the work on them.  The port runs
one process a device, and this module is its counterpart of that list: a
process joins a ``torch.distributed`` group and learns its rank, the
world and its device.  ``launch/mesh.py::make_host_mesh`` lays the ranks
out as the ``("data", "model")`` mesh of ``(world, 1)``.

A process joins from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) or from explicit ``rank``,
``world`` and ``init_method`` (a ``file://`` rendezvous in a temporary
directory needs no port).  The backend follows the device: NCCL for
CUDA, rank r on ``cuda:LOCAL_RANK`` (``cuda:r`` when the rank is given),
gloo for the CPU.  ``backend=`` names another: two ranks on one card,
which NCCL refuses, go over gloo.  Nothing falls back: a backend that
fails to start raises.

``spawn`` starts the ranks of a group as processes of this host (the
training launcher's one command over every card; the tests' CPU ranks).
"""
from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in its group."""

    rank: int
    world: int
    device: torch.device
    backend: str


def current() -> Optional[Tuple[int, int]]:
    """(rank, world) of this process's group; None outside one."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank(), dist.get_world_size()


def join(device=None, *, rank: Optional[int] = None,
         world: Optional[int] = None, init_method: Optional[str] = None,
         backend: Optional[str] = None) -> Ranks:
    """Join a process group: from ``torchrun``'s environment when no
    ``rank`` is given, else as ``rank`` of ``world`` through
    ``init_method``.  ``device``: the card unless the caller names
    another; a card given without an index is ``cuda:LOCAL_RANK``."""
    if current() is not None:
        raise RuntimeError("this process is in a process group already")
    if rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("no rank given and no torchrun environment "
                             "(RANK, WORLD_SIZE)")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    else:
        if world is None or init_method is None:
            raise ValueError("an explicit rank needs world and init_method")
        local = rank
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return Ranks(rank, world, dev, backend)


def leave() -> None:
    """Tear this process's group down (nothing outside one)."""
    if current() is not None:
        dist.destroy_process_group()


@contextlib.contextmanager
def joined(device=None, **kw) -> Iterator[Ranks]:
    """``join`` for the length of a ``with`` block, then ``leave``."""
    r = join(device, **kw)
    try:
        yield r
    finally:
        leave()


def _rank_main(fn, rank, world, init_method, device, backend, args, out):
    try:
        with joined(device, rank=rank, world=world, init_method=init_method,
                    backend=backend) as r:
            result = fn(r, *args)
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise
    # pickled here: through the queue, torch would share a tensor's memory
    # by a descriptor that this process takes with it when it ends
    out.put((rank, True, pickle.dumps(result)))


def spawn(fn: Callable[..., Any], world: int, *args, device=None,
          backend: Optional[str] = None, timeout: float = 3600.0
          ) -> List[Any]:
    """``fn(ranks, *args)`` in ``world`` new processes of this host, each a
    rank of one group (a ``file://`` rendezvous in a temporary
    directory); their results in rank order.  ``fn``, ``args`` and the
    results are pickled: ``fn`` is a module-level function.  A rank that
    raises, dies or outlasts ``timeout`` seconds fails the call with its
    traceback; every process is ended before this returns."""
    # a fork of a server that has imported torch and ``fn``'s module once:
    # a rank starts without importing them again, and no rank inherits
    # this process's threads or CUDA state
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(["torch", fn.__module__])
    out = ctx.Queue()
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            fn, r, world, init, device, backend, args, out))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    rank, ok, value = out.get(timeout=1.0)
                except queue.Empty:
                    # a rank that ended well has its result in the queue
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if not dead:
                        if time.monotonic() > deadline:
                            raise TimeoutError(f"{world} ranks outlasted "
                                               f"{timeout} s")
                        continue
                    # a rank that raised sent its traceback before it
                    # ended; it may reach the queue after the exit code
                    try:
                        rank, ok, value = out.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"ranks {dead} of {world} ended "
                                           f"without a result") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                results[rank] = pickle.loads(value)
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
            out.close()
    return [results[r] for r in range(world)]
