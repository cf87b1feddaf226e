"""Device meshes: the host's, arbitrary ones, and the production plans.

A ``Mesh`` is the JAX package's ``jax.sharding.Mesh`` reduced to what this
package reads: ``devices``, a numpy array of device ids laid out on the
mesh's axes; ``axis_names``; ``shape``, the mapping axis → size; and the
``platform`` the ids belong to — "cuda" or "cpu" for devices this host
drives, "plan" for placeholder ids.  The production layouts (16×16 chips,
2×16×16 over two pods) are plans: what reads them (the elastic re-mesh
arithmetic, the cost walk) needs their shape, not their devices.  A plan
places tensors on the meta device.

The host mesh is the JAX package's ``(n, 1)`` over every local device.
The port drives one device a process, so over n > 1 devices it is a
mesh of ranks: inside a ``torch.distributed`` group
(``distributed/ranks.py``) ``make_host_mesh`` gives the ``(world, 1)``
mesh whose ids are the group's ranks, each holding the batch rows of its
"data" index, and ``Mesh.device`` is this rank's own device.  Outside a
group the host mesh is one device: a host of n > 1 cards is refused, as
one process would train on its first card while the mesh claimed n.
Building a mesh touches no device state (it counts the cards); a
degraded mesh over fewer ranks forms their subgroup.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

PLACEHOLDER = "plan"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray            # device ids, one axis per axis name
    axis_names: Tuple[str, ...]
    platform: str = PLACEHOLDER    # "cuda" | "cpu" | "plan"
    # a mesh of ranks: this rank's device, and the process group of the
    # mesh's ranks (None: every rank of the world)
    local: Optional[torch.device] = None
    group: Any = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "devices", np.asarray(self.devices))
        object.__setattr__(self, "axis_names", tuple(self.axis_names))
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} with axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_ranks(self) -> bool:
        """Whether the mesh's ids are the ranks of a process group."""
        return self.local is not None

    @property
    def holds_this_rank(self) -> bool:
        """Whether this process is one of the mesh's ranks (a degraded
        mesh leaves the ranks past its extent out); any other mesh is
        this process's own."""
        return not self.spans_ranks or dist.get_rank() in self.devices

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` of a mesh of ranks."""
        if self.spans_ranks:
            hit = np.argwhere(self.devices == dist.get_rank())
            if len(hit):
                return int(hit[0][self.axis_names.index(axis)])
        raise ValueError(f"this process is not a rank of the mesh "
                         f"{self.shape}")

    @property
    def device(self) -> torch.device:
        """Where this process places the mesh's tensors: this rank's
        device on a mesh of ranks, else the mesh's first device (every
        leaf is replicated on a mesh of one device), the meta device for
        a plan."""
        if self.local is not None:
            return self.local
        if self.platform == "cuda":
            return torch.device("cuda", int(self.devices.flat[0]))
        if self.platform == "cpu":
            return torch.device("cpu")
        return torch.device("meta")


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              platform: str = PLACEHOLDER) -> Mesh:
    """A mesh over ids 0 .. prod(shape) - 1 of ``platform`` (tests,
    degraded and elastic meshes)."""
    n = math.prod(shape)
    return Mesh(np.arange(n).reshape(tuple(shape)), tuple(axes), platform)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 chips a pod; the multi-pod plan adds a leading 2-pod
    axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def rank_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: torch.device) -> Mesh:
    """A mesh over the group's ranks 0 .. prod(shape) - 1, this rank on
    ``device``; fewer ranks than the world form their subgroup, which
    every rank of the world must call this to form."""
    n, world = math.prod(shape), dist.get_world_size()
    if n > world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    group = None if n == world else dist.new_group(list(range(n)))
    return Mesh(np.arange(n).reshape(tuple(shape)), tuple(axes),
                device.type, local=device, group=group)


def make_host_mesh(device=None) -> Mesh:
    """The ("data", "model") mesh of (n, 1) over this host's devices (the
    card unless the caller names another device): inside a process group
    its (world, 1) ranks, this rank on ``device`` (a card without an
    index: the current one, which ``ranks.join`` set); outside one the
    one device there is — the CPU, or a host's only card."""
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no host mesh on {dev}")
    if dist.is_available() and dist.is_initialized():
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return rank_mesh((dist.get_world_size(), 1), ("data", "model"), dev)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        raise RuntimeError(
            f"this host has {n} cards and this process is in no process "
            f"group: one process drives one card, so a mesh over {n} needs "
            f"{n} ranks — start them with `torchrun --nproc-per-node {n} "
            f"-m repro_torch.launch.train` or `python -m "
            f"repro_torch.launch.train` (which starts {n} ranks itself), "
            f"or make one card visible (CUDA_VISIBLE_DEVICES)")
    return make_mesh((1, 1), ("data", "model"), dev.type)


def degraded_mesh(lost_chips: int, *, multi_pod: bool = False) -> Mesh:
    """Elastic-scaling helper: the largest (data', model) mesh that fits the
    surviving device count — the 'model' extent is preserved (TP degree is
    fixed by weight shardings), data parallelism shrinks."""
    base = make_production_mesh(multi_pod=multi_pod)
    total = base.devices.size - lost_chips
    model = base.shape["model"]
    data = total // model
    if data < 1:
        raise ValueError(f"cannot remesh: {total} chips < model axis {model}")
    if multi_pod:
        return make_mesh((1, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))
