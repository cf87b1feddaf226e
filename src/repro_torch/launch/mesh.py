"""Device meshes: the host's, arbitrary ones, and the production plans.

A ``Mesh`` is the JAX package's ``jax.sharding.Mesh`` reduced to what this
package reads: ``devices``, a numpy array of device ids laid out on the
mesh's axes; ``axis_names``; ``shape``, the mapping axis → size; and the
``platform`` the ids belong to — "cuda" or "cpu" for devices this process
drives, "plan" for placeholder ids.  The production layouts (16×16 chips,
2×16×16 over two pods) are plans: no one process holds 256 ranks, and
what reads them (the elastic re-mesh arithmetic, the cost walk) needs
their shape, not their devices.  A plan places tensors on the meta device.

No ``torch.distributed`` device mesh is built here: that needs a process
group on every rank, and one process drives one card.  Building a mesh
touches no device state (``make_host_mesh`` only counts the cards).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

PLACEHOLDER = "plan"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    devices: np.ndarray            # device ids, one axis per axis name
    axis_names: Tuple[str, ...]
    platform: str = PLACEHOLDER    # "cuda" | "cpu" | "plan"

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
    def device(self) -> torch.device:
        """Where this process places the mesh's tensors: its first device
        (every leaf is replicated on a mesh of one device), the meta
        device for a plan."""
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


def make_host_mesh(device=None) -> Mesh:
    """The ("data", "model") mesh of (n, 1) over this host's n cards (the
    card unless the caller names another device; the CPU is one
    device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return make_mesh((torch.cuda.device_count(), 1), ("data", "model"),
                         "cuda")
    if dev.type == "cpu":
        return make_mesh((1, 1), ("data", "model"), "cpu")
    raise ValueError(f"no host mesh on {dev}")


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
