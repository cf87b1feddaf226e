"""Fleet planning: partition the device set into engine-pool shards.

``plan_fleet`` splits the visible CUDA devices round-robin into
``n_shards`` disjoint groups.  Each shard runs a full replica of the model
pool behind its own ``PoolServer`` + ``GreenServRouter`` (weak scaling: n
shards absorb n× the arrival rate at ~flat per-query latency).

``shard_mesh`` gives a shard its ``(n_dev, 1)`` ``("data", "model")``
mesh and ``fleet_mesh`` one over every shard's devices (``launch.mesh``),
as the JAX package's: the frame of reference of the elastic re-mesh
record a fail-over leaves.  Shards that share a device (one card, many
virtual shards) share its id in the meshes, as JAX meshes allow.

Planning is pure bookkeeping — importing this module never touches device
state.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import PLACEHOLDER, Mesh


def base_model_name(member: str) -> str:
    """Strip the ``@shard`` adoption suffix: arms a shard adopts during
    fail-over are named ``<base>@<dead-shard>`` so pool names stay unique
    while the all-reduce still merges their statistics per base model."""
    return member.split("@", 1)[0]


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """One engine-pool shard: a named, disjoint slice of the device set."""

    index: int
    name: str
    device_ids: Tuple[int, ...]
    models: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return len(self.device_ids)


@dataclasses.dataclass(frozen=True)
class FleetPlan:
    """Shard layout + mesh builders (axes fixed to ("data", "model"), as in
    the JAX package); ``platform`` is the devices' ("cuda", "cpu", or
    "plan" for devices known only by id)."""

    shards: Tuple[ShardSpec, ...]
    axes: Tuple[str, str] = ("data", "model")
    platform: str = "cuda"

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def _mesh(self, ids) -> Mesh:
        return Mesh(np.array(ids).reshape(len(ids), 1), self.axes,
                    self.platform)

    def shard_mesh(self, spec: ShardSpec) -> Mesh:
        """Per-shard mesh: (n_dev, 1) over exactly the shard's devices."""
        return self._mesh(spec.device_ids)

    def fleet_mesh(self) -> Mesh:
        """Whole-fleet mesh (all shards' devices) — the frame of reference
        for ``plan_remesh`` degradation records on shard loss."""
        return self._mesh([i for spec in self.shards
                           for i in spec.device_ids])


def _device_id(d) -> int:
    """A device's id: ``.id`` where it has one, a ``torch.device``'s index
    (the current CUDA device for a bare "cuda")."""
    if isinstance(d, torch.device):
        if d.index is not None:
            return d.index
        return torch.cuda.current_device() if d.type == "cuda" else 0
    return int(d.id)


def plan_fleet(n_shards: int,
               pool_names: Sequence[str],
               devices: Optional[Sequence] = None) -> FleetPlan:
    """Partition devices round-robin (``devices[i::n_shards]``) into
    ``n_shards`` shard specs, each replicating the full ``pool_names``.

    ``devices`` holds objects with an ``.id`` or ``torch.device``s; None
    means every visible CUDA device (ids = their indices) and raises where
    there is none — a fleet meant for the card never plans onto the CPU.
    With fewer devices than shards (one card, many virtual shards), shards
    share devices one-to-one by index modulo the device count — the
    controller is a concurrency structure there, not a placement one.
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if not pool_names:
        raise ValueError("pool_names must be non-empty")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices= to "
                               "plan a fleet elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    ids = [_device_id(d) for d in devices]
    platform = (devices[0].type if devices and isinstance(devices[0],
                                                          torch.device)
                else PLACEHOLDER)
    shards: List[ShardSpec] = []
    models = tuple(pool_names)
    for i in range(n_shards):
        mine = tuple(ids[i::n_shards]) if len(ids) >= n_shards \
            else (ids[i % len(ids)],)
        shards.append(ShardSpec(index=i, name=f"shard{i}",
                                device_ids=mine, models=models))
    return FleetPlan(shards=tuple(shards), platform=platform)
