"""Elastic scaling: re-mesh on node loss and reshard from checkpoint.

When chips are lost, training resumes on the largest viable mesh: the TP
("model") extent is preserved — weight shards assume it — and data
parallelism shrinks to whatever still fits.  The global batch either shrinks
with it or is held constant by raising the microbatch count; both policies
are supported and the choice is recorded in the run log.

The recovery path is: detect loss → ``plan_remesh`` → rebuild step bundle on
the degraded mesh → ``checkpoint.restore(..., shardings=new)`` → continue.
The arithmetic is the JAX package's, on ``launch.mesh.Mesh``; a plan over
a mesh of ranks keeps its first ranks (``build_mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.launch.mesh import PLACEHOLDER, Mesh, make_mesh, rank_mesh


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: Tuple[int, ...]
    new_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    lost_chips: int
    batch_policy: str            # "shrink" | "hold" (raise n_micro)
    n_micro_multiplier: int

    @property
    def new_data_parallel(self) -> int:
        return self.new_shape[-2]


def plan_remesh(mesh: Mesh, lost_chips: int,
                batch_policy: str = "hold") -> RemeshPlan:
    """Largest (pods × data' × model) mesh on the surviving chips."""
    axes = tuple(mesh.axis_names)
    shape = tuple(mesh.devices.shape)
    model = shape[-1]
    total = mesh.devices.size - lost_chips
    # keep the pod axis only if a full pod-multiple survives
    if "pod" in axes:
        per_pod = shape[-2] * model
        pods = max(total // per_pod, 1)
        data = (total - (pods - 1) * per_pod) // model if pods == 1 else shape[-2]
        data = min(data, shape[-2])
        new_shape = (pods, data, model)
    else:
        data = total // model
        if data < 1:
            raise ValueError(
                f"{total} surviving chips cannot host model axis {model}")
        new_shape = (data, model)
    old_dp = shape[0] * shape[-2] if "pod" in axes else shape[0]
    new_dp = (new_shape[0] * new_shape[1] if "pod" in axes
              else new_shape[0])
    mult = max(1, -(-old_dp // new_dp)) if batch_policy == "hold" else 1
    return RemeshPlan(old_shape=shape, new_shape=new_shape, axes=axes,
                      lost_chips=lost_chips, batch_policy=batch_policy,
                      n_micro_multiplier=mult)


def build_mesh(plan: RemeshPlan, base: Optional[Mesh] = None) -> Mesh:
    """The plan's mesh over the first ids of ``base``, the mesh it
    re-meshes (placeholder ids without one).  Over a mesh of ranks: the
    first ranks, which form their subgroup (every rank calls this), this
    rank on its own device; the ranks past the plan's extent hold no
    place on it."""
    if base is not None and base.spans_ranks:
        return rank_mesh(plan.new_shape, plan.axes, base.device)
    return make_mesh(plan.new_shape, plan.axes,
                     base.platform if base is not None else PLACEHOLDER)
