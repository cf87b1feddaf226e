"""Distributed runtime: checkpointing and fault detection.

The JAX package's third module, ``elastic`` (``plan_remesh``,
``build_mesh``: re-meshing a device mesh after chips are lost), needs the
device-mesh plan that comes with the dry-run's port (ROADMAP A.11) and has
no counterpart here yet.
"""
from repro_torch.distributed import checkpoint, fault
from repro_torch.distributed.checkpoint import (latest_step, prune, restore,
                                                save)
from repro_torch.distributed.fault import (HeartbeatMonitor,
                                           StragglerDetector, TrainWatchdog)

__all__ = ["checkpoint", "fault", "latest_step", "prune", "restore", "save",
           "HeartbeatMonitor", "StragglerDetector", "TrainWatchdog"]
