"""Distributed runtime: checkpointing, fault detection and elastic
re-meshing (``elastic.plan_remesh`` / ``build_mesh`` over
``launch.mesh.Mesh``)."""
from repro_torch.distributed import checkpoint, elastic, fault
from repro_torch.distributed.checkpoint import (latest_step, prune, restore,
                                                save)
from repro_torch.distributed.elastic import (RemeshPlan, build_mesh,
                                             plan_remesh)
from repro_torch.distributed.fault import (HeartbeatMonitor,
                                           StragglerDetector, TrainWatchdog)

__all__ = ["checkpoint", "elastic", "fault", "latest_step", "prune",
           "restore", "save", "RemeshPlan", "build_mesh", "plan_remesh",
           "HeartbeatMonitor", "StragglerDetector", "TrainWatchdog"]
