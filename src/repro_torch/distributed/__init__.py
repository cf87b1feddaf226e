"""Distributed runtime: checkpointing, fault detection, elastic
re-meshing (``elastic.plan_remesh`` / ``build_mesh`` over
``launch.mesh.Mesh``) and the process group of the ranks
(``ranks``)."""
from repro_torch.distributed import checkpoint, elastic, fault, ranks
from repro_torch.distributed.checkpoint import (latest_step, prune, restore,
                                                save)
from repro_torch.distributed.elastic import (RemeshPlan, build_mesh,
                                             plan_remesh)
from repro_torch.distributed.fault import (HeartbeatMonitor,
                                           StragglerDetector, TrainWatchdog)

__all__ = ["checkpoint", "elastic", "fault", "ranks", "latest_step", "prune",
           "restore", "save", "RemeshPlan", "build_mesh", "plan_remesh",
           "HeartbeatMonitor", "StragglerDetector", "TrainWatchdog"]
