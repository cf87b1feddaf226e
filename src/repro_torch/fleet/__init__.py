"""Fleet subsystem: device-resident router state + sharded engine pools.

Two halves:

* residency — ``route_batch`` keeps all learning state (bandit
  sufficient statistics, k-means centroids) on the router's device across
  batches; ``TransferLedger`` (re-exported from
  ``repro_torch.core.residency``) is the audit trail proving zero
  per-call host↔device state transfer;
* scale-out — ``plan_fleet`` partitions devices into shards, each a full
  pool replica behind its own ``PoolServer``; ``FleetController``
  load-balances, all-reduces feedback statistics (exact — they are
  additive), and fails shards over without losing requests.
"""
from repro_torch.core.residency import TransferLedger
from repro_torch.fleet.plan import (FleetPlan, ShardSpec, base_model_name,
                                    plan_fleet)
from repro_torch.fleet.sync import FeedbackAllReduce
from repro_torch.fleet.controller import (FleetController, FleetShard,
                                          build_fleet, drive_fleet)

__all__ = ["TransferLedger", "FleetPlan", "ShardSpec", "base_model_name",
           "plan_fleet", "FeedbackAllReduce", "FleetController",
           "FleetShard", "build_fleet", "drive_fleet"]
