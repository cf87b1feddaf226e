"""Predictive energy cost model: pre-dispatch joule forecasts
(docs/ENERGY.md).

``EnergyCostModel`` forecasts the Wh a query will meter on each candidate
engine *before* dispatch — an analytic roofline prior (mirroring the
engines' own charging rules in ``core.energy`` / ``serving.engine``) plus
an online RLS residual calibrated from the metered ledger.  Consumers:
the router's per-(query, arm) energy tilt, the cache's predicted prefix
discounts, the governor's in-flight predicted-Wh charge, and the
scheduler's energy-aware admission planner.

This package is the JAX package's ``repro/costmodel`` (numpy only),
carried as its own copy.  Its prior calls the port's ``core/energy.py``
functions, which read the module's H100 constants at call time, so a
caller (or a test) that sets those constants changes every forecast.
"""
from repro_torch.costmodel.model import (FEATURE_DIM, PHASES, EngineCostModel,
                                         EnergyCostModel)
from repro_torch.costmodel.residual import RLSResidual

__all__ = ["EnergyCostModel", "EngineCostModel", "RLSResidual",
           "FEATURE_DIM", "PHASES"]
