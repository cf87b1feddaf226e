"""Serving: requests, per-model engines (real and simulated), the pool
scheduler."""
from repro_torch.serving.engine import (BaseEngine, EngineFailure,
                                        ModelEngine, SimEngine)
from repro_torch.serving.request import Request, RequestState, Response
from repro_torch.serving.scheduler import LivelockError, PoolServer

__all__ = ["BaseEngine", "EngineFailure", "ModelEngine", "SimEngine",
           "Request", "RequestState", "Response", "LivelockError",
           "PoolServer"]
