"""Serving: requests, per-model engines (real and simulated), the pool
scheduler, the reliability layer (circuit breakers) and chaos fault
injection."""
from repro_torch.serving.engine import (BaseEngine, EngineFailure,
                                        ModelEngine, SimEngine)
from repro_torch.serving.faults import FaultInjector, FaultSpec, fault_storm
from repro_torch.serving.reliability import BreakerConfig, CircuitBreaker
from repro_torch.serving.request import Request, RequestState, Response
from repro_torch.serving.scheduler import LivelockError, PoolServer

__all__ = ["BaseEngine", "EngineFailure", "ModelEngine", "SimEngine",
           "Request", "RequestState", "Response", "PoolServer",
           "LivelockError", "BreakerConfig", "CircuitBreaker",
           "FaultInjector", "FaultSpec", "fault_storm"]
