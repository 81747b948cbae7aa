"""Continuous-batching serving of the port: slot cache, paged cache,
chunked decode, the dense and paged engines (serial or pipelined
dispatch), prompt staging (``staging``), the plan database (``plandb``),
and the replica router with its fault injector and health layer
(``router``, ``faults``, ``health``)."""

from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine
from repro_torch.serve.faults import (FaultSpec, FaultyEngine,
                                      TransientFault, chaos_schedule,
                                      poison_slot)
from repro_torch.serve.health import (FaultTolerantRouter, HealthConfig,
                                      NoHealthyReplica, ReplicaHealth,
                                      deadline_for, priced_degradation)
from repro_torch.serve.router import QueueFull, ReplicaRouter
from repro_torch.serve.staging import PromptStager

__all__ = [
    "FaultSpec",
    "FaultTolerantRouter",
    "FaultyEngine",
    "HealthConfig",
    "NoHealthyReplica",
    "PagedServeEngine",
    "PromptStager",
    "QueueFull",
    "ReplicaHealth",
    "ReplicaRouter",
    "Request",
    "ServeEngine",
    "TransientFault",
    "chaos_schedule",
    "deadline_for",
    "poison_slot",
    "priced_degradation",
]
