"""Continuous-batching serving of the port: slot cache, paged cache,
chunked decode, and the dense and paged engines."""

from repro_torch.serve.engine import PagedServeEngine, Request, ServeEngine

__all__ = ["PagedServeEngine", "Request", "ServeEngine"]
