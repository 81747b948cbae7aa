"""Continuous-batching serving of the port: slot cache, chunked decode,
and the dense ``ServeEngine``."""

from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
