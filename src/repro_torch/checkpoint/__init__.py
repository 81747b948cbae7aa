"""Async, crash-atomic checkpoints of tensor trees (``checkpointer``)."""

from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
