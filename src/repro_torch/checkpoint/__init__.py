"""Checkpoints in the JAX package's on-disk format (``checkpointer``)."""
from repro_torch.checkpoint.checkpointer import Checkpointer, latest_step

__all__ = ["Checkpointer", "latest_step"]
