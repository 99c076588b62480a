"""Batched serving on the port's model stack."""
from repro_torch.serve.engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
