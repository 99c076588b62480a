"""The port's model stack (dense GQA family so far)."""
from repro_torch.models import attention, layers, model, spec, transformer

__all__ = ["attention", "layers", "model", "spec", "transformer"]
