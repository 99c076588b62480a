"""The port's model stack (dense GQA, ssm and hybrid families so far)."""
from repro_torch.models import attention, layers, model, spec, ssm, transformer

__all__ = ["attention", "layers", "model", "spec", "ssm", "transformer"]
