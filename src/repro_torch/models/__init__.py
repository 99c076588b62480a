"""The port's model stack (dense GQA, moe with GQA, ssm and hybrid families so far)."""
from repro_torch.models import attention, layers, model, moe, spec, ssm, transformer

__all__ = ["attention", "layers", "model", "moe", "spec", "ssm", "transformer"]
