"""Paged KV gather: plain PyTorch version (``ref``), CUDA kernel
(``kv_gather``) and the device-dispatching entry point (``ops``)."""
from repro_torch.kernels.kv_gather.ops import kv_gather

__all__ = ["kv_gather"]
