"""Mamba-2 SSD chunked scan: plain PyTorch versions (``ref``), CUDA kernel
(``ssd``) and the device-dispatching entry points (``ops``)."""
