"""Causal flash attention: plain PyTorch version (``ref``), CUDA kernel
(``flash_attention``) and the device-dispatching entry point (``ops``)."""
