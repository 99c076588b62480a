"""RMSNorm: plain PyTorch version (``ref``), CUDA kernel (``rmsnorm``) and
the device-dispatching entry points (``ops``)."""
