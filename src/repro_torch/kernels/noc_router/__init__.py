"""FlooNoC router cycle: plain PyTorch version (``ref``), CUDA kernels
(``noc_router``) and the device-dispatching entry point (``ops``)."""
