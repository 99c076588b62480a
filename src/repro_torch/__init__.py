"""PyTorch/CUDA port of the FlooNoC reproduction.

The cycle-level NoC simulator of ``repro`` rebuilt on PyTorch, with the
router cycle as hand-written CUDA kernels for Hopper (``sm_90a``). The
package imports ``torch`` and ``numpy`` only; ``repro`` stays the
reference it is tested against.
"""
