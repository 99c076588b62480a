"""Paper Fig. 8's congested pattern through the port: bit-complement at
32 kB x 4 on the 8x4 mesh (``tests/test_noc_traffic.py::
test_bit_complement_congested``), in a file of its own for the time it
takes on the CPU. The port's SimState equals JAX's leaf for leaf, every
stats entry is equal, and the JAX test's claim holds on the port.

Horizon: the JAX test runs 20000 cycles; every DMA is done by cycle 8733
in the JAX simulator, so the mirror runs 9700 and asserts every DMA done
(utilisation is fixed once the last beat lands).
"""
import torch

from test_torch_noc_traffic import NT, _busy_util, _dma
from torch_mirror import build_both, run_both

torch.set_num_threads(1)


def test_bit_complement_congested():
    """Bisection-limited pattern: well below peak (paper: ~28%)."""
    _, _, out = run_both(build_both(_dma("bit-complement", 32, 4)), 9700)
    assert out["dma_done"][:NT].sum() == NT * 4
    util = _busy_util(out, slice(0, NT))
    assert util < 0.6, f"bit-complement should be congested, got {util:.2f}"
