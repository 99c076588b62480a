"""Paper Fig. 8 through the port: ``tests/test_noc_traffic.py``'s
pattern tests, mirrored. Each configuration runs in both packages; the
port's SimState equals JAX's leaf for leaf, every stats entry is equal,
and the JAX test's claim holds on the port's stats.

Horizons: the JAX tests run past the last DMA's completion (6000 and
12000 cycles). The mirrors stop at the completion cycle measured in the
JAX simulator plus at least 10% and assert every DMA done, so the claims
read the numbers they read at the JAX horizon (utilisation is beats over
``last_rx``, fixed once the last beat lands). Bit-complement at 32 kB
runs in ``test_torch_noc_traffic_bitcompl.py``, Fig. 11 in
``test_torch_noc_hbm.py``.
"""
import numpy as np
import torch

from torch_mirror import build_both, run_both

torch.set_num_threads(1)

NT = 32  # compute tiles of the 8x4 mesh


def _busy_util(out, tiles):
    """Received beats / busy window per tile, averaged (the JAX test's)."""
    beats = out["beats_rcvd"][tiles].astype(float)
    t = np.maximum(out["last_rx"][tiles], 1)
    return float((beats / t).mean())


def _dma(pattern, kb, txns):
    def make(pkg):
        topo = pkg.top.build_mesh(nx=4, ny=8)
        return topo, pkg.T.dma_workload(topo, pattern, transfer_kb=kb, n_txns=txns)
    return make


def test_neighbor_near_peak():
    """Zero-contention neighbor reads: near-peak wide-link utilization.
    All done by cycle 4149 (JAX); runs 4600."""
    _, _, out = run_both(build_both(_dma("neighbor", 32, 8)), 4600)
    assert out["dma_done"][:NT].sum() == NT * 8
    assert _busy_util(out, slice(0, NT)) > 0.85


# all DMAs done by cycle (JAX): 549 / 1946 / 2205
ORDERING_HORIZONS = {"neighbor": 610, "uniform": 2150, "bit-complement": 2430}


def test_pattern_ordering():
    """neighbor >= uniform >= bit-complement in utilization (8 kB x 4)."""
    utils = {}
    for p, cycles in ORDERING_HORIZONS.items():
        _, _, out = run_both(build_both(_dma(p, 8, 4)), cycles, tag=p)
        assert out["dma_done"][:NT].sum() == NT * 4, p
        utils[p] = _busy_util(out, slice(0, NT))
    assert utils["neighbor"] >= utils["uniform"] >= utils["bit-complement"]
