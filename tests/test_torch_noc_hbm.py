"""Paper Fig. 11 through the port: ``tests/test_noc_traffic.py``'s HBM
and Occamy tests, mirrored. Each configuration runs in both packages; the
port's SimState equals JAX's leaf for leaf, every stats entry is equal,
and the JAX test's claim holds on the port's stats.

Horizons: the JAX tests run past the last DMA's completion (4000 and
16000 cycles). The mirrors stop at the completion cycle measured in the
JAX simulator plus at least 10% and assert every DMA done, so the claims
read the numbers they read at the JAX horizon (utilisation is beats over
``last_rx``, fixed once the last beat lands). The Occamy latency test
has no completion (steady narrow traffic) and keeps its 800 cycles.
"""
import dataclasses
import functools

import numpy as np
import torch

from repro.core.noc.params import NocParams
from torch_mirror import build_both, run_both

torch.set_num_threads(1)

NT = 32


def _mesh(pkg):
    return pkg.top.build_mesh(nx=4, ny=8)


def test_hbm_zero_load_high_util():
    """One DMA per HBM channel: ~97% of channel bandwidth (Fig. 11a).
    All done by cycle 2219 (JAX); runs 2450."""
    def make(pkg):
        topo = _mesh(pkg)
        return topo, pkg.T.hbm_workload(topo, full_load=False, n_txns=24, transfer_kb=4)
    sims = build_both(make)
    _, _, out = run_both(sims, 2450)
    topo = sims[1].topo
    col0 = [e for e in range(NT) if topo.tile_coord[e][0] == 0]
    assert out["dma_done"][col0].sum() == len(col0) * 24
    p = NocParams()
    beats = out["beats_rcvd"][col0].astype(float)
    util = beats / np.maximum(out["last_rx"][col0], 1) / p.hbm_rate
    assert util.mean() > 0.9, f"zero-load HBM util {util.mean():.2f}"


@functools.lru_cache(maxsize=None)
def _full_load():
    """FlooNoC full load, 8 x 4 kB per tile: all done by cycle 2963 (JAX);
    runs 3300. Shared by two tests."""
    def make(pkg):
        topo = _mesh(pkg)
        return topo, pkg.T.hbm_workload(topo, full_load=True, n_txns=8, transfer_kb=4)
    sims = build_both(make)
    _, _, out = run_both(sims, 3300)
    assert out["dma_done"][:NT].sum() == NT * 8
    return sims[1].topo, out


def test_hbm_full_load_shared_fairly():
    """All 4 tiles per row share a channel: each gets a usable share and the
    aggregate saturates the channel (Fig. 11a full-load: 28/24/24/24)."""
    topo, out = _full_load()
    p = NocParams()
    row0 = [e for e in range(NT) if topo.tile_coord[e][1] == 0]
    beats = out["beats_rcvd"][row0].astype(float)
    util = beats / np.maximum(out["last_rx"][row0], 1) / p.hbm_rate
    assert util.sum() > 0.8, "aggregate should saturate the channel"
    assert util.min() > 0.12, f"every tile deserves a share: {util}"


def test_occamy_full_load_worse_than_floonoc():
    """The hierarchical-Xbar baseline sustains lower full-load HBM util than
    the mesh. Occamy's DMAs are all done by cycle 2501 (JAX); runs 2760."""
    def make(pkg):
        occ = pkg.top.build_occamy(n_groups=6, clusters_per_group=4, n_hbm=8, spill=4)
        nt = occ.meta["n_clusters"]
        wl = pkg.epm.idle_workload(occ.n_endpoints, n_tiles=nt)
        dd = np.full((occ.n_endpoints, 1), -1, np.int32)
        dt = np.zeros((occ.n_endpoints, 1), np.int32)
        for e in range(nt):
            dd[e, 0] = nt + (e % 8)
            dt[e, 0] = 8
        return occ, dataclasses.replace(wl, dma_dst=dd, dma_txns=dt, dma_beats=64)
    _, _, out_o = run_both(build_both(make, max_outstanding=4), 2760)
    assert out_o["dma_done"][:24].sum() == 24 * 8
    _, out_f = _full_load()
    p = NocParams()

    def agg_util(out, nt, n_ch):
        beats = out["beats_rcvd"][:nt].astype(float).sum()
        t = max(out["last_rx"][:nt].max(), 1)
        return beats / t / p.hbm_rate / n_ch

    u_occ = agg_util(out_o, 24, 8)
    u_floo = agg_util(out_f, NT, 8)
    assert u_floo > u_occ, f"floonoc {u_floo:.2f} should beat occamy {u_occ:.2f}"


def test_occamy_intra_vs_inter_group_latency():
    """Occamy: intra-group access is cheap, group-to-group much slower
    (paper Fig. 11d: ~10 vs ~43 cycles zero-load)."""
    def lat(src, dst):
        def make(pkg):
            occ = pkg.top.build_occamy()
            E = occ.n_endpoints
            wl = pkg.epm.idle_workload(E, n_tiles=occ.meta["n_clusters"])
            nr = np.zeros((E,), np.float32)
            nr[src] = 0.02
            nd = np.full((E,), -1, np.int32)
            nd[src] = dst
            return occ, dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
        _, _, out = run_both(build_both(make), 800, tag=f"{src}->{dst}")
        return float(out["narrow_lat_mean"][src])

    intra = lat(0, 1)   # same group
    inter = lat(0, 5)   # cluster in another group (through top xbar + spills)
    assert inter > intra + 15
    assert intra < 25
