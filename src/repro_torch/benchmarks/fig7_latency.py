"""Fig. 7: tile-to-tile narrow read latency breakdown (22 / +4-per-hop / 58)."""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.benchmarks.common import row, timed
from repro_torch.core.noc import endpoints as epm
from repro_torch.core.noc import sim as S
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import build_mesh


def _lat(topo, src, dst, device, cycles=900):
    E = topo.n_endpoints
    wl = epm.idle_workload(E, n_tiles=topo.meta["n_tiles"])
    nr = np.zeros((E,), np.float32)
    nr[src] = 0.02
    nd = np.full((E,), -1, np.int32)
    nd[src] = dst
    wl = dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
    sim = S.build_sim(topo, NocParams(), wl, device=device)
    (st, us) = timed(lambda: S.run(sim, cycles), iters=1)
    return float(S.stats(sim, st)["narrow_lat_mean"][src]), us


def bench(full: bool = False, smoke: bool = False, device=None) -> list[dict]:
    if smoke:
        lat1, us = _lat(build_mesh(nx=4, ny=2), 0, 1, device, cycles=300)
        return [row("fig7/smoke_neighbor_roundtrip_cycles", us, lat1,
                    target=22, rel_tol=0.01)]
    topo = build_mesh(nx=4, ny=8)
    rows = []
    lat1, us = _lat(topo, 0, 1, device)
    rows.append(row("fig7/neighbor_roundtrip_cycles", us, lat1, target=22, rel_tol=0.01))
    lat2, us2 = _lat(topo, 0, 2, device)
    rows.append(row("fig7/per_hop_delta_cycles", us2, lat2 - lat1, target=4, rel_tol=0.01))
    lat_c, us3 = _lat(topo, 0, 31, device)
    rows.append(row("fig7/corner_roundtrip_cycles", us3, lat_c, target=58, rel_tol=0.01))
    # component budget (paper: routers 8, NIs 3, cluster+mem 11)
    p = NocParams()
    cluster = p.cluster_req_lat + p.cluster_rsp_lat + p.mem_lat
    rows.append(row("fig7/cluster_mem_cycles", 0.0, cluster, target=11, rel_tol=0.01))
    rows.append(row("fig7/ni_cycles", 0.0,
                    p.ni_req_lat * 2 + p.ni_rsp_lat, target=3, rel_tol=0.01))
    return rows
