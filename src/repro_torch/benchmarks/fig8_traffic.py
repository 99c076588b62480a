"""Fig. 8: wide-link bandwidth utilization per traffic pattern x transfer size
and narrow latency under load."""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks.common import row, timed
from repro_torch.core.noc import sim as S
from repro_torch.core.noc import traffic as T
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import build_mesh


def _util(topo, pattern, kb, txns, cycles, device):
    wl = T.dma_workload(topo, pattern, transfer_kb=kb, n_txns=txns)
    sim = S.build_sim(topo, NocParams(), wl, device=device)
    st, us = timed(lambda: S.run(sim, cycles), iters=1)
    out = S.stats(sim, st)
    nt = topo.meta["n_tiles"]
    done = out["dma_done"][:nt].sum() / (nt * txns)
    beats = out["beats_rcvd"][:nt].astype(float)
    util = float((beats / np.maximum(out["last_rx"][:nt], 1)).mean())
    return util, done, us


def bench(full: bool = False, smoke: bool = False, device=None) -> list[dict]:
    if smoke:
        util, done, us = _util(build_mesh(nx=4, ny=2), "neighbor", 1,
                               txns=2, cycles=600, device=device)
        return [row("fig8/smoke_util_neighbor_1kB", us, round(util, 3)),
                row("fig8/smoke_done_frac", 0.0, round(done, 2), target=1,
                    rel_tol=0.01)]
    topo = build_mesh(nx=4, ny=8)
    rows = []
    sizes = [1, 8, 32] if full else [8, 32]
    patterns = T.PATTERNS if full else ["neighbor", "uniform", "bit-complement",
                                        "tiled-matmul"]
    results = {}
    for p in patterns:
        for kb in sizes:
            cycles = 4000 * max(kb // 8, 1) + 4000
            util, done, us = _util(topo, p, kb, txns=4, cycles=cycles, device=device)
            results[(p, kb)] = util
            rows.append(row(f"fig8/util/{p}/{kb}kB", us, round(util, 3)))
    # paper-shaped assertions
    rows.append(row("fig8/neighbor_32kB_near_peak", 0.0,
                    round(results[("neighbor", 32)], 3), target=0.9, cmp="ge"))
    rows.append(row("fig8/bitcompl_congested", 0.0,
                    round(results[("bit-complement", 32)], 3), target=0.6, cmp="le"))
    rows.append(row("fig8/ordering_neighbor_ge_uniform", 0.0,
                    int(results[("neighbor", 32)] >= results[("uniform", 32)]),
                    target=1, rel_tol=0.01))

    # --- Fig. 8 bottom: narrow access latency vs injection ratio ---
    lat = {}
    for p in ("neighbor", "uniform", "bit-complement"):
        for rate in ((0.02, 0.1, 0.3) if full else (0.02, 0.3)):
            wl = T.narrow_workload(topo, p, rate)
            sim = S.build_sim(topo, NocParams(), wl, device=device)
            st, us = timed(lambda s=sim: S.run(s, 2500), iters=1)
            out = S.stats(sim, st)
            nt = topo.meta["n_tiles"]
            m = float(np.nanmean(np.where(out["narrow_lat_cnt"][:nt] > 0,
                                          out["narrow_lat_mean"][:nt], np.nan)))
            lat[(p, rate)] = m
            rows.append(row(f"fig8/lat/{p}/inj{rate}", us, round(m, 1)))
    # zero-contention neighbor traffic keeps zero-load latency at any rate
    rows.append(row("fig8/neighbor_latency_flat", 0.0,
                    round(lat[("neighbor", 0.3)] - lat[("neighbor", 0.02)], 1),
                    target=2, cmp="le"))
    # congested patterns degrade under load (paper: moderate increase)
    rows.append(row("fig8/bitcompl_latency_grows", 0.0,
                    int(lat[("bit-complement", 0.3)] > lat[("bit-complement", 0.02)]),
                    target=1, rel_tol=0.01))
    return rows
