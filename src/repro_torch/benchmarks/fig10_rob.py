"""Fig. 10: RoB vs RoB-less ordering area (kGE, 1-4 DMA channels) + the
end-to-end performance microbench (multi-stream removes ordering stalls)."""
from __future__ import annotations

from repro_torch.benchmarks.common import row, timed
from repro_torch.core.noc import analytical as A
from repro_torch.core.noc import sim as S
from repro_torch.core.noc import traffic as T
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import build_mesh


def _completion(order, streams, alternate, unique_txn, device, cycles=4000,
                n_txns=16, ny=4):
    topo = build_mesh(nx=4, ny=ny)
    wl = T.ordering_workload(topo, streams=streams, alternate=alternate,
                             unique_txn=unique_txn, n_txns=n_txns, transfer_kb=1)
    sim = S.build_sim(topo, NocParams(ni_order=order), wl, device=device)
    st, us = timed(lambda: S.run(sim, cycles), iters=1)
    out = S.stats(sim, st)
    return int(out["last_rx"][0]), int(out["ni_stalls"][0]), us


def bench(full: bool = False, smoke: bool = False, device=None) -> list[dict]:
    rows = []
    if smoke:
        t1, s1, us1 = _completion("robless", 1, True, False, device, cycles=800,
                                  n_txns=4, ny=2)
        rows.append(row("fig10/smoke_robless_1stream_stalls", us1, s1,
                        target=1, cmp="ge"))
        return rows
    for c in (1, 2, 3, 4):
        for order in ("rob", "robless"):
            a = A.tile_ordering_area_kge(order, c)
            rows.append(row(f"fig10/area_kGE/{order}/{c}ch", 0.0,
                            round(sum(a.values()), 1)))
    rows.append(row("fig10/ni_robless_kGE", 0.0, A.ni_area_kge("robless"),
                    target=25, rel_tol=0.01))
    rows.append(row("fig10/rob_savings_kGE", 0.0, A.rob_savings_kge(),
                    target=256, rel_tol=0.01))
    rows.append(row("fig10/ni_reduction_pct", 0.0,
                    round(100 * (1 - A.ni_area_kge("robless") / A.ni_area_kge("rob")), 1),
                    target=91, rel_tol=0.02))

    # end-to-end: single stream + alternating dst stalls; multi-stream doesn't
    t1, s1, us1 = _completion("robless", 1, True, False, device)
    t2, s2, us2 = _completion("robless", 2, False, True, device)
    t3, s3, us3 = _completion("rob", 1, True, False, device)
    rows.append(row("fig10/robless_1stream_stalls", us1, s1, target=50, cmp="ge"))
    rows.append(row("fig10/robless_2stream_stalls", us2, s2, target=0, rel_tol=0.01))
    rows.append(row("fig10/multistream_speedup", 0.0, round(t1 / max(t2, 1), 2),
                    target=1.6, cmp="ge"))
    rows.append(row("fig10/matches_rob_perf", 0.0, round(t3 / max(t2, 1), 2),
                    target=0.9, cmp="ge"))
    return rows
