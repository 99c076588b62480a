"""Table III: comparison with state-of-the-art NoCs (bandwidth, energy)."""
from __future__ import annotations

from repro_torch.benchmarks.common import row
from repro_torch.core.noc import analytical as A


def bench(full: bool = False) -> list[dict]:
    rows = [
        row("table3/wide_link_gbps", 0.0, round(A.peak_link_bandwidth_gbps(), 0),
            target=645, rel_tol=0.01),
        row("table3/tile_to_tile_gbps", 0.0, round(A.tile_to_tile_bandwidth_gbps(), 0),
            target=806, rel_tol=0.01),
        row("table3/aggregate_tbps", 0.0, round(A.aggregate_bandwidth_tbps(), 1),
            target=103, rel_tol=0.01),
        row("table3/energy_pj_b_hop", 0.0, A.energy_per_byte_per_hop_pj(),
            target=0.15, rel_tol=0.01),
        row("table3/3x_vs_piton", 0.0,
            round(A.SOA_TABLE["piton"]["pj_per_b_hop"] / A.energy_per_byte_per_hop_pj(), 1),
            target=3.0, rel_tol=0.01),
        row("table3/2x_bandwidth_vs_esp", 0.0,
            round(A.SOA_TABLE["floonoc"]["t2t_gbps"] / A.SOA_TABLE["esp"]["t2t_gbps"], 2),
            target=2.0, cmp="ge"),
        row("table3/noc_area_pct", 0.0, 100 * A.NOC_TILE_FRACTION, target=3.5,
            rel_tol=0.01),
    ]
    return rows
