"""Fig. 9: tile area breakdown + 4 kB-transfer energy (analytical models)."""
from __future__ import annotations

from repro_torch.benchmarks.common import row
from repro_torch.core.noc import analytical as A


def bench(full: bool = False) -> list[dict]:
    rows = [
        row("fig9a/noc_tile_area_pct", 0.0, A.NOC_TILE_FRACTION * 100, target=3.5,
            rel_tol=0.01),
        row("fig9a/interconnect_tile_area_pct", 0.0,
            A.INTERCONNECT_TILE_FRACTION * 100, target=6.9, rel_tol=0.01),
        row("fig9a/router_buffer_fraction_pct", 0.0,
            A.ROUTER_BUFFER_FRACTION * 100, target=53, rel_tol=0.01),
        row("fig9b/router_energy_4kB_pJ", 0.0, A.router_energy_4kb_neighbor_pj(),
            target=596, rel_tol=0.01),
        row("fig9b/energy_pJ_per_B_per_hop", 0.0, A.energy_per_byte_per_hop_pj(),
            target=0.15, rel_tol=0.01),
    ]
    return rows
