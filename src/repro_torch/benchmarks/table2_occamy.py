"""Table II: FlooNoC mesh vs Occamy (area, frequency, GFLOPS, density)."""
from __future__ import annotations

from repro_torch.benchmarks.common import row
from repro_torch.core.noc import analytical as A


def bench(full: bool = False) -> list[dict]:
    floo = A.floonoc_system(4, 8)
    floo83 = A.floonoc_system(3, 8)
    occ = A.occamy_system()
    g_occ = A.gflops_dp(24, 1.14)
    g_83 = A.gflops_dp(24, 1.26)
    g_84 = A.gflops_dp(32, 1.26)
    return [
        row("table2/occamy_gflops", 0.0, g_occ, target=438, rel_tol=0.01),
        row("table2/floonoc_8x3_gflops", 0.0, g_83, target=484, rel_tol=0.01),
        row("table2/floonoc_8x4_gflops", 0.0, g_84, target=645, rel_tol=0.01),
        row("table2/gflops_gain_pct", 0.0, round(100 * (g_84 / g_occ - 1), 1),
            target=47, rel_tol=0.03),
        row("table2/die_area_8x3_mm2", 0.0, round(floo83.die_mm2, 1), target=29.5,
            rel_tol=0.03),
        row("table2/die_area_8x4_mm2", 0.0, round(floo.die_mm2, 1), target=39.3,
            rel_tol=0.02),
        row("table2/area_reduction_8x3_pct", 0.0,
            round(100 * (1 - floo83.die_mm2 / 42.1), 1), target=30, rel_tol=0.1),
        row("table2/top_level_reduction_pct", 0.0,
            round(100 * (1 - floo83.top_mm2 / occ.top_mm2), 1), target=85, rel_tol=0.05),
        row("table2/compute_density", 0.0, round(g_84 / floo.die_mm2, 1),
            target=16.4, rel_tol=0.02),
    ]
