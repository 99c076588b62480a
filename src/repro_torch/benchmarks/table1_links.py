"""Table I: physical link dimensions from the field budget."""
from __future__ import annotations

from repro_torch.benchmarks.common import row
from repro_torch.core.noc import analytical as A


def bench(full: bool = False) -> list[dict]:
    w = A.link_widths()
    return [
        row("table1/req_bits", 0.0, w["req"], target=119, rel_tol=0.001),
        row("table1/rsp_bits", 0.0, w["rsp"], target=103, rel_tol=0.001),
        row("table1/wide_bits", 0.0, w["wide"], target=603, rel_tol=0.001),
        row("table1/header_bits", 0.0, A.header_bits()),
    ]
