"""NoC-aware collective scheduler: prices gradient-sync configurations on a
FlooNoC-like fabric model and picks stream count / bucket sizes.

The cost model reuses the paper's numbers: wide on-pod links (ICI-class BW),
a scarce pod-boundary link (C2C-class), per-hop latency, and per-message
injection overhead. This is the design-time analogue of the cycle simulator:
the simulator validates microarchitecture; this model steers the framework.

The port's copy of ``repro.core.scheduler`` (pure Python).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.collectives import FabricCollectiveModel
from repro_torch.core.noc.params import NocParams

ICI_BW = 50e9  # B/s per on-pod link (TPU v5e-class)
C2C_BW = 12.5e9  # B/s pod-boundary (DCI per chip, scarce like the paper's C2C)
# cycles per router traversal, from the simulator-calibrated collective model
# (matches paper Fig. 7's 2-cycles-per-hop routers)
HOP_LAT = FabricCollectiveModel.from_noc_params(NocParams()).hop_cycles
FREQ = 1.26e9
MSG_OVERHEAD_S = 5e-6  # per-collective injection/firmware overhead
COMPRESS_RATIO = 0.25  # int8 vs f32


@dataclass(frozen=True)
class SyncPlanCost:
    n_streams: int
    intra_s: float
    pod_s: float
    overhead_s: float
    overlap_factor: float

    @property
    def total_s(self) -> float:
        # independent streams overlap; the paper's multi-stream DMA removes
        # cross-stream ordering, so wall time ~ max(stream) + small serial part
        return (self.intra_s + self.pod_s) * self.overlap_factor + self.overhead_s


def ring_time(bytes_total: int, group: int, bw: float) -> float:
    if group <= 1:
        return 0.0
    return 2 * bytes_total * (group - 1) / group / bw  # all-reduce = RS + AG


def cost(grad_bytes: int, *, n_streams: int, data_shards: int, pods: int,
         compress_pod: bool, compute_s: float = 0.0) -> SyncPlanCost:
    per_stream = grad_bytes / max(n_streams, 1)
    intra = ring_time(per_stream, data_shards, ICI_BW)
    pod_bytes = per_stream * (COMPRESS_RATIO if compress_pod else 1.0)
    pod = ring_time(pod_bytes, pods, C2C_BW)
    overhead = MSG_OVERHEAD_S * n_streams * (1 + (pods > 1))
    # streams pipeline against compute: more streams -> better overlap, with
    # diminishing returns; fully serial at 1 stream
    overlap = 1.0 / min(n_streams, 4) if compute_s > 0 else 1.0
    return SyncPlanCost(n_streams, intra, pod, overhead, overlap)


def suggest(grad_bytes: int, *, data_shards: int, pods: int = 1,
            compute_s: float = 0.0, allow_compress: bool = True) -> dict:
    """Pick (n_streams, compress_pod) minimizing modeled sync wall time."""
    best = None
    for n in (1, 2, 4, 8, 16):
        for comp in ({False, True} if (pods > 1 and allow_compress) else {False}):
            c = cost(grad_bytes, n_streams=n, data_shards=data_shards, pods=pods,
                     compress_pod=comp, compute_s=compute_s)
            if best is None or c.total_s < best[0].total_s:
                best = (c, n, comp)
    c, n, comp = best
    return {
        "n_streams": n,
        "compress_pod": comp,
        "est_total_s": c.total_s,
        "est_intra_s": c.intra_s,
        "est_pod_s": c.pod_s,
    }
