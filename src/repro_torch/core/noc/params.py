"""FlooNoC microarchitecture parameters (paper Section III-V defaults).

The port's copy of ``repro.core.noc.params`` without the two Pallas dispatch
knobs (``backend``, ``router_tile``): here the tensors' device decides where
the router cycle runs, and the CUDA kernels choose their own launch
geometry. Values this slice of the port does not implement yet raise
``NotImplementedError`` naming the ROADMAP item that brings them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NocParams:
    """FlooNoC microarchitecture + simulator configuration (paper defaults).

    Covers router buffer depths, NI ordering scheme and credits, cluster/
    memory latencies (calibrated to Fig. 7), the HBM model, link widths
    (Table I) and the physical channel count (``n_channels``).
    """

    # router microarchitecture
    depth_in: int = 2  # input FIFO depth (paper: minimal input buffers)
    depth_out: int = 2  # output buffers (timing closure across >1mm links)

    # virtual channels per physical channel (1 = the paper's VC-less mesh
    # routers; 2 = dateline VCs, which make the torus deadlock-free)
    n_vcs: int = 1

    # endpoint / NI
    n_txn_ids: int = 8  # AXI TxnIDs tracked per endpoint
    ni_order: str = "robless"  # "robless" | "rob"
    rob_beats: int = 128  # RoB capacity in wide beats (8 kB / 64 B)
    max_outstanding: int = 32  # per DMA stream

    # cluster-internal latencies (calibrated to Fig. 7: 22-cycle neighbor
    # round trip = 8 router + 3 NI + 11 cluster/memory)
    cluster_req_lat: int = 4
    cluster_rsp_lat: int = 4
    mem_lat: int = 3
    ni_req_lat: int = 1  # AXI -> flit packing
    ni_rsp_lat: int = 1  # flit -> AXI unpacking (target side: 1 more)

    # HBM model (HBM2E MT54A16G808A00AC-36: 57.6 GB/s per channel)
    # wide link moves 64 B/cycle @ 1.26 GHz = 80.6 GB/s -> ratio 0.714
    hbm_rate: float = 57.6 / 80.6
    hbm_eff: float = 0.97  # refresh/row-miss derate (zero-load util ~97%)

    # link frequency / widths (Table I)
    freq_ghz: float = 1.26
    narrow_bits: int = 64
    wide_bits: int = 512

    # egress queue depths
    egress_depth: int = 8
    memq_depth: int = 256  # >= fan-in x max_outstanding for the workloads used

    # physical channels: req + rsp + (n_channels - 2) wide channels.
    # 3 = the paper's req/rsp/wide; >3 stripes wide traffic over extra wide
    # channels by TxnID (PATRONoC-style parallel AXI channels).
    n_channels: int = 3

    # step implementation: "fast" (circular queues, fused FIFO updates) or
    # "naive", the roll-based reference (two-step FIFO pop then push, queues
    # with their head at slot 0); both are ported and agree on all live
    # state (sim.canonical_state)
    step_impl: str = "fast"

    # multi-cycle super-stepping: k fabric cycles per fabric call (one fused
    # kernel launch on the card); 1 = per-cycle stepping
    fused_cycles: int = 1

    # in-network collective offload: multicast fork tables and per-router
    # reduction ALUs in the fabric (groups passed to sim.build_sim);
    # per-cycle stepping only
    collective_offload: bool = False

    def __post_init__(self):
        """Validate the knobs."""
        if self.n_channels < 3:
            raise ValueError("n_channels must be >= 3 (req, rsp, >=1 wide)")
        if self.step_impl not in ("fast", "naive"):
            raise ValueError(
                f"step_impl must be 'fast' or 'naive', got {self.step_impl!r}")
        if self.fused_cycles < 1:
            raise ValueError("fused_cycles must be >= 1")
        if self.n_vcs < 1:
            raise ValueError("n_vcs must be >= 1")
        if self.collective_offload and self.fused_cycles != 1:
            raise ValueError("collective_offload requires fused_cycles == 1")

    @property
    def fast(self) -> bool:
        """The fast step: circular queues and the apply kernel's fused FIFO
        mode (else the naive step: roll-based queues, the unfused mode)."""
        return self.step_impl == "fast"


# flit kinds
NARROW_REQ = 0
NARROW_RSP = 1
WIDE_AR = 2  # wide read request (rides the narrow `req` link)
WIDE_R = 3  # wide read data beat (wide link)
WIDE_AW_W = 4  # wide write addr+data beats (wide link, wormhole)
WIDE_B = 5  # write response (rsp link)
WIDE_MC = 6  # multicast write beat (collective offload, tree-forked)
WIDE_RED = 7  # reduction partial-sum beat (collective offload, ALU-combined)

# physical channel roles (channel indices >= CH_WIDE are all wide channels;
# the channel *count* lives in NocParams.n_channels)
CH_REQ = 0
CH_RSP = 1
CH_WIDE = 2

# role channel a kind travels on (wide kinds ride wide_channel_of(txn, C))
KIND_CHANNEL = {
    NARROW_REQ: CH_REQ,
    NARROW_RSP: CH_RSP,
    WIDE_AR: CH_REQ,
    WIDE_R: CH_WIDE,
    WIDE_AW_W: CH_WIDE,
    WIDE_B: CH_RSP,
    WIDE_MC: CH_WIDE,
    WIDE_RED: CH_WIDE,
}


def wide_channel_of(txn, n_channels: int):
    """Physical channel carrying the wide beats of a transfer.

    Wide traffic stripes over channels CH_WIDE..n_channels-1 by TxnID, so all
    transfers of one TxnID share a channel. With the paper's n_channels=3
    this is always CH_WIDE."""
    return CH_WIDE + txn % (n_channels - CH_WIDE)
