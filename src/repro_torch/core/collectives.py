"""Simulator-calibrated cycle model of collectives on the wide-link fabric.

The port's copy of the numpy class ``FabricCollectiveModel`` from
``repro.core.collectives`` (and its merged-chain tolerance), which prices
the schedules of ``repro_torch.core.noc.collective_traffic``. The rest of
that module, the ``shard_map`` collectives of the JAX training stack
(bucketing, dimension-ordered psum, compressed pod sync, narrow sync), is
not ported yet: it waits for the model stack (ROADMAP Queue 1 item 12),
where it moves to ``torch.distributed``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


# Tolerance of the model on merged row-ring schedules (the regime the MoE
# expert groups sit in on the torus): the per-VC serialization term is
# calibrated on the full-fabric torus stress grid to <=10%
# (tests/test_noc_vc.py), but when several row rings merge into one
# all-to-all chain the model over-serializes the shared wrap edges, so
# those rows track at this looser, pinned bar instead
# (tests/test_noc_spec.py::test_merged_a2a_chain_tolerance).
MERGED_A2A_CHAIN_RTOL = 0.20


# Replaces bare hop-count guesses with link/serialization terms calibrated
# against the cycle-level fabric (repro.core.noc): every constant below is
# derived from the simulator's microarchitecture, and
# tests/test_noc_collectives.py pins the model against measured cycle
# counts of collective schedules lowered onto that fabric
# (repro.core.noc.collective_traffic).
@dataclass(frozen=True)
class FabricCollectiveModel:
    """Cycle cost of collective phases on the wide-link fabric.

    A chunk crossing one ring edge costs
        ``max(streams * beats, beats + hop_cycles * hops + issue_cycles)``:
    either the edge is *serializer-bound* (the source NI pushes
    ``streams * beats`` wide beats through its single write serializer per
    ring step, hiding the hop latency of any one stream) or it is
    *latency-bound* (the chunk's own ``beats`` serialization plus
    ``hop_cycles`` per router traversal). ``hops`` counts router
    traversals (``Topology.hops``: mesh manhattan distance + 1).
    """

    hop_cycles: float  # per router traversal (in-buf + out-buf stage)
    issue_cycles: float  # receive-gate satisfied -> first beat injected
    rt_cycles: float  # extra one-way latency of the B-response round trip

    @classmethod
    def from_noc_params(cls, params) -> "FabricCollectiveModel":
        """Derive the terms from NocParams (see noc/engine.py semantics:
        a flit spends >= 1 cycle in the input and output buffer of every
        router, so one traversal costs 2 cycles at zero load). The NI issue
        overhead is zero cycles: the write serializer claims the transfer
        and emits its first beat in the same cycle the receive-gate is
        satisfied, and the egress-ready (+1) offset overlaps the first
        router's input-buffer stage already counted in hop_cycles."""
        return cls(
            hop_cycles=2.0,
            issue_cycles=0.0,
            rt_cycles=float(params.mem_lat + params.ni_rsp_lat),
        )

    @classmethod
    def for_topology(cls, topo, params) -> "FabricCollectiveModel":
        """Per-topology terms. The engine models every traversal — mesh
        router, torus wrap link, express hop, die-to-die repeater, Occamy
        Xbar/spill register — as the same 2-stage router, so the default
        per-traversal cost is uniform and the topology differences live in
        the edge-hop paths each schedule computes from ``Topology.hops``
        (a torus wrap edge is 2 cycles, a multi-die boundary edge is
        ``2 * (2 + d2d)``). A topology whose links are modeled differently
        can override the link/serialization terms through its ``meta``
        (``hop_cycles`` / ``issue_cycles`` / ``rt_cycles``); the new-
        topology tests validate the resulting model against measured
        completion cycles (exact on 1-D torus rings, <=10% on multi-die).
        """
        base = cls.from_noc_params(params)
        meta = getattr(topo, "meta", None) or {}
        return cls(
            hop_cycles=float(meta.get("hop_cycles", base.hop_cycles)),
            issue_cycles=float(meta.get("issue_cycles", base.issue_cycles)),
            rt_cycles=float(meta.get("rt_cycles", base.rt_cycles)),
        )

    def edge_cycles(self, beats: int, hops: int, streams: int = 1) -> float:
        return max(streams * beats,
                   beats + self.hop_cycles * hops + self.issue_cycles)

    def pipelined_ring_cycles(self, beats: int, paths, streams: int = 1,
                              occupancy: float = 1.0) -> float:
        """Completion time of a pipelined ring phase.

        ``paths``: [n_chunks, n_steps] router traversals of the edge each
        chunk crosses at each step. Chunks move concurrently; the phase
        finishes when the slowest chunk has walked its whole path. Every
        step but the last paces the chunk at the per-edge cost; the final
        step completes one link latency (``beats + hop_cycles * hops``)
        after the last stream's send begins — offset by the
        ``(streams - 1) * beats`` serializer stagger — NOT a full
        ``streams * beats`` pace slot, which matters on serializer-bound
        uniform rings (e.g. a multi-stream torus ring, where every edge is
        a wrap-free unit hop).

        ``occupancy`` > 1 models wormhole link sharing with concurrent
        traffic outside this ring (``collective_traffic.merge_disjoint``
        computes it from the merged groups' route-link sets): every pace
        slot stretches to ``occupancy * streams * beats`` because the
        shared link must also carry the other groups' bursts."""
        paths = np.asarray(paths)
        if paths.size == 0:  # zero-step phase (e.g. a 1-wide ring): no traffic
            return 0.0
        per_edge = np.maximum(
            occupancy * streams * beats,
            beats + self.hop_cycles * paths + self.issue_cycles)
        last = beats + self.hop_cycles * paths[:, -1] + self.issue_cycles \
            + (occupancy - 1.0) * streams * beats
        per_chunk = (per_edge[:, :-1].sum(axis=1)
                     + (streams - 1) * beats + last)
        return float(per_chunk.max())

    def rotation_all_to_all_cycles(self, beats: int, hop_mat, cong_mat=None,
                                   block_mat=None, streams: int = 1,
                                   occupancy: float = 1.0,
                                   vc_chain=None) -> float:
        """Completion time of a lockstep-rotation (direct) all-to-all.

        ``hop_mat[i, k]`` is the router-traversal count of the edge ring
        position i crosses at step k (it sends directly to position
        ``i + k + 1``); ``cong_mat[i, k]`` counts *other* bursts sharing
        the most-loaded single link of that route in the same step, and
        ``block_mat[i, k]`` counts the distinct other bursts whose route
        shares *any* link with it (a wormhole burst can wait behind a
        different blocker at each shared link, so the true serialization
        sits between the two counts — calibration against the 4x4 mesh
        grid puts it halfway).

        The lockstep gate couples every position within a few steps, so
        the completion sums per-step maxima: each step costs the larger of
        the wormhole throughput term
        ``(1 + cong + (block - cong) / 2) * streams * beats`` and the
        RoB-less round-trip term ``beats + 2 * hop_cycles * hops +
        rt_cycles`` (every step retargets the stream's TxnID, so a stream
        cannot issue step k+1 before its step-k B response returned); the
        final step pays only the one-way arrival. A congestion-free
        per-position recurrence over the gate/serializer/NI constraints
        is kept as a floor for small fabrics where no link is shared.

        ``vc_chain[k]`` (virtual-channel schedules only) is the size minus
        one of the largest connected component of the step's
        (link, VC)-sharing graph: on a VC fabric wormhole coupling is
        transitive — burst A waiting on B waiting on C drains as one
        serialized chain, and dateline-bumped VC1 traffic additionally
        yields shared wires to VC0 sharers — so the step's occupancy
        factor is floored at ``1 + 1.05 * vc_chain[k]`` (calibrated
        against the 4x4-and-down torus all-to-all stress grid; the
        nudge above full serialization pays for the VC0-priority
        stalls)."""
        hop_mat = np.asarray(hop_mat, np.float64)
        n, K = hop_mat.shape
        if K == 0 or n < 2:
            return 0.0
        cong = (np.zeros_like(hop_mat) if cong_mat is None
                else np.asarray(cong_mat, np.float64))
        block = cong if block_mat is None else np.asarray(block_mat, np.float64)
        eff = 1.0 + cong + 0.5 * (block - cong)  # wormhole occupancy factor
        chain = (None if vc_chain is None
                 else np.asarray(vc_chain, np.float64))
        total = 0.0
        for k in range(K):
            eff_k = eff[:, k].max()
            if chain is not None:
                eff_k = max(eff_k, 1.0 + 1.05 * chain[k])
            thr = occupancy * eff_k * streams * beats
            hmx = hop_mat[:, k].max()
            if k < K - 1:
                lat = beats + 2 * self.hop_cycles * hmx + self.rt_cycles
            else:  # last step completes on arrival, not on the B response
                lat = (streams - 1) * beats + beats + self.hop_cycles * hmx
            total += max(thr, lat + self.issue_cycles)
        # congestion-free floor: per-position gate/serializer/NI recurrence
        send = np.zeros((n,), np.float64)
        for k in range(K):
            arrive = send + beats + self.hop_cycles * hop_mat[:, k]
            bresp = send + beats + 2 * self.hop_cycles * hop_mat[:, k] \
                + self.rt_cycles
            if k + 1 < K:
                # source of position i at step k is position i - (k + 1)
                send = np.maximum(send + streams * beats,
                                  np.maximum(np.roll(arrive, k + 1), bresp))
        floor = (send + (streams - 1) * beats + beats
                 + self.hop_cycles * hop_mat[:, -1]).max()
        return float(max(total, floor))

    def ring_all_to_all_cycles(self, step_beats, edge_hops,
                               streams: int = 1,
                               occupancy: float = 1.0) -> float:
        """Completion time of a store-and-forward ring all-to-all.

        ``step_beats[k]`` is the shrinking per-step burst size (step k
        forwards the chunks that still have to travel) and ``edge_hops[i]``
        the router traversals of ring position i's successor edge. The
        destination never changes, so rounds pipeline at the serializer
        rate; the recurrence mirrors the ring collectives: step k+1 at a
        position starts when its own serializer drained and its
        predecessor's step-k burst arrived."""
        step_beats = np.asarray(step_beats, np.float64)
        edge_hops = np.asarray(edge_hops, np.float64)
        K = len(step_beats)
        n = len(edge_hops)
        if K == 0 or n < 2:
            return 0.0
        send = np.zeros((n,), np.float64)
        for k in range(K - 1):
            arrive = send + step_beats[k] + self.hop_cycles * edge_hops \
                + self.issue_cycles
            pred_arrive = np.roll(arrive, 1)  # position i's predecessor is i-1
            send = np.maximum(send + occupancy * streams * step_beats[k],
                              pred_arrive)
        last = send + (streams - 1) * step_beats[-1] + step_beats[-1] \
            + self.hop_cycles * edge_hops + self.issue_cycles \
            + (occupancy - 1.0) * streams * step_beats[-1]
        return float(last.max())

    def pipeline_chain_cycles(self, beats: int, chains_hops, rounds: int,
                              streams: int = 1, chains_cong=None) -> float:
        """Completion time of relay-gated point-to-point pipeline chains.

        ``chains_hops`` is a list of per-chain edge hop lists (stage j ->
        stage j+1 router traversals). Every stage keeps one destination, so
        the RoB-less NI never stalls (same-destination writes pipeline) and
        the chain paces at the head's serializer rate ``streams * beats``;
        round r at a relay is gated on round r having *arrived* from
        upstream. The recurrence
        ``send[j][r] = max(send[j-1][r] + beats + hop_cycles * h_j,
        send[j][r-1] + streams * beats)`` therefore collapses to the
        classic pipeline bound — fill (one latency term per edge) plus
        ``rounds - 1`` pace slots, with the ``(streams - 1) * beats``
        serializer stagger paid once on the final arrival.

        ``chains_cong`` (same shape as ``chains_hops``) counts the other
        chain edges each edge shares a link with — concurrent stages of a
        stacked pipeline serialize their bursts through shared links, so
        a chain's pace slot stretches to the bottleneck-edge occupancy
        ``(1 + cong) * streams * beats``."""
        best = 0.0
        if chains_cong is None:
            chains_cong = [[0] * len(h) for h in chains_hops]
        for hops, congs in zip(chains_hops, chains_cong):
            if not hops or rounds <= 0:
                continue
            pace = max((1 + c) * streams * beats for c in congs)
            fill = sum(beats + self.hop_cycles * h + self.issue_cycles
                       + c * streams * beats
                       for h, c in zip(hops, congs))
            best = max(best, (rounds - 1) * pace
                       + (streams - 1) * beats + fill)
        return best

    def tree_multicast_cycles(self, beats: int, hops_list,
                              streams: int = 1) -> float:
        """Offloaded (in-fabric tree) multicast: the root injects each
        stream's chunk ONCE and the routers fork it at the tree's fan-outs,
        so completion is the root's serializer drain (``streams * beats``,
        posted — no B-response round trips) plus the link latency to the
        *deepest* member; ``hops_list`` are the root -> member router
        traversal counts."""
        if not list(hops_list):
            return 0.0
        return (streams * beats + self.hop_cycles * max(hops_list)
                + self.issue_cycles)

    def infabric_all_reduce_cycles(self, beats: int, red_hops, mc_hops,
                                   streams: int = 1) -> float:
        """Offloaded all-reduce: contributors push partial-sum bursts up the
        reduction tree, each router's ALU slot combining per beat and
        forwarding store-and-forward (a combined beat is emitted only after
        every child contributed it, then the *next* beat's contributions
        pop — a 2-cycle-per-beat pace at the merge points, matching the
        2-stage router); the root then tree-multicasts the combined chunk,
        gated on the reduction burst's arrival. ``red_hops`` are the
        contributor -> root traversal counts, ``mc_hops`` the root ->
        member counts. Streams drain in a fixed global order (see
        ``sim._generators``), so the reduce phases serialize at the 2-cycle
        beat pace while each completed stream's result multicast overlaps
        the NEXT stream's reduction — only the LAST stream's multicast tail
        (one chunk + the deepest member's link latency) adds completion
        time. The additive constant is the injection + ejection +
        slowest-child alignment overhead, calibrated against the cycle
        simulator (tests/test_noc_offload.py pins the <=10% agreement)."""
        if not list(red_hops):
            return 0.0
        reduce = (2.0 * streams * beats
                  + self.hop_cycles * max(red_hops) + 4.0)
        tail = beats + self.hop_cycles * max(mc_hops) + self.issue_cycles
        return reduce + tail

    def serial_unicast_cycles(self, beats: int, hop_lists) -> float:
        """Software multicast: one root pushes a chunk to each destination,
        destinations split over the per-stream ``hop_lists``.

        Two regimes, the slower wins: (a) RoB-less round-trip bound — a
        stream must wait for each write's B-response before retargeting its
        TxnID to a new destination, so its sends serialize over full round
        trips; (b) serializer bound — all streams share the root's single
        write serializer, which emits ``beats`` (+1 reclaim cycle) per send
        back-to-back once enough streams exist to always have one eligible."""
        chains = [
            sum(beats + 2 * self.hop_cycles * h + self.issue_cycles
                + self.rt_cycles for h in hops)
            for hops in hop_lists if hops
        ]
        all_h = [h for hops in hop_lists for h in hops]
        if not all_h:
            return 0.0
        serializer = len(all_h) * (beats + 1) \
            + 2 * self.hop_cycles * max(all_h) + self.rt_cycles
        return float(max(max(chains), serializer))
