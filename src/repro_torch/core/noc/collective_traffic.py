"""Collective schedules lowered onto the cycle-level fabric.

The port's copy of ``repro.core.noc.collective_traffic`` (numpy only): it
gives the same schedules, workloads, ``expect_rx`` and cycle estimates as
the JAX package's, and its workloads drive ``repro_torch.core.noc.sim``.

The follow-on FlooNoC work (Colagrande et al.) carries ML collectives on the
same wide physical links the paper built for bulk DMA. This module compiles
all-gather / reduce-scatter / all-reduce (1-D ring and 2-D dimension-ordered
ring), software multicast, barrier, personalized all-to-all (direct
rotation, or a torus-safe store-and-forward ring) and relay-gated p2p
pipeline chains into multi-stream DMA ``Workload`` programmes: each step
becomes one wide write burst whose issue is gated on the *receipt* of a
prior step's chunk (``Workload.dma_dst_seq`` / ``dma_gate`` /
``dma_beats_seq``, see endpoints.py), so the simulator reproduces the real
pipeline skew, serialization and wormhole behaviour of a collective instead
of an open-loop traffic pattern.

Ring builders take an ``order`` that may be a *subset* of the tiles (a
parallelism group's ring) and ``merge_disjoint`` fuses disjoint groups
into one concurrent schedule; ``repro_torch.core.noc.ml_traffic`` builds
on that to compile whole training-step phases (DDP / TP / MoE / PP — see
docs/WORKLOADS.md).

Streams split the data: with S streams every tile runs S independent ring
pipelines under distinct TxnIDs (the paper's multi-stream DMA), which both
parallelizes the collective and — for multicast — removes the RoB-less NI's
destination-change round-trip serialization.

Gate semantics: a gate is a receive-*count* threshold per (endpoint,
stream), not a per-source dependence edge — the NI counts complete write
bursts without inspecting the sender. That is exact for the schedules
built here because they are source-symmetric: in a 1-D ring each tile has
a single predecessor, and in the 2-D schedule a column burst can only be
*sent* after its sender finished the row phase, so on the deterministic
fabric counts and true dependencies coincide
(tests/test_noc_collectives.py asserts the dimension order held in the
delivered trace). Hand-built schedules whose steps mix sources
asymmetrically may satisfy a gate with the "wrong" burst under heavy
cross-traffic skew.

Cross-validation: every schedule carries the per-chunk edge-hop paths that
``repro_torch.core.collectives.FabricCollectiveModel`` (simulator-calibrated
link/serialization terms) prices; ``analytical_cycles`` must match the
measured completion cycle within ~15% (tests/test_noc_collectives.py).

Collectives run as RoB-less writes; ``rob`` ordering works but its credit
accounting uses the scalar ``dma_beats`` approximation for variable-size
schedules.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.collectives import FabricCollectiveModel
from repro_torch.core.noc.endpoints import Workload, idle_workload
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import Topology, route_vcs

COLLECTIVES = ["all-gather", "reduce-scatter", "all-reduce", "all-reduce-2d",
               "multicast", "barrier", "all-to-all", "p2p"]


@dataclass(frozen=True)
class Phase:
    """Analytical metadata of one pipelined ring phase: chunk size and the
    router-traversal count of the edge each chunk crosses at each step
    (``paths[c, t]``)."""

    beats: int
    paths: np.ndarray  # [n_chunks, n_steps] int


@dataclass(frozen=True)
class CollectiveSchedule:
    """Per-(endpoint, stream, step) transfer programme + analytical model.

    ``dst_seq[e, s, k]`` is the destination of step k (-1 = no transfer),
    issued only once stream s at endpoint e has received ``gate[e, s, k]``
    complete write bursts; ``beats_seq`` gives the burst length. ``txns``
    is the number of scheduled transfers per (endpoint, stream) and
    ``expect_rx`` the bursts each (endpoint, stream) must end up receiving
    (exactly-once delivery check).
    """

    name: str
    dst_seq: np.ndarray  # [E, S, K] int32
    gate: np.ndarray  # [E, S, K] int32
    beats_seq: np.ndarray  # [E, S, K] int32
    txns: np.ndarray  # [E, S] int32
    expect_rx: np.ndarray  # [E, S] int32
    phases: tuple  # tuple[Phase] (empty for serial-unicast schedules)
    model: str = "pipelined-ring"  # | "serial-unicast"
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def n_streams(self) -> int:
        """DMA streams (= independent ring pipelines) per endpoint."""
        return self.dst_seq.shape[1]

    @property
    def n_steps(self) -> int:
        """Maximum schedule length K over all (endpoint, stream) programmes."""
        return self.dst_seq.shape[2]


# ----------------------------------------------------------------------
# ring embeddings
# ----------------------------------------------------------------------
def snake_order(topo: Topology) -> np.ndarray:
    """Boustrophedon tile order: consecutive ring neighbours are grid
    neighbours everywhere except the single wrap-around edge (which a torus
    closes with a wrap link, and a multi-die fabric prices through its
    boundary chains)."""
    nx, ny = topo.meta["nx"], topo.meta["ny"]
    order = []
    for y in range(ny):
        xs = range(nx) if y % 2 == 0 else range(nx - 1, -1, -1)
        order.extend(y * nx + x for x in xs)
    return np.asarray(order, np.int32)


def ring_order(topo: Topology) -> np.ndarray:
    """Default ring embedding for a topology: boustrophedon over (nx, ny)
    grids (mesh / torus / multi-die global coords), plain endpoint order on
    coordinate-free fabrics (Occamy's hierarchical Xbars)."""
    if topo.tile_coord is not None and "nx" in topo.meta and "ny" in topo.meta:
        return snake_order(topo)
    return np.arange(topo.meta["n_tiles"], dtype=np.int32)


def _ring_hops(topo: Topology, order: np.ndarray) -> np.ndarray:
    """Router traversals of each directed ring edge order[i] -> order[i+1],
    walked on the routing tables (``Topology.hops``) so torus wrap links,
    express links and die-to-die repeater chains are all priced by the
    fabric that actually carries them — not by mesh-coordinate arithmetic."""
    nxt = np.roll(order, -1)
    return np.asarray([topo.hops(int(a), int(b)) for a, b in zip(order, nxt)],
                      np.int32)


def _chunk_paths(edge_hops: np.ndarray, n_steps: int) -> np.ndarray:
    """paths[c, t] = hops of the edge chunk c crosses at step t: the chunk
    born at ring position c walks edges c, c+1, ... around the ring."""
    n = len(edge_hops)
    c = np.arange(n)[:, None]
    t = np.arange(n_steps)[None, :]
    return edge_hops[(c + t) % n]


def _empty(E: int, S: int, K: int):
    return (np.full((E, S, K), -1, np.int32), np.zeros((E, S, K), np.int32),
            np.zeros((E, S, K), np.int32))


def _beats_of(data_kb: float, parts: int) -> int:
    """Wide beats (64 B) per chunk when data_kb is split into `parts`."""
    return max(int(np.ceil(data_kb * 1024 / 64 / parts)), 1)


# ----------------------------------------------------------------------
# schedule builders
# ----------------------------------------------------------------------
def _ring_schedule(topo: Topology, name: str, laps_steps: int, beats: int,
                   streams: int, order: np.ndarray | None) -> CollectiveSchedule:
    """Common body of the 1-D ring collectives: every tile sends `beats` to
    its ring successor at each of `laps_steps` steps, step k gated on k
    received bursts (the chunk forwarded at step k is the one received at
    step k-1). ``order`` may be a subset of the tiles (a parallelism
    group's ring); non-members stay idle."""
    E = topo.n_endpoints
    order = ring_order(topo) if order is None else np.asarray(order, np.int32)
    succ = np.full((E,), -1, np.int32)
    succ[order] = np.roll(order, -1)  # succ[tile] = next tile on the ring
    dst, gate, bts = _empty(E, streams, laps_steps)
    k = np.arange(laps_steps, dtype=np.int32)
    for tile in order:
        dst[tile, :, :] = succ[tile]
        gate[tile, :, :] = k[None, :]
        bts[tile, :, :] = beats
    txns = np.zeros((E, streams), np.int32)
    txns[order] = laps_steps
    expect = np.zeros((E, streams), np.int32)
    expect[order] = laps_steps  # ring: one burst in per burst out
    hops = _ring_hops(topo, order)
    phase = Phase(beats=beats, paths=_chunk_paths(hops, laps_steps))
    return CollectiveSchedule(
        name=name, dst_seq=dst, gate=gate, beats_seq=bts, txns=txns,
        expect_rx=expect, phases=(phase,),
        meta={"order": order, "edge_hops": hops},
    )


def _ring_n(topo: Topology, order) -> int:
    """Ring length: the whole fabric by default, else the given group."""
    return topo.meta["n_tiles"] if order is None else len(order)


def all_gather(topo: Topology, *, data_kb: float = 16, streams: int = 1,
               order: np.ndarray | None = None) -> CollectiveSchedule:
    """Ring all-gather: N-1 steps, each moving one node's chunk onward."""
    n = _ring_n(topo, order)
    beats = _beats_of(data_kb, n * streams)
    return _ring_schedule(topo, "all-gather", n - 1, beats, streams, order)


def reduce_scatter(topo: Topology, *, data_kb: float = 16, streams: int = 1,
                   order: np.ndarray | None = None) -> CollectiveSchedule:
    """Ring reduce-scatter: same wire pattern as all-gather (the reduction
    itself is local compute, modeled as free against the wide transfers)."""
    n = _ring_n(topo, order)
    beats = _beats_of(data_kb, n * streams)
    return _ring_schedule(topo, "reduce-scatter", n - 1, beats, streams, order)


def all_reduce(topo: Topology, *, data_kb: float = 16, streams: int = 1,
               order: np.ndarray | None = None,
               algo: str = "ring") -> CollectiveSchedule:
    """Ring all-reduce = reduce-scatter + all-gather: 2(N-1) steps of
    data/N-sized chunks.

    ``algo="infabric"`` offloads the reduction to the fabric instead
    (requires ``NocParams(collective_offload=True)``): every participant
    pushes its full chunk ONE hop-tree up to the root — router ALU slots
    combine the partial sums per beat in flight — and the root then
    tree-multicasts the combined chunk, gated on the reduction burst's
    arrival. Two posted bursts per stream total, versus the ring's
    2(N-1) gated round trips. The group rides in ``meta["groups"]``; pass
    it to ``sim.build_sim(..., groups=...)``.
    """
    n = _ring_n(topo, order)
    if algo == "infabric":
        E = topo.n_endpoints
        order = ring_order(topo) if order is None else np.asarray(order, np.int32)
        root = int(order[0])
        members = [int(t) for t in order]
        contribs = [t for t in members if t != root]
        beats = _beats_of(data_kb, streams)
        dst, gate, bts = _empty(E, streams, 1)
        txns = np.zeros((E, streams), np.int32)
        expect = np.zeros((E, streams), np.int32)
        # one group PER STREAM over the same tree: the router ALU keeps one
        # accumulator slot per group, so distinct streams' partial sums
        # must not share one (their beats would interleave and the tail
        # flags misalign). Stream s contributes to reduction address
        # E + G + s and the root multicasts its result to group s, gated
        # on that stream's combined burst arriving.
        for s in range(streams):
            dst[contribs, s, 0] = E + streams + s
            dst[root, s, 0] = E + s
        bts[contribs, :, 0] = beats
        txns[contribs, :] = 1
        gate[root, :, 0] = 1
        bts[root, :, 0] = beats
        txns[root, :] = 1
        expect[root, :] = 1       # the combined reduction burst
        expect[contribs, :] = 1   # the multicast result
        return CollectiveSchedule(
            name="all-reduce", dst_seq=dst, gate=gate, beats_seq=bts,
            txns=txns, expect_rx=expect, phases=(),
            model="infabric-allreduce",
            meta={"root": root, "beats": beats,
                  "red_hops": [topo.hops(t, root) for t in contribs],
                  "mc_hops": [topo.hops(root, t) for t in contribs],
                  "groups": [{"root": root, "members": members,
                              "reduce": contribs} for _ in range(streams)]},
        )
    if algo != "ring":
        raise ValueError(f"all_reduce: unknown algo {algo!r}")
    beats = _beats_of(data_kb, n * streams)
    return _ring_schedule(topo, "all-reduce", 2 * (n - 1), beats, streams, order)


def all_reduce_2d(topo: Topology, *, data_kb: float = 16,
                  streams: int = 1) -> CollectiveSchedule:
    """Dimension-ordered 2-D all-reduce (XY-routing analogue): a ring
    all-reduce along each row, then one along each column; column steps are
    gated on the full row phase having arrived at that tile. Works on any
    (nx, ny)-gridded topology: on a torus the (x+1) % nx ring successor is
    a wrap link (no turnaround penalty), on a multi-die fabric the row
    rings cross the boundary repeater chains."""
    E = topo.n_endpoints
    nx, ny = topo.meta["nx"], topo.meta["ny"]
    nt = topo.meta["n_tiles"]
    coord = topo.tile_coord
    k_row, k_col = 2 * (nx - 1), 2 * (ny - 1)
    b_row = _beats_of(data_kb, nx * streams)
    b_col = _beats_of(data_kb, ny * streams)
    K = k_row + k_col
    dst, gate, bts = _empty(E, streams, K)
    for e in range(nt):
        x, y = coord[e]
        row_succ = y * nx + (x + 1) % nx
        col_succ = ((y + 1) % ny) * nx + x
        dst[e, :, :k_row] = row_succ
        gate[e, :, :k_row] = np.arange(k_row)[None, :]
        bts[e, :, :k_row] = b_row
        dst[e, :, k_row:] = col_succ
        gate[e, :, k_row:] = k_row + np.arange(k_col)[None, :]
        bts[e, :, k_row:] = b_col
    txns = np.zeros((E, streams), np.int32)
    txns[:nt] = K
    expect = np.zeros((E, streams), np.int32)
    expect[:nt] = K
    # phase hop structure from the routing tables: every row/column ring is
    # walked with Topology.hops (mesh: 2/edge + an nx-router wrap; torus:
    # 2/edge everywhere; multi-die: boundary edges include the repeater
    # chain), and the completion bound is the max over all rings' chunks
    rows_ = [np.arange(nx, dtype=np.int32) + y * nx for y in range(ny)]
    cols_ = [np.arange(ny, dtype=np.int32) * nx + x for x in range(nx)]
    row_paths = np.vstack([_chunk_paths(_ring_hops(topo, r), k_row)
                           for r in rows_])
    col_paths = np.vstack([_chunk_paths(_ring_hops(topo, c), k_col)
                           for c in cols_])
    phases = (Phase(beats=b_row, paths=row_paths),
              Phase(beats=b_col, paths=col_paths))
    return CollectiveSchedule(
        name="all-reduce-2d", dst_seq=dst, gate=gate, beats_seq=bts,
        txns=txns, expect_rx=expect, phases=phases,
        meta={"k_row": k_row, "k_col": k_col},
    )


def multicast(topo: Topology, root: int = 0, *, data_kb: float = 4,
              streams: int = 1, offload: bool = False) -> CollectiveSchedule:
    """Software multicast: the root unicasts one chunk to every other tile,
    destinations round-robined over the DMA streams. With one stream the
    RoB-less NI serializes full round trips (TxnID retargeting); multiple
    streams pipeline — the paper's multi-stream argument at collective
    level.

    ``offload=True`` lowers to the in-fabric tree multicast instead
    (requires ``NocParams(collective_offload=True)``): the root injects each
    stream's chunk ONCE, addressed to the collective group, and the routers
    replicate it at the tree's fan-out ports — no per-destination unicasts
    and no B-response round trips (posted). The group definition rides in
    ``meta["groups"]``; pass it to ``sim.build_sim(..., groups=...)``.
    """
    E = topo.n_endpoints
    nt = topo.meta["n_tiles"]
    if offload:
        beats = _beats_of(data_kb, streams)
        dsts = [t for t in range(nt) if t != root]
        dst, gate, bts = _empty(E, streams, 1)
        txns = np.zeros((E, streams), np.int32)
        expect = np.zeros((E, streams), np.int32)
        dst[root, :, 0] = E  # group 0's multicast address
        bts[root, :, 0] = beats
        txns[root, :] = 1
        expect[dsts, :] = 1  # every member hears each stream's chunk once
        hops = [topo.hops(root, d) for d in dsts]
        return CollectiveSchedule(
            name="multicast", dst_seq=dst, gate=gate, beats_seq=bts,
            txns=txns, expect_rx=expect, phases=(), model="mc-tree",
            meta={"root": root, "beats": beats, "mc_hops": hops,
                  "groups": [{"root": root, "members": list(range(nt))}]},
        )
    beats = _beats_of(data_kb, 1)
    dsts = [t for t in range(nt) if t != root]
    K = int(np.ceil(len(dsts) / streams))
    dst, gate, bts = _empty(E, streams, max(K, 1))
    txns = np.zeros((E, streams), np.int32)
    expect = np.zeros((E, streams), np.int32)
    hop_lists = []
    for s in range(streams):
        mine = dsts[s::streams]
        hop_lists.append([topo.hops(root, d) for d in mine])
        for k, d in enumerate(mine):
            dst[root, s, k] = d
            bts[root, s, k] = beats
            expect[d, s] = 1
        txns[root, s] = len(mine)
    return CollectiveSchedule(
        name="multicast", dst_seq=dst, gate=gate, beats_seq=bts, txns=txns,
        expect_rx=expect, phases=(), model="serial-unicast",
        meta={"root": root, "beats": beats, "hop_lists": hop_lists},
    )


def barrier(topo: Topology, *, streams: int = 1,
            order: np.ndarray | None = None) -> CollectiveSchedule:
    """Barrier as a 1-beat ring all-gather: after N-1 gated steps every tile
    has heard from every other."""
    n = _ring_n(topo, order)
    sched = _ring_schedule(topo, "barrier", n - 1, 1, streams, order)
    return sched


def _route_links(topo: Topology, port_ep: np.ndarray, src: int,
                 dst: int) -> list:
    """(router, out-port) links an src -> dst transfer occupies, walked on
    the routing tables (the wormhole-contention unit: two bursts sharing any
    one of these serialize behind each other)."""
    links = []
    cur = int(topo.ep_attach[src][0])
    for _ in range(10 * topo.n_routers):
        p = int(topo.route[cur, dst])
        links.append((cur, p))
        if port_ep[cur, p] == dst:
            return links
        cur = int(topo.link_to[cur, p][0])
        assert cur >= 0, "route leads off fabric"
    raise AssertionError("routing loop")


def all_to_all(topo: Topology, *, data_kb: float = 16, streams: int = 1,
               order: np.ndarray | None = None,
               algo: str = "auto", n_vcs: int = 1) -> CollectiveSchedule:
    """All-to-all personalized exchange (the MoE dispatch/combine pattern).

    Every participating tile exchanges a distinct ``data_kb / n`` chunk
    with every other tile. Two algorithms:

    * ``"direct"`` — lockstep rotation: at step k, ring position i sends
      its chunk straight to position ``i + k + 1`` (mod n); each step is
      a shift permutation, each tile receives exactly one burst per step,
      and step k+1 is gated on k+1 received bursts, so one permutation is
      in flight at a time. Every step retargets the stream's TxnID, so the
      RoB-less NI serializes a stream's steps over full B-response round
      trips (the effect multi-stream multicast escapes). Requires
      cycle-free routing (mesh / multi-die XY, Occamy's up-down tree).
    * ``"ring"`` — store-and-forward neighbor exchange: at step k every
      tile sends its ring successor one burst carrying the ``n - 1 - k``
      chunks that still have to travel, keeping the one addressed to it.
      Every send is a single ring edge terminating at an endpoint, so no
      multi-hop wormhole cycle can form — this is the variant that is
      safe on a torus, whose wrap links close cyclic channel dependencies
      the VC-less fabric cannot break (``meta["wrap"]``); the fixed
      successor also never retargets the TxnID.

    ``"auto"`` picks ``"ring"`` on wrap topologies *when the fabric is
    VC-less* and ``"direct"`` everywhere else: with ``n_vcs >= 2`` the
    dateline VC-switch (docs/ROUTING.md) breaks the wrap cycles, so direct
    rotation is deadlock-free on the torus too — and beats the ring
    fallback, whose per-step payload is ``n - 1 - k`` chunks instead of 1.
    ``meta`` carries the analytical inputs, walked on the routing tables:
    ``hop_mat[i, k]`` + per-step link-sharing ``cong_mat[i, k]`` (physical
    wire sharing — one flit per cycle per link regardless of VCs) +
    wormhole-blocking ``block_mat[i, k]`` (at (link, VC) granularity:
    bursts meeting on different VCs of a wire have separate FIFOs and
    don't block each other's wormholes) for direct; per-step beats +
    ring-edge hops for ring.
    """
    E = topo.n_endpoints
    order = ring_order(topo) if order is None else np.asarray(order, np.int32)
    n = len(order)
    if algo == "auto":
        algo = "ring" if (topo.meta.get("wrap") and n_vcs < 2) else "direct"
    K = max(n - 1, 0)
    chunk = _beats_of(data_kb, n * streams)
    txns = np.zeros((E, streams), np.int32)
    txns[order] = K
    expect = np.zeros((E, streams), np.int32)
    expect[order] = K  # one burst in per step
    k_arr = np.arange(K, dtype=np.int32)
    if algo == "ring":
        dst, gate, bts = _empty(E, streams, max(K, 1))
        step_beats = (n - 1 - k_arr) * chunk  # chunks still travelling
        for i, tile in enumerate(order):
            dst[tile, :, :K] = order[(i + 1) % n]
            gate[tile, :, :K] = k_arr[None, :]
            bts[tile, :, :K] = step_beats[None, :]
        hops = _ring_hops(topo, order)
        return CollectiveSchedule(
            name="all-to-all", dst_seq=dst, gate=gate, beats_seq=bts,
            txns=txns, expect_rx=expect, phases=(), model="a2a-ring",
            meta={"order": order, "chunk": chunk, "step_beats": step_beats,
                  "edge_hops": hops, "algo": algo},
        )
    if algo != "direct":
        raise ValueError(f"all_to_all: unknown algo {algo!r}")
    beats = chunk
    dst, gate, bts = _empty(E, streams, max(K, 1))
    hop_mat = np.zeros((n, max(K, 1)), np.int32)
    port_ep = topo.port_ep
    links_of = {}  # (src, dst) -> link list, cached across steps
    vcs_of = {}  # (src, dst) -> per-hop VC (all 0 when VC-less)
    cong_mat = np.zeros((n, max(K, 1)), np.int32)
    for i, tile in enumerate(order):
        peers = order[(i + 1 + k_arr) % n]
        dst[tile, :, :K] = peers[None, :]
        gate[tile, :, :K] = k_arr[None, :]
        bts[tile, :, :K] = beats
        for k in range(K):
            route = _route_links(topo, port_ep, int(tile), int(peers[k]))
            links_of[(int(tile), int(peers[k]))] = route
            vcs_of[(int(tile), int(peers[k]))] = (
                route_vcs(topo, route) if n_vcs >= 2 else [0] * len(route))
            hop_mat[i, k] = len(route)  # one link per router traversal
    block_mat = np.zeros((n, max(K, 1)), np.int32)
    vc_chain = np.zeros((max(K, 1),), np.int32)
    for k in range(K):
        load: dict = {}
        pairs = [(int(t), int(order[(i + 1 + k) % n]))
                 for i, t in enumerate(order)]
        phys = [frozenset(links_of[pr]) for pr in pairs]
        # blocking is per (link, VC): separate VCs of one wire have their
        # own input FIFOs, so wormholes only couple within a VC (at
        # n_vcs=1 every VC is 0 and this reduces to plain link sets)
        sets = [frozenset(zip(links_of[pr], vcs_of[pr])) for pr in pairs]
        for mine in phys:
            for ln in mine:
                load[ln] = load.get(ln, 0) + 1
        for i in range(n):
            cong_mat[i, k] = max(load[ln] for ln in phys[i]) - 1
            block_mat[i, k] = sum(1 for j in range(n)
                                  if j != i and sets[i] & sets[j])
        # transitive wormhole coupling: bursts whose routes form one
        # connected component of the (link, VC)-sharing graph drain as a
        # single serialized chain on a VC fabric (dateline-bumped VC1
        # traffic additionally yields the wire to VC0 sharers), so the
        # step is paced by the largest component, not the largest pair
        parent = list(range(n))

        def _find(a):
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for i in range(n):
            for j in range(i + 1, n):
                if sets[i] & sets[j]:
                    parent[_find(i)] = _find(j)
        comp: dict = {}
        for i in range(n):
            r = _find(i)
            comp[r] = comp.get(r, 0) + 1
        vc_chain[k] = max(comp.values()) - 1
    meta = {"order": order, "beats": beats, "hop_mat": hop_mat,
            "cong_mat": cong_mat, "block_mat": block_mat, "algo": algo,
            "n_vcs": n_vcs}
    if n_vcs >= 2:
        meta["vc_chain"] = vc_chain
    return CollectiveSchedule(
        name="all-to-all", dst_seq=dst, gate=gate, beats_seq=bts, txns=txns,
        expect_rx=expect, phases=(), model="a2a-rotation",
        meta=meta,
    )


def default_p2p_pairs(topo: Topology,
                      order: np.ndarray | None = None) -> list:
    """One pipeline chain over the whole fabric: ring position i feeds
    position i + 1 (no wrap) — the shape of pipeline-parallel stages."""
    order = ring_order(topo) if order is None else np.asarray(order, np.int32)
    return [(int(a), int(b)) for a, b in zip(order[:-1], order[1:])]


def p2p(topo: Topology, pairs=None, *, data_kb: float = 16, rounds: int = 4,
        streams: int = 1) -> CollectiveSchedule:
    """Relay-gated point-to-point chains (pipeline-parallel activations).

    ``pairs`` is a list of directed ``(src, dst)`` tile edges forming
    disjoint chains: each tile sends to at most one successor and receives
    from at most one predecessor, and no edge set may close a cycle (a
    cycle of relay gates deadlocks; rejected here). Every source sends
    ``rounds`` bursts of ``data_kb`` (split over ``streams``) to its fixed
    successor; a tile with a predecessor forwards round r only once round
    r has *arrived* (gate = r), so the schedule reproduces real pipeline
    fill/drain skew. Destinations never change, so the RoB-less NI
    pipelines rounds back-to-back — the pattern paces at the serializer
    rate, not the B-response round trip.

    Default ``pairs``: one chain along ``ring_order`` (snake), i.e. the
    whole fabric as one pipeline.
    """
    E = topo.n_endpoints
    if pairs is None:
        pairs = default_p2p_pairs(topo)
    pairs = [(int(a), int(b)) for a, b in pairs]
    srcs = [a for a, _ in pairs]
    dsts = [b for _, b in pairs]
    if len(set(srcs)) != len(srcs):
        raise ValueError("p2p: a tile may send to at most one successor")
    if len(set(dsts)) != len(dsts):
        raise ValueError("p2p: a tile may receive from at most one "
                         "predecessor (relay gates count bursts blindly)")
    succ = dict(pairs)
    has_pred = set(dsts)
    # reject cycles: a cycle of relay gates (every member waiting for its
    # predecessor's round) never fires its first round
    heads = [a for a in srcs if a not in has_pred]
    reached: set = set()
    chains_hops = []
    chains_edges = []
    port_ep = topo.port_ep
    for h in heads:
        hops = []
        edges = []
        cur = h
        while cur in succ:
            nxt = succ[cur]
            route = _route_links(topo, port_ep, cur, nxt)
            hops.append(len(route))  # one link per router traversal
            edges.append(frozenset(route))
            reached.add(cur)
            cur = nxt
        chains_hops.append(hops)
        chains_edges.append(edges)
    if len(reached) != len(srcs):
        raise ValueError("p2p: pairs close a cycle (relay gates deadlock)")
    # wormhole link sharing between concurrently-pumping stages (all edges
    # of all chains are busy at once in steady state): per edge, count the
    # other edges whose route shares a link
    flat = [e for es in chains_edges for e in es]
    chains_cong = [
        [sum(1 for other in flat if other is not mine and mine & other)
         for mine in es]
        for es in chains_edges
    ]
    beats = _beats_of(data_kb, streams)
    K = max(rounds, 1)
    dst, gate, bts = _empty(E, streams, K)
    txns = np.zeros((E, streams), np.int32)
    expect = np.zeros((E, streams), np.int32)
    r_arr = np.arange(rounds, dtype=np.int32)
    for a, b in pairs:
        dst[a, :, :rounds] = b
        # a relay forwards round r only once round r arrived: r+1 bursts
        gate[a, :, :rounds] = (r_arr[None, :] + 1) if a in has_pred else 0
        bts[a, :, :rounds] = beats
        txns[a, :] = rounds
        expect[b, :] = rounds
    return CollectiveSchedule(
        name="p2p", dst_seq=dst, gate=gate, beats_seq=bts, txns=txns,
        expect_rx=expect, phases=(), model="p2p-chains",
        meta={"pairs": pairs, "beats": beats, "rounds": rounds,
              "chains_hops": chains_hops, "chains_cong": chains_cong},
    )


def _sched_links(topo: Topology, port_ep: np.ndarray,
                 sched: CollectiveSchedule) -> set:
    """(router, out-port) links any transfer of a schedule traverses."""
    es, ss, ks = np.nonzero(sched.dst_seq >= 0)  # dst_seq is [E, S, K]
    pairs = {(int(e), int(sched.dst_seq[e, s, k]))
             for e, s, k in zip(es, ss, ks)}
    links: set = set()
    for src, dst in pairs:
        if dst >= topo.n_endpoints:
            continue  # group-addressed (offloaded) step: no unicast route
        links.update(_route_links(topo, port_ep, src, dst))
    return links


def merge_disjoint(topo: Topology, scheds: list) -> CollectiveSchedule:
    """Merge schedules over *disjoint* tile groups into one concurrent
    schedule (e.g. every tensor-parallel group's ring in one Workload).

    All members must share the model type, stream count, step count and
    per-step beat structure (the compiler builds symmetric groups, so this
    holds by construction); participating endpoint sets must be disjoint
    (gates count received bursts blindly, so cross-group traffic at a
    shared endpoint would corrupt the gate semantics). The member
    schedules ride along in ``meta["group_scheds"]`` and
    ``analytical_cycles`` prices the merge as the slowest group; each
    member gets a ``meta["occupancy"]`` factor — the largest number of
    groups sharing one of its route links, walked on the routing tables —
    so cross-group wormhole serialization (e.g. two data-parallel rings
    sharing a mesh row) is priced too."""
    if len(scheds) == 1:
        return scheds[0]
    ref = scheds[0]
    assert all(s.model == ref.model and s.n_streams == ref.n_streams
               and s.n_steps == ref.n_steps for s in scheds), \
        "merge_disjoint: members must share model/stream/step structure"
    active = [np.flatnonzero(s.txns.sum(axis=1) + s.expect_rx.sum(axis=1))
              for s in scheds]
    allc = np.concatenate(active)
    assert len(np.unique(allc)) == len(allc), \
        "merge_disjoint: endpoint groups must be disjoint"
    E = topo.n_endpoints
    group_lists = [list(s.meta.get("groups", ())) for s in scheds]
    G_total = sum(len(g) for g in group_lists)
    if G_total:
        # group-addressed steps encode the schedule-LOCAL group count in
        # the address split ([E, E+G) = multicast, [E+G, E+2G) = reduction
        # contribution): renumber each member's addresses into the merged
        # group table before overlaying the dst sequences
        base = 0
        renum = []
        for s, gl in zip(scheds, group_lists):
            gi = len(gl)
            d = s.dst_seq
            is_mc = (d >= E) & (d < E + gi)
            is_red = d >= E + gi
            d2 = np.where(is_mc, d + base,
                          np.where(is_red, d - gi + G_total + base, d))
            renum.append(dataclasses.replace(s, dst_seq=d2.astype(np.int32)))
            base += gi
        scheds = renum
    dst = np.full_like(ref.dst_seq, -1)
    gate = np.zeros_like(ref.gate)
    bts = np.zeros_like(ref.beats_seq)
    txns = np.zeros_like(ref.txns)
    expect = np.zeros_like(ref.expect_rx)
    for s in scheds:
        sel = s.dst_seq != -1
        dst = np.where(sel, s.dst_seq, dst)
        gate = gate + s.gate
        bts = np.where(sel, s.beats_seq, bts)
        txns = txns + s.txns
        expect = expect + s.expect_rx
    # cross-group wormhole contention: how many groups ride each link
    port_ep = topo.port_ep
    link_sets = [_sched_links(topo, port_ep, s) for s in scheds]
    load: dict = {}
    for ls in link_sets:
        for ln in ls:
            load[ln] = load.get(ln, 0) + 1
    priced = tuple(
        dataclasses.replace(
            s, meta={**s.meta,
                     "occupancy": float(max((load[ln] for ln in ls),
                                            default=1))})
        for s, ls in zip(scheds, link_sets))
    meta = {"group_scheds": priced}
    if G_total:
        meta["groups"] = [g for gl in group_lists for g in gl]
    return CollectiveSchedule(
        name=ref.name, dst_seq=dst, gate=gate, beats_seq=bts, txns=txns,
        expect_rx=expect, phases=(), model=ref.model,
        meta=meta,
    )


def build(topo: Topology, name: str, **kw) -> CollectiveSchedule:
    """Build a named collective schedule (see ``COLLECTIVES``) on ``topo``."""
    builders = {"all-gather": all_gather, "reduce-scatter": reduce_scatter,
                "all-reduce": all_reduce, "all-reduce-2d": all_reduce_2d,
                "multicast": multicast, "barrier": barrier,
                "all-to-all": all_to_all, "p2p": p2p}
    return builders[name](topo, **kw)


# ----------------------------------------------------------------------
# lowering + checks + analytics
# ----------------------------------------------------------------------
def to_workload(topo: Topology, sched: CollectiveSchedule) -> Workload:
    """Lower a schedule into a multi-stream DMA write Workload. Stream s
    rides TxnID s (unique_txn_per_stream), so receive-gates and RoB-less
    ordering resolve per stream; keep streams <= NocParams.n_txn_ids.

    Runs ``check_schedule`` first: a deadlocking or over/under-delivering
    schedule is rejected here instead of silently stalling the simulator.
    """
    check_schedule(sched)
    E = topo.n_endpoints
    wl = idle_workload(E, n_tiles=topo.meta["n_tiles"], streams=sched.n_streams)
    return dataclasses.replace(
        wl, dma_txns=sched.txns, dma_write=True,
        dma_beats=int(sched.beats_seq.max()),
        dma_dst_seq=sched.dst_seq, dma_gate=sched.gate,
        dma_beats_seq=sched.beats_seq,
        n_groups=len(sched.meta.get("groups", ())),
    )


def check_schedule(sched: CollectiveSchedule) -> None:
    """Deadlock-freedom + exactly-once delivery at schedule level: replay
    the gates (a transfer fires once its stream has received its gate count)
    and verify every scheduled transfer eventually fires and every
    (endpoint, stream) receives exactly expect_rx bursts.

    Offloaded (group-addressed) steps replay the fabric's collective
    semantics: a multicast to ``E + g`` delivers one burst to every group
    member but the sender, and a reduction contribution to ``E + G + g``
    delivers ONE combined burst to the group's root once every contributor
    has sent (the in-fabric ALU merges the partials)."""
    E, S, _ = sched.dst_seq.shape
    groups = list(sched.meta.get("groups", ()))
    G = len(groups)
    contrib = np.zeros((G, S), np.int64)
    rx = np.zeros((E, S), np.int64)
    k = np.zeros((E, S), np.int64)
    fired = 0
    total = int(sched.txns.sum())
    while True:
        progress = False
        for e in range(E):
            for s in range(S):
                while k[e, s] < sched.txns[e, s]:
                    step = int(k[e, s])
                    if rx[e, s] < sched.gate[e, s, step]:
                        break
                    d = int(sched.dst_seq[e, s, step])
                    assert d >= 0, f"scheduled step {step} at ({e},{s}) has no dst"
                    if d >= E + G:  # reduction contribution to group d-E-G
                        g = d - E - G
                        contrib[g, s] += 1
                        if contrib[g, s] == len(groups[g]["reduce"]):
                            rx[groups[g]["root"], s] += 1
                    elif d >= E:  # multicast to group d-E
                        for m in groups[d - E]["members"]:
                            if m != e:
                                rx[m, s] += 1
                    else:
                        rx[d, s] += 1
                    k[e, s] += 1
                    fired += 1
                    progress = True
        if not progress:
            break
    assert fired == total, f"schedule deadlocks: {fired}/{total} transfers fired"
    np.testing.assert_array_equal(rx, sched.expect_rx)


def analytical_cycles(sched: CollectiveSchedule, params: NocParams,
                      topo: Topology | None = None) -> float:
    """Simulator-calibrated completion-cycle estimate for a schedule.

    Pass ``topo`` to use the per-topology model terms
    (``FabricCollectiveModel.for_topology``); the schedule's edge-hop paths
    already price the topology's links via ``Topology.hops``."""
    if "group_scheds" in sched.meta:
        # disjoint groups run concurrently: completion is the slowest group
        # (per-group link contention is already in each group's meta; the
        # merge assumes groups share no links, which the compiler's
        # row/column placements satisfy)
        return max(analytical_cycles(s, params, topo)
                   for s in sched.meta["group_scheds"])
    model = (FabricCollectiveModel.for_topology(topo, params)
             if topo is not None
             else FabricCollectiveModel.from_noc_params(params))
    S = sched.n_streams
    occ = float(sched.meta.get("occupancy", 1.0))
    if sched.model == "serial-unicast":
        return model.serial_unicast_cycles(sched.meta["beats"],
                                           sched.meta["hop_lists"])
    if sched.model == "mc-tree":
        return model.tree_multicast_cycles(sched.meta["beats"],
                                           sched.meta["mc_hops"], streams=S)
    if sched.model == "infabric-allreduce":
        return model.infabric_all_reduce_cycles(
            sched.meta["beats"], sched.meta["red_hops"],
            sched.meta["mc_hops"], streams=S)
    if sched.model == "a2a-rotation":
        return model.rotation_all_to_all_cycles(
            sched.meta["beats"], sched.meta["hop_mat"],
            sched.meta["cong_mat"], sched.meta.get("block_mat"), streams=S,
            occupancy=occ, vc_chain=sched.meta.get("vc_chain"))
    if sched.model == "a2a-ring":
        return model.ring_all_to_all_cycles(
            sched.meta["step_beats"], sched.meta["edge_hops"], streams=S,
            occupancy=occ)
    if sched.model == "p2p-chains":
        return model.pipeline_chain_cycles(
            sched.meta["beats"], sched.meta["chains_hops"],
            sched.meta["rounds"], streams=S,
            chains_cong=sched.meta.get("chains_cong"))
    return sum(
        model.pipelined_ring_cycles(ph.beats, ph.paths, streams=S,
                                    occupancy=occ)
        for ph in sched.phases
    )


def measured_cycles(stats: dict, topo: Topology) -> int:
    """Completion cycle of a collective run: the last wide beat received by
    any participating tile."""
    nt = topo.meta["n_tiles"]
    return int(np.asarray(stats["last_rx"])[:nt].max())
