"""ML-parallelism traffic compiler: model config -> fabric Workloads.

FlooNoC is motivated by bulk-transfer traffic from ML accelerators
(PATRONoC makes the same case for multi-accelerator DNN platforms), and
this module closes the loop between the repo's transformer stack and its
cycle-level fabric: it takes a ``repro_torch.configs.ModelConfig`` plus a
:class:`ParallelismSpec` (dp / tp / ep / pp degrees, microbatch count,
gradient-bucket size) and a ``Topology``, and compiles the communication
of one training step into per-phase
:class:`~repro_torch.core.noc.collective_traffic.CollectiveSchedule` s:

* **ddp** — data-parallel gradient all-reduce, bucketed for overlap: the
  gradient buckets ride independent DMA streams (distinct TxnIDs — the
  paper's multi-stream DMA is exactly a bucketed-overlap engine), one
  ring all-reduce per data-parallel group.
* **tp** — tensor-parallel activation all-gather + reduce-scatter per
  layer (Megatron sequence-parallel style: 4 all-gathers + 4
  reduce-scatters per layer per fwd+bwd pass; both have the same ring
  wire pattern, so one merged all-gather schedule prices all eight).
* **moe** — expert-parallel token all-to-all (dispatch + combine, fwd +
  bwd) within each expert-parallel group; uses the deadlock-safe
  algorithm for the topology (direct rotation on acyclically-routed
  fabrics and on a torus with ``n_vcs >= 2``, store-and-forward ring on
  a VC-less torus).
* **pp** — pipeline-parallel point-to-point microbatch activations:
  relay-gated chains between consecutive stages, reproducing the real
  fill/drain skew.

Device placement: device ``(p, d, t)`` (pipeline stage p, data rank d,
tensor rank t; tensor fastest) maps to tile ``(p * dp + d) * tp + t`` —
row-major on gridded fabrics, so tensor-parallel groups are contiguous
row segments (tight rings), data-parallel groups are column-strided, and
pipeline stages are contiguous bands. All groups of one phase run
concurrently in a single merged schedule (``merge_disjoint``).

Every phase carries two schedules: ``schedule`` at the true byte sizes
(for ``analytical_cycles`` — the calibrated model is closed-form, so
full-scale sizes are free) and ``sim_schedule`` with payloads capped at
``sim_cap_kb`` (so the cycle-level simulator finishes in seconds while
exercising the identical wire pattern). ``python -m
repro_torch.noc_explore --workload {ddp,tp,moe,pp}`` drives both;
``docs/WORKLOADS.md`` walks the whole pipeline.

The port's copy of ``repro.core.noc.ml_traffic`` (numpy only): the same
phases, schedules and step reports. :func:`validate_phase` replays a phase
on the port's simulator, on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.noc import collective_traffic as CT
from repro_torch.core.noc.topology import Topology, route_vcs

WORKLOADS = ["ddp", "tp", "moe", "pp"]


@dataclass(frozen=True)
class ParallelismSpec:
    """Parallelisation of one training job over the fabric's tiles.

    ``dp * tp * pp`` devices are placed tensor-fastest; ``ep`` (expert
    parallelism) partitions each data-parallel group and must divide
    ``dp``. ``microbatches`` is the pipeline depth per step,
    ``bucket_kb`` the DDP gradient bucket size (buckets become DMA
    streams, clamped to ``max_streams`` = the NI's TxnID budget), and
    ``streams`` the per-collective stream count of the tp/moe/pp phases.
    """

    dp: int = 1
    tp: int = 1
    pp: int = 1
    ep: int = 1
    microbatches: int = 4
    bucket_kb: float = 512.0
    act_bytes: int = 2  # bf16 activations
    grad_bytes: int = 4  # fp32 gradient buckets
    streams: int = 2
    max_streams: int = 8  # NocParams.n_txn_ids budget

    def __post_init__(self):
        """Validate degree positivity and divisibility."""
        if min(self.dp, self.tp, self.pp, self.ep, self.microbatches) < 1:
            raise ValueError("all parallelism degrees must be >= 1")
        if self.dp % self.ep != 0:
            raise ValueError(f"ep={self.ep} must divide dp={self.dp}")

    @property
    def n_devices(self) -> int:
        """Total devices (= fabric tiles) the job occupies."""
        return self.dp * self.tp * self.pp

    def device(self, p: int, d: int, t: int) -> int:
        """Tile index of pipeline stage p, data rank d, tensor rank t."""
        return (p * self.dp + d) * self.tp + t


@dataclass(frozen=True)
class TrafficPhase:
    """One compiled communication phase of a training step.

    ``schedule`` is built at the true byte sizes (priced analytically);
    ``sim_schedule`` caps the payload at the compiler's ``sim_cap_kb``
    so the cycle-level run stays cheap while keeping the identical wire
    pattern. ``count`` is how many times the schedule runs per training
    step (e.g. 8 tensor-parallel collectives per layer) and ``data_kb``
    the true per-invocation payload.
    """

    name: str  # "ddp" | "tp" | "moe" | "pp"
    pattern: str  # collective_traffic builder behind it
    schedule: CT.CollectiveSchedule
    sim_schedule: CT.CollectiveSchedule
    count: int
    data_kb: float
    note: str


def _grad_kb(cfg, par: ParallelismSpec) -> float:
    """Dense-gradient bytes per device: params sharded over tp * pp."""
    return cfg.n_params() * par.grad_bytes / (par.tp * par.pp) / 1024.0


def _act_kb(cfg, par: ParallelismSpec, tokens_per_device: int) -> float:
    """Full activation payload of one tensor-parallel collective."""
    return tokens_per_device * cfg.d_model * par.act_bytes / 1024.0


def _moe_kb(cfg, par: ParallelismSpec, tokens_per_device: int) -> float:
    """Tokens dispatched per device per MoE all-to-all (top-k routed)."""
    top_k = max(cfg.moe_top_k, 1)
    return tokens_per_device * top_k * cfg.d_model * par.act_bytes / 1024.0


def _groups(par: ParallelismSpec):
    """(tp_groups, dp_groups, ep_groups, pp_pairs) as tile-index lists."""
    tp_groups = [
        np.asarray([par.device(p, d, t) for t in range(par.tp)], np.int32)
        for p in range(par.pp) for d in range(par.dp)
    ]
    dp_groups = [
        np.asarray([par.device(p, d, t) for d in range(par.dp)], np.int32)
        for p in range(par.pp) for t in range(par.tp)
    ]
    ep_groups = [
        np.asarray([par.device(p, b * par.ep + j, t)
                    for j in range(par.ep)], np.int32)
        for p in range(par.pp) for t in range(par.tp)
        for b in range(par.dp // par.ep)
    ]
    pp_pairs = [
        (par.device(p, d, t), par.device(p + 1, d, t))
        for d in range(par.dp) for t in range(par.tp)
        for p in range(par.pp - 1)
    ]
    return tp_groups, dp_groups, ep_groups, pp_pairs


def _cycle_witness(waits: dict):
    """First node found on a cycle of a waits-for graph, or None if acyclic
    (iterative DFS, three-color)."""
    WHITE, GREY, BLACK = 0, 1, 2
    color = {ln: WHITE for ln in waits}
    for root in waits:
        if color[root] != WHITE:
            continue
        stack = [(root, iter(waits[root]))]
        color[root] = GREY
        while stack:
            node, it = stack[-1]
            for nxt in it:
                c = color.get(nxt, BLACK)  # terminal links have no deps
                if c == GREY:
                    return nxt
                if c == WHITE:
                    color[nxt] = GREY
                    stack.append((nxt, iter(waits[nxt])))
                    break
            else:
                color[node] = BLACK
                stack.pop()
    return None


def required_vcs_for_pairs(topo: Topology, pairs) -> int:
    """Minimum ``NocParams.n_vcs`` for concurrent wormhole transfers over
    the given ``(src_ep, dst_ep)`` pairs to be deadlock-free.

    The Dally-Seitz core of :func:`required_vcs`, usable for any traffic
    description that reduces to a set of endpoint pairs (a collective
    schedule's sends, a traffic pattern's destination map — the
    ``FabricSpec`` validator calls it with the latter). Returns 1 / 2 /
    a huge sentinel exactly as :func:`required_vcs` does.
    """
    if not topo.meta.get("wrap"):
        return 1
    port_ep = topo.port_ep
    routes = [CT._route_links(topo, port_ep, int(src), int(dst))
              for src, dst in pairs]
    waits: dict = {}  # link -> set of links it can wait on
    for route in routes:
        for a, b in zip(route[:-1], route[1:]):
            waits.setdefault(a, set()).add(b)
    if _cycle_witness(waits) is None:
        return 1
    waits_vc: dict = {}  # (link, vc) -> set of (link, vc) it can wait on
    for route in routes:
        hops = list(zip(route, route_vcs(topo, route)))
        for a, b in zip(hops[:-1], hops[1:]):
            waits_vc.setdefault(a, set()).add(b)
    if _cycle_witness(waits_vc) is None:
        return 2
    return 1 << 30  # no dateline VC assignment breaks the cycle


def required_vcs(topo: Topology, sched) -> int:
    """Minimum ``NocParams.n_vcs`` for a schedule to be deadlock-free.

    Dally-Seitz condition on wrap topologies (torus): a wormhole burst
    holds its current channel while waiting for the next one, so deadlock
    is possible iff the union of the schedule's routes contains a cycle
    in the channel-waits-for graph. On a VC-less fabric a channel is a
    physical link; with ``n_vcs >= 2`` it is a (link, VC) pair and the
    dateline switch (``topology.route_vcs``, docs/ROUTING.md) reassigns
    VCs so each ring's cycle is cut. Returns 1 if the link-level graph is
    already acyclic (mesh / multi-die XY and Occamy's up-down tree always
    are; so are grid-aligned torus rings), 2 if the dateline VC
    assignment breaks every cycle, and a huge sentinel if even that graph
    is cyclic (impossible for shortest-direction torus routing, possible
    for a hand-built ``order`` that crosses a dateline twice). The
    computation is per phase: phases run one at a time, so only transfers
    of the same schedule hold channels concurrently.
    """
    if not topo.meta.get("wrap"):
        return 1
    E = topo.n_endpoints
    groups = list(sched.meta.get("groups", ()))
    G = len(groups)
    es, ss, ks = np.nonzero(sched.dst_seq >= 0)
    pairs = set()
    for e, s, k in zip(es, ss, ks):
        d = int(sched.dst_seq[e, s, k])
        if d >= E + G:  # reduction contribution: store-and-forward to root
            pairs.add((int(e), int(groups[d - E - G]["root"])))
        elif d >= E:  # multicast: the fork tree rides the unicast routes
            pairs.update((int(e), int(m)) for m in groups[d - E]["members"]
                         if int(m) != int(e))
        else:
            pairs.add((int(e), d))
    return required_vcs_for_pairs(topo, pairs)


def _check_wrap_safe(topo: Topology, sched, phase: str,
                     n_vcs: int = 1) -> None:
    """Raise unless the fabric has enough VCs for the schedule's routes
    (``required_vcs``); the error names the fix on either axis — raise
    ``n_vcs`` or realign the placement."""
    need = required_vcs(topo, sched)
    if n_vcs >= need:
        return
    raise ValueError(
        f"{phase}: routes on wrap topology {topo.name} close a wormhole "
        f"channel-dependency cycle the fabric's n_vcs={n_vcs} cannot "
        f"break; this placement needs n_vcs >= {need} "
        "(NocParams(n_vcs=2) enables dateline VC-switching — see "
        "docs/ROUTING.md). Alternatively pick parallelism degrees that "
        "align groups with the grid (e.g. tp = nx so data-parallel rings "
        "run down columns).")


def compile_traffic(cfg, par: ParallelismSpec, topo: Topology, *,
                    tokens_per_device: int = 1024,
                    sim_cap_kb: float = 32.0,
                    workloads=None, n_vcs: int = 1,
                    params=None) -> list[TrafficPhase]:
    """Compile one training step's communication onto ``topo``.

    ``cfg`` is a ``repro_torch.configs.ModelConfig`` (any registered arch);
    ``workloads`` restricts the emitted phases (default: every phase
    whose parallelism degree is active — dp>1 for ddp, tp>1, pp>1, and
    ep>1 with a routed-expert model for moe). Raises if the job needs
    more devices than ``topo`` has tiles, or if a phase's routes need
    more virtual channels than ``n_vcs`` (match ``NocParams.n_vcs`` of
    the simulated fabric; ``required_vcs`` computes the threshold).

    Pass ``params`` (a ``NocParams`` with ``collective_offload=True``)
    to let the compiler pick software vs in-fabric lowering per phase:
    the ddp gradient all-reduce is priced both as the software ring and
    as the router-offloaded in-fabric reduction (``algo="infabric"``)
    and the analytically cheaper one wins — in-fabric wins the
    latency-bound regime (small buckets), the ring wins bandwidth-bound
    payloads where its 1/N-chunk pipelining beats the tree's
    store-and-forward ALU. The pick is recorded in the phase ``note``.
    """
    n_tiles = topo.meta["n_tiles"]
    if par.n_devices > n_tiles:
        raise ValueError(
            f"job needs {par.n_devices} devices but {topo.name} has "
            f"{n_tiles} tiles")
    want = set(WORKLOADS if workloads is None else workloads)
    unknown = want - set(WORKLOADS)
    if unknown:
        raise ValueError(f"unknown workloads {sorted(unknown)}; "
                         f"choose from {WORKLOADS}")
    tp_groups, dp_groups, ep_groups, pp_pairs = _groups(par)
    layers_per_stage = -(-cfg.n_layers // par.pp)  # ceil
    n_moe_layers = (max(cfg.n_layers - cfg.first_k_dense, 0)
                    if cfg.n_experts else 0)
    moe_layers_per_stage = -(-n_moe_layers // par.pp) if n_moe_layers else 0
    phases: list[TrafficPhase] = []

    def _merged(builder, groups, kb, **kw):
        full = CT.merge_disjoint(
            topo, [builder(topo, data_kb=kb, order=g, **kw) for g in groups])
        sim = CT.merge_disjoint(
            topo, [builder(topo, data_kb=min(kb, sim_cap_kb), order=g, **kw)
                   for g in groups])
        return full, sim

    if "ddp" in want and par.dp > 1:
        kb = _grad_kb(cfg, par)
        n_buckets = max(int(np.ceil(kb / par.bucket_kb)), 1)
        streams = min(n_buckets, par.max_streams)
        full, sim = _merged(CT.all_reduce, dp_groups, kb, streams=streams)
        pattern = "all-reduce"
        note = (f"{n_buckets} gradient buckets over {streams} DMA streams, "
                f"{len(dp_groups)} ring(s) of {par.dp}")
        if params is not None and getattr(params, "collective_offload",
                                          False):
            off_full, off_sim = _merged(CT.all_reduce, dp_groups, kb,
                                        streams=streams, algo="infabric")
            ring_c = CT.analytical_cycles(full, params, topo)
            off_c = CT.analytical_cycles(off_full, params, topo)
            if off_c < ring_c:
                full, sim, pattern = off_full, off_sim, "all-reduce-infabric"
                note += (f"; in-fabric reduction offload picked "
                         f"({off_c:.0f} vs ring {ring_c:.0f} model cycles)")
            else:
                note += (f"; software ring kept ({ring_c:.0f} vs in-fabric "
                         f"{off_c:.0f} model cycles)")
        phases.append(TrafficPhase(
            name="ddp", pattern=pattern, schedule=full,
            sim_schedule=sim, count=1, data_kb=kb, note=note))
    if "tp" in want and par.tp > 1:
        kb = _act_kb(cfg, par, tokens_per_device)
        full, sim = _merged(CT.all_gather, tp_groups, kb,
                            streams=min(par.streams, par.max_streams))
        phases.append(TrafficPhase(
            name="tp", pattern="all-gather", schedule=full,
            sim_schedule=sim, count=8 * layers_per_stage, data_kb=kb,
            note=f"4 all-gather + 4 reduce-scatter (same wire pattern) per "
                 f"layer x {layers_per_stage} layers/stage, "
                 f"{len(tp_groups)} ring(s) of {par.tp}"))
    if "moe" in want and par.ep > 1 and cfg.n_experts:
        kb = _moe_kb(cfg, par, tokens_per_device)
        full, sim = _merged(CT.all_to_all, ep_groups, kb,
                            streams=min(par.streams, par.max_streams),
                            n_vcs=n_vcs)
        groups = full.meta.get("group_scheds", (full,))
        algo = groups[0].meta["algo"]
        phases.append(TrafficPhase(
            name="moe", pattern="all-to-all", schedule=full,
            sim_schedule=sim, count=4 * moe_layers_per_stage, data_kb=kb,
            note=f"dispatch+combine, fwd+bwd x {moe_layers_per_stage} MoE "
                 f"layers/stage, {len(ep_groups)} group(s) of {par.ep}, "
                 f"algo={algo}"))
    if "pp" in want and par.pp > 1:
        kb = _act_kb(cfg, par, tokens_per_device) / par.microbatches
        full = CT.p2p(topo, pp_pairs, data_kb=kb, rounds=par.microbatches,
                      streams=min(par.streams, par.max_streams))
        sim = CT.p2p(topo, pp_pairs, data_kb=min(kb, sim_cap_kb),
                     rounds=par.microbatches,
                     streams=min(par.streams, par.max_streams))
        phases.append(TrafficPhase(
            name="pp", pattern="p2p", schedule=full, sim_schedule=sim,
            count=2, data_kb=kb,
            note=f"{par.microbatches} microbatches through "
                 f"{len(pp_pairs)} stage boundaries (fwd + bwd)"))
    if workloads is not None:
        missing = want - {ph.name for ph in phases}
        if missing:
            raise ValueError(
                f"requested workload(s) {sorted(missing)} are inactive for "
                f"this spec/config (ddp needs dp>1, tp needs tp>1, pp needs "
                f"pp>1, moe needs ep>1 and a routed-expert model)")
    for ph in phases:
        _check_wrap_safe(topo, ph.schedule, ph.name, n_vcs)
    return phases


# demo-sized jobs for the 4x4 (16-device) fabrics: one spec per pattern,
# the same as the JAX package's collective benchmark rows and explorer
# demos (``python -m repro_torch.noc_explore --workload``)
DEMO_SPECS = {
    "ddp": (dict(dp=16, bucket_kb=64.0), 256),  # (ParallelismSpec kw, tokens)
    "tp": (dict(dp=4, tp=4), 512),
    "moe": (dict(dp=16, ep=4), 256),
    "pp": (dict(dp=4, pp=4, microbatches=8), 512),
}


def phase_workload(topo: Topology, phase: TrafficPhase, *, sim: bool = True):
    """Lower a phase to a runnable ``Workload`` (sim-capped by default)."""
    sched = phase.sim_schedule if sim else phase.schedule
    return CT.to_workload(topo, sched)


def validate_phase(topo: Topology, phase: TrafficPhase, params,
                   device=None) -> dict:
    """Replay a phase's sim-capped schedule on the cycle-level fabric.

    Runs the simulator (on ``device``: ``cuda`` unless the caller names
    another) for 1.5x the model's estimate (+ slack) and returns
    ``{"measured", "model", "delivered"}`` — the simulate-and-compare step
    behind ``noc_explore --workload``.
    """
    from repro_torch.core.noc import sim as S

    sched = phase.sim_schedule
    est = CT.analytical_cycles(sched, params, topo)
    sim = S.build_sim(topo, params, CT.to_workload(topo, sched),
                      groups=sched.meta.get("groups"), device=device)
    out = S.stats(sim, S.run(sim, int(est * 1.5) + 500))
    return {
        "measured": CT.measured_cycles(out, topo),
        "model": est,
        "delivered": bool(np.array_equal(out["rx_bursts"],
                                         sched.expect_rx)),
    }


def step_report(phases: list[TrafficPhase], params, topo: Topology,
                freq_ghz: float | None = None) -> list[dict]:
    """Per-phase cycle estimate of one training step's communication.

    Returns one dict per phase: analytical cycles per invocation at the
    true payload size, invocation count, total cycles, and microseconds
    at the fabric frequency (``params.freq_ghz`` unless overridden).
    Phases are priced independently — overlap with compute (and between
    phases) is a scheduling decision this report deliberately leaves out.
    """
    f = params.freq_ghz if freq_ghz is None else freq_ghz
    rows = []
    for ph in phases:
        per_inv = CT.analytical_cycles(ph.schedule, params, topo)
        total = per_inv * ph.count
        rows.append({
            "phase": ph.name, "pattern": ph.pattern, "count": ph.count,
            "data_kb": round(ph.data_kb, 1),
            "cycles_per_invocation": round(per_inv, 1),
            "total_cycles": round(total, 1),
            "us_per_step": round(total / f / 1000.0, 2),
            "note": ph.note,
        })
    return rows
