"""Cycle-accurate router fabric in PyTorch, batched over physical channels.

One ``FabricState`` carries *all* physical channels of the NoC (the paper
instantiates three routers per tile: req / rsp / wide) as packed int32
tensors over [C channels, R routers, P ports, DEPTH fifo slots, NF flit
fields]. The per-cycle router datapath lives in
``repro_torch.kernels.noc_router``: ``ops.router_cycle`` runs the plain
PyTorch version on CPU tensors and the CUDA kernels on CUDA tensors.

The counterpart of ``repro.core.noc.engine``: fused or two-step FIFO
updates (``fabric_cycle(fused_fifo=...)``: the fast and the naive step),
gather-based endpoint injection, virtual channels with dateline
switching (``n_vcs > 1``), fused multi-cycle windows
(``fabric_cycles_fused``) and in-network collective offload (multicast
fork and reduction trees from ``make_tables(groups=...)``, the reduction
ALU state in ``FabricState.red_acc`` / ``red_got``).

Cycle semantics: arbitration and link decisions are both computed from the
cycle-start snapshot, then applied. A flit spends >= 1 cycle in the input
buffer and >= 1 cycle in the output buffer: 2 cycles per router hop at zero
load, matching the paper's Fig. 7.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.noc.topology import Topology, route_vcs
from repro_torch.device import resolve_device
from repro_torch.kernels.noc_router import ops as router_ops
from repro_torch.kernels.noc_router.ref import (  # noqa: F401  (re-exported API)
    F_DST,
    F_KIND,
    F_LAST,
    F_META,
    F_SRC,
    F_TS,
    F_TXN,
    FLIT_FIELDS,
    NF,
    NRED,
    empty_flits,
    heads,
    inject_endpoints,
    pack_flit,
)


@dataclass
class FabricState:
    """Channel-batched router-fabric state. ``red_acc`` / ``red_got`` are
    the per-(router, group) reduction-ALU state of the collective offload
    path; they stay ``None`` unless the fabric has collective groups."""

    in_buf: torch.Tensor  # [C, R, P, Din, NF]
    in_cnt: torch.Tensor  # [C, R, P]
    out_buf: torch.Tensor  # [C, R, P, Dout, NF]
    out_cnt: torch.Tensor  # [C, R, P]
    rr_ptr: torch.Tensor  # [C, R, P] round-robin pointer per *output* port
    wh_lock: torch.Tensor  # [C, R, P] wormhole: locked input port (-1 = free)
    red_acc: torch.Tensor | None = None  # [C, R, G, NRED] reduction ALU slots
    red_got: torch.Tensor | None = None  # [C, R, G, P] per-beat contributions


def init_fabric(topo: Topology, depth_in: int, depth_out: int,
                n_channels: int, n_vcs: int = 1, n_groups: int = 0,
                device=None) -> FabricState:
    """Empty fabric state for ``n_channels`` physical channels of ``topo``.

    With ``n_vcs > 1`` the port axis folds the VC axis in: slot
    ``p * n_vcs + v`` is (physical port p, virtual channel v), each with
    its own FIFOs, round-robin pointer and wormhole lock. ``n_groups > 0``
    sizes the collective-offload reduction state (all zero: empty ALU
    slots)."""
    dev = resolve_device(device)
    C, R, P = n_channels, topo.n_routers, topo.n_ports * n_vcs
    z = lambda: torch.zeros((C, R, P), dtype=torch.int32, device=dev)
    G = n_groups
    return FabricState(
        in_buf=empty_flits((C, R, P, depth_in), device=dev),
        in_cnt=z(),
        out_buf=empty_flits((C, R, P, depth_out), device=dev),
        out_cnt=z(),
        rr_ptr=z(),
        wh_lock=torch.full((C, R, P), -1, dtype=torch.int32, device=dev),
        red_acc=(torch.zeros((C, R, G, NRED), dtype=torch.int32, device=dev)
                 if G else None),
        red_got=(torch.zeros((C, R, G, P), dtype=torch.bool, device=dev)
                 if G else None),
    )


@dataclass(frozen=True)
class FabricTables:
    """Static routing/wiring tables shared by every physical channel.

    With ``n_vcs > 1``, ``port_ep``/``ep_attach`` are *slot*-level
    (endpoints attach at VC0 of their port) while ``route``/``link_src``/
    ``link_dst`` stay physical; ``vc_out`` is the dateline VC-switch
    table. ``n_vcs = 1`` keeps ``vc_out=None``. The collective-offload
    trees are ``None`` unless the tables were made with groups."""

    route: torch.Tensor  # [R, E] physical out port
    link_src: torch.Tensor  # [R, Pp, 2] upstream (router, port) feeding my in port
    link_dst: torch.Tensor  # [R, Pp, 2]
    port_ep: torch.Tensor  # [R, P] endpoint attached (-1); slot-level if V > 1
    ep_attach: torch.Tensor  # [E, 2] (router, port-or-slot)
    # output VC for (router, input slot, physical out port); None when V == 1
    vc_out: torch.Tensor | None = None  # [R, P*V, Pp]
    n_vcs: int = 1
    # collective-offload trees: multicast fork out-slots per group, the
    # reduction parent out-slot (-1 off-tree) and the per-beat child
    # contribution count per (router, group)
    fork_out: torch.Tensor | None = None  # [R, G, P] bool
    red_parent: torch.Tensor | None = None  # [R, G] int32
    red_need: torch.Tensor | None = None  # [R, G] int32
    n_groups: int = 0


def _route_walk(topo: Topology, port_ep: np.ndarray, src_ep: int,
                dst_ep: int):
    """(router, physical out port) hops of the deterministic src->dst route,
    ejection link included (the last hop's port attaches ``dst_ep``).
    ``port_ep`` is ``topo.port_ep``, which the property rebuilds on every
    access (minutes per tree at 32x32 if read per hop)."""
    r = int(topo.ep_attach[src_ep, 0])
    links = []
    for _ in range(topo.n_routers + 2):
        p = int(topo.route[r, dst_ep])
        links.append((r, p))
        if int(port_ep[r, p]) == dst_ep:
            return links
        r = int(topo.link_to[r, p][0])
    raise ValueError(
        f"routing walk {src_ep}->{dst_ep} did not terminate")


def _collective_trees(topo: Topology, groups, n_vcs: int):
    """Multicast fork / reduction trees from the routing tables (numpy).

    ``groups`` is a sequence of dicts: ``{"root": ep, "members": [ep, ...]}``
    for a multicast tree (root -> every member along the deterministic
    routes, ejection slots included) plus optionally ``"reduce": [ep,
    ...]`` for a reduction tree (every contributor's route to the root;
    converging hops become ALU child slots, the root's ejection slot is
    the final parent). Multicast slots carry the dateline VCs of
    ``route_vcs``; reduction hops are store-and-forward per router and
    always travel VC0. Raises if a group's multicast routes do not form a
    tree or its reduction routes disagree on a parent port.
    """
    V = n_vcs
    R, Pp = topo.n_routers, topo.n_ports
    G = len(groups)
    port_ep = topo.port_ep
    fork = np.zeros((R, G, Pp * V), bool)
    red_parent = np.full((R, G), -1, np.int32)
    red_need = np.zeros((R, G), np.int32)
    for g, grp in enumerate(groups):
        root = int(grp["root"])
        members = [int(m) for m in grp.get("members", ())]
        in_ports: dict[int, set[int]] = {}
        for m in members:
            if m == root:
                continue
            links = _route_walk(topo, port_ep, root, m)
            vcs = route_vcs(topo, links) if V > 1 else [0] * len(links)
            for (r, p), v in zip(links, vcs):
                fork[r, g, p * V + v] = True
                r2, p2 = (int(x) for x in topo.link_to[r, p])
                if r2 >= 0:
                    in_ports.setdefault(r2, set()).add(p2)
        if any(len(s) > 1 for s in in_ports.values()):
            raise ValueError(
                f"multicast routes of group {g} do not form a tree")
        child_slots: dict[int, set[int]] = {}
        for m in (int(c) for c in grp.get("reduce", ())):
            ar = int(topo.ep_attach[m, 0])
            child_slots.setdefault(ar, set()).add(
                int(topo.ep_attach[m, 1]) * V)
            for r, p in _route_walk(topo, port_ep, m, root):
                slot = p * V  # reduction hops always travel VC0
                if red_parent[r, g] not in (-1, slot):
                    raise ValueError(
                        f"reduction routes of group {g} disagree at router {r}")
                red_parent[r, g] = slot
                if int(port_ep[r, p]) != root:
                    r2, p2 = (int(x) for x in topo.link_to[r, p])
                    child_slots.setdefault(r2, set()).add(p2 * V)
        for r, slots in child_slots.items():
            red_need[r, g] = len(slots)
    return fork, red_parent, red_need


def make_tables(topo: Topology, n_vcs: int = 1, groups=None,
                device=None) -> FabricTables:
    """FabricTables on ``device`` derived from a Topology's numpy tables.

    ``groups`` (optional) derives the collective-offload multicast fork /
    reduction trees from the same routing tables (``_collective_trees``);
    ``None`` leaves them out."""
    dev = resolve_device(device)
    R, P = topo.n_routers, topo.n_ports
    link_src = np.full((R, P, 2), -1, np.int32)
    for r in range(R):
        for p in range(P):
            r2, p2 = topo.link_to[r, p]
            if r2 >= 0:
                link_src[r2, p2] = (r, p)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    offload = {}
    if groups is not None:
        fork, red_parent, red_need = _collective_trees(topo, groups, n_vcs)
        offload = dict(fork_out=torch.as_tensor(fork, device=dev),
                       red_parent=t(red_parent), red_need=t(red_need),
                       n_groups=len(groups))
    if n_vcs == 1:
        return FabricTables(route=t(topo.route), link_src=t(link_src),
                            link_dst=t(topo.link_to), port_ep=t(topo.port_ep),
                            ep_attach=t(topo.ep_attach), **offload)
    V = n_vcs
    # slot-level endpoint tables: endpoints live on VC0 of their port
    port_ep = np.full((R, P * V), -1, np.int32)
    port_ep[:, ::V] = topo.port_ep
    ep_attach = topo.ep_attach.copy()
    ep_attach[:, 1] *= V
    # dateline VC-switching table: a flit arriving on input slot (pin, vin)
    # and routed out physical port pout departs on
    #   1    if dateline[r, pout]  (crossing the ring's dateline)
    #   vin  if port_dim[r, pout] == port_dim[r, pin]  (same ring)
    #   0    otherwise  (dimension turn / ejection resets the VC)
    # Topologies without VC tables keep everything on VC0.
    vc_out = np.zeros((R, P * V, P), np.int32)
    if topo.port_dim is not None and topo.dateline is not None:
        for pin in range(P):
            same = topo.port_dim == topo.port_dim[:, pin:pin + 1]
            for vin in range(V):
                vout = np.where(same, vin, 0)
                vout = np.where(topo.dateline, min(1, V - 1), vout)
                vc_out[:, pin * V + vin, :] = vout
    return FabricTables(route=t(topo.route), link_src=t(link_src),
                        link_dst=t(topo.link_to), port_ep=t(port_ep),
                        ep_attach=t(ep_attach), vc_out=t(vc_out), n_vcs=V,
                        **offload)


def fabric_cycle(st: FabricState, tb: FabricTables,
                 ep_ingress_space: torch.Tensor, *, fused_fifo: bool = True):
    """One cycle of every channel at once.

    ``ep_ingress_space`` [C, E] bool: the endpoint can accept one flit on
    that channel this cycle (a refused flit stays in the router's output
    buffer). ``fused_fifo`` applies each FIFO's pop+push as one fused
    update (the fast step); ``False`` is the naive step's two-step pop then
    push (same live contents, other dead-slot garbage; on a CUDA device the
    apply kernel's unfused mode). With collective groups in the tables the
    cycle runs the offload datapath and carries the reduction state.
    Returns ``(state', ep_flit [C, E, NF], ep_valid [C, E])``.
    """
    offload = {}
    if tb.fork_out is not None:
        offload = dict(fork_out=tb.fork_out, red_parent=tb.red_parent,
                       red_need=tb.red_need, red_acc=st.red_acc,
                       red_got=st.red_got,
                       n_endpoints=int(tb.ep_attach.shape[0]))
    out = router_ops.router_cycle(
        st.in_buf, st.in_cnt, st.out_buf, st.out_cnt, st.rr_ptr, st.wh_lock,
        tb.route, tb.link_src, tb.link_dst, tb.port_ep, tb.ep_attach,
        ep_ingress_space, vc_out=tb.vc_out, n_vcs=tb.n_vcs,
        fused_fifo=fused_fifo, **offload)
    # (state..., ep_flit, ep_valid[, red_acc', red_got'])
    return FabricState(*out[:6], *out[8:]), out[6], out[7]


def fabric_cycles_fused(st: FabricState, tb: FabricTables,
                        ep_ingress_space: torch.Tensor,
                        eg, eg_ready, eg_head, eg_cnt, cycle0: int,
                        n_cycles: int):
    """``n_cycles`` fused fabric cycles with egress injection threaded in.

    The super-step core: the fabric advances ``n_cycles`` with
    ``ep_ingress_space`` held, injecting each endpoint's ready circular-
    egress head per cycle except the window's last (the caller injects
    after the endpoint phases, so a 1-cycle window equals ``fabric_cycle``
    + ``inject``). On a CUDA device the whole window is one kernel launch.
    Returns ``(state', eg, eg_ready, eg_head, eg_cnt, ep_flit [C, N, E, NF],
    ep_valid [C, N, E], req_waiting [C, N, E])``. Collective offload is
    per-cycle only (``fused_cycles == 1``).
    """
    if tb.fork_out is not None:
        raise ValueError(
            "collective offload does not support fused multi-cycle windows")
    (in2, in_cnt2, out2, out_cnt2, rr, wh, eg, eg_ready, eg_head, eg_cnt,
     ep_flit, ep_valid, waiting) = router_ops.router_cycles_fused(
        st.in_buf, st.in_cnt, st.out_buf, st.out_cnt, st.rr_ptr, st.wh_lock,
        eg, eg_ready, eg_head, eg_cnt,
        tb.route, tb.link_src, tb.link_dst, tb.port_ep, tb.ep_attach,
        ep_ingress_space, cycle0, n_cycles, vc_out=tb.vc_out,
        n_vcs=tb.n_vcs)
    return (FabricState(in2, in_cnt2, out2, out_cnt2, rr, wh),
            eg, eg_ready, eg_head, eg_cnt, ep_flit, ep_valid, waiting)


def inject(st: FabricState, tb: FabricTables, flit: torch.Tensor,
           want: torch.Tensor):
    """Endpoints push one flit per channel into their attached port's
    in_buf (seen by the arbiter next cycle). ``flit`` [C, E, NF]; ``want``
    [C, E]. Returns ``(state, accepted [C, E])``.

    Both steps inject through this one gather form. The JAX package's
    naive step injects with a one-hot ``fifo_push`` per attach port
    (``_inject_one``), which it documents as bit-identical: an accepted
    flit needs space, so the push's slot ``clip(cnt, 0, D - 1)`` is
    ``cnt`` and both forms write the same cells (held against the naive
    JAX state leaf for leaf in ``tests/test_torch_noc_naive.py``)."""
    in_buf, in_cnt, accepted = inject_endpoints(
        st.in_buf, st.in_cnt, tb.ep_attach[:, 0], tb.ep_attach[:, 1],
        tb.port_ep, flit, want)
    return dataclasses.replace(st, in_buf=in_buf, in_cnt=in_cnt), accepted
