"""Cycle-accurate router fabric in PyTorch, batched over physical channels.

One ``FabricState`` carries *all* physical channels of the NoC (the paper
instantiates three routers per tile: req / rsp / wide) as packed int32
tensors over [C channels, R routers, P ports, DEPTH fifo slots, NF flit
fields]. The per-cycle router datapath lives in
``repro_torch.kernels.noc_router``: ``ops.router_cycle`` runs the plain
PyTorch version on CPU tensors and the CUDA kernels on CUDA tensors.

This is the offload-less part of ``repro.core.noc.engine`` on its fast
path: fused FIFO updates, gather-based endpoint injection, virtual
channels with dateline switching (``n_vcs > 1``) and fused multi-cycle
windows (``fabric_cycles_fused``).

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

from repro_torch.core.noc.topology import Topology
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
    empty_flits,
    heads,
    inject_endpoints,
    pack_flit,
)


@dataclass
class FabricState:
    """Channel-batched router-fabric state."""

    in_buf: torch.Tensor  # [C, R, P, Din, NF]
    in_cnt: torch.Tensor  # [C, R, P]
    out_buf: torch.Tensor  # [C, R, P, Dout, NF]
    out_cnt: torch.Tensor  # [C, R, P]
    rr_ptr: torch.Tensor  # [C, R, P] round-robin pointer per *output* port
    wh_lock: torch.Tensor  # [C, R, P] wormhole: locked input port (-1 = free)


def init_fabric(topo: Topology, depth_in: int, depth_out: int,
                n_channels: int, n_vcs: int = 1, device=None) -> FabricState:
    """Empty fabric state for ``n_channels`` physical channels of ``topo``.

    With ``n_vcs > 1`` the port axis folds the VC axis in: slot
    ``p * n_vcs + v`` is (physical port p, virtual channel v), each with
    its own FIFOs, round-robin pointer and wormhole lock."""
    dev = resolve_device(device)
    C, R, P = n_channels, topo.n_routers, topo.n_ports * n_vcs
    z = lambda: torch.zeros((C, R, P), dtype=torch.int32, device=dev)
    return FabricState(
        in_buf=empty_flits((C, R, P, depth_in), device=dev),
        in_cnt=z(),
        out_buf=empty_flits((C, R, P, depth_out), device=dev),
        out_cnt=z(),
        rr_ptr=z(),
        wh_lock=torch.full((C, R, P), -1, dtype=torch.int32, device=dev),
    )


@dataclass(frozen=True)
class FabricTables:
    """Static routing/wiring tables shared by every physical channel.

    With ``n_vcs > 1``, ``port_ep``/``ep_attach`` are *slot*-level
    (endpoints attach at VC0 of their port) while ``route``/``link_src``/
    ``link_dst`` stay physical; ``vc_out`` is the dateline VC-switch
    table. ``n_vcs = 1`` keeps ``vc_out=None``."""

    route: torch.Tensor  # [R, E] physical out port
    link_src: torch.Tensor  # [R, Pp, 2] upstream (router, port) feeding my in port
    link_dst: torch.Tensor  # [R, Pp, 2]
    port_ep: torch.Tensor  # [R, P] endpoint attached (-1); slot-level if V > 1
    ep_attach: torch.Tensor  # [E, 2] (router, port-or-slot)
    # output VC for (router, input slot, physical out port); None when V == 1
    vc_out: torch.Tensor | None = None  # [R, P*V, Pp]
    n_vcs: int = 1


def make_tables(topo: Topology, n_vcs: int = 1, groups=None,
                device=None) -> FabricTables:
    """FabricTables on ``device`` derived from a Topology's numpy tables."""
    if groups is not None:
        raise NotImplementedError(
            "collective groups are not ported yet (ROADMAP Queue 1 item 9)")
    dev = resolve_device(device)
    R, P = topo.n_routers, topo.n_ports
    link_src = np.full((R, P, 2), -1, np.int32)
    for r in range(R):
        for p in range(P):
            r2, p2 = topo.link_to[r, p]
            if r2 >= 0:
                link_src[r2, p2] = (r, p)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    if n_vcs == 1:
        return FabricTables(route=t(topo.route), link_src=t(link_src),
                            link_dst=t(topo.link_to), port_ep=t(topo.port_ep),
                            ep_attach=t(topo.ep_attach))
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
                        ep_attach=t(ep_attach), vc_out=t(vc_out), n_vcs=V)


def fabric_cycle(st: FabricState, tb: FabricTables,
                 ep_ingress_space: torch.Tensor):
    """One cycle of every channel at once (fused FIFO datapath).

    ``ep_ingress_space`` [C, E] bool: the endpoint can accept one flit on
    that channel this cycle (a refused flit stays in the router's output
    buffer). Returns ``(state', ep_flit [C, E, NF], ep_valid [C, E])``.
    """
    (in2, in_cnt2, out2, out_cnt2, rr, wh, ep_flit, ep_valid) = (
        router_ops.router_cycle(
            st.in_buf, st.in_cnt, st.out_buf, st.out_cnt, st.rr_ptr,
            st.wh_lock, tb.route, tb.link_src, tb.link_dst, tb.port_ep,
            tb.ep_attach, ep_ingress_space, vc_out=tb.vc_out,
            n_vcs=tb.n_vcs))
    return FabricState(in2, in_cnt2, out2, out_cnt2, rr, wh), ep_flit, ep_valid


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
    ep_valid [C, N, E], req_waiting [C, N, E])``. (Collective offload,
    which the JAX version refuses here, has no tables in the port.)
    """
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
    [C, E]. Returns ``(state, accepted [C, E])``."""
    in_buf, in_cnt, accepted = inject_endpoints(
        st.in_buf, st.in_cnt, tb.ep_attach[:, 0], tb.ep_attach[:, 1],
        tb.port_ep, flit, want)
    return dataclasses.replace(st, in_buf=in_buf, in_cnt=in_cnt), accepted
