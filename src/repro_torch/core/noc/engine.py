"""Cycle-accurate router fabric in PyTorch, batched over physical channels.

One ``FabricState`` carries *all* physical channels of the NoC (the paper
instantiates three routers per tile: req / rsp / wide) as packed int32
tensors over [C channels, R routers, P ports, DEPTH fifo slots, NF flit
fields]. The per-cycle router datapath lives in
``repro_torch.kernels.noc_router``: ``ops.router_cycle`` runs the plain
PyTorch version on CPU tensors and the CUDA kernels on CUDA tensors.

This is the VC-less, offload-less slice of ``repro.core.noc.engine`` on its
fast path: fused FIFO updates and gather-based endpoint injection.

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
                n_channels: int, device=None) -> FabricState:
    """Empty fabric state for ``n_channels`` physical channels of ``topo``."""
    dev = resolve_device(device)
    C, R, P = n_channels, topo.n_routers, topo.n_ports
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
    """Static routing/wiring tables shared by every physical channel."""

    route: torch.Tensor  # [R, E] out port
    link_src: torch.Tensor  # [R, P, 2] upstream (router, port) feeding my in port
    link_dst: torch.Tensor  # [R, P, 2]
    port_ep: torch.Tensor  # [R, P] endpoint attached (-1)
    ep_attach: torch.Tensor  # [E, 2] (router, port)


def make_tables(topo: Topology, n_vcs: int = 1, groups=None,
                device=None) -> FabricTables:
    """FabricTables on ``device`` derived from a Topology's numpy tables."""
    if n_vcs != 1:
        raise NotImplementedError(
            "n_vcs > 1 is not ported yet (ROADMAP Queue 1 item 7)")
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
    return FabricTables(route=t(topo.route), link_src=t(link_src),
                        link_dst=t(topo.link_to), port_ep=t(topo.port_ep),
                        ep_attach=t(topo.ep_attach))


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
            tb.ep_attach, ep_ingress_space))
    return FabricState(in2, in_cnt2, out2, out_cnt2, rr, wh), ep_flit, ep_valid


def inject(st: FabricState, tb: FabricTables, flit: torch.Tensor,
           want: torch.Tensor):
    """Endpoints push one flit per channel into their attached port's
    in_buf (seen by the arbiter next cycle). ``flit`` [C, E, NF]; ``want``
    [C, E]. Returns ``(state, accepted [C, E])``."""
    in_buf, in_cnt, accepted = inject_endpoints(
        st.in_buf, st.in_cnt, tb.ep_attach[:, 0], tb.ep_attach[:, 1],
        tb.port_ep, flit, want)
    return dataclasses.replace(st, in_buf=in_buf, in_cnt=in_cnt), accepted
