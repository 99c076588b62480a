"""Public entry points: router-fabric cycles, dispatched on the device.

``router_cycle`` runs one cycle of the channel-batched fabric (state
``[C, R, P, ...]``, tables shared across channels) on the fused FIFO
datapath (``fused_fifo=True``, the fast step) or the two-step pop then push
(``fused_fifo=False``, the naive step); ``router_cycles_fused`` advances it
N cycles with the endpoint egress injection threaded in (the multi-cycle
super-step, fused FIFO datapath). The tensors decide where they run:

* on the CPU they run the plain version (``ref.router_cycle_reference``,
  ``ref.router_cycles_scan``), with the channel axis as a batch dimension
  (no Python channel loop);
* on a CUDA device they launch the CUDA kernels
  (``noc_router.router_cycle_cuda``, ``noc_router.router_cycles_fused_cuda``;
  the apply kernel in the FIFO mode asked for), or raise.

``n_vcs > 1`` selects the virtual-channel datapath (slot-level P axis,
``vc_out`` [R, P, Pp] the dateline table). Passing ``fork_out`` selects
the collective-offload datapath of ``router_cycle`` (on a CUDA device the
offload arb kernel with the same apply kernel). This module does not import
``repro_torch.core.noc``: the engine layers on top of it.
"""
from __future__ import annotations

from repro_torch.kernels.noc_router.noc_router import (
    router_cycle_cuda,
    router_cycle_offload_cuda,
    router_cycles_fused_cuda,
)
from repro_torch.kernels.noc_router.ref import (
    router_cycle_offload_reference,
    router_cycle_reference,
    router_cycles_scan,
)


def _device_kind(t) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no router-cycle kernel for device {t.device}")
    return t.device.type


def router_cycle(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                 route, link_src, link_dst, port_ep, ep_attach, ep_space,
                 vc_out=None, n_vcs: int = 1, fork_out=None, red_parent=None,
                 red_need=None, red_acc=None, red_got=None,
                 n_endpoints: int = 0, fused_fifo: bool = True):
    """One cycle of every channel at once.

    State is channel-batched (``in_buf`` [C, R, P, Din, NF], counters
    [C, R, P]); tables are shared (``route`` [R, E], ``link_src``/
    ``link_dst`` [R, Pp, 2], ``port_ep`` [R, P], ``ep_attach`` [E, 2]);
    ``ep_space`` [C, E] bool. Returns ``(in_buf, in_cnt, out_buf, out_cnt,
    rr_ptr, wh_lock, ep_flit [C, E, NF], ep_valid [C, E])``, bit for bit
    the JAX ``ops.router_cycle(..., fused_fifo=fused_fifo)``: the fused FIFO
    update, or the reference's two-step pop then push (same live contents,
    other dead-slot garbage).

    Passing ``fork_out`` [R, G, P] (with ``red_parent`` / ``red_need``
    [R, G] and the channel-batched reduction state ``red_acc``
    [C, R, G, NRED] / ``red_got`` [C, R, G, P]) selects the collective-
    offload datapath and extends the return tuple to ``(..., red_acc',
    red_got')``.
    """
    args = (in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock, route,
            link_src, link_dst, port_ep, ep_attach, ep_space)
    if fork_out is not None:
        off = dict(fork_out=fork_out, red_parent=red_parent,
                   red_need=red_need, red_acc=red_acc, red_got=red_got,
                   n_endpoints=n_endpoints, vc_out=vc_out, n_vcs=n_vcs)
        if _device_kind(in_buf) == "cuda":
            return router_cycle_offload_cuda(*args, **off, fused=fused_fifo)
        return router_cycle_offload_reference(
            *args[:6], red_acc, red_got, *args[6:11], fork_out, red_parent,
            red_need, ep_space, n_endpoints=n_endpoints, fused=fused_fifo,
            vc_out=vc_out, n_vcs=n_vcs)
    if _device_kind(in_buf) == "cuda":
        return router_cycle_cuda(*args, vc_out=vc_out, n_vcs=n_vcs,
                                 fused=fused_fifo)
    return router_cycle_reference(*args, fused=fused_fifo, vc_out=vc_out,
                                  n_vcs=n_vcs)


def router_cycles_fused(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                        eg, eg_ready, eg_head, eg_cnt,
                        route, link_src, link_dst, port_ep, ep_attach,
                        ep_space, cycle0: int, n_cycles: int,
                        vc_out=None, n_vcs: int = 1):
    """``n_cycles`` fused fabric cycles with egress injection threaded in.

    The array contract of the JAX ``ops.router_cycles_fused``: the
    :func:`router_cycle` state plus the channel-batched circular egress
    queues (``eg`` [C, E, Q, NF], ``eg_ready`` [C, E, Q],
    ``eg_head``/``eg_cnt`` [C, E]) and the window's first cycle number
    ``cycle0``; ``ep_space`` is held for the window. Returns the 10 updated
    state tensors plus ``(ep_flit [C, N, E, NF], ep_valid [C, N, E],
    req_waiting [C, N, E])``.
    """
    args = (in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock, eg, eg_ready,
            eg_head, eg_cnt, route, link_src, link_dst, port_ep, ep_attach,
            ep_space, cycle0, n_cycles)
    if _device_kind(in_buf) == "cuda":
        return router_cycles_fused_cuda(*args, vc_out=vc_out, n_vcs=n_vcs)
    return router_cycles_scan(*args, vc_out=vc_out, n_vcs=n_vcs)
