"""Public entry point: one router-fabric cycle, dispatched on the device.

``router_cycle`` runs one cycle of the channel-batched fabric (state
``[C, R, P, ...]``, tables shared across channels) on the fused FIFO
datapath. The tensors decide where it runs:

* on the CPU it runs the plain version (``ref.router_cycle_reference``),
  with the channel axis as a batch dimension (no Python channel loop);
* on a CUDA device it launches the two CUDA kernels
  (``noc_router.router_cycle_cuda``), or raises.

This module does not import ``repro_torch.core.noc``: the engine layers on
top of it.
"""
from __future__ import annotations

from repro_torch.kernels.noc_router.noc_router import router_cycle_cuda
from repro_torch.kernels.noc_router.ref import router_cycle_reference


def router_cycle(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                 route, link_src, link_dst, port_ep, ep_attach, ep_space):
    """One cycle of every channel at once.

    State is channel-batched (``in_buf`` [C, R, P, Din, NF], counters
    [C, R, P]); tables are shared (``route`` [R, E], ``link_src``/
    ``link_dst`` [R, P, 2], ``port_ep`` [R, P], ``ep_attach`` [E, 2]);
    ``ep_space`` [C, E] bool. Returns ``(in_buf, in_cnt, out_buf, out_cnt,
    rr_ptr, wh_lock, ep_flit [C, E, NF], ep_valid [C, E])``, bit for bit
    the JAX ``ops.router_cycle(..., fused_fifo=True)``.
    """
    args = (in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock, route,
            link_src, link_dst, port_ep, ep_attach, ep_space)
    if in_buf.device.type == "cuda":
        return router_cycle_cuda(*args)
    if in_buf.device.type == "cpu":
        return router_cycle_reference(*args, fused=True)
    raise ValueError(f"no router-cycle kernel for device {in_buf.device}")
