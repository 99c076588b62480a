"""CUDA router cycle for Hopper: build, ctypes binding and wrappers.

The kernels (``csrc/noc_router.cu``) are the counterparts of the JAX
package's Pallas router kernels:

1. **arb** — a warp per 32 / P routers, a lane per slot: round-robin
   output arbitration from the cycle-start snapshot, written to scratch tensors
   (``arb_pop``, ``granted``, ``chosen``, ``rr_ptr'``, ``wh_lock'``,
   post-pop ``in_space``). Replaces ``_arb_kernel``; with ``n_vcs > 1``
   (dateline slot expansion through ``vc_out``) ``_arb_kernel_vc``.
2. **apply** — a lane per slot, as arb: link resolution against the
   fabric-wide snapshot (one remote load per side and lane, a wire's VC
   choice by a ballot over the port group's lanes) plus the FIFO update of
   both sides, staged in shared memory and written coalesced into freshly
   allocated output buffers (never in place). Replaces ``_apply_kernel`` at
   any ``n_vcs``, in both of its FIFO modes (a runtime argument): fused
   (``fifo_update``, the fast step) and unfused (``fifo_pop`` then
   ``fifo_push``, the naive step, counted as ``apply_unfused``).
3. **fused** — one thread-block cluster per channel runs an N-cycle window
   with the channel's state in the cluster's shared memory (arb, apply and
   egress injection per cycle, one cluster barrier between the phases;
   other CTAs' routers read through distributed shared memory).
   ``fused_plan`` sizes the cluster; a channel too large for 16 CTAs runs
   the same window with its state in global memory (one CTA per channel).
   Replaces ``_fused_kernel`` and, with ``n_vcs > 1``, ``_fused_kernel_vc``.
4. **arb_offload** — a lane per slot, as arb: the collective-
   offload arbitration (multicast fork, reduction ALU, emission
   pre-emption) at any ``n_vcs``, with the ALU state ``red_acc`` /
   ``red_got`` in and out. Replaces ``_arb_kernel_offload``; its merged
   decisions go to the same apply kernel.

One per-cycle step is an arb then an apply launch: the launch boundary is
the arb -> link barrier (``in_space`` of every router must be visible
before any link decision).

The library is built by ``repro_torch.kernels.build`` (``nvcc`` for
``sm_90a`` at first use on a CUDA tensor, keyed by a hash of the sources,
into ``_build/`` beside this file); importing the module builds nothing. It
exposes a plain C interface loaded with ``ctypes``. ``LAUNCHES`` counts the
launches of each kernel and mode (``*_vc`` for ``n_vcs > 1``), so a run can
show that it went through them.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels.build import CudaLibrary, ptr as _ptr, refuse_grad, stream as _stream
from repro_torch.kernels.noc_router.ref import (
    NF,
    NRED,
    ArbDecisions,
    endpoint_deliveries,
)

CSRC = Path(__file__).parent / "csrc"
SOURCES = (CSRC / "noc_router.cu",)
MAX_P = 32  # slots (ports x VCs) per router: a warp's lanes, a request mask's bits
# Din + Dout at most: the apply kernel stages 128 slots' FIFO rows, both
# sides, in a CTA's 227 KB of shared memory
MAX_APPLY_DEPTH = 64
FUSED_PTRS = 40  # pointer operands of noc_fused_global_launch (FusedArgs)
CLUSTER_PTRS = 30  # pointer operands of noc_fused_cluster_launch (ClusterArgs)
OFFLOAD_PTRS = 20  # pointer operands of noc_arb_offload_launch

# launches of each kernel and mode, counted where the wrapper launches it
LAUNCHES = {"arb": 0, "apply": 0, "arb_vc": 0, "apply_vc": 0, "fused": 0,
            "fused_vc": 0, "arb_offload": 0, "arb_offload_vc": 0,
            "apply_unfused": 0, "apply_unfused_vc": 0}


def _declare(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.noc_arb_launch.argtypes = [vp] * 13 + [ci] * 7 + [vp]
    lib.noc_arb_launch.restype = ci
    lib.noc_apply_launch.argtypes = [vp] * 16 + [ci] * 8 + [vp]
    lib.noc_apply_launch.restype = ci
    lib.noc_fused_global_launch.argtypes = [vp, vp, vp]
    lib.noc_fused_global_launch.restype = ci
    lib.noc_fused_cluster_prepare.argtypes = [vp, vp]
    lib.noc_fused_cluster_prepare.restype = ci
    lib.noc_fused_cluster_launch.argtypes = [vp, vp, vp]
    lib.noc_fused_cluster_launch.restype = ci
    lib.noc_arb_offload_launch.argtypes = [vp, vp, vp]
    lib.noc_arb_offload_launch.restype = ci


LIBRARY = CudaLibrary("noc_router", SOURCES, Path(__file__).parent / "_build",
                      _declare)


# ---------------------------------------------------------------------------
# the fused window's plan: one thread-block cluster per channel

SMEM_PER_CTA = 232_448  # an H100 block's shared memory (227 KB)
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is a non-portable cluster size
MAX_THREADS = 768  # noc_fused_cluster_kernel's bound (up to 85 registers)
PREFERRED_WARPS = 12  # per CTA: more is slower than a larger cluster (PERF.md)
GLOBAL_THREADS = 512  # noc_fused_global_kernel's CTA


@dataclass(frozen=True)
class FusedPlan:
    """How one fused window runs: ``kernel`` "cluster" (``cluster`` CTAs
    per channel, CTA k owning routers ``ranges[k]``, ``smem_bytes`` of
    shared memory and ``threads`` threads each, a lane per slot and
    ``slots_per_thread`` routers' slots per lane) or "global" (one CTA per
    channel, the state in global memory)."""

    kernel: str
    cluster: int
    routers_per_cta: int
    ranges: tuple
    smem_bytes: int
    threads: int
    slots_per_thread: int


def smem_bytes(slots: int, depth_in: int, depth_out: int, n_vcs: int = 1,
               ports: int = 0) -> int:
    """Shared memory of one CTA holding ``slots`` router slots: the
    arithmetic of ``smem_layout`` in ``noc_fused_cluster_kernel``'s source
    (every array rounded up to 16 bytes). Per slot: the input FIFO, the
    output FIFO and its count (two copies, ping-pong), the input count,
    ``rr``/``wh``, three link addresses, the attached endpoint with its
    egress head, count, head entry and ready stamp, the ``vc_out`` row
    (``ports`` physical ports, with ``n_vcs > 1``), the arbitration byte,
    ``in_space`` (two copies) and the endpoint flags."""
    copies = 2
    r16 = lambda n: -(-n // 16) * 16
    ints = 4 * slots
    return (r16(depth_in * NF * ints) + r16(copies * depth_out * NF * ints)
            + r16(ints) + r16(copies * ints) + 8 * r16(ints) + r16(NF * ints)
            + r16(ints) + r16(ports * ints if n_vcs > 1 else 0)
            + r16(slots) + r16(copies * slots) + r16(slots))


def fused_plan(R: int, P: int, depth_in: int, depth_out: int, n_vcs: int = 1,
               cluster: int | None = None,
               slots_per_thread: int | None = None) -> FusedPlan:
    """The plan of a fused window over ``R`` routers of ``P`` slots.

    By default the smallest cluster (1, 2, 4, 8 or 16 CTAs per channel)
    whose CTAs each hold their share of the routers in at most
    ``SMEM_PER_CTA`` bytes with a lane per slot in at most
    ``PREFERRED_WARPS`` warps; failing that, the smallest whose share fits
    at all, with as few router groups per warp as ``MAX_THREADS`` allow. A
    channel that no 16-CTA cluster holds runs the global-memory kernel.
    ``cluster`` and ``slots_per_thread`` pin a variant (for timing and
    tests); a pinned variant that does not fit raises.
    """
    if not 1 <= P <= MAX_P or n_vcs < 1 or P % n_vcs:
        raise ValueError(f"{P} slots in n_vcs={n_vcs} (at most {MAX_P} slots)")
    rpw = 32 // P  # routers per warp
    fits = []
    for cl in CLUSTER_SIZES if cluster is None else (cluster,):
        if cl not in CLUSTER_SIZES:
            raise ValueError(f"cluster must be one of {CLUSTER_SIZES}, got {cl}")
        rc = -(-R // cl)
        smem = smem_bytes(rc * P, depth_in, depth_out, n_vcs, P // n_vcs)
        groups = -(-rc // rpw)
        k = slots_per_thread or -(-groups // (MAX_THREADS // 32))
        warps = -(-groups // k)
        if smem > SMEM_PER_CTA or warps > MAX_THREADS // 32:
            if cluster is not None:
                raise ValueError(
                    f"cluster {cl} ({k} slots per thread) does not "
                    f"fit R={R}, P={P}: {smem} bytes of shared memory, "
                    f"{warps} warps per CTA")
            continue
        ranges = tuple((min(R, r0), min(R, r0 + rc))
                       for r0 in range(0, cl * rc, rc))
        fits.append(FusedPlan("cluster", cl, rc, ranges, smem, warps * 32, k))
    for plan in fits:
        if plan.threads <= PREFERRED_WARPS * 32:
            return plan
    if fits:
        return fits[0]
    return global_plan(R)


def global_plan(R: int) -> FusedPlan:
    """The global-memory kernel's plan: one CTA per channel."""
    return FusedPlan("global", 1, R, ((0, R),), 0, GLOBAL_THREADS, 1)


_PLACED = {}  # cluster plans the card has accepted: (device, dims) -> clusters


def _cluster_dims(plan: FusedPlan, C, R, P, Din, Dout, E, Q, V, cycle0, N):
    return (ctypes.c_int * 15)(
        C, R, P, Din, Dout, E, Q, V, cycle0, N, plan.cluster,
        plan.routers_per_cta, plan.threads, plan.slots_per_thread,
        plan.smem_bytes)


def _place(lib, plan: FusedPlan, dims, dev) -> int:
    """Allow the plan's shared memory and cluster size on the kernel and
    check, once per plan, that the card can place its clusters; raise with
    the numbers if it cannot."""
    key = (dev.index, plan, dims[0])
    if key not in _PLACED:
        n = ctypes.c_int(0)
        err = lib.noc_fused_cluster_prepare(dims, ctypes.byref(n))
        if err != 0:
            raise RuntimeError(f"noc_fused_cluster_kernel: plan {plan} refused "
                               f"(error {err})")
        if n.value < 1:
            raise RuntimeError(
                f"noc_fused_cluster_kernel: plan {plan} cannot be placed: "
                f"cudaOccupancyMaxActiveClusters = {n.value} for clusters of "
                f"{plan.cluster} CTAs x {plan.threads} threads x "
                f"{plan.smem_bytes} bytes of shared memory")
        _PLACED[key] = n.value
    return _PLACED[key]


def _check(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def mode(kernel: str, n_vcs: int) -> str:
    """``LAUNCHES`` key of ``kernel`` ("arb", "apply", "apply_unfused",
    "fused", "arb_offload") at ``n_vcs``."""
    return kernel if n_vcs == 1 else f"{kernel}_vc"


def apply_mode(fused: bool) -> str:
    """``LAUNCHES`` kernel name of the apply kernel's FIFO mode: "apply"
    (fused, the fast step) or "apply_unfused" (the naive step)."""
    return "apply" if fused else "apply_unfused"


def _count(kernel: str, n_vcs: int, err: int, key: str | None = None):
    """Raise on a refused launch of ``noc_{kernel}_kernel``, else count it
    under ``key`` (default ``kernel``) in its VC mode."""
    if err != 0:
        raise RuntimeError(f"noc_{kernel}_kernel launch failed: CUDA error {err}")
    LAUNCHES[mode(key or kernel, n_vcs)] += 1


def _require_cuda(name: str, dev):
    """Raise unless the wrapper ``name`` was given CUDA tensors: a kernel
    has no CPU mode, and no wrapper falls back to the plain version."""
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")


def _dims(*bufs, n_vcs: int = 1):
    """(C, R, P, D...) of a launch from its [C, R, P, D, NF] buffers."""
    for b in bufs:
        if b.dim() != 5 or b.shape[-1] != NF:
            raise ValueError(f"expected a [C, R, P, D, {NF}] flit buffer, "
                             f"got {tuple(b.shape)}")
        if b.numel() >= 2**31:
            raise ValueError("state too large for 32-bit thread indexing")
    C, R, P = bufs[0].shape[:3]
    if not 1 <= P <= MAX_P:
        raise ValueError(f"the CUDA arb kernel takes 1..{MAX_P} slots, got {P}")
    if n_vcs < 1 or P % n_vcs:
        raise ValueError(f"{P} slots do not fold into n_vcs={n_vcs}")
    return (C, R, P, *(b.shape[3] for b in bufs))


def _check_vc(vc_out, n_vcs, R, P, dev):
    """``vc_out`` must be an [R, P, P / n_vcs] table when n_vcs > 1, and
    absent otherwise."""
    if n_vcs == 1:
        if vc_out is not None:
            raise ValueError("vc_out is only taken with n_vcs > 1")
        return
    _check("vc_out", vc_out, torch.int32, (R, P, P // n_vcs), dev)


def arb_cuda(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
             depth_out: int, vc_out=None, n_vcs: int = 1) -> ArbDecisions:
    """Launch the arb kernel on channel-batched state (CUDA tensors).

    The counterpart of ``ref.arb_decisions`` over ``[C, R, P, ...]``;
    outputs are fresh scratch tensors.
    """
    dev = in_buf.device
    refuse_grad("arb_cuda", in_buf, in_cnt, out_cnt)  # no backward: autograd must not record it
    _require_cuda("arb_cuda", dev)
    C, R, P, Din = _dims(in_buf, n_vcs=n_vcs)
    Dout = int(depth_out)
    if route.dim() != 2:
        raise ValueError("route must be [R, E]")
    E = route.shape[1]
    i32, b = torch.int32, torch.bool
    _check("in_buf", in_buf, i32, (C, R, P, Din, NF), dev)
    for name, t in (("in_cnt", in_cnt), ("out_cnt", out_cnt),
                    ("rr_ptr", rr_ptr), ("wh_lock", wh_lock)):
        _check(name, t, i32, (C, R, P), dev)
    _check("route", route, i32, (R, E), dev)
    _check_vc(vc_out, n_vcs, R, P, dev)
    out = ArbDecisions(
        arb_pop=torch.empty((C, R, P), dtype=b, device=dev),
        granted=torch.empty((C, R, P), dtype=b, device=dev),
        chosen=torch.empty((C, R, P, NF), dtype=i32, device=dev),
        rr_ptr=torch.empty((C, R, P), dtype=i32, device=dev),
        wh_lock=torch.empty((C, R, P), dtype=i32, device=dev),
        in_space=torch.empty((C, R, P), dtype=b, device=dev))
    lib = LIBRARY.load()
    err = lib.noc_arb_launch(
        _ptr(in_buf), _ptr(in_cnt), _ptr(out_cnt), _ptr(rr_ptr),
        _ptr(wh_lock), _ptr(route), _ptr(vc_out), _ptr(out.arb_pop),
        _ptr(out.granted), _ptr(out.chosen), _ptr(out.rr_ptr),
        _ptr(out.wh_lock), _ptr(out.in_space), C, R, P, Din, Dout, E, n_vcs,
        _stream(dev))
    _count("arb", n_vcs, err)
    return out


def arb_offload_cuda(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
                     depth_out: int, fork_out, red_parent, red_need, red_acc,
                     red_got, n_endpoints: int, vc_out=None, n_vcs: int = 1):
    """Launch the offload arb kernel on channel-batched state (CUDA
    tensors): the counterpart of ``ref.offload_decisions`` over
    ``[C, R, P, ...]``. Returns ``(ArbDecisions, red_acc', red_got')``,
    all fresh tensors; the inputs are only read."""
    dev = in_buf.device
    refuse_grad("arb_offload_cuda", in_buf, in_cnt, out_cnt, red_acc)  # no backward: autograd must not record it
    _require_cuda("arb_offload_cuda", dev)
    C, R, P, Din = _dims(in_buf, n_vcs=n_vcs)
    Dout = int(depth_out)
    if route.dim() != 2 or fork_out.dim() != 3:
        raise ValueError("route must be [R, E] and fork_out [R, G, P]")
    E, G = route.shape[1], fork_out.shape[1]
    if n_endpoints != E:
        raise ValueError(f"n_endpoints={n_endpoints} but route has {E} columns")
    if G < 1:
        raise ValueError("the offload arb kernel needs at least one group")
    i32, b = torch.int32, torch.bool
    _check("in_buf", in_buf, i32, (C, R, P, Din, NF), dev)
    for name, t in (("in_cnt", in_cnt), ("out_cnt", out_cnt),
                    ("rr_ptr", rr_ptr), ("wh_lock", wh_lock)):
        _check(name, t, i32, (C, R, P), dev)
    _check("route", route, i32, (R, E), dev)
    _check_vc(vc_out, n_vcs, R, P, dev)
    _check("fork_out", fork_out, b, (R, G, P), dev)
    _check("red_parent", red_parent, i32, (R, G), dev)
    _check("red_need", red_need, i32, (R, G), dev)
    _check("red_acc", red_acc, i32, (C, R, G, NRED), dev)
    _check("red_got", red_got, b, (C, R, G, P), dev)
    out = ArbDecisions(
        arb_pop=torch.empty((C, R, P), dtype=b, device=dev),
        granted=torch.empty((C, R, P), dtype=b, device=dev),
        chosen=torch.empty((C, R, P, NF), dtype=i32, device=dev),
        rr_ptr=torch.empty((C, R, P), dtype=i32, device=dev),
        wh_lock=torch.empty((C, R, P), dtype=i32, device=dev),
        in_space=torch.empty((C, R, P), dtype=b, device=dev))
    red_acc2 = torch.empty_like(red_acc)
    red_got2 = torch.empty_like(red_got)
    ptrs = [in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route, vc_out,
            fork_out, red_parent, red_need, red_acc, red_got, *out,
            red_acc2, red_got2]
    assert len(ptrs) == OFFLOAD_PTRS
    c_ptrs = (ctypes.c_void_p * OFFLOAD_PTRS)(
        *(None if t is None else t.data_ptr() for t in ptrs))
    dims = (ctypes.c_int * 8)(C, R, P, Din, Dout, E, n_vcs, G)
    err = LIBRARY.load().noc_arb_offload_launch(c_ptrs, dims, _stream(dev))
    _count("arb_offload", n_vcs, err)
    return out, red_acc2, red_got2


def apply_cuda(in_buf, in_cnt, out_buf, out_cnt, arb: ArbDecisions,
               link_src, link_dst, port_ep, ep_space, n_vcs: int = 1,
               fused: bool = True):
    """Launch the apply kernel: the counterpart of ``ref.apply_phase(...,
    fused=fused)``, the fused FIFO update or (``fused=False``, counted as
    ``apply_unfused``) the two-step pop then push. Returns fresh
    ``(in_buf', in_cnt', out_buf', out_cnt')``; the inputs stay the
    untouched cycle-start snapshot. The link tables are physical ([R, P /
    n_vcs, 2])."""
    dev = in_buf.device
    refuse_grad("apply_cuda", in_buf, in_cnt, out_buf, out_cnt)  # no backward: autograd must not record it
    _require_cuda("apply_cuda", dev)
    C, R, P, Din, Dout = _dims(in_buf, out_buf, n_vcs=n_vcs)
    if Din + Dout > MAX_APPLY_DEPTH:
        raise ValueError(f"the CUDA apply kernel takes depths summing to at most "
                         f"{MAX_APPLY_DEPTH}, got {Din} + {Dout}")
    E = ep_space.shape[-1]
    i32, b = torch.int32, torch.bool
    _check("in_buf", in_buf, i32, (C, R, P, Din, NF), dev)
    _check("out_buf", out_buf, i32, (C, R, P, Dout, NF), dev)
    _check("in_cnt", in_cnt, i32, (C, R, P), dev)
    _check("out_cnt", out_cnt, i32, (C, R, P), dev)
    for name in ("arb_pop", "granted", "in_space"):
        _check(name, getattr(arb, name), b, (C, R, P), dev)
    _check("chosen", arb.chosen, i32, (C, R, P, NF), dev)
    _check("link_src", link_src, i32, (R, P // n_vcs, 2), dev)
    _check("link_dst", link_dst, i32, (R, P // n_vcs, 2), dev)
    _check("port_ep", port_ep, i32, (R, P), dev)
    _check("ep_space", ep_space, b, (C, E), dev)
    new_in = torch.empty_like(in_buf)
    new_in_cnt = torch.empty_like(in_cnt)
    new_out = torch.empty_like(out_buf)
    new_out_cnt = torch.empty_like(out_cnt)
    lib = LIBRARY.load()
    err = lib.noc_apply_launch(
        _ptr(in_buf), _ptr(in_cnt), _ptr(out_buf), _ptr(out_cnt),
        _ptr(arb.arb_pop), _ptr(arb.granted), _ptr(arb.chosen),
        _ptr(arb.in_space), _ptr(link_src), _ptr(link_dst), _ptr(port_ep),
        _ptr(ep_space), _ptr(new_in), _ptr(new_in_cnt), _ptr(new_out),
        _ptr(new_out_cnt), C, R, P, Din, Dout, E, n_vcs, int(bool(fused)),
        _stream(dev))
    _count("apply", n_vcs, err, key=apply_mode(fused))
    return new_in, new_in_cnt, new_out, new_out_cnt


def router_cycle_cuda(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                      route, link_src, link_dst, port_ep, ep_attach,
                      ep_space, vc_out=None, n_vcs: int = 1, fused: bool = True):
    """One fabric cycle of every channel on the CUDA kernels (the apply
    kernel in the FIFO mode ``fused`` names).

    Same contract as ``ref.router_cycle_reference(..., fused=fused)`` over
    channel-batched state: returns ``(in_buf, in_cnt, out_buf, out_cnt,
    rr_ptr, wh_lock, ep_flit [C, E, NF], ep_valid [C, E])``. The endpoint
    deliveries are gathered from the cycle-start snapshot, which the apply
    kernel leaves untouched (its outputs are separate tensors).
    """
    arb = arb_cuda(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
                   depth_out=out_buf.shape[-2], vc_out=vc_out, n_vcs=n_vcs)
    in2, in_cnt2, out2, out_cnt2 = apply_cuda(
        in_buf, in_cnt, out_buf, out_cnt, arb, link_src, link_dst, port_ep,
        ep_space, n_vcs=n_vcs, fused=fused)
    ep_flit, ep_valid = endpoint_deliveries(out_buf, out_cnt, ep_attach,
                                            ep_space)
    return (in2, in_cnt2, out2, out_cnt2, arb.rr_ptr, arb.wh_lock, ep_flit,
            ep_valid)


def router_cycle_offload_cuda(in_buf, in_cnt, out_buf, out_cnt, rr_ptr,
                              wh_lock, route, link_src, link_dst, port_ep,
                              ep_attach, ep_space, fork_out, red_parent,
                              red_need, red_acc, red_got, n_endpoints: int,
                              vc_out=None, n_vcs: int = 1, fused: bool = True):
    """One fabric cycle of every channel with collective offload: the
    offload arb kernel, then the same apply kernel (fork copies and
    emitted reduction flits reach it through the merged ``granted`` /
    ``chosen``; ``fused`` picks its FIFO mode). Same contract as
    ``ref.router_cycle_offload_reference(..., fused=fused)`` over
    channel-batched state: returns ``(in_buf, in_cnt,
    out_buf, out_cnt, rr_ptr, wh_lock, ep_flit, ep_valid, red_acc',
    red_got')``."""
    arb, red_acc2, red_got2 = arb_offload_cuda(
        in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
        depth_out=out_buf.shape[-2], fork_out=fork_out,
        red_parent=red_parent, red_need=red_need, red_acc=red_acc,
        red_got=red_got, n_endpoints=n_endpoints, vc_out=vc_out,
        n_vcs=n_vcs)
    in2, in_cnt2, out2, out_cnt2 = apply_cuda(
        in_buf, in_cnt, out_buf, out_cnt, arb, link_src, link_dst, port_ep,
        ep_space, n_vcs=n_vcs, fused=fused)
    ep_flit, ep_valid = endpoint_deliveries(out_buf, out_cnt, ep_attach,
                                            ep_space)
    return (in2, in_cnt2, out2, out_cnt2, arb.rr_ptr, arb.wh_lock, ep_flit,
            ep_valid, red_acc2, red_got2)


def router_cycles_fused_cuda(in_buf, in_cnt, out_buf, out_cnt, rr_ptr,
                             wh_lock, eg, eg_ready, eg_head, eg_cnt, route,
                             link_src, link_dst, port_ep, ep_attach,
                             ep_space, cycle0: int, n_cycles: int,
                             vc_out=None, n_vcs: int = 1,
                             plan: FusedPlan | None = None):
    """``n_cycles`` fused fabric cycles in one launch: one thread-block
    cluster per channel with the state in shared memory, or, for a channel
    that no 16-CTA cluster holds, one CTA per channel with the state in
    global memory. ``plan`` (default ``fused_plan`` of the shapes) chooses;
    a plan the card cannot place, or a refused launch, raises.

    Same contract as ``ref.router_cycles_scan`` over channel-batched state:
    returns the 10 updated state tensors (fresh; the inputs are not
    modified) plus ``(ep_flit [C, N, E, NF], ep_valid [C, N, E],
    req_waiting [C, N, E])``. Endpoints attach at unique slots, and
    ``port_ep`` is the inverse of ``ep_attach``, as on every topology.
    """
    dev = in_buf.device
    refuse_grad("router_cycles_fused_cuda", in_buf, in_cnt, out_buf, out_cnt)  # no backward: autograd must not record it
    _require_cuda("router_cycles_fused_cuda", dev)
    N = int(n_cycles)
    if N < 1:
        raise ValueError(f"n_cycles must be >= 1, got {N}")
    C, R, P, Din, Dout = _dims(in_buf, out_buf, n_vcs=n_vcs)
    E, Q = eg_ready.shape[-2:]
    i32, b = torch.int32, torch.bool
    _check("in_buf", in_buf, i32, (C, R, P, Din, NF), dev)
    _check("out_buf", out_buf, i32, (C, R, P, Dout, NF), dev)
    for name, t in (("in_cnt", in_cnt), ("out_cnt", out_cnt),
                    ("rr_ptr", rr_ptr), ("wh_lock", wh_lock)):
        _check(name, t, i32, (C, R, P), dev)
    _check("eg", eg, i32, (C, E, Q, NF), dev)
    _check("eg_ready", eg_ready, i32, (C, E, Q), dev)
    _check("eg_head", eg_head, i32, (C, E), dev)
    _check("eg_cnt", eg_cnt, i32, (C, E), dev)
    _check("route", route, i32, (R, E), dev)
    _check_vc(vc_out, n_vcs, R, P, dev)
    _check("link_src", link_src, i32, (R, P // n_vcs, 2), dev)
    _check("link_dst", link_dst, i32, (R, P // n_vcs, 2), dev)
    _check("port_ep", port_ep, i32, (R, P), dev)
    _check("ep_attach", ep_attach, i32, (E, 2), dev)
    _check("ep_space", ep_space, b, (C, E), dev)
    plan = plan or fused_plan(R, P, Din, Dout, n_vcs)
    state = [torch.empty_like(t) for t in (in_buf, in_cnt, out_buf, out_cnt,
                                           rr_ptr, wh_lock, eg, eg_ready,
                                           eg_head, eg_cnt)]
    ep_flit = torch.empty((C, N, E, NF), dtype=i32, device=dev)
    ep_valid = torch.empty((C, N, E), dtype=b, device=dev)
    waiting = torch.empty((C, N, E), dtype=b, device=dev)
    ptrs = [in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
            eg, eg_ready, eg_head, eg_cnt,
            route, vc_out, link_src, link_dst, port_ep, ep_attach, ep_space,
            *state, ep_flit, ep_valid, waiting]
    lib = LIBRARY.load()
    if plan.kernel == "cluster":
        # ClusterArgs, in declaration order
        assert len(ptrs) == CLUSTER_PTRS
        dims = _cluster_dims(plan, C, R, P, Din, Dout, E, Q, n_vcs,
                             int(cycle0), N)
        _place(lib, plan, dims, dev)
        c_ptrs = (ctypes.c_void_p * CLUSTER_PTRS)(
            *(None if t is None else t.data_ptr() for t in ptrs))
        err = lib.noc_fused_cluster_launch(c_ptrs, dims, _stream(dev))
    else:
        # FusedArgs, in declaration order: the ping-pong half and the
        # arbitration scratch follow
        ptrs += [torch.empty_like(t) for t in (in_buf, in_cnt, out_buf,
                                               out_cnt, rr_ptr, wh_lock)]
        ptrs += [torch.empty((C, R, P), dtype=b, device=dev) for _ in range(3)]
        ptrs.append(torch.empty((C, R, P, NF), dtype=i32, device=dev))
        assert len(ptrs) == FUSED_PTRS
        c_ptrs = (ctypes.c_void_p * FUSED_PTRS)(
            *(None if t is None else t.data_ptr() for t in ptrs))
        dims = (ctypes.c_int * 10)(C, R, P, Din, Dout, E, Q, n_vcs,
                                   int(cycle0), N)
        err = lib.noc_fused_global_launch(c_ptrs, dims, _stream(dev))
    _count("fused", n_vcs, err)
    return (*state, ep_flit, ep_valid, waiting)
