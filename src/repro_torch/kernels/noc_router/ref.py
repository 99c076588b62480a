"""Plain PyTorch version of the FlooNoC router cycle.

This is the PyTorch counterpart of ``repro.kernels.noc_router.ref``: the
bit-exact specification of the per-cycle router datapath — cycle-start
snapshot, round-robin output arbitration, wormhole locks, FIFO push/pop over
packed ``[R, P, D, NF]`` int32 flit state, with or without virtual
channels, one cycle at a time or as a fused multi-cycle window, and with
in-network collective offload (``offload_decisions``: multicast fork and
reduction ALU). The CUDA kernels in ``noc_router.py`` are held against
these functions.

Every function here takes any number of leading batch axes in front of the
router axis (the channel axis ``C`` in the engine), while the routing and
wiring tables (``route`` [R, E], ``link_src``/``link_dst`` [R, P, 2],
``port_ep`` [R, P]) are shared across the batch. So the channel-batched
fabric runs these functions once, with no Python channel loop, and a
single channel is just the unbatched call.

With ``n_vcs = V > 1`` the port axis is *slot*-level: slot ``p * V + v``
is (physical port p, virtual channel v). ``route`` and the link tables
stay physical ([R, Pp, 2], Pp = P / V); ``vc_out`` [R, P, Pp] gives the
departing VC of a head on an input slot routed out a physical port.

Cycle semantics: arbitration and link decisions are both computed from the
cycle-start snapshot, then applied. A flit spends >= 1 cycle in the input
buffer and >= 1 cycle in the output buffer: 2 cycles per router hop at zero
load, matching the paper's Fig. 7.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

# packed flit layout: trailing axis of NF int32 fields
FLIT_FIELDS = ("dst", "src", "kind", "txn", "last", "ts", "meta")
NF = len(FLIT_FIELDS)
F_DST, F_SRC, F_KIND, F_TXN, F_LAST, F_TS, F_META = range(NF)

# collective-offload flit kinds (equal to repro_torch.core.noc.params.WIDE_MC
# / WIDE_RED; this package does not import core.noc). MC/RED flits are
# group-addressed: F_DST = n_endpoints + group id.
KIND_MC = 6
KIND_RED = 7

# per-(router, group) reduction-ALU accumulator layout: trailing axis of
# NRED int32 fields. "nlast" accumulates max(1 - F_LAST), so the all-zero
# reset state emits last=1 and clearing an emitted slot is a zero-fill.
RED_FIELDS = ("val", "cnt", "nlast", "txn", "ts", "src")
NRED = len(RED_FIELDS)
A_VAL, A_CNT, A_NLAST, A_TXN, A_TS, A_SRC = range(NRED)

I32 = torch.int32


def empty_flits(shape, device=None) -> torch.Tensor:
    """Zeroed packed flit tensor of shape [*shape, NF]."""
    return torch.zeros((*tuple(shape), NF), dtype=I32, device=device)


def broadcast_fields(ref, *values) -> torch.Tensor:
    """Stack ``ref`` and ``values`` (tensors or ints, broadcast against
    ``ref``'s shape) along a new trailing int32 axis."""
    parts = [ref]
    for v in values:
        if isinstance(v, torch.Tensor):
            parts.append(v.to(I32).expand(ref.shape))
        else:
            parts.append(torch.full_like(ref, v))
    return torch.stack(parts, dim=-1)


def pack_flit(dst, src, kind, txn, last, ts, meta) -> torch.Tensor:
    """Pack per-field values (tensors or ints, broadcast against ``dst``'s
    shape) into [..., NF] int32."""
    return broadcast_fields(torch.as_tensor(dst).to(I32), src, kind, txn,
                            last, ts, meta)


def fifo_pop(buf, cnt, pop_mask):
    """Drop the head slot of every FIFO selected by ``pop_mask`` [..., P]."""
    shifted = torch.roll(buf, -1, dims=-2)
    newbuf = torch.where(pop_mask[..., None, None], shifted, buf)
    return newbuf, cnt - pop_mask.to(I32)


def fifo_push(buf, cnt, push_mask, flit):
    """Append ``flit`` [..., P, NF] at the tail where ``push_mask`` [..., P]."""
    D = buf.shape[-2]
    idx = cnt.clamp(0, D - 1)
    d = torch.arange(D, device=buf.device)
    onehot = (d == idx[..., None]) & push_mask[..., None]
    newbuf = torch.where(onehot[..., None], flit[..., None, :], buf)
    return newbuf, cnt + push_mask.to(I32)


def fifo_update(buf, cnt, pop_mask, push_mask, flit):
    """Fused pop-then-push, slot for slot what the JAX ``fifo_update`` writes.

    Identical to ``fifo_pop`` followed by ``fifo_push`` on every live slot
    (index < count). Dead slots hold the same garbage as the JAX fused
    path: the ``D == 2`` direct-select form and the general
    ``min(d + pop, D - 1)`` shift. Never pushes past the last slot:
    callers guarantee space.
    """
    D = buf.shape[-2]
    cnt1 = cnt - pop_mask.to(I32)
    if D == 2:
        head = torch.where(pop_mask[..., None], buf[..., 1, :], buf[..., 0, :])
        tail = cnt1.clamp(0, 1)
        s0 = torch.where((push_mask & (tail == 0))[..., None], flit, head)
        s1 = torch.where((push_mask & (tail == 1))[..., None], flit,
                         buf[..., 1, :])
        return torch.stack([s0, s1], dim=-2), cnt1 + push_mask.to(I32)
    d = torch.arange(D, device=buf.device)
    src = torch.clamp(d + pop_mask[..., None].to(torch.int64), max=D - 1)
    shifted = torch.gather(buf, -2, src[..., None].expand(buf.shape))
    at_tail = push_mask[..., None] & (d == cnt1.clamp(0, D - 1)[..., None])
    newbuf = torch.where(at_tail[..., None], flit[..., None, :], shifted)
    return newbuf, cnt1 + push_mask.to(I32)


def heads(buf) -> torch.Tensor:
    """Head flit of every FIFO: [..., D, NF] -> [..., NF]."""
    return buf[..., 0, :]


class ArbDecisions(NamedTuple):
    """Per-output-port arbitration results, all computed from the snapshot."""

    arb_pop: torch.Tensor  # [..., R, P_in] bool: head popped by some output
    granted: torch.Tensor  # [..., R, P_out] bool: output port granted a flit
    chosen: torch.Tensor  # [..., R, P_out, NF] flit the output port latches
    rr_ptr: torch.Tensor  # [..., R, P_out] updated round-robin pointer
    wh_lock: torch.Tensor  # [..., R, P_out] updated wormhole lock (-1 free)
    in_space: torch.Tensor  # [..., R, P_in] bool: input FIFO space after pops


INT32_MIN = -(2**31)


def request_slots(route, dst, vc_out=None, n_vcs: int = 1):
    """Output slot every head requests: [..., R, P] int32.

    The route is ``route[r, clip(dst, 0, None)]``; a destination past the
    table gets INT32_MIN, the value JAX's out-of-bounds gather fills in
    (at V = 1 it matches no port). With ``n_vcs > 1`` the physical port
    expands to slot ``phys * V + vc_out[r, slot_in, clip(phys, 0, Pp - 1)]``
    in int32 wraparound arithmetic, as in JAX: a past-table head at V = 2
    wraps to slot ``vc_out[r, slot_in, 0]``.
    """
    R, E = route.shape
    d = dst.clamp(min=0)
    r_idx = torch.arange(R, device=route.device)[:, None]
    port = route[r_idx, d.clamp(max=E - 1).long()]
    port = torch.where(d < E, port, INT32_MIN)
    if n_vcs == 1:
        return port
    return vc_slots(port, vc_out, n_vcs)


def vc_slots(port, vc_out, n_vcs: int):
    """Physical out port -> output slot ``port * V + vc_out[r, slot_in,
    clip(port, 0, Pp - 1)]`` in int32 wraparound arithmetic, as in JAX."""
    R, P, Pp = vc_out.shape
    r_idx = torch.arange(R, device=vc_out.device)[:, None]
    s_idx = torch.arange(P, device=vc_out.device)
    vout = vc_out[r_idx, s_idx, port.clamp(0, Pp - 1).long()]
    return wrap32(port.long() * n_vcs + vout.long())


def wrap32(x):
    """An int64 tensor to int32 with two's-complement wraparound: what
    JAX's int32 arithmetic (sums included) keeps."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(I32)


def first_true(mask):
    """Keep only the first True along the last axis (lowest index wins)."""
    return mask & (mask.to(I32).cumsum(dim=-1) == 1)


def arb_decisions(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
                  depth_out: int, vc_out=None, n_vcs: int = 1) -> ArbDecisions:
    """Round-robin output arbitration from the cycle-start snapshot.

    Each output port picks the lowest-scoring eligible input head
    (round-robin distance ``(pin - rr_ptr) % P``, a floor modulo); ties go
    to the lowest input index. Eligibility requires a head routed to that
    port, a free or matching wormhole lock, and output-buffer space. A
    granted tail flit releases the wormhole lock; a granted body flit locks
    the output to its input port.

    With ``n_vcs > 1`` heads request output *slots* (``request_slots``);
    arbitration then runs unchanged over slots, each with its own
    round-robin pointer and wormhole lock.
    """
    P = in_cnt.shape[-1]
    Din = in_buf.shape[-2]
    h = heads(in_buf)  # [..., R, P, NF]
    req_port = torch.where(
        in_cnt > 0, request_slots(route, h[..., F_DST], vc_out, n_vcs), -1)

    dev = in_buf.device
    pout = torch.arange(P, device=dev)
    pin = torch.arange(P, device=dev)[:, None]  # [P_in, 1]
    elig = req_port[..., :, None] == pout  # [..., R, P_in, P_out]
    locked = wh_lock[..., None, :]
    elig &= (locked < 0) | (locked == pin)
    elig &= (out_cnt < depth_out)[..., None, :]

    score = torch.remainder(pin - rr_ptr[..., None, :], P)
    score = torch.where(elig, score, P + 1)
    # first-min over the input axis: a strict < keeps the lowest index
    best = score[..., 0, :]
    winner = torch.zeros_like(best)
    for i in range(1, P):
        si = score[..., i, :]
        better = si < best
        best = torch.where(better, si, best)
        winner = torch.where(better, i, winner)
    granted = best <= P  # [..., R, P_out]
    win_onehot = (winner[..., None, :] == pin) & granted[..., None, :]
    arb_pop = win_onehot.any(dim=-1)  # [..., R, P_in]
    chosen = torch.gather(h, -2, winner.long()[..., None].expand(h.shape))

    rr = torch.where(granted, torch.remainder(winner + 1, P), rr_ptr)
    is_tail = chosen[..., F_LAST] > 0
    wh = torch.where(granted & ~is_tail, winner, wh_lock)
    wh = torch.where(granted & is_tail, -1, wh)

    in_space = (in_cnt - arb_pop.to(I32)) < Din
    return ArbDecisions(arb_pop, granted, chosen, rr.to(I32), wh.to(I32),
                        in_space)


def offload_decisions(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
                      depth_out: int, fork_out, red_parent, red_need,
                      red_acc, red_got, n_endpoints: int, vc_out=None,
                      n_vcs: int = 1):
    """Arbitration with tree-multicast fork and in-fabric reduction ALU.

    The ``collective_offload=True`` counterpart of ``arb_decisions``, slot
    for slot the JAX ``ref.offload_decisions`` over any leading batch axes.
    Extra inputs, shared across the batch unless noted:

    * ``fork_out`` [R, G, P] bool: multicast tree out-slots per group. A
      head with ``F_KIND == KIND_MC`` and ``F_DST == n_endpoints + g``
      requests every marked slot and pops only when it wins all of them in
      the same cycle; a partial win cancels the won branches (their
      round-robin pointers do not move).
    * ``red_parent`` / ``red_need`` [R, G] int32: the out-slot toward the
      reduction root (-1 off-tree) and the number of child slots that
      contribute to each beat.
    * ``red_acc`` [..., R, G, NRED] int32 / ``red_got`` [..., R, G, P]
      bool: the ALU slot. A ``KIND_RED`` head at a child slot that has not
      contributed to the current beat is consumed into the accumulator
      (``val`` += F_META, ``cnt`` += 1, metadata max-merged) when the slot
      can take it; once ``cnt == red_need`` the combined flit is emitted
      into the parent out-slot (the lowest group id wins a shared port,
      and emission pre-empts arbitration on that port) and the slot
      zero-clears, taking the next beat in the same cycle.

    The destination is clipped into ``[0, E - 1]`` before the route
    lookup, so a group-addressed head never reaches the past-table fill of
    ``request_slots``. Sums wrap in int32 as JAX's do. Returns
    ``(ArbDecisions, red_acc', red_got')``; the apply phase consumes the
    merged decisions unchanged.
    """
    P = in_cnt.shape[-1]
    Din = in_buf.shape[-2]
    R, G = red_need.shape
    lead = in_cnt.shape[:-2]
    dev = in_buf.device
    gs = torch.arange(G, device=dev)
    ps = torch.arange(P, device=dev)

    h = heads(in_buf)  # [..., R, P, NF]
    h_valid = in_cnt > 0
    is_mc = h_valid & (h[..., F_KIND] == KIND_MC)
    is_red = h_valid & (h[..., F_KIND] == KIND_RED)
    g_of = (h[..., F_DST] - n_endpoints).clamp(0, G - 1).long()  # [..., R, P]

    # ---- reduction ALU (all decisions from the cycle-start snapshot) ----
    on_tree = red_need > 0  # [R, G]
    full = on_tree & (red_acc[..., A_CNT] >= red_need)  # [..., R, G]
    parent = red_parent.clamp(0, P - 1).long().expand(*lead, R, G)
    parent_free = torch.gather(out_cnt < depth_out, -1, parent)
    parent_unlocked = torch.gather(wh_lock, -1, parent) < 0
    can_emit = full & (red_parent >= 0) & parent_free & parent_unlocked
    emit_oh = (parent[..., None] == ps) & can_emit[..., None]  # [..., R, G, P]
    emit_oh = emit_oh & (emit_oh.to(I32).cumsum(dim=-2) == 1)  # lowest g
    emit_port = emit_oh.any(dim=-2)  # [..., R, P_out]
    emitting = emit_oh.any(dim=-1)  # [..., R, G]
    # the emitting group of each port (0 where none): at most one per port
    g_sel = (emit_oh.long() * gs[:, None]).sum(dim=-2)  # [..., R, P_out]
    acc_sel = torch.gather(red_acc, -2,
                           g_sel[..., None].expand(*lead, R, P, NRED))
    red_flit = pack_flit(  # stays group-addressed for the next hop
        (g_sel + n_endpoints).to(I32), acc_sel[..., A_SRC], KIND_RED,
        acc_sel[..., A_TXN], 1 - acc_sel[..., A_NLAST], acc_sel[..., A_TS],
        acc_sel[..., A_VAL])

    # consume RED heads whose group slot takes a contribution this cycle:
    # not yet contributed to the current beat, and the slot is either not
    # full or flushing its snapshot this same cycle (pipelined refill)
    accept_g = on_tree & (~full | emitting)  # [..., R, G]
    accept_at = torch.gather(accept_g, -1, g_of)  # [..., R, P_in]
    got_at = torch.gather(red_got, -2, g_of[..., None, :])[..., 0, :]
    red_pop = is_red & ~got_at & accept_at
    gmask = red_pop[..., None, :] & (g_of[..., None, :] == gs[:, None])
    base_acc = torch.where(emitting[..., None], 0, red_acc)
    base_got = red_got & ~emitting[..., None]

    def merged_max(v):
        """Max of ``v`` [..., R, P] over each group's contributors, with 0
        for the other slots (JAX's ``where(gmask, v, 0).max(-1)``)."""
        return torch.where(gmask, v[..., None, :], 0).amax(dim=-1)

    contrib_sum = torch.where(gmask, h[..., F_META][..., None, :].long(),
                              0).sum(dim=-1)
    red_acc2 = torch.stack([
        wrap32(base_acc[..., A_VAL].long() + contrib_sum),
        wrap32(base_acc[..., A_CNT].long() + gmask.long().sum(dim=-1)),
        torch.maximum(base_acc[..., A_NLAST], merged_max(1 - h[..., F_LAST])),
        torch.maximum(base_acc[..., A_TXN], merged_max(h[..., F_TXN])),
        torch.maximum(base_acc[..., A_TS], merged_max(h[..., F_TS])),
        torch.maximum(base_acc[..., A_SRC], merged_max(h[..., F_SRC])),
    ], dim=-1)
    red_got2 = base_got | gmask

    # ---- arbitration with multicast fork requests ----
    r_idx = torch.arange(R, device=dev)[:, None]
    port = route[r_idx, h[..., F_DST].clamp(0, n_endpoints - 1).long()]
    if n_vcs > 1:
        port = vc_slots(port, vc_out, n_vcs)
    uni = h_valid & ~is_mc & ~is_red
    req_port = torch.where(uni, port, -1)
    pin = ps[:, None]
    fork_at = fork_out[r_idx, g_of]  # [..., R, P_in, P_out]
    req = (req_port[..., :, None] == ps) | (is_mc[..., :, None] & fork_at)
    locked = wh_lock[..., None, :]
    elig = req & ((locked < 0) | (locked == pin))
    elig &= (out_cnt < depth_out)[..., None, :]
    elig &= ~emit_port[..., None, :]  # reduction emission owns the port

    score = torch.remainder(pin - rr_ptr[..., None, :], P)
    score = torch.where(elig, score, P + 1)
    best = score[..., 0, :]
    winner = torch.zeros_like(best)
    for i in range(1, P):
        si = score[..., i, :]
        better = si < best
        best = torch.where(better, si, best)
        winner = torch.where(better, i, winner)
    granted0 = best <= P  # [..., R, P_out]
    win_onehot = (winner[..., None, :] == pin) & granted0[..., None, :]

    # a multicast head fires only when it wins EVERY requested branch
    fire_mc = is_mc & req.any(dim=-1) & ~(req & ~win_onehot).any(dim=-1)
    pop_uni = (win_onehot & uni[..., None]).any(dim=-1)
    arb_pop = pop_uni | fire_mc | red_pop

    # cancel grants whose winner is a multicast head that did not fire
    wl = winner.long()
    granted = granted0 & (~torch.gather(is_mc, -1, wl)
                          | torch.gather(fire_mc, -1, wl))
    chosen = torch.gather(h, -2, wl[..., None].expand(h.shape))
    rr = torch.where(granted, torch.remainder(winner + 1, P), rr_ptr)
    is_tail = chosen[..., F_LAST] > 0
    wh = torch.where(granted & ~is_tail, winner, wh_lock)
    wh = torch.where(granted & is_tail, -1, wh)

    # merge reduction emissions (their ports were excluded from arb)
    granted_all = granted | emit_port
    chosen_all = torch.where(emit_port[..., None], red_flit, chosen)
    in_space = (in_cnt - arb_pop.to(I32)) < Din
    return (ArbDecisions(arb_pop, granted_all, chosen_all, rr.to(I32),
                         wh.to(I32), in_space), red_acc2, red_got2)


def link_inputs(out_heads_all, out_valid_all, link_src, in_space,
                n_vcs: int = 1):
    """Link traversal on the input side: which upstream head feeds each
    input port and whether it is accepted this cycle.

    ``out_heads_all`` [..., R, P, NF] / ``out_valid_all`` [..., R, P] are
    the fabric-wide snapshot; ``link_src`` [R, Pp, 2] the upstream table
    (both coordinates clipped into range as the JAX reference does).
    Returns ``(up_head [..., R, P, NF], link_accept [..., R, P])``.

    With ``n_vcs > 1`` slot (p, v) receives from upstream slot (src_p, v)
    only, and each wire accepts the *lowest eligible VC first* (eligible:
    upstream head valid and this VC's input FIFO has space).
    """
    V = n_vcs
    R_all, P = out_valid_all.shape[-2:]
    Pp = P // V
    src_r, src_p = link_src[..., 0], link_src[..., 1]  # [R, Pp]
    have_up = (src_r >= 0)[..., None]  # [R, Pp, 1]
    sr = src_r.clamp(0, R_all - 1).long()[..., None]
    slot = (src_p.clamp(0, Pp - 1).long()[..., None] * V
            + torch.arange(V, device=link_src.device))  # [R, Pp, V]
    lead = in_space.shape[:-1]
    up_head = out_heads_all[..., sr, slot, :].reshape(*lead, P, NF)
    up_valid = (out_valid_all[..., sr, slot] & have_up).reshape(in_space.shape)
    elig = up_valid & in_space
    if V > 1:
        elig = first_true(elig.reshape(*lead, Pp, V)).reshape(in_space.shape)
    return up_head, elig


def sent_mask(out_valid, link_dst, port_ep, in_space_all, ep_space,
              n_vcs: int = 1):
    """Which output heads leave their buffer this cycle: over a live link
    iff the downstream input FIFO has space after its own arbitration pops
    (``in_space_all`` [..., R, P]), or into an attached endpoint iff it
    signalled ingress space (``ep_space`` [..., E]).

    With ``n_vcs > 1`` the link leg recomputes ``link_inputs``'s
    lowest-eligible-VC-first choice from the upstream side; endpoint slots
    are VC0 only (slot-level ``port_ep``), so the endpoint leg is
    unchanged.
    """
    V = n_vcs
    E = ep_space.shape[-1]
    R_all, P = in_space_all.shape[-2:]
    Pp = P // V
    dst_r, dst_p = link_dst[..., 0], link_dst[..., 1]  # [R, Pp]
    to_router = (dst_r >= 0)[..., None]
    dr = dst_r.clamp(0, R_all - 1).long()[..., None]
    slot = (dst_p.clamp(0, Pp - 1).long()[..., None] * V
            + torch.arange(V, device=link_dst.device))  # [R, Pp, V]
    down_space = in_space_all[..., dr, slot]  # [..., R, Pp, V]
    lead = out_valid.shape[:-1]
    elig = (to_router & down_space).reshape(out_valid.shape) & out_valid
    if V > 1:
        elig = first_true(elig.reshape(*lead, Pp, V)).reshape(out_valid.shape)
    has_ep = port_ep >= 0
    ep_ok = ep_space[..., port_ep.clamp(0, E - 1).long()]
    return elig | (has_ep & out_valid & ep_ok)


def apply_cycle(in_buf, in_cnt, out_buf, out_cnt, arb_pop, granted, chosen,
                link_accept, up_head, sent, fused: bool = False):
    """Apply the snapshot decisions: FIFO pops then pushes, per side.

    ``fused=True`` applies each side's pop+push as one ``fifo_update``
    (same live contents, different dead-slot garbage)."""
    if fused:
        in2, in_cnt2 = fifo_update(in_buf, in_cnt, arb_pop, link_accept,
                                   up_head)
        out2, out_cnt2 = fifo_update(out_buf, out_cnt, sent, granted, chosen)
        return in2, in_cnt2, out2, out_cnt2
    in1, in_cnt1 = fifo_pop(in_buf, in_cnt, arb_pop)
    in2, in_cnt2 = fifo_push(in1, in_cnt1, link_accept, up_head)
    out1, out_cnt1 = fifo_pop(out_buf, out_cnt, sent)
    out2, out_cnt2 = fifo_push(out1, out_cnt1, granted, chosen)
    return in2, in_cnt2, out2, out_cnt2


def apply_phase(in_buf, in_cnt, out_buf, out_cnt, arb: ArbDecisions,
                link_src, link_dst, port_ep, ep_space, fused: bool = True,
                n_vcs: int = 1):
    """Link resolution against the cycle-start snapshot plus the FIFO
    updates of both sides: the plain version of the CUDA apply kernel.
    Returns ``(in_buf', in_cnt', out_buf', out_cnt')``."""
    out_heads = heads(out_buf)
    out_valid = out_cnt > 0
    up_head, link_accept = link_inputs(out_heads, out_valid, link_src,
                                       arb.in_space, n_vcs=n_vcs)
    sent = sent_mask(out_valid, link_dst, port_ep, arb.in_space, ep_space,
                     n_vcs=n_vcs)
    return apply_cycle(in_buf, in_cnt, out_buf, out_cnt, arb.arb_pop,
                       arb.granted, arb.chosen, link_accept, up_head, sent,
                       fused=fused)


def endpoint_deliveries(out_buf, out_cnt, ep_attach, ep_space):
    """Output heads at every endpoint's attach port, from the cycle-start
    snapshot: ``(ep_flit [..., E, NF], ep_valid [..., E])``."""
    er, ep_p = ep_attach[:, 0].long(), ep_attach[:, 1].long()
    ep_flit = heads(out_buf)[..., er, ep_p, :]
    ep_valid = (out_cnt[..., er, ep_p] > 0) & ep_space
    return ep_flit, ep_valid


def router_cycle_reference(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                           route, link_src, link_dst, port_ep, ep_attach,
                           ep_space, fused: bool = False, vc_out=None,
                           n_vcs: int = 1):
    """One router cycle over the full fabric (plain version).

    State is ``[..., R, P, ...]`` (any leading batch axes, e.g. channels);
    ``ep_space`` [..., E] is the endpoint ingress-space mask. Returns
    ``(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock, ep_flit [..., E,
    NF], ep_valid [..., E])``. ``fused`` selects the fused FIFO datapath;
    ``n_vcs > 1`` the virtual-channel datapath with the dateline table
    ``vc_out``. Endpoint delivery is slot-level already (endpoints attach
    at VC0), so it needs no VC branch.
    """
    arb = arb_decisions(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
                        depth_out=out_buf.shape[-2], vc_out=vc_out,
                        n_vcs=n_vcs)
    in2, in_cnt2, out2, out_cnt2 = apply_phase(
        in_buf, in_cnt, out_buf, out_cnt, arb, link_src, link_dst, port_ep,
        ep_space, fused=fused, n_vcs=n_vcs)
    ep_flit, ep_valid = endpoint_deliveries(out_buf, out_cnt, ep_attach,
                                            ep_space)
    return (in2, in_cnt2, out2, out_cnt2, arb.rr_ptr, arb.wh_lock, ep_flit,
            ep_valid)


def router_cycle_offload_reference(in_buf, in_cnt, out_buf, out_cnt, rr_ptr,
                                   wh_lock, red_acc, red_got, route, link_src,
                                   link_dst, port_ep, ep_attach, fork_out,
                                   red_parent, red_need, ep_space,
                                   n_endpoints: int, fused: bool = False,
                                   vc_out=None, n_vcs: int = 1):
    """One router cycle with collective offload (plain version).

    ``router_cycle_reference`` with arbitration through
    ``offload_decisions`` (fork table + reduction ALU); the reduction state
    ``red_acc`` [..., R, G, NRED] / ``red_got`` [..., R, G, P] rides along.
    Returns the ``router_cycle_reference`` tuple extended with
    ``(red_acc', red_got')``. The link and apply phases are shared
    unchanged: offload only changes which flits are popped and latched.
    """
    arb, red_acc2, red_got2 = offload_decisions(
        in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, route,
        depth_out=out_buf.shape[-2], fork_out=fork_out,
        red_parent=red_parent, red_need=red_need, red_acc=red_acc,
        red_got=red_got, n_endpoints=n_endpoints, vc_out=vc_out,
        n_vcs=n_vcs)
    in2, in_cnt2, out2, out_cnt2 = apply_phase(
        in_buf, in_cnt, out_buf, out_cnt, arb, link_src, link_dst, port_ep,
        ep_space, fused=fused, n_vcs=n_vcs)
    ep_flit, ep_valid = endpoint_deliveries(out_buf, out_cnt, ep_attach,
                                            ep_space)
    return (in2, in_cnt2, out2, out_cnt2, arb.rr_ptr, arb.wh_lock, ep_flit,
            ep_valid, red_acc2, red_got2)


def inject_endpoints(in_buf, in_cnt, er, ep_p, port_ep, flit, want):
    """Gather-push one flit per endpoint into its attached input FIFO.

    ``er``/``ep_p`` [E] are the attach (router, port) of every endpoint,
    ``port_ep`` [R, P] the inverse map (-1 where none), ``flit`` [..., E,
    NF], ``want`` [..., E]. Attach ports are unique, so each port pulls its
    endpoint's flit and writes slot ``cnt`` through a one-hot select.
    Returns ``(in_buf, in_cnt, accepted [..., E])``.
    """
    Din = in_buf.shape[-2]
    pe = port_ep.clamp(min=0).long()
    want_rp = want[..., pe] & (port_ep >= 0)
    acc_rp = want_rp & (in_cnt < Din)
    flit_rp = flit[..., pe, :]  # [..., R, P, NF]
    d = torch.arange(Din, device=in_buf.device)
    at = acc_rp[..., None] & (d == in_cnt[..., None])
    in_buf = torch.where(at[..., None], flit_rp[..., None, :], in_buf)
    in_cnt = in_cnt + acc_rp.to(I32)
    accepted = acc_rp[..., er.long(), ep_p.long()]
    return in_buf, in_cnt, accepted


def fused_cycle_body(i: int, carry, route, link_src, link_dst, port_ep,
                     ep_attach, ep_space, cycle0, n_cycles: int, vc_out=None,
                     n_vcs: int = 1):
    """Cycle ``i`` of the fused multi-cycle window (any leading batch axes).

    ``carry`` holds the fabric state plus the endpoint egress queues
    (circular: ``eg`` [..., E, Q, NF], ``eg_ready`` [..., E, Q],
    ``eg_head``/``eg_cnt`` [..., E]). Capture ``req_waiting`` (an output
    head pending at an attach port, pre-cycle), run the router cycle
    against the held ``ep_space``, then inject each endpoint's ready egress
    head, except on the window's last cycle, where the caller injects
    after the endpoint phases. Returns ``(carry', (ep_flit [..., E, NF],
    ep_valid [..., E], req_waiting [..., E]))``.
    """
    (in_buf, in_cnt, out_buf, out_cnt, rr, wh,
     eg, eg_ready, eg_head, eg_cnt) = carry
    er, ep_p = ep_attach[:, 0], ep_attach[:, 1]
    req_waiting = out_cnt[..., er.long(), ep_p.long()] > 0

    (in_buf, in_cnt, out_buf, out_cnt, rr, wh, ep_flit, ep_valid) = (
        router_cycle_reference(in_buf, in_cnt, out_buf, out_cnt, rr, wh,
                               route, link_src, link_dst, port_ep, ep_attach,
                               ep_space, fused=True, vc_out=vc_out,
                               n_vcs=n_vcs))

    Q = eg_ready.shape[-1]
    h = eg_head.long()[..., None]  # [..., E, 1]
    head_flit = torch.gather(eg, -2, h[..., None].expand(*h.shape, NF))[..., 0, :]
    head_ready = torch.gather(eg_ready, -1, h)[..., 0]
    want = (eg_cnt > 0) & (head_ready <= cycle0 + i) & (i < n_cycles - 1)
    in_buf, in_cnt, accepted = inject_endpoints(in_buf, in_cnt, er, ep_p,
                                                port_ep, head_flit, want)
    eg_head = torch.remainder(eg_head + accepted.to(I32), Q)
    eg_cnt = eg_cnt - accepted.to(I32)
    carry = (in_buf, in_cnt, out_buf, out_cnt, rr, wh,
             eg, eg_ready, eg_head, eg_cnt)
    return carry, (ep_flit, ep_valid, req_waiting)


def router_cycles_scan(in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
                       eg, eg_ready, eg_head, eg_cnt,
                       route, link_src, link_dst, port_ep, ep_attach,
                       ep_space, cycle0, n_cycles: int, vc_out=None,
                       n_vcs: int = 1):
    """``n_cycles`` of ``fused_cycle_body`` in order: the plain version of
    the fused CUDA kernel. Returns the 10 updated state tensors plus
    ``(ep_flit [..., N, E, NF], ep_valid [..., N, E], req_waiting
    [..., N, E])``: the JAX ``ops.router_cycles_fused`` layout with the
    channel axis leading."""
    carry = (in_buf, in_cnt, out_buf, out_cnt, rr_ptr, wh_lock,
             eg, eg_ready, eg_head, eg_cnt)
    flits, valids, waits = [], [], []
    for i in range(n_cycles):
        carry, (f, v, w) = fused_cycle_body(
            i, carry, route, link_src, link_dst, port_ep, ep_attach,
            ep_space, cycle0, n_cycles, vc_out=vc_out, n_vcs=n_vcs)
        flits.append(f)
        valids.append(v)
        waits.append(w)
    return (*carry, torch.stack(flits, dim=-3), torch.stack(valids, dim=-2),
            torch.stack(waits, dim=-2))
