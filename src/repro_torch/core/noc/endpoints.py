"""Endpoint models: compute-tile cluster (narrow cores + multi-stream DMA +
SPM) and HBM channels, with the paper's Network-Interface ordering schemes.

NI ordering (paper Sec. III-A):
  * RoB-less: per TxnID outstanding counter + last destination; a new request
    stalls while the TxnID has outstanding transactions to a *different*
    destination (static routing makes same-destination responses in-order).
  * RoB: end-to-end flow control on reorder-buffer credits.

The multi-stream DMA (paper Sec. IV-A) gives each backend its own TxnID, so
RoB-less ordering never stalls across streams.

The PyTorch counterpart of ``repro.core.noc.endpoints``: the queue helpers
take ``circular`` (True: the fast step's circular queues; False: the naive
step's roll-based queues, head always at slot 0). The NI trackers' scatter
forms of the naive step (``_col_add``, ``_ni_issue``, the three-call
``_ni_retire``) are exact integer adds into distinct cells, the same math
as the one-hot forms here, so both steps share them. Everything is
vectorized over endpoints *and* physical channels; state is int32 (float32
for the token buckets and latency sums, bool for flags), indices used for
gathers are int64. No function here synchronises with the device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.noc.engine import NF, empty_flits
from repro_torch.core.noc.params import NocParams
from repro_torch.kernels.noc_router.ref import broadcast_fields

I32 = torch.int32
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Workload:
    """Static per-endpoint traffic programme (numpy, baked into the sim)."""

    narrow_rate: np.ndarray  # [E] f32 requests/cycle (0 = off)
    narrow_dst: np.ndarray  # [E] int32 (-1 off, -2 uniform-random per msg)
    dma_dst: np.ndarray  # [E, C] int32 destination per stream (-1 off, -2 uniform)
    dma_alt_dst: np.ndarray  # [E, C] int32 alternate per-odd-txn dst (-1 = none)
    dma_txns: np.ndarray  # [E, C] transfers per stream
    dma_beats: int  # wide beats per transfer (4 kB = 64)
    dma_write: bool  # False = reads, True = writes
    n_tiles: int
    unique_txn_per_stream: bool = True  # multi-stream DMA (unique TxnIDs)
    # scheduled (multi-phase) DMA of the collective lowering: transfer k of
    # stream s at endpoint e goes to dma_dst_seq[e, s, k] with
    # dma_beats_seq[e, s, k] beats once the endpoint has received
    # dma_gate[e, s, k] complete write bursts on that stream
    dma_dst_seq: np.ndarray | None = None  # [E, S, K] int32
    dma_gate: np.ndarray | None = None  # [E, S, K] int32 required rx_bursts
    dma_beats_seq: np.ndarray | None = None  # [E, S, K] int32
    # in-fabric collective offload (params.collective_offload): DMA
    # destinations in [E, E+n_groups) are offloaded multicasts to group g,
    # [E+n_groups, E+2*n_groups) reduction contributions to group g. Both
    # are posted writes (no NI/RoB tracking); the fabric must be built with
    # matching groups (sim.build_sim)
    n_groups: int = 0

    @property
    def n_streams(self) -> int:
        """Number of DMA streams per endpoint (the paper's multi-stream DMA)."""
        return self.dma_dst.shape[1]


def idle_workload(E: int, n_tiles: int, streams: int = 1) -> Workload:
    """All-quiet Workload template; callers dataclasses.replace traffic in."""
    z = np.zeros((E,), np.float32)
    m1 = np.full((E,), -1, np.int32)
    return Workload(
        narrow_rate=z, narrow_dst=m1,
        dma_dst=np.full((E, streams), -1, np.int32),
        dma_alt_dst=np.full((E, streams), -1, np.int32),
        dma_txns=np.zeros((E, streams), np.int32),
        dma_beats=64, dma_write=False, n_tiles=n_tiles,
    )


@dataclass
class EndpointState:
    """Per-endpoint simulator state, vectorized over all E endpoints.

    Field for field the JAX ``EndpointState``: NI ordering trackers,
    narrow/DMA generators, the write-burst serializer, the memory request
    queue + server, per-channel egress queues, and the statistics counters
    surfaced by ``sim.stats``. On the fast step the queues are circular
    (head pointer advances on pop; pushes land at ``(head + cnt) % Q``); on
    the naive step the head stays at slot 0 and a pop rolls the queue.
    """

    # NI ordering
    ni_cnt: torch.Tensor  # [E, T] outstanding per TxnID
    ni_dst: torch.Tensor  # [E, T] destination of outstanding txns (-1)
    rob_credit: torch.Tensor  # [E] beats of RoB space left (rob mode)
    # narrow generator
    n_acc: torch.Tensor  # [E] f32 token bucket
    n_seq: torch.Tensor  # [E]
    # DMA streams
    d_txns_left: torch.Tensor  # [E, S]
    d_outst: torch.Tensor  # [E, S] outstanding transfers
    d_seq: torch.Tensor  # [E, S] issue index
    d_beats_got: torch.Tensor  # [E, S] read beats received (stats)
    rx_bursts: torch.Tensor  # [E, S] complete write bursts received per stream
    # write burst serializer (one active burst per endpoint)
    w_stream: torch.Tensor  # [E] active stream (-1)
    w_left: torch.Tensor  # [E] beats left
    w_beats: torch.Tensor  # [E] total beats of the active burst (rides F_META)
    w_dst: torch.Tensor  # [E]
    w_txn: torch.Tensor  # [E]
    w_ts: torch.Tensor  # [E]
    # target-side write burst reassembly counter
    t_aww_left: torch.Tensor  # [E]
    t_aww_src: torch.Tensor  # [E]
    t_aww_txn: torch.Tensor  # [E]
    # memory request queue (circular) + server
    mq: torch.Tensor  # [E, Q, NMQ] packed requests
    mq_head: torch.Tensor  # [E] circular head
    mq_cnt: torch.Tensor  # [E]
    m_busy: torch.Tensor  # [E] service countdown
    m_beats: torch.Tensor  # [E] beats left of current response
    m_flit: torch.Tensor  # current response template [E, NF]
    m_active: torch.Tensor  # [E] bool
    hbm_tok: torch.Tensor  # [E] f32
    # egress queues (channel axis aligned with the fabric), circular
    eg: torch.Tensor  # [C, E, Q, NF]
    eg_ready: torch.Tensor  # [C, E, Q]
    eg_head: torch.Tensor  # [C, E]
    eg_cnt: torch.Tensor  # [C, E]
    # stats
    lat_sum: torch.Tensor  # [E] f32 narrow round-trip latency
    lat_cnt: torch.Tensor  # [E]
    beats_rcvd: torch.Tensor  # [E] wide payload beats received
    beats_sent: torch.Tensor  # [E]
    ni_stall: torch.Tensor  # [E] cycles a ready request was stalled by ordering
    eg_overflow: torch.Tensor  # [E] cycles req delivery waited on rsp egress
    hbm_served: torch.Tensor  # [E] beats served by this endpoint's memory
    n_sent: torch.Tensor  # [E]
    d_done: torch.Tensor  # [E, S] transfers fully completed
    last_rx: torch.Tensor  # [E] cycle of the most recent payload beat received
    first_rx: torch.Tensor  # [E] cycle of the first payload beat (-1)


# packed memory-queue layout (trailing axis, like flits)
MQ_FIELDS = ("src", "txn", "beats", "kind", "ts", "meta")
NMQ = len(MQ_FIELDS)
MQ_SRC, MQ_TXN, MQ_BEATS, MQ_KIND, MQ_TS, MQ_META = range(NMQ)


def init_endpoints(E: int, params: NocParams, streams: int,
                   device) -> EndpointState:
    """Zeroed EndpointState for E endpoints with ``streams`` DMA streams."""
    T, Q = params.n_txn_ids, params.memq_depth
    EQ = params.egress_depth
    C = params.n_channels
    dev = torch.device(device)
    z = lambda *s: torch.zeros(s, dtype=I32, device=dev)
    full = lambda s, v: torch.full(s, v, dtype=I32, device=dev)
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
    return EndpointState(
        ni_cnt=z(E, T), ni_dst=full((E, T), -1),
        rob_credit=full((E,), params.rob_beats),
        n_acc=f32(E), n_seq=z(E),
        d_txns_left=z(E, streams), d_outst=z(E, streams), d_seq=z(E, streams),
        d_beats_got=z(E, streams), rx_bursts=z(E, streams),
        w_stream=full((E,), -1), w_left=z(E), w_beats=z(E),
        w_dst=z(E), w_txn=z(E), w_ts=z(E),
        t_aww_left=z(E), t_aww_src=z(E), t_aww_txn=z(E),
        mq=z(E, Q, NMQ), mq_head=z(E), mq_cnt=z(E),
        m_busy=z(E), m_beats=z(E), m_flit=empty_flits((E,), device=dev),
        m_active=torch.zeros((E,), dtype=torch.bool, device=dev),
        hbm_tok=f32(E),
        eg=z(C, E, EQ, NF), eg_ready=z(C, E, EQ),
        eg_head=z(C, E), eg_cnt=z(C, E),
        lat_sum=f32(E), lat_cnt=z(E),
        beats_rcvd=z(E), beats_sent=z(E), ni_stall=z(E), eg_overflow=z(E),
        hbm_served=z(E),
        n_sent=z(E), d_done=z(E, streams),
        last_rx=z(E), first_rx=full((E,), -1),
    )


def _hash(a, b, c):
    """The reference's uint32 mixing hash, emulated in int64.

    PyTorch has no usable uint32 right shift, so every intermediate is kept
    in [0, 2**32) by masking after each multiply and add. The multipliers
    are taken modulo 2**32 into (-2**31, 2**31) so that no int64 product
    overflows; the low 32 bits are what the uint32 arithmetic keeps.
    """
    def u(x):
        return torch.as_tensor(x).to(torch.int64) & _M32

    a, b, c = u(a), u(b), u(c)
    h = (a * (2654435761 - 2**32)) & _M32
    h = (h + ((b * 40503) & _M32)) & _M32
    h = (h + ((c * 69069) & _M32)) & _M32
    h = (h + 12345) & _M32
    h = ((h ^ (h >> 13)) * 1274126177) & _M32
    h = h ^ (h >> 16)
    return (h & 0x7FFFFFFF).to(I32)


def _isum(x, dim):
    """Integer sum that stays int32 (torch would widen to int64)."""
    return x.sum(dim=dim, dtype=I32)


def _col_add(x, idx, delta):
    """``x[e, idx] += delta`` for every endpoint: x [E, K]; idx/delta
    [..., E] with the endpoint axis last (leading axes, e.g. channel,
    accumulate). A one-hot multiply-sum: exact integer math, no scatter."""
    K = x.shape[1]
    oh = torch.arange(K, device=x.device) == idx[..., None]
    contrib = torch.where(oh, delta[..., None].to(I32), 0)
    if contrib.dim() > 2:
        contrib = _isum(contrib, tuple(range(contrib.dim() - 2)))
    return x + contrib


def _pack_mq(src, txn, beats, kind, ts, meta) -> torch.Tensor:
    return broadcast_fields(src.to(I32), txn, beats, kind, ts, meta)


def _mq_push(mq, mq_head, mq_cnt, mask, src, txn, beats, kind, ts, meta,
             circular: bool = True):
    """Push one request per endpoint where ``mask`` [E]. mq: [E, Q, NMQ].

    ``circular=True`` (the fast step) writes the circular tail ``(head +
    cnt) % Q``. The reference drops the masked rows of a scatter; here
    every row writes exactly once (unique indices, so the write order
    cannot matter on any device): a masked row rewrites its own head slot
    with the value it already holds. ``circular=False`` (the naive step,
    head always 0) writes slot ``clip(cnt, 0, Q - 1)`` through a one-hot
    select, so on overflow it overwrites the newest slot where the circular
    push wraps onto the oldest; callers keep ``mq_cnt < Q``. The head
    never moves on a push.
    """
    E, Q = mq.shape[:2]
    vals = _pack_mq(src, txn, beats, kind, ts, meta)  # [E, NMQ]
    if not circular:
        q = torch.arange(Q, device=mq.device)
        onehot = (q == mq_cnt.clamp(0, Q - 1)[:, None]) & mask[:, None]
        mq = torch.where(onehot[..., None], vals[:, None, :], mq)
        return mq, mq_cnt + mask.to(I32)
    slot = torch.where(mask, torch.remainder(mq_head + mq_cnt, Q),
                       mq_head).long()
    e = torch.arange(E, device=mq.device)
    vals = torch.where(mask[:, None], vals, mq[e, slot])
    mq = mq.index_put((e, slot), vals)
    return mq, mq_cnt + mask.to(I32)


def _mq_push_multi(mq, mq_head, mq_cnt, mask, src, txn, beats, kind, ts,
                   meta, circular: bool = True):
    """Push up to one request per (channel, endpoint) where ``mask`` [C, E];
    same-endpoint pushes from different channels land in consecutive slots
    (channel order). All value args are [C, E] (or broadcastable scalars).

    Circular: the slots of one endpoint are distinct, so the write is a
    one-hot select: ``arange(Q) == slot`` is all false for a masked row
    (slot Q), as the reference's dropped scatter leaves it. Naive (head 0):
    slot ``clip(cnt + offset, 0, Q - 1)``; on overflow the clip aliases
    several channels onto slot Q - 1 and the highest channel's write is
    kept (last write wins, as sequential per-channel pushes).
    """
    Q = mq.shape[1]
    m = mask.to(I32)
    offset = torch.cumsum(m, dim=0, dtype=I32) - m  # lower-channel pushes
    vals = _pack_mq(src, txn, beats, kind, ts, meta)  # [C, E, NMQ]
    q = torch.arange(Q, device=mq.device)
    if not circular:
        idx = (mq_cnt[None] + offset).clamp(0, Q - 1)
        oh = (q == idx[..., None]) & mask[..., None]  # [C, E, Q]
        prio = torch.arange(mask.shape[0], device=mq.device)[:, None, None]
        winner = torch.where(oh, prio, -1).amax(dim=0)  # [E, Q]
        oh = oh & (winner[None] == prio)
    else:
        slot = torch.where(mask, torch.remainder(mq_head + mq_cnt + offset, Q), Q)
        oh = q == slot[..., None]  # [C, E, Q]
    contrib = _isum(torch.where(oh[..., None], vals[:, :, None, :], 0), 0)
    mq = torch.where(oh.any(dim=0)[..., None], contrib, mq)
    return mq, mq_cnt + _isum(m, 0)


def _mq_pop(mq, mq_head, mq_cnt, can_pop, circular: bool = True):
    """Peek + conditionally pop the head of every endpoint's memory queue.

    Returns ``(head_vals [E, NMQ], mq, mq_head, mq_cnt)``. The circular pop
    is a head advance (the buffer is untouched); the naive pop rolls the
    whole queue one slot toward the head (the old head lands in slot Q - 1).
    """
    Q = mq.shape[1]
    if not circular:
        head_vals = mq[:, 0]
        mq = torch.where(can_pop[:, None, None], torch.roll(mq, -1, dims=1), mq)
        return head_vals, mq, mq_head, mq_cnt - can_pop.to(I32)
    e = torch.arange(mq.shape[0], device=mq.device)
    head_vals = mq[e, mq_head.long()]
    mq_head = torch.remainder(mq_head + can_pop.to(I32), Q)
    return head_vals, mq, mq_head, mq_cnt - can_pop.to(I32)


def _eg_push(eg, eg_ready, eg_head, eg_cnt, ch, mask, flit, ready,
             circular: bool = True):
    """Push flit [E, NF] onto the egress queue of channel ``ch``, a static
    int or a per-endpoint [E] tensor (dynamic channel select).

    The slot is the circular tail ``(head + cnt) % Q``, or with
    ``circular=False`` (the naive step, head 0) ``clip(cnt, 0, Q - 1)``. A
    masked push goes to slot Q, whose one-hot row ``arange(Q) == Q`` is all
    false, so nothing is written (``one_hot`` would raise on it)."""
    C, E, Q = eg_ready.shape
    q = torch.arange(Q, device=eg.device)

    def tail(head, cnt):
        if circular:
            return torch.where(mask, torch.remainder(head + cnt, Q), Q)
        return torch.where(mask, cnt.clamp(0, Q - 1), Q)

    if isinstance(ch, int):
        # static channel: rewrite only the eg[ch] slice (the same cells as
        # the reference's one-hot over every channel)
        slot_oh = q == tail(eg_head[ch], eg_cnt[ch])[:, None]  # [E, Q]
        eg = eg.clone()
        eg[ch] = torch.where(slot_oh[..., None], flit[:, None, :], eg[ch])
        eg_ready = eg_ready.clone()
        eg_ready[ch] = torch.where(slot_oh, ready[:, None], eg_ready[ch])
        eg_cnt = eg_cnt.clone()
        eg_cnt[ch] += mask.to(I32)
        return eg, eg_ready, eg_cnt
    ch = ch.long().expand((E,))
    ch_oh = torch.arange(C, device=eg.device)[:, None] == ch  # [C, E]
    cnt_at = torch.gather(eg_cnt, 0, ch[None, :])[0]  # [E]
    head_at = torch.gather(eg_head, 0, ch[None, :])[0]
    m3 = ch_oh[:, :, None] & (q == tail(head_at, cnt_at)[:, None])[None]  # [C, E, Q]
    eg = torch.where(m3[..., None], flit[None, :, None, :], eg)
    eg_ready = torch.where(m3, ready[None, :, None], eg_ready)
    return eg, eg_ready, eg_cnt + (ch_oh & mask[None]).to(I32)


def _eg_peek(eg, eg_ready, eg_head, circular: bool = True):
    """Head flit + ready time of every (channel, endpoint) egress queue:
    ``(head [C, E, NF], ready_ts [C, E])`` (slot 0 for the naive queues)."""
    if not circular:
        return eg[:, :, 0, :], eg_ready[:, :, 0]
    h = eg_head.long()
    head = torch.gather(eg, 2, h[:, :, None, None].expand(*h.shape, 1, NF))[:, :, 0]
    ready = torch.gather(eg_ready, 2, h[:, :, None])[:, :, 0]
    return head, ready


def _eg_pop(eg, eg_ready, eg_head, eg_cnt, mask, circular: bool = True):
    """Pop the head of every (channel, endpoint) queue where mask [C, E]: a
    head advance, or with ``circular=False`` a roll of the queue."""
    if not circular:
        eg = torch.where(mask[..., None, None], torch.roll(eg, -1, dims=2), eg)
        eg_ready = torch.where(mask[..., None], torch.roll(eg_ready, -1, dims=2),
                               eg_ready)
        return eg, eg_ready, eg_head, eg_cnt - mask.to(I32)
    Q = eg_ready.shape[-1]
    eg_head = torch.remainder(eg_head + mask.to(I32), Q)
    return eg, eg_ready, eg_head, eg_cnt - mask.to(I32)


def _ni_check(st: EndpointState, txn, dst, params: NocParams, beats):
    """RoB-less / RoB admission check. txn, dst, beats: [E] or [E, S]."""
    E = st.ni_cnt.shape[0]
    if params.ni_order == "robless":
        eidx = torch.arange(E, device=txn.device).reshape((E,) + (1,) * (txn.dim() - 1))
        cnt = st.ni_cnt[eidx, txn.long()]
        last = st.ni_dst[eidx, txn.long()]
        return (cnt == 0) | (last == dst)
    rob = st.rob_credit.reshape((E,) + (1,) * (txn.dim() - 1))
    return rob >= beats  # rob: end-to-end credit flow control


def _ni_issue(st: EndpointState, mask, txn, dst, beats, params: NocParams):
    """Record issued requests in the NI trackers: ``(ni_cnt, ni_dst, rob)``."""
    ni_cnt = _col_add(st.ni_cnt, txn, mask.to(I32))
    oh = (torch.arange(st.ni_dst.shape[1], device=txn.device) == txn[:, None]) & mask[:, None]
    ni_dst = torch.where(oh, dst[:, None].to(I32), st.ni_dst)
    if params.ni_order == "rob":
        rob = st.rob_credit - torch.where(mask, beats, 0).to(I32)
    else:
        rob = st.rob_credit
    return ni_cnt, ni_dst, rob


def _ni_retire(ni_cnt, ni_dst, rob_credit, mask, txn, beats, params: NocParams):
    """Retire completions. mask/txn: [..., E]-shaped with the endpoint axis
    last (leading axes, e.g. channel, are summed)."""
    ni_cnt = _col_add(ni_cnt, txn, -mask.to(I32))
    if params.ni_order == "rob":
        beats = torch.as_tensor(beats, dtype=I32, device=mask.device).expand(txn.shape)
        credit = torch.where(mask, beats, 0)
        lead = tuple(range(txn.dim() - 1))
        rob_credit = rob_credit + (_isum(credit, lead) if lead else credit)
    return ni_cnt, ni_dst, rob_credit
