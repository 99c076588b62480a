"""Full-system FlooNoC simulator in PyTorch: a channel-batched fabric (req /
rsp / wide plus optional extra wide channels) + vectorized endpoints,
stepped cycle by cycle from Python.

The PyTorch counterpart of ``repro.core.noc.sim``, with both of its step
implementations: ``step_impl="fast"`` (circular queues, fused FIFO
updates) and ``"naive"``, the roll-based reference (two-step FIFO pop then
push, the apply kernel's unfused mode on the card; queues whose head stays
at slot 0, per-channel memory-queue pushes, one dynamic-channel egress
push in the memory server). The per-cycle body contains no Python loop
over channels or endpoints. The router cycle runs on the device's kernels
(``ops.router_cycle``, or ``ops.router_cycles_fused`` for a ``fused_cycles
> 1`` super-step, fast step only); the endpoint phases are plain tensor
code. ``run`` keeps the cycle number a
Python int, so stepping never waits on the device.

``run_sweep`` steps B workloads of one fabric as one state: the fabric's
channel axis holds C x B channels (channel-major: fabric channel
``c * B + b`` is channel ``c`` of configuration ``b``, over the shared
tables, so the router kernels launch once per cycle whatever B is) and
the endpoint axis B x E rows (row ``b * E + e`` is endpoint ``e`` of
configuration ``b``). So the fabric's ``[C*B, E, ...]`` and the endpoint
phases' ``[C, B*E, ...]`` are one memory layout. A Sim's own workload is
the batch of one.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.noc import endpoints as epm
from repro_torch.core.noc import engine as eng
from repro_torch.core.noc.engine import (
    F_KIND,
    F_LAST,
    F_META,
    F_SRC,
    F_TS,
    F_TXN,
)
from repro_torch.core.noc.params import (
    CH_REQ,
    CH_RSP,
    CH_WIDE,
    NARROW_REQ,
    NARROW_RSP,
    WIDE_AR,
    WIDE_AW_W,
    WIDE_B,
    WIDE_MC,
    WIDE_R,
    WIDE_RED,
    NocParams,
    wide_channel_of,
)
from repro_torch.core.noc.topology import Topology
from repro_torch.device import resolve_device

I32 = torch.int32

@dataclass
class SimState:
    """Full simulator state: fabric + endpoints + the cycle counter (a 0-d
    int32 tensor)."""

    fabric: eng.FabricState  # channel-batched [C, ...]
    eps: epm.EndpointState
    cycle: torch.Tensor


def _full(E, value, device):
    return torch.full((E,), value, dtype=I32, device=device)


def _ingest(st: epm.EndpointState, flits, valid, cycle: int,
            params: NocParams, eidx):
    """Process delivered flits on all channels at once.

    flits: [C, E, NF]; valid: [C, E]; ``eidx`` [E] each row's endpoint
    index within its configuration. Narrow requests / responses ride their
    role channels (CH_REQ / CH_RSP); wide kinds are recognized by kind on any
    wide channel, so counters are summed over the channel axis."""
    E = st.lat_sum.shape[0]
    dev = flits.device
    circ = params.fast
    kind = flits[..., F_KIND]  # [C, E]

    # ---- req channel: we are the target ----
    f = flits[CH_REQ]
    v = valid[CH_REQ]
    is_nreq = v & (f[:, F_KIND] == NARROW_REQ)
    is_war = v & (f[:, F_KIND] == WIDE_AR)
    rsp_flit = eng.pack_flit(f[:, F_SRC], eidx, NARROW_RSP, f[:, F_TXN], 1,
                             f[:, F_TS], 1)
    rsp_ready = _full(E, cycle + params.ni_rsp_lat + params.mem_lat
                      + params.ni_req_lat, dev)
    # the req-channel delivery is gated on rsp-egress space upstream (see
    # Sim.step), so this push can never overflow the queue
    eg, eg_ready, eg_cnt = epm._eg_push(st.eg, st.eg_ready, st.eg_head,
                                        st.eg_cnt, CH_RSP, is_nreq, rsp_flit,
                                        rsp_ready, circular=circ)
    mq, mq_cnt = epm._mq_push(st.mq, st.mq_head, st.mq_cnt, is_war,
                              f[:, F_SRC], f[:, F_TXN], f[:, F_META], WIDE_R,
                              f[:, F_TS], f[:, F_META], circular=circ)

    # ---- wide kinds (any channel) ----
    S = st.d_outst.shape[1]  # streams
    stream = flits[..., F_TXN].clamp(0, S - 1)
    is_r = valid & (kind == WIDE_R)
    d_beats_got = epm._col_add(st.d_beats_got, stream, is_r.to(I32))
    r_done = is_r & (flits[..., F_LAST] > 0)
    d_outst = epm._col_add(st.d_outst, stream, -r_done.to(I32))
    d_done = epm._col_add(st.d_done, stream, r_done.to(I32))
    # write bursts arriving (we are the target); wormhole => no interleave
    is_w = valid & (kind == WIDE_AW_W)
    rcvd = is_r | is_w
    if params.collective_offload:
        # in-fabric collective payloads (tree-forked multicast beats and
        # combined reduction partials) are posted writes: they count as
        # received beats and complete bursts, but neither enqueue a memory
        # response nor touch the issuer-side NI
        is_off = valid & ((kind == WIDE_MC) | (kind == WIDE_RED))
        rcvd = rcvd | is_off
        off_tail = is_off & (flits[..., F_LAST] > 0)
    beats_rcvd = st.beats_rcvd + epm._isum(rcvd, 0)
    any_beat = rcvd.any(dim=0)
    cyc_e = _full(E, cycle, dev)
    last_rx = torch.where(any_beat, cyc_e, st.last_rx)
    first_rx = torch.where(any_beat & (st.first_rx < 0), cyc_e, st.first_rx)
    w_tail = is_w & (flits[..., F_LAST] > 0)
    if circ and params.n_channels == 3:
        # single wide channel: AW_W beats only ever ride CH_WIDE, so the
        # per-channel push collapses to a single-channel push (same cells;
        # the naive step keeps the per-channel push, as the reference does)
        fw = flits[CH_WIDE]
        mq, mq_cnt = epm._mq_push(mq, st.mq_head, mq_cnt, w_tail[CH_WIDE],
                                  fw[:, F_SRC], fw[:, F_TXN], 1, WIDE_B,
                                  fw[:, F_TS], fw[:, F_META])
    else:
        mq, mq_cnt = epm._mq_push_multi(mq, st.mq_head, mq_cnt, w_tail,
                                        flits[..., F_SRC], flits[..., F_TXN],
                                        1, WIDE_B, flits[..., F_TS],
                                        flits[..., F_META], circular=circ)
    # completed write bursts per stream (the scheduled DMA's gate signal);
    # offloaded collective tails count too (a root gates its multicast on
    # the in-fabric reduction arriving)
    burst_tail = w_tail | off_tail if params.collective_offload else w_tail
    rx_bursts = epm._col_add(st.rx_bursts, stream, burst_tail.to(I32))

    # ---- rsp channel ----
    f = flits[CH_RSP]
    v = valid[CH_RSP]
    is_nrsp = v & (f[:, F_KIND] == NARROW_RSP)
    rx_const = params.cluster_rsp_lat
    lat_sum = st.lat_sum + torch.where(
        is_nrsp, (cycle - f[:, F_TS] + rx_const).to(torch.float32), 0.0)
    lat_cnt = st.lat_cnt + is_nrsp.to(I32)
    is_b = v & (f[:, F_KIND] == WIDE_B)
    stream_b = f[:, F_TXN].clamp(0, S - 1)
    d_outst = epm._col_add(d_outst, stream_b, -is_b.to(I32))
    d_done = epm._col_add(d_done, stream_b, is_b.to(I32))
    # the three retirements (wide-R tails on any channel, narrow and B
    # responses on CH_RSP) have disjoint masks and only add into ni_cnt /
    # rob_credit, so one combined retire is exact: the naive step's three
    # sequential calls make the same integer sums. B responses and read
    # tails carry the issued beat count in F_META (exact RoB credits).
    rsp_row = (torch.arange(params.n_channels, device=dev) == CH_RSP)[:, None]
    m_all = r_done | (rsp_row & (is_nrsp | is_b)[None])
    beats_all = (torch.where(r_done, flits[..., F_META], 0)
                 + (rsp_row & is_nrsp[None]).to(I32)
                 + torch.where(rsp_row & is_b[None], f[None, :, F_META], 0))
    ni_cnt, ni_dst, rob = epm._ni_retire(st.ni_cnt, st.ni_dst, st.rob_credit,
                                         m_all, flits[..., F_TXN], beats_all,
                                         params)

    return dataclasses.replace(
        st, ni_cnt=ni_cnt, ni_dst=ni_dst, rob_credit=rob, mq=mq, mq_cnt=mq_cnt,
        d_beats_got=d_beats_got, rx_bursts=rx_bursts, beats_rcvd=beats_rcvd,
        d_outst=d_outst, d_done=d_done, lat_sum=lat_sum, lat_cnt=lat_cnt,
        last_rx=last_rx, first_rx=first_rx, eg=eg, eg_ready=eg_ready,
        eg_cnt=eg_cnt,
    )


@dataclass(frozen=True)
class WorkloadTensors:
    """The array fields of B workloads of one fabric as device tensors
    (made once), with the per-row constants the endpoint phases read.

    Row ``b * E + e`` is endpoint ``e`` of configuration ``b``; a Sim's own
    workload is B = 1. ``dma_beats`` and ``dma_txns``, a scalar and the
    initial ``d_txns_left`` of a Workload, are per-row tensors here, so a
    sweep over transfer sizes batches them like the other fields."""

    narrow_rate: torch.Tensor  # [B*E] f32
    narrow_dst: torch.Tensor  # [B*E] i32
    dma_dst: torch.Tensor  # [B*E, S] i32
    dma_alt_dst: torch.Tensor  # [B*E, S] i32
    dma_txns: torch.Tensor  # [B*E, S] i32
    dma_beats: torch.Tensor  # [B*E, 1] i32 beats per (unscheduled) transfer
    dma_dst_seq: torch.Tensor | None  # [B*E, S, K] i32
    dma_gate: torch.Tensor | None
    dma_beats_seq: torch.Tensor | None
    eidx: torch.Tensor  # [B*E] i32 endpoint index within the configuration
    is_hbm: torch.Tensor  # [B*E] bool
    is_mem: torch.Tensor  # [B*E] bool
    n_endpoints: int  # E

    @property
    def batch(self) -> int:
        """B, the number of configurations."""
        return self.eidx.shape[0] // self.n_endpoints

    @classmethod
    def stack(cls, wls: list[epm.Workload], topo: Topology,
              device) -> "WorkloadTensors":
        """The rows of ``wls`` (workloads of ``topo``) on ``device``, with
        ``topo``'s HBM / memory maps."""
        B, E = len(wls), topo.n_endpoints
        is_hbm = np.zeros((E,), bool)
        n_hbm = topo.meta.get("n_hbm", 0)
        if n_hbm:
            is_hbm[E - n_hbm:] = True
        is_mem = np.ones((E,), bool)  # every endpoint can serve (tiles: SPM)

        def rows(f, dtype):
            vals = [getattr(w, f) for w in wls]
            if vals[0] is None:
                return None
            return torch.as_tensor(np.concatenate(
                [np.asarray(v, dtype) for v in vals]), device=device)

        beats = np.repeat(np.array([w.dma_beats for w in wls], np.int32), E)
        tile = lambda a: torch.as_tensor(np.tile(a, B), device=device)
        return cls(
            narrow_rate=rows("narrow_rate", np.float32),
            narrow_dst=rows("narrow_dst", np.int32),
            dma_dst=rows("dma_dst", np.int32),
            dma_alt_dst=rows("dma_alt_dst", np.int32),
            dma_txns=rows("dma_txns", np.int32),
            dma_beats=torch.as_tensor(beats[:, None], device=device),
            dma_dst_seq=rows("dma_dst_seq", np.int32),
            dma_gate=rows("dma_gate", np.int32),
            dma_beats_seq=rows("dma_beats_seq", np.int32),
            eidx=torch.as_tensor(np.tile(np.arange(E, dtype=np.int32), B),
                                 device=device),
            is_hbm=tile(is_hbm), is_mem=tile(is_mem), n_endpoints=E)


def _generators(st: epm.EndpointState, cycle: int, params: NocParams,
                wl: epm.Workload, wt: WorkloadTensors):
    """Narrow + DMA request generation into egress queues. ``wl`` gives the
    static attributes, ``wt`` the rows' arrays."""
    E = wt.n_endpoints  # per configuration: the group-address base
    n_rows = st.lat_sum.shape[0]
    dev = st.lat_sum.device
    circ = params.fast
    eidx = wt.eidx
    eg, eg_ready, eg_cnt = st.eg, st.eg_ready, st.eg_cnt
    EQ = eg_ready.shape[-1]
    T = st.ni_cnt.shape[1]
    n_tiles = wl.n_tiles
    src_delay = params.cluster_req_lat + params.ni_req_lat

    # ---- narrow generator ----
    n_acc = st.n_acc + wt.narrow_rate
    want_n = (n_acc >= 1.0) & (wt.narrow_dst != -1)
    dst_n = torch.where(wt.narrow_dst == -2,
                        _uniform_dst(eidx, st.n_seq, n_tiles),
                        wt.narrow_dst).to(I32)
    txn_n = torch.remainder(st.n_seq, T)
    ones = torch.ones((n_rows,), dtype=I32, device=dev)
    ok_n = epm._ni_check(st, txn_n, dst_n, params, ones)
    space_n = eg_cnt[CH_REQ] < EQ
    fire_n = want_n & ok_n & space_n
    stall_n = want_n & ~ok_n
    flit_n = eng.pack_flit(dst_n, eidx, NARROW_REQ, txn_n, 1, cycle, 1)
    eg, eg_ready, eg_cnt = epm._eg_push(
        eg, eg_ready, st.eg_head, eg_cnt, CH_REQ, fire_n, flit_n,
        _full(n_rows, cycle + src_delay, dev), circular=circ)
    ni_cnt, ni_dst, rob = epm._ni_issue(st, fire_n, txn_n, dst_n, ones,
                                        params)
    n_acc = torch.where(fire_n, n_acc - 1.0, n_acc.clamp(max=4.0))
    n_seq = st.n_seq + fire_n.to(I32)
    n_sent = st.n_sent + fire_n.to(I32)

    # ---- DMA: pick one eligible stream per endpoint (rotating priority) ----
    S = st.d_outst.shape[1]
    s_idx = torch.arange(S, dtype=I32, device=dev)
    if wl.unique_txn_per_stream:
        txn_of_stream = torch.remainder(s_idx, T)[None, :].expand(n_rows, S)
    else:
        txn_of_stream = torch.zeros((n_rows, S), dtype=I32, device=dev)
    if wt.dma_dst_seq is not None:
        # scheduled multi-phase DMA: destination, beats and receive gate
        # are looked up per issue index
        k = st.d_seq.clamp(0, wt.dma_dst_seq.shape[-1] - 1).long()[:, :, None]
        at_k = lambda a: torch.gather(a, 2, k)[..., 0]
        dst_es = at_k(wt.dma_dst_seq)
        beats = at_k(wt.dma_beats_seq)
        gate_ok = st.rx_bursts >= at_k(wt.dma_gate)
        enabled = dst_es != -1
    else:
        # per-(e, s) desired destination for the *next* transfer
        odd = torch.remainder(st.d_seq, 2) == 1
        dst_es = torch.where((wt.dma_alt_dst >= 0) & odd, wt.dma_alt_dst,
                             wt.dma_dst)
        dst_es = torch.where(
            wt.dma_dst == -2,
            _uniform_dst(eidx[:, None], st.d_seq * S + s_idx[None, :],
                         n_tiles),
            dst_es).to(I32)
        beats = wt.dma_beats.expand(n_rows, S)
        gate_ok = torch.ones((n_rows, S), dtype=torch.bool, device=dev)
        enabled = wt.dma_dst != -1
    st_tmp = dataclasses.replace(st, ni_cnt=ni_cnt, ni_dst=ni_dst,
                                 rob_credit=rob)
    ok_es = epm._ni_check(st_tmp, txn_of_stream, dst_es, params, beats)
    n_off = wl.n_groups
    if n_off:
        # group-addressed transfers (dst >= E: offloaded multicast in
        # [E, E+G), reduction contributions in [E+G, E+2G)) are posted
        # writes: no response returns, so they bypass the NI/RoB check
        ok_es = ok_es | (dst_es >= E)
    want_es = ((st.d_txns_left > 0) & (st.d_outst < params.max_outstanding)
               & enabled & gate_ok)
    elig = want_es & ok_es
    if n_off:
        # static lowest-stream-first pick under collective offload: the
        # in-fabric reduction consumes the streams' bursts beat-aligned per
        # group, so every contributor drains its streams in one global
        # order (a rotating pick can close a circular wait through the
        # shared write serializer)
        score = torch.where(elig, s_idx[None, :], S + 1)
    else:
        rot = torch.remainder(s_idx[None, :] - (cycle + eidx[:, None]), S)
        score = torch.where(elig, rot, S + 1)
    # argmin ties go to the first index: rank by (score, stream) so the
    # minimum is unique on every device
    pick = (score * S + s_idx).argmin(dim=1)
    best = torch.gather(score, 1, pick[:, None])[:, 0]
    any_pick = best <= S
    stall_d = (want_es & ~ok_es).any(dim=1) & ~any_pick

    e64 = torch.arange(n_rows, device=dev)
    pick_dst = dst_es[e64, pick]
    pick_txn = txn_of_stream[e64, pick]
    pick_beats = beats[e64, pick]
    pick32 = pick.to(I32)

    if not wl.dma_write:
        space_r = eg_cnt[CH_REQ] < EQ
        fire_d = any_pick & space_r
        flit_ar = eng.pack_flit(pick_dst, eidx, WIDE_AR, pick_txn, 1, cycle,
                                pick_beats)
        eg, eg_ready, eg_cnt = epm._eg_push(
            eg, eg_ready, st.eg_head, eg_cnt, CH_REQ, fire_d, flit_ar,
            _full(n_rows, cycle + src_delay, dev), circular=circ)
        w_stream, w_left, w_beats, w_dst, w_txn, w_ts = (
            st.w_stream, st.w_left, st.w_beats, st.w_dst, st.w_txn, st.w_ts)
    else:
        # claim the write serializer
        fire_d = any_pick & (st.w_stream < 0)
        w_stream = torch.where(fire_d, pick32, st.w_stream)
        w_left = torch.where(fire_d, pick_beats, st.w_left)
        w_beats = torch.where(fire_d, pick_beats, st.w_beats)
        w_dst = torch.where(fire_d, pick_dst, st.w_dst)
        w_txn = torch.where(fire_d, pick_txn, st.w_txn)
        w_ts = torch.where(fire_d, _full(n_rows, cycle, dev), st.w_ts)

    d_done = st.d_done
    if n_off:
        # posted group-addressed transfers hold no NI slot and are never
        # outstanding (nothing retires them): they count done at issue
        pick_off = fire_d & (pick_dst >= E)
        fire_ni = fire_d & ~pick_off
        d_done = epm._col_add(d_done, pick, pick_off.to(I32))
    else:
        fire_ni = fire_d
    ni_cnt, ni_dst, rob = epm._ni_issue(st_tmp, fire_ni, pick_txn, pick_dst,
                                        pick_beats, params)
    d_txns_left = epm._col_add(st.d_txns_left, pick, -fire_d.to(I32))
    d_outst = epm._col_add(st.d_outst, pick, fire_ni.to(I32))
    d_seq = epm._col_add(st.d_seq, pick, fire_d.to(I32))

    # ---- write burst serializer: one AW_W beat per cycle ----
    beats_sent = st.beats_sent
    if wl.dma_write:
        active = w_stream >= 0
        if circ and params.n_channels == 3:
            wch = CH_WIDE  # single wide channel: static-channel push
            space_w = eg_cnt[CH_WIDE] < EQ
        else:
            wch = wide_channel_of(w_txn.clamp(min=0), params.n_channels)
            space_w = torch.gather(eg_cnt, 0, wch.long()[None, :])[0] < EQ
        emit = active & space_w
        last = torch.where(emit, (w_left == 1).to(I32), 0)
        # META carries the burst's TOTAL beats so the target can echo it in
        # the B response (exact retirement credit at the issuer)
        if n_off:
            # decode the group-address range at emission: reduction
            # contributions rewrite dst to the group address [E, E+G) that
            # the in-fabric ALU emits toward the root; multicast beats keep it
            is_red_w = w_dst >= E + n_off
            kind_w = torch.where(is_red_w, WIDE_RED,
                                 torch.where(w_dst >= E, WIDE_MC, WIDE_AW_W))
            flit_w = eng.pack_flit(torch.where(is_red_w, w_dst - n_off, w_dst),
                                   eidx, kind_w, w_txn, last, w_ts, w_beats)
        else:
            flit_w = eng.pack_flit(w_dst, eidx, WIDE_AW_W, w_txn, last, w_ts,
                                   w_beats)
        eg, eg_ready, eg_cnt = epm._eg_push(
            eg, eg_ready, st.eg_head, eg_cnt, wch, emit, flit_w,
            _full(n_rows, cycle + 1, dev), circular=circ)
        beats_sent = beats_sent + emit.to(I32)
        w_left = torch.where(emit, w_left - 1, w_left)
        done_w = emit & (w_left == 0)
        w_stream = torch.where(done_w, -1, w_stream)

    ni_stall = st.ni_stall + stall_n.to(I32) + stall_d.to(I32)
    return dataclasses.replace(
        st, eg=eg, eg_ready=eg_ready, eg_cnt=eg_cnt, ni_cnt=ni_cnt,
        ni_dst=ni_dst, rob_credit=rob, n_acc=n_acc, n_seq=n_seq,
        n_sent=n_sent, d_txns_left=d_txns_left, d_outst=d_outst, d_seq=d_seq,
        d_done=d_done, w_stream=w_stream, w_left=w_left, w_beats=w_beats,
        w_dst=w_dst, w_txn=w_txn, w_ts=w_ts, beats_sent=beats_sent,
        ni_stall=ni_stall,
    )


def _uniform_dst(e, seq, n_tiles: int):
    """Pseudo-random destination tile other than ``e`` (hash of e, seq)."""
    h = epm._hash(e, seq, 0)
    other = torch.remainder(h, max(n_tiles - 1, 1))
    return torch.remainder(e + 1 + other, n_tiles).to(I32)


def _memory(st: epm.EndpointState, cycle: int, params: NocParams,
            wt: WorkloadTensors):
    """Memory server: pop requests, serve after latency, emit response beats
    (``wt``: the rows' endpoint indices and HBM / memory maps)."""
    E = st.lat_sum.shape[0]
    dev = st.lat_sum.device
    eidx, is_hbm, is_mem = wt.eidx, wt.is_hbm, wt.is_mem
    EQ = st.eg_ready.shape[-1]
    circ = params.fast

    # the refill is one float32 value, as JAX's weak-typed scalar becomes
    refill = float(np.float32(params.hbm_rate * params.hbm_eff))
    hbm_tok = torch.where(is_hbm, (st.hbm_tok + refill).clamp(max=8.0),
                          torch.ones_like(st.hbm_tok))

    m_busy = (st.m_busy - 1).clamp(min=0)
    # pop next request when idle
    can_pop = ~st.m_active & (st.mq_cnt > 0) & is_mem
    head, mq, mq_head, mq_cnt = epm._mq_pop(st.mq, st.mq_head, st.mq_cnt,
                                            can_pop, circular=circ)
    m_active = st.m_active | can_pop
    m_busy = torch.where(can_pop, params.mem_lat + params.ni_rsp_lat, m_busy)
    m_beats = torch.where(can_pop, head[:, epm.MQ_BEATS], st.m_beats)
    # response template META = the original transfer size (MQ_META)
    new_flit = eng.pack_flit(head[:, epm.MQ_SRC], eidx, head[:, epm.MQ_KIND],
                             head[:, epm.MQ_TXN], 0, head[:, epm.MQ_TS],
                             head[:, epm.MQ_META])
    m_flit = torch.where(can_pop[:, None], new_flit, st.m_flit)

    # emit a beat when serving (wide reads stripe over the wide channels by
    # TxnID, B responses ride rsp)
    is_wide_r = m_flit[:, F_KIND] == WIDE_R
    wch = wide_channel_of(m_flit[:, F_TXN].clamp(min=0), params.n_channels)
    ch_of_kind = torch.where(is_wide_r, wch, CH_RSP)
    tok_ok = torch.where(is_hbm & is_wide_r, hbm_tok >= 1.0, True)
    space = torch.gather(st.eg_cnt, 0, ch_of_kind.long()[None, :])[0] < EQ
    emit = m_active & (m_busy == 0) & tok_ok & space & (m_beats > 0)
    out = m_flit.clone()
    out[:, F_LAST] = (m_beats == 1).to(I32)
    ready = _full(E, cycle + params.ni_req_lat, dev)

    if circ:
        # two legs (wide read beats / B responses on CH_RSP): disjoint masks
        # per endpoint, so the writes commute; with 3 channels both are
        # static
        wide_ch = CH_WIDE if params.n_channels == 3 else wch
        eg, eg_ready, eg_cnt = epm._eg_push(
            st.eg, st.eg_ready, st.eg_head, st.eg_cnt, wide_ch,
            emit & is_wide_r, out, ready)
        eg, eg_ready, eg_cnt = epm._eg_push(
            eg, eg_ready, st.eg_head, eg_cnt, CH_RSP, emit & ~is_wide_r, out,
            ready)
    else:
        # the reference's one push on the per-endpoint channel
        eg, eg_ready, eg_cnt = epm._eg_push(
            st.eg, st.eg_ready, st.eg_head, st.eg_cnt, ch_of_kind, emit, out,
            ready, circular=False)

    hbm_tok = torch.where(is_hbm & emit & is_wide_r, hbm_tok - 1.0, hbm_tok)
    hbm_served = st.hbm_served + (emit & is_hbm & is_wide_r).to(I32)
    m_beats = torch.where(emit, m_beats - 1, m_beats)
    m_active = m_active & ~(emit & (m_beats == 0))

    return dataclasses.replace(
        st, mq=mq, mq_head=mq_head, mq_cnt=mq_cnt, m_busy=m_busy,
        m_beats=m_beats, m_flit=m_flit, m_active=m_active, hbm_tok=hbm_tok,
        hbm_served=hbm_served, eg=eg, eg_ready=eg_ready, eg_cnt=eg_cnt,
    )


@dataclass
class Sim:
    """A built simulator: topology + params + workload + derived tables,
    all on one device."""

    topo: Topology
    params: NocParams
    wl: epm.Workload
    tables: eng.FabricTables
    wt: WorkloadTensors
    device: torch.device

    def init_state(self, wt: WorkloadTensors | None = None) -> SimState:
        """Fresh SimState at cycle 0 on the sim's device: of the sim's own
        workload, or of the B configurations of ``wt`` (``C * B`` fabric
        channels and ``B * E`` endpoint rows)."""
        wt = self.wt if wt is None else wt
        B = wt.batch
        fabric = eng.init_fabric(self.topo, self.params.depth_in,
                                 self.params.depth_out,
                                 B * self.params.n_channels, self.params.n_vcs,
                                 n_groups=self.tables.n_groups,
                                 device=self.device)
        eps = epm.init_endpoints(B * self.topo.n_endpoints, self.params,
                                 self.wl.n_streams, self.device)
        eps = dataclasses.replace(eps, d_txns_left=wt.dma_txns.clone())
        return SimState(fabric=fabric, eps=eps,
                        cycle=torch.zeros((), dtype=I32, device=self.device))

    @torch.no_grad()
    def step(self, st: SimState, cycle: int | None = None,
             wt: WorkloadTensors | None = None):
        """One simulated cycle. ``cycle`` is ``st.cycle`` as a Python int
        (read from the state, with a device sync, when omitted); ``wt`` the
        batch of workloads ``st`` holds (the sim's own by default). Returns
        ``(state', (ep_flit [C, B*E, NF], ep_valid [C, B*E]))``."""
        if cycle is None:
            cycle = int(st.cycle)
        wt = self.wt if wt is None else wt
        fast = self.params.fast
        B = wt.batch
        E = self.topo.n_endpoints
        C = self.params.n_channels
        EQ = st.eps.eg_ready.shape[-1]
        # 1) fabric cycle, all channels of all configurations at once. A
        #    delivered narrow request pushes its response into the CH_RSP
        #    egress queue, so req-channel delivery is held while that queue
        #    is full.
        rsp_free = st.eps.eg_cnt[CH_RSP] < EQ
        space = torch.ones((C, B * E), dtype=torch.bool, device=self.device)
        space[CH_REQ] = rsp_free
        er = self.tables.ep_attach[:, 0].long()
        ep_p = self.tables.ep_attach[:, 1].long()
        out_cnt = st.fabric.out_cnt.unflatten(0, (C, B))
        req_waiting = out_cnt[CH_REQ][:, er, ep_p].reshape(B * E) > 0
        # [C*B, E, ...] and [C, B*E, ...] are views of one another
        fabric, ep_flit, ep_valid = eng.fabric_cycle(
            st.fabric, self.tables, space.view(C * B, E), fused_fifo=fast)
        ep_flit = ep_flit.reshape(C, B * E, *ep_flit.shape[2:])
        ep_valid = ep_valid.reshape(C, B * E)
        # 2) endpoint processing
        eps = _ingest(st.eps, ep_flit, ep_valid, cycle, self.params, wt.eidx)
        eps = dataclasses.replace(
            eps, eg_overflow=eps.eg_overflow
            + (req_waiting & ~rsp_free).to(I32))
        eps = _generators(eps, cycle, self.params, self.wl, wt)
        eps = _memory(eps, cycle, self.params, wt)
        # 3) egress -> injection: every channel's head whose ready time came
        head, ready_ts = epm._eg_peek(eps.eg, eps.eg_ready, eps.eg_head,
                                      circular=fast)
        ready = (eps.eg_cnt > 0) & (ready_ts <= cycle)  # [C, B*E]
        fabric, accepted = eng.inject(
            fabric, self.tables, head.reshape(C * B, E, *head.shape[2:]),
            ready.reshape(C * B, E))
        eg, eg_ready, eg_head, eg_cnt = epm._eg_pop(
            eps.eg, eps.eg_ready, eps.eg_head, eps.eg_cnt,
            accepted.reshape(C, B * E), circular=fast)
        eps = dataclasses.replace(eps, eg=eg, eg_ready=eg_ready,
                                  eg_head=eg_head, eg_cnt=eg_cnt)
        return (SimState(fabric=fabric, eps=eps, cycle=st.cycle + 1),
                (ep_flit, ep_valid))

    @torch.no_grad()
    def step_super(self, st: SimState, cycle: int | None = None):
        """One super-step: ``params.fused_cycles`` = k cycles per fabric
        call.

        The fabric advances k cycles through ``eng.fabric_cycles_fused``
        (one fused kernel launch on the card), recording per-cycle
        deliveries; the endpoint phases then replay those k cycles in order
        against their true cycle numbers, and the final egress injection
        closes the window. A k=1 super-step equals :meth:`step`. For k>1
        the req-channel backpressure mask is sampled at the window start
        and held, and an egress flit pushed during the window becomes
        injectable only at the window's close, as in the JAX package.
        ``cycle`` is ``st.cycle`` as a Python int (read from the state when
        omitted). Requires ``step_impl="fast"`` (the circular egress queues
        are threaded through the fused window). Returns ``(state', (ep_flit
        [k, C, E, NF], ep_valid [k, C, E]))``.
        """
        if not self.params.fast:
            raise ValueError("step_super requires step_impl='fast'")
        if cycle is None:
            cycle = int(st.cycle)
        k = self.params.fused_cycles
        E = self.topo.n_endpoints
        C = self.params.n_channels
        EQ = st.eps.eg_ready.shape[-1]
        rsp_free = st.eps.eg_cnt[CH_RSP] < EQ
        space = torch.ones((C, E), dtype=torch.bool, device=self.device)
        space[CH_REQ] = rsp_free
        (fabric, eg, eg_ready, eg_head, eg_cnt, dF, dV, dW) = (
            eng.fabric_cycles_fused(
                st.fabric, self.tables, space, st.eps.eg, st.eps.eg_ready,
                st.eps.eg_head, st.eps.eg_cnt, cycle, k))
        eps = dataclasses.replace(st.eps, eg=eg, eg_ready=eg_ready,
                                  eg_head=eg_head, eg_cnt=eg_cnt)
        # [C, k, ...] -> [k, C, ...] for the per-cycle endpoint replay
        dF, dV, dW = (x.transpose(0, 1) for x in (dF, dV, dW))
        for j in range(k):
            eps = _ingest(eps, dF[j], dV[j], cycle + j, self.params,
                          self.wt.eidx)
            eps = dataclasses.replace(
                eps, eg_overflow=eps.eg_overflow
                + (dW[j, CH_REQ] & ~rsp_free).to(I32))
            eps = _generators(eps, cycle + j, self.params, self.wl, self.wt)
            eps = _memory(eps, cycle + j, self.params, self.wt)
        head, ready_ts = epm._eg_peek(eps.eg, eps.eg_ready, eps.eg_head)
        ready = (eps.eg_cnt > 0) & (ready_ts <= cycle + (k - 1))
        fabric, accepted = eng.inject(fabric, self.tables, head, ready)
        eg, eg_ready, eg_head, eg_cnt = epm._eg_pop(
            eps.eg, eps.eg_ready, eps.eg_head, eps.eg_cnt, accepted)
        eps = dataclasses.replace(eps, eg=eg, eg_ready=eg_ready,
                                  eg_head=eg_head, eg_cnt=eg_cnt)
        return (SimState(fabric=fabric, eps=eps, cycle=st.cycle + k),
                (dF, dV))

    def _advance(self, st: SimState, cycle: int):
        """One (super-)step from ``cycle``: ``step`` at k = 1, else
        ``step_super``. Returns ``(state', deliveries, cycles advanced)``."""
        k = self.params.fused_cycles
        if k == 1:
            return (*self.step(st, cycle), 1)
        return (*self.step_super(st, cycle), k)

    def _n_steps(self, n_cycles: int) -> int:
        k = self.params.fused_cycles
        if n_cycles % k:
            raise ValueError(
                f"n_cycles={n_cycles} not a multiple of fused_cycles={k}")
        return n_cycles // k


def build_sim(topo: Topology, params: NocParams, wl: epm.Workload,
              groups: list[dict] | None = None, device=None) -> Sim:
    """Assemble a Sim on ``device`` (``cuda`` unless the caller names
    another): fabric tables, HBM/memory maps and workload tensors.

    ``groups`` (requires ``params.collective_offload``) declares the
    in-fabric collective groups, ``{"root": ep, "members": [...]}`` dicts
    with optional ``"reduce": [...]`` contributors, whose multicast fork
    and reduction trees go into the fabric tables; workloads address group
    ``g`` as destination ``E + g`` (multicast) or ``E + G + g`` (reduction
    contribution).
    """
    dev = resolve_device(device)
    if groups is not None and not params.collective_offload:
        raise ValueError(
            "collective groups require NocParams(collective_offload=True)")
    if wl.n_groups and (groups is None or len(groups) != wl.n_groups):
        raise ValueError(
            f"workload addresses {wl.n_groups} collective group(s) but the "
            f"fabric was built with {0 if groups is None else len(groups)}")
    return Sim(
        topo=topo, params=params, wl=wl,
        tables=eng.make_tables(topo, params.n_vcs, groups=groups, device=dev),
        wt=WorkloadTensors.stack([wl], topo, dev), device=dev,
    )


@torch.no_grad()
def run(sim: Sim, n_cycles: int, state: SimState | None = None) -> SimState:
    """Advance ``sim`` by ``n_cycles`` (from ``state`` or a fresh one).

    ``params.fused_cycles`` > 1 advances in fused super-steps (``n_cycles``
    must be a multiple, or ``ValueError``; the naive step raises JAX's
    ``ValueError`` there, as ``step_super`` does)."""
    n_steps = sim._n_steps(n_cycles)
    st = state if state is not None else sim.init_state()
    cyc = int(st.cycle)  # the only read of the device per call
    for _ in range(n_steps):
        st, _, k = sim._advance(st, cyc)
        cyc += k
    return st


# workload fields that may vary across a sweep batch; everything else
# (dma_write, unique_txn_per_stream, n_tiles, stream count, group count,
# schedule presence and length) must match across the batch
SWEEP_FIELDS = ("narrow_rate", "narrow_dst", "dma_dst", "dma_alt_dst",
                "dma_txns", "dma_beats", "dma_dst_seq", "dma_gate",
                "dma_beats_seq")

# EndpointState leaves whose leading axis is the channel (the rest lead
# with the endpoint rows)
_CHANNEL_LEAVES = ("eg", "eg_ready", "eg_head", "eg_cnt")


def _split(st: SimState, B: int, C: int, E: int) -> list[SimState]:
    """The B configurations' own SimStates of a batched one."""
    out = []
    for b in range(B):
        fabric = {}
        for f in dataclasses.fields(st.fabric):
            v = getattr(st.fabric, f.name)
            fabric[f.name] = (None if v is None else
                              v.unflatten(0, (C, B))[:, b].clone())
        eps = {}
        for f in dataclasses.fields(st.eps):
            v = getattr(st.eps, f.name)
            if f.name in _CHANNEL_LEAVES:
                v = v.reshape(C, B, E, *v.shape[2:])[:, b]
            else:
                v = v.reshape(B, E, *v.shape[1:])[b]
            eps[f.name] = v.clone()
        out.append(SimState(fabric=eng.FabricState(**fabric),
                            eps=epm.EndpointState(**eps),
                            cycle=st.cycle.clone()))
    return out


@torch.no_grad()
def run_sweep(sim: Sim, wls: list[epm.Workload], n_cycles: int) -> list[SimState]:
    """Run N workload configurations of one fabric as ONE batched state.

    All workloads must share ``sim.topo`` / ``sim.params`` and every static
    workload attribute (read/write mode, stream count, n_tiles, group
    count, schedule shape); their array fields (``SWEEP_FIELDS``) become the
    batch's rows. Each cycle is one ``Sim.step`` of the whole batch, so the
    router kernels launch as often as for one configuration. The sweep
    steps cycle by cycle whatever ``params.fused_cycles`` is, on either
    ``step_impl``, as the JAX package's ``run_sweep`` does. Returns one final SimState per workload,
    equal to a sequential per-cycle run of it.
    """
    ref = sim.wl
    for w in wls:
        if (w.dma_write != ref.dma_write
                or w.unique_txn_per_stream != ref.unique_txn_per_stream
                or w.n_tiles != ref.n_tiles or w.n_streams != ref.n_streams
                or w.n_groups != ref.n_groups):
            raise ValueError("sweep workloads must share static workload attributes")
        # the swept-field list is derived from the REFERENCE workload, so a
        # field the reference leaves unset would be silently dropped for the
        # whole batch (the config would run with the wrong traffic): require
        # presence agreement for every sweepable field, not just the
        # schedule triple
        for f in SWEEP_FIELDS:
            if (getattr(w, f) is None) != (getattr(ref, f) is None):
                raise ValueError(
                    f"sweep workloads must agree on {f} presence (swept "
                    "fields are taken from the reference sim.wl, so a field "
                    "only some workloads set would be silently ignored)")
    E, C = sim.topo.n_endpoints, sim.params.n_channels
    wt = WorkloadTensors.stack(wls, sim.topo, sim.device)
    st = sim.init_state(wt)
    for cyc in range(n_cycles):
        st, _ = sim.step(st, cyc, wt)
    return _split(st, len(wls), C, E)


# selectable per-cycle trace fields for run_trace: "deliver" (the endpoint
# deliveries), "counters" (small occupancy/progress counters) and "fabric"
# (the whole FabricState every cycle: O(T*C*R*P*D*NF), opt in deliberately)
TRACE_FIELDS = ("deliver", "counters", "fabric")


def _trace_slice(st: SimState, deliver, fields: tuple) -> dict:
    out = {}
    for f in fields:
        if f == "deliver":
            out[f] = deliver
        elif f == "counters":
            fab = st.fabric
            out[f] = {
                "eg_cnt": st.eps.eg_cnt,
                "mq_cnt": st.eps.mq_cnt,
                "in_flight": (epm._isum(fab.in_cnt, (1, 2))
                              + epm._isum(fab.out_cnt, (1, 2))),
                "beats_rcvd": st.eps.beats_rcvd,
                "n_sent": st.eps.n_sent,
            }
        else:
            out[f] = st.fabric
    return out


def _stack(items):
    """Stack a list of equally-shaped nests (tuples, dicts, dataclasses;
    ``None`` leaves stay ``None``)."""
    first = items[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple):
        return tuple(_stack(list(xs)) for xs in zip(*items))
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items]) for k in first}
    return type(first)(**{f.name: _stack([getattr(x, f.name) for x in items])
                          for f in dataclasses.fields(first)})


@torch.no_grad()
def run_trace(sim: Sim, n_cycles: int, state: SimState | None = None,
              fields: tuple = ("deliver",)):
    """Like run(), but also returns a per-cycle trace.

    With the default ``fields=("deliver",)`` the trace is the endpoint
    deliveries ``(flits [T, C, E, NF], valid [T, C, E])``. Other
    ``TRACE_FIELDS`` come back in a dict keyed by field name. With
    ``fused_cycles > 1`` the deliveries are flattened to per-cycle
    ``[T, C, ...]`` while "counters"/"fabric" stay per super-step (they
    sample the state at window boundaries).
    """
    fields = tuple(fields)
    for f in fields:
        if f not in TRACE_FIELDS:
            raise ValueError(
                f"unknown trace field {f!r}; expected one of {TRACE_FIELDS}")
    n_steps = sim._n_steps(n_cycles)
    st = state if state is not None else sim.init_state()
    cyc = int(st.cycle)
    slices = []
    for _ in range(n_steps):
        st, deliver, k = sim._advance(st, cyc)
        cyc += k
        slices.append(_trace_slice(st, deliver, fields))
    trace = _stack(slices)
    if sim.params.fused_cycles > 1 and "deliver" in trace:
        # [T/k, k, C, ...] -> [T, C, ...]
        trace["deliver"] = tuple(x.flatten(0, 1) for x in trace["deliver"])
    if fields == ("deliver",):
        return st, trace["deliver"]
    return st, trace


def canonical_state(sim: Sim, st: SimState, scrub: bool = False) -> SimState:
    """SimState with implementation-defined garbage masked out.

    The fast and naive steps agree on all live state but leave different
    garbage where nothing live is stored: dead FIFO slots (index >= count)
    after fused vs two-step updates, and rotated vs head-at-0 queues. This
    rotates every circular queue to head 0 and zeroes all dead queue/FIFO
    slots, as ``repro.core.noc.sim.canonical_state`` does, so the fast and
    the naive state of one run are equal leaf for leaf after it iff the two
    agree on all live state. ``scrub=True``
    also neutralizes the endpoint scratch registers that keep their last
    burst after going idle (``m_flit``, the ``w_*`` serializer registers,
    NI destination slots with zero outstanding count).
    """
    f, eps = st.fabric, st.eps

    def mask_fifo(buf, cnt):
        """Zero slots at or past the FIFO count (buf [..., D, NF])."""
        D = buf.shape[-2]
        live = torch.arange(D, device=buf.device) < cnt[..., None]
        return torch.where(live[..., None], buf, 0)

    fabric = dataclasses.replace(
        f, in_buf=mask_fifo(f.in_buf, f.in_cnt),
        out_buf=mask_fifo(f.out_buf, f.out_cnt))

    dev = eps.mq.device
    Q = eps.mq.shape[1]
    rot = torch.remainder(eps.mq_head[:, None] + torch.arange(Q, device=dev), Q)
    mq = torch.gather(eps.mq, 1, rot.long()[..., None].expand(eps.mq.shape))
    mq = torch.where((torch.arange(Q, device=dev) < eps.mq_cnt[:, None])[..., None],
                     mq, 0)

    EQ = eps.eg_ready.shape[-1]
    rote = torch.remainder(eps.eg_head[..., None] + torch.arange(EQ, device=dev),
                           EQ).long()
    live = torch.arange(EQ, device=dev) < eps.eg_cnt[..., None]
    eg = torch.where(live[..., None],
                     torch.gather(eps.eg, 2, rote[..., None].expand(eps.eg.shape)), 0)
    eg_ready = torch.where(live, torch.gather(eps.eg_ready, 2, rote), 0)
    eps = dataclasses.replace(
        eps, mq=mq, mq_head=torch.zeros_like(eps.mq_head),
        eg=eg, eg_ready=eg_ready, eg_head=torch.zeros_like(eps.eg_head))
    if scrub:
        w_idle = eps.w_stream < 0
        z = torch.zeros_like(eps.w_left)
        eps = dataclasses.replace(
            eps,
            m_flit=torch.where(eps.m_active[:, None], eps.m_flit, 0),
            w_left=torch.where(w_idle, z, eps.w_left),
            w_beats=torch.where(w_idle, z, eps.w_beats),
            w_dst=torch.where(w_idle, z, eps.w_dst),
            w_txn=torch.where(w_idle, z, eps.w_txn),
            w_ts=torch.where(w_idle, z, eps.w_ts),
            ni_dst=torch.where(eps.ni_cnt == 0, -1, eps.ni_dst),
        )
    return SimState(fabric=fabric, eps=eps, cycle=st.cycle)


def stats(sim: Sim, st: SimState) -> dict:
    """Summarize a final SimState: latency, beats, utilization, stalls."""
    eps = {f.name: getattr(st.eps, f.name).cpu().numpy()
           for f in dataclasses.fields(st.eps)}
    cyc = int(st.cycle)
    n_tiles = sim.wl.n_tiles
    lat = eps["lat_sum"] / np.maximum(eps["lat_cnt"], 1)
    return {
        "cycles": cyc,
        "narrow_lat_mean": lat[:n_tiles],
        "narrow_lat_cnt": eps["lat_cnt"][:n_tiles],
        "beats_rcvd": eps["beats_rcvd"],
        "beats_sent": eps["beats_sent"],
        "hbm_served": eps["hbm_served"],
        "ni_stalls": eps["ni_stall"],
        "eg_overflow": eps["eg_overflow"],
        "dma_done": eps["d_done"],
        "rx_bursts": eps["rx_bursts"],
        "last_rx": eps["last_rx"],
        "first_rx": eps["first_rx"],
        "mq_max": int(eps["mq_cnt"].max()),
        "wide_util": eps["beats_rcvd"][:n_tiles].sum() / max(cyc * n_tiles, 1),
        "hbm_util": (
            eps["hbm_served"].sum()
            / max(cyc * max(int(sim.wt.is_hbm.sum()), 1), 1)
            / sim.params.hbm_rate
        ),
    }
