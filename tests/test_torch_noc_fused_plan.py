"""The fused window's cluster plan and schedule, on the CPU.

``noc_fused_cluster_kernel`` runs only on the card. What surrounds it is
checked here:

* ``fused_plan`` on every fabric the port runs in fused windows: the 8x4
  mesh and torus, the 32x32 mesh and torus, and ``chip_smoke.py``'s ragged
  23x19 mesh take a cluster of at most 16 CTAs with at most 232 448 bytes
  of shared memory each, router ranges that cover every router once, and
  at most 1 024 threads; its 48x48 torus at ``n_vcs=2`` takes the
  global-memory kernel;
* an emulation of the kernel's schedule in PyTorch: the state split into
  the plan's tiles (one per CTA, each padded to the same slot count),
  arbitration per tile, then per tile the apply phase's reads (another
  tile's output counts, heads and input space through the owner tile and
  its local offset, as the kernel addresses distributed shared memory)
  and writes (input FIFO in place in ascending slot order after the
  router's reads, output FIFO into the other copy), tile by tile, so a
  tile writing what a later tile reads this cycle would show; egress
  injection by the attach slot, and the state written back from the
  tiles. Held bit-equal to the
  port's ``ref.router_cycles_scan`` and to the JAX package's, at N = 1 and
  4, V = 1 and 2, on the 8x4 fabrics and the 5x7 mesh and torus split
  raggedly over 4 tiles.

Integer state, so the tolerance is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import engine as jeng
from repro.core.noc.topology import build_topology as jax_build_topology
from repro.kernels.noc_router import ref as jref
from repro_torch.core.noc.topology import build_topology
from repro_torch.kernels.noc_router import noc_router as K
from repro_torch.kernels.noc_router import ref as tref
from repro_torch.kernels.noc_router.ref import F_DST, F_LAST, NF

torch.set_num_threads(1)

INT_MIN = -(2**31)

# (name, builder kwargs, n_vcs, expected kernel and cluster)
FABRICS = [
    ("mesh", dict(nx=4, ny=8), 1, ("cluster", 1)),
    ("torus", dict(nx=4, ny=8), 2, ("cluster", 1)),
    ("mesh", dict(nx=32, ny=32), 1, ("cluster", 16)),
    ("torus", dict(nx=32, ny=32), 2, ("cluster", 16)),
    ("mesh", dict(nx=23, ny=19), 1, ("cluster", 8)),
]


def _shape(name, kw, V):
    topo = build_topology(name, **kw)
    return topo.n_routers, topo.n_ports * V


@pytest.mark.parametrize("name,kw,V,want", FABRICS,
                         ids=lambda x: x if isinstance(x, str) else None)
def test_fused_plan_fits_every_fused_fabric(name, kw, V, want):
    R, P = _shape(name, kw, V)
    plan = K.fused_plan(R, P, 2, 2, V)
    assert (plan.kernel, plan.cluster) == want
    assert plan.cluster in K.CLUSTER_SIZES and plan.cluster <= 16
    assert plan.smem_bytes <= K.SMEM_PER_CTA == 232_448
    assert plan.threads <= K.MAX_THREADS <= 1024 and plan.threads % 32 == 0
    covered = [r for lo, hi in plan.ranges for r in range(lo, hi)]
    assert covered == list(range(R)) and len(plan.ranges) == plan.cluster
    rpw = 32 // P  # routers per warp
    assert plan.threads // 32 * plan.slots_per_thread * rpw >= plan.routers_per_cta
    assert plan.smem_bytes == K.smem_bytes(plan.routers_per_cta * P, 2, 2,
                                           V, P // V)


def test_fused_plan_ragged_and_oversized():
    """chip_smoke.py's ragged fabric splits unevenly over 8 CTAs; a fabric
    past a 16-CTA cluster (its 48x48 torus at n_vcs=2, a
    64x64 mesh) takes the global-memory kernel; pinned variants that do not
    fit raise."""
    plan = K.fused_plan(23 * 19, 5, 2, 2, 1)
    assert plan.ranges[-2:] == ((330, 385), (385, 437))
    # the smallest cluster that fits in at most PREFERRED_WARPS warps: 16
    # CTAs of 11 warps at 32x32, not 8 of 22
    assert K.fused_plan(1024, 5, 2, 2, 1).threads == 352
    assert K.fused_plan(1024, 5, 2, 2, 1, cluster=8).threads == 704
    assert K.fused_plan(64 * 64, 5, 2, 2, 1).kernel == "global"
    assert K.fused_plan(48 * 48, 10, 2, 2, 2).kernel == "global"
    with pytest.raises(ValueError):
        K.fused_plan(1024, 5, 2, 2, 1, cluster=4)
    with pytest.raises(ValueError):
        K.fused_plan(437, 5, 2, 2, 1, cluster=2)


def test_smem_bytes_per_slot():
    """At depth 2 a slot takes 248 bytes, 20 more with two VCs on 5 ports
    (slot counts that are multiples of 16 round nothing up)."""
    assert K.smem_bytes(160, 2, 2) == 160 * 248
    assert K.smem_bytes(160, 2, 2, 2, 5) == 160 * 268


# ---------------------------------------------------------------------------
# the schedule, emulated tile by tile


def _wrap32(x):
    return ((x + 2**31) % 2**32) - 2**31


def emulate_window(plan, state, tables, ep_space, cycle0, N, V):
    """The cluster kernel's schedule over channel-batched state: returns
    what ``router_cycles_fused_cuda`` returns."""
    (in_buf, in_cnt, out_buf, out_cnt, rr, wh, eg, eg_ready, eg_head,
     eg_cnt) = state
    route, link_src, link_dst, port_ep, ep_attach, vc_out = tables
    C, R, P, Din, _ = in_buf.shape
    Dout, E, Q = out_buf.shape[3], eg.shape[1], eg.shape[2]
    Pp, Rc = P // V, plan.routers_per_cta
    S, T = Rc * P, plan.cluster
    i32 = torch.int32

    def tile_zeros(*shape, dtype=i32):
        return [torch.zeros((C, S) + shape, dtype=dtype) for _ in range(T)]

    # ---- the state in, the tables of each slot ----
    t_in, t_ic, t_rr, t_wh = tile_zeros(Din, NF), tile_zeros(), tile_zeros(), tile_zeros()
    t_out = [tile_zeros(Dout, NF) for _ in range(2)]  # ping-pong copies
    t_oc = [tile_zeros() for _ in range(2)]
    t_isp = [tile_zeros(dtype=torch.bool) for _ in range(2)]
    up, down = [torch.full((S,), -1) for _ in range(T)], [torch.full((S,), -1) for _ in range(T)]
    flag_pe = [torch.zeros((C, S), dtype=torch.bool) for _ in range(T)]
    ep_at = [torch.full((S,), -1) for _ in range(T)]
    egh, egc = tile_zeros(), tile_zeros()
    ns = []
    for k, (r0, r1) in enumerate(plan.ranges):
        n = (r1 - r0) * P
        ns.append(n)
        sl = slice(r0, r1)
        t_in[k][:, :n] = in_buf[:, sl].reshape(C, n, Din, NF)
        t_out[0][k][:, :n] = out_buf[:, sl].reshape(C, n, Dout, NF)
        t_ic[k][:, :n] = in_cnt[:, sl].reshape(C, n)
        t_oc[0][k][:, :n] = out_cnt[:, sl].reshape(C, n)
        t_rr[k][:, :n] = rr[:, sl].reshape(C, n)
        t_wh[k][:, :n] = wh[:, sl].reshape(C, n)
        for t in range(n):
            r, p = r0 + t // P, t % P
            for tab, dst in ((link_src, up[k]), (link_dst, down[k])):
                lr, lport = (int(x) for x in tab[r, p // V])
                if lr >= 0:
                    dst[t] = (min(max(lr, 0), R - 1) * P
                              + min(max(lport, 0), Pp - 1) * V)
            pe = int(port_ep[r, p])
            if pe >= 0:
                flag_pe[k][:, t] = ep_space[:, min(max(pe, 0), E - 1)]
    for e in range(E):
        ar, ap = (int(x) for x in ep_attach[e])
        k = ar // Rc
        t = (ar - k * Rc) * P + ap
        ep_at[k][t] = e
        egh[k][:, t] = eg_head[:, e]
        egc[k][:, t] = eg_cnt[:, e]

    def _write(k, n, reads, i, N, cur, nxt):
        """The apply phase's writes of tile k, in the kernel's order."""
        accept, sent, flit, chosen, icnt, ocnt, g, pops = reads
        ib = t_in[k]
        c1 = icnt - pops.to(torch.int32)
        tail = c1.clamp(0, Din - 1)
        for d in range(Din):  # in place, ascending
            push = accept & (tail == d)
            shifted = ib[:, :n, min(d + 1, Din - 1)]
            ib[:, :n, d] = torch.where(push[..., None], flit,
                                       torch.where(pops[..., None], shifted,
                                                   ib[:, :n, d]))
        nic = c1 + accept.to(torch.int32)
        if i < N - 1:
            for t in range(n):
                e = int(ep_at[k][t])
                if e < 0:
                    continue
                h, cq = egh[k][:, t].long(), egc[k][:, t]
                ready = eg_ready[torch.arange(len(h)), e, h]
                ok = (cq > 0) & (ready <= cycle0 + i) & (nic[:, t] < Din)
                for c in torch.nonzero(ok).flatten().tolist():
                    ib[c, t, int(nic[c, t])] = eg[c, e, int(h[c])]
                    nic[c, t] += 1
                    egh[k][c, t] = (int(h[c]) + 1) % Q
                    egc[k][c, t] = int(cq[c]) - 1
        t_ic[k][:, :n] = nic
        o0 = t_out[cur][k]
        o1 = t_out[nxt][k]
        c2 = ocnt - sent.to(torch.int32)
        otail = c2.clamp(0, Dout - 1)
        for d in range(Dout):
            take = o0[:, :n, min(d + 1, Dout - 1)]
            src = torch.where(sent[..., None], take, o0[:, :n, d])
            o1[:, :n, d] = torch.where((g & (otail == d))[..., None], chosen, src)
        t_oc[nxt][k][:, :n] = c2 + g.to(torch.int32)

    ep_flit = torch.zeros((C, N, E, NF), dtype=i32)
    ep_valid = torch.zeros((C, N, E), dtype=torch.bool)
    waiting = torch.zeros((C, N, E), dtype=torch.bool)
    dec = [None] * T
    cur = 0
    for i in range(N):
        par = i % 2
        # ---- 1. arbitration, per tile: a lane per slot, a warp per router
        for k, (r0, r1) in enumerate(plan.ranges):
            nr, n = r1 - r0, ns[k]
            if n == 0:
                continue
            routers = torch.arange(r0, r1).repeat_interleave(P)
            cnt = t_ic[k][:, :n]
            dst = t_in[k][:, :n, 0, F_DST].long().clamp(min=0)
            port = torch.where(dst < E, route[routers, dst.clamp(max=E - 1)].long(),
                               torch.full_like(dst, INT_MIN))
            if V > 1:
                slot = torch.arange(n) % P
                vout = vc_out[routers, slot, port.clamp(0, Pp - 1)].long()
                port = _wrap32(port * V + vout)
            req = torch.where(cnt > 0, port, -1).reshape(C, nr, 1, P)  # by pin
            lock = t_wh[k][:, :n].reshape(C, nr, P, 1)  # by pout
            ptr = t_rr[k][:, :n].reshape(C, nr, P, 1)
            space = (t_oc[cur][k][:, :n] < Dout).reshape(C, nr, P, 1)
            pin = torch.arange(P).reshape(1, 1, 1, P)
            pout = torch.arange(P).reshape(1, 1, P, 1)
            elig = (req == pout) & ((lock < 0) | (lock == pin)) & space
            score = torch.where(elig, torch.remainder(pin - ptr, P), P + 1)
            best, winner = score.min(dim=-1)  # the first minimum
            g = best <= P
            pops = (g[..., None] & (winner[..., None] == pin)).any(dim=-2)
            tail = torch.gather(t_in[k][:, :n, 0, F_LAST].reshape(C, nr, P), 2,
                                winner) > 0
            lock, ptr = lock[..., 0], ptr[..., 0]
            t_rr[k][:, :n] = torch.where(g, (winner + 1) % P, ptr).reshape(C, n)
            t_wh[k][:, :n] = torch.where(g, torch.where(tail, -1, winner),
                                         lock).reshape(C, n)
            dec[k] = (g.reshape(C, n), pops.reshape(C, n), winner.reshape(C, n))
            t_isp[par][k][:, :n] = (cnt - pops.reshape(C, n).to(i32)) < Din
        # ---- (cluster barrier) 2. link resolution and FIFO updates, per tile
        nxt = cur ^ 1
        for k in range(T):
            n = ns[k]
            if n == 0:
                continue
            slot = torch.arange(n)
            v = slot % P % V
            gb = slot // P * P + slot % P // V * V
            accept = torch.zeros((C, n), dtype=torch.bool)
            sent = torch.zeros((C, n), dtype=torch.bool)
            decided_a = torch.zeros((C, n), dtype=torch.bool)
            decided_s = torch.zeros((C, n), dtype=torch.bool)
            flit = torch.zeros((C, n, NF), dtype=i32)
            for t in range(n):
                u_g, d_g = int(up[k][t]), int(down[k][t])
                for u in range(int(v[t]) + 1):
                    if u_g >= 0:  # the owner tile of the upstream slot group
                        ru = u_g // S
                        oc_u = t_oc[cur][ru][:, u_g - ru * S + u]
                        e_ok = (oc_u > 0) & t_isp[par][k][:, gb[t] + u] & ~decided_a[:, t]
                        accept[:, t] |= e_ok & (u == v[t])
                        decided_a[:, t] |= e_ok
                    if d_g >= 0:
                        rd = d_g // S
                        isp_d = t_isp[par][rd][:, d_g - rd * S + u]
                        e_ok = (t_oc[cur][k][:, gb[t] + u] > 0) & isp_d & ~decided_s[:, t]
                        sent[:, t] |= e_ok & (u == v[t])
                        decided_s[:, t] |= e_ok
                if u_g >= 0:
                    ru = u_g // S
                    flit[:, t] = t_out[cur][ru][:, u_g - ru * S + int(v[t]), 0]
            g, pops, winner = dec[k]
            ocnt = t_oc[cur][k][:, :n].clone()
            sent |= flag_pe[k][:, :n] & (ocnt > 0)
            chosen = torch.gather(t_in[k][:, :n, 0],
                                  1, (slot // P * P + winner)[..., None].expand(C, n, NF))
            for t in range(n):  # deliveries: the cycle-start snapshot
                e = int(ep_at[k][t])
                if e >= 0:
                    ep_flit[:, i, e] = t_out[cur][k][:, t, 0]
                    ep_valid[:, i, e] = (ocnt[:, t] > 0) & ep_space[:, e]
                    waiting[:, i, e] = ocnt[:, t] > 0
            reads = (accept, sent, flit, chosen, t_ic[k][:, :n].clone(), ocnt,
                     g, pops)
            _write(k, n, reads, i, N, cur, nxt)
        cur = nxt

    # ---- the state out
    outs = [torch.empty_like(x) for x in (in_buf, in_cnt, out_buf, out_cnt, rr, wh)]
    for k, (r0, r1) in enumerate(plan.ranges):
        n, sl = ns[k], slice(r0, r1)
        for dst, src in ((outs[0], t_in[k]), (outs[1], t_ic[k]),
                         (outs[2], t_out[cur][k]), (outs[3], t_oc[cur][k]),
                         (outs[4], t_rr[k]), (outs[5], t_wh[k])):
            dst[:, sl] = src[:, :n].reshape(dst[:, sl].shape)
    head, cnt = eg_head.clone(), eg_cnt.clone()
    for k in range(T):
        for t in range(ns[k]):
            e = int(ep_at[k][t])
            if e >= 0:
                head[:, e], cnt[:, e] = egh[k][:, t], egc[k][:, t]
    return (*outs, eg.clone(), eg_ready.clone(), head, cnt, ep_flit,
            ep_valid, waiting)


CASES = [("mesh", dict(nx=4, ny=8), 1), ("torus", dict(nx=4, ny=8), 2),
         ("mesh", dict(nx=5, ny=7), 1), ("torus", dict(nx=5, ny=7), 2)]


@pytest.mark.parametrize("N", [1, 4])
@pytest.mark.parametrize("name,kw,V", CASES,
                         ids=[f"{n}{k['nx']}x{k['ny']}-vc{v}" for n, k, v in CASES])
def test_schedule_matches_scan(name, kw, V, N):
    """The emulated schedule, for the default plan and on 4 tiles (ragged
    at 5x7: 9, 9, 9 and 8 routers), equal to the port's
    ``router_cycles_scan`` and that equal to the JAX package's, leaf for
    leaf, dead FIFO slots included."""
    from test_torch_cuda_kernels import _egress, _snapshot

    rng = np.random.default_rng(900 + 10 * N + V + kw["ny"])
    jtopo = jax_build_topology(name, **kw)
    jtb = jeng.make_tables(jtopo, n_vcs=V)
    keys = ("route", "link_src", "link_dst", "port_ep", "ep_attach")
    tables = [np.array(getattr(jtb, k)) for k in keys]
    vc_out = None if V == 1 else np.array(jtb.vc_out)
    R, E = jtopo.n_routers, jtopo.n_endpoints
    C, Q, cycle0 = 3, 8, 100
    snap = _snapshot(rng, (C,), R, E, 2, 2, V)
    q = _egress(rng, C, E, Q, cycle0, N)
    state = [snap[k] for k in ("in_buf", "in_cnt", "out_buf", "out_cnt",
                               "rr_ptr", "wh_lock")]
    state += [q[k] for k in ("eg", "eg_ready", "eg_head", "eg_cnt")]
    T = lambda x: None if x is None else torch.as_tensor(x)
    args = (*map(T, state), *map(T, tables), T(snap["ep_space"]), cycle0, N)
    want = tref.router_cycles_scan(*args, vc_out=T(vc_out), n_vcs=V)

    # the JAX reference, one channel at a time
    jvc = None if vc_out is None else jnp.asarray(vc_out)
    for c in range(C):
        carry, per_cycle = jref.router_cycles_scan(
            *(jnp.asarray(x[c]) for x in state), *map(jnp.asarray, tables),
            jnp.asarray(snap["ep_space"][c]), cycle0, N, vc_out=jvc, n_vcs=V)
        for i, leaf in enumerate((*carry, *per_cycle)):
            np.testing.assert_array_equal(np.asarray(leaf), want[i][c].numpy(),
                                          err_msg=f"JAX leaf {i}, channel {c}")

    P = 5 * V
    plans = [K.fused_plan(R, P, 2, 2, V)]
    plans.append(K.fused_plan(R, P, 2, 2, V, cluster=4))
    if name == "mesh" and kw["nx"] == 5:
        assert plans[1].ranges == ((0, 9), (9, 18), (18, 27), (27, 35))
    emu_tables = (*map(T, tables), T(vc_out))
    for plan in plans:
        got = emulate_window(plan, [T(x) for x in state], emu_tables,
                             T(snap["ep_space"]), cycle0, N, V)
        for i, (a, b) in enumerate(zip(want, got)):
            assert torch.equal(a, b), f"cluster {plan.cluster}: output {i}"
    # the window moved flits: something was delivered
    assert want[11].any()
