"""The per-cycle arbitration kernels' warp schedules, emulated on the CPU.

``noc_arb_kernel`` and ``noc_arb_offload_kernel`` run only on the card.
Here each is emulated lane by lane in numpy, as the CUDA source runs it:
CTAs of four warps of 32 lanes; with P slots a warp holds ``32 // P``
routers, lane ``sub * P + p`` being slot p of router ``sub`` (``base =
sub * P``); lanes past the last whole router and the routers past C * R in
the last warp load and write nothing but take part in every shuffle (they
read lane ``(base + pin) & 31``); requests, the winner's flags and head
are shuffles; the pop mask and the reduction ALU's sums and maxima are
segmented reductions (log-step shuffles down, a lane taking its partner
only inside its router, then a broadcast from lane ``base``), skipped by a
warp whose ballot has no taker; the ALU's count is the ballot's popcount
over the router's lanes.

Both emulations are held bit for bit against the port's
``ref.arb_decisions`` / ``ref.offload_decisions`` and against the JAX
package's ``repro.kernels.noc_router.ref`` on the same numpy snapshots, at
P in {1, 5, 10, 30, 32} (V in {1, 2, 6}), with C * R not a multiple of the
routers per warp, and for the offload kernel G in {1, 3, 40}, with groups
sharing a parent slot, multicast heads that lose a branch and reduction
heads that have already contributed made common. Integer state, so the
tolerance is exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.noc_router import ref as jref
from repro_torch.kernels.noc_router import ref as tref
from repro_torch.kernels.noc_router.ref import (
    A_CNT,
    A_NLAST,
    A_SRC,
    A_TS,
    A_TXN,
    A_VAL,
    F_DST,
    F_KIND,
    F_LAST,
    F_META,
    F_SRC,
    F_TS,
    F_TXN,
    KIND_MC,
    KIND_RED,
    NF,
    NRED,
)
from test_torch_cuda_kernels import _offload, _snapshot, _tables

torch.set_num_threads(1)

FULL = 0xFFFFFFFF
INT_MIN = -(2**31)
THREADS = 128  # kArbThreads: four warps a CTA


def _wrap32(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32) - 2**31


class Lanes:
    """Every lane of a per-cycle arbitration launch over ``n`` routers of
    ``P`` slots, as ``slot_lane`` sets it up: arrays of shape [warps, 32]."""

    def __init__(self, n, P):
        rpw = 32 // P
        warps = -(-n // rpw)
        blocks = -(-warps * 32 // THREADS)  # arb_blocks
        lane = np.arange(32)
        sub = lane // P
        self.P, self.n = P, n
        self.p = np.broadcast_to(lane - sub * P, (blocks * 4, 32))
        self.base = np.broadcast_to(sub * P, self.p.shape)
        self.cr = np.arange(blocks * 4)[:, None] * rpw + sub
        self.live = (sub < rpw) & (self.cr < n)
        self.group = np.broadcast_to((((1 << P) - 1) << (sub * P)) & FULL, self.p.shape)

    def shfl(self, v, src):
        """``__shfl_sync(FULL_MASK, v, src & 31)``; ``v`` [warps, 32]."""
        src = np.broadcast_to(np.asarray(src) & 31, v.shape)
        return np.take_along_axis(v, src, axis=1)

    def shfl_down(self, v, d):
        """``__shfl_down_sync(FULL_MASK, v, d)``: lane l reads l + d, or
        keeps its own value past lane 31."""
        lane = np.arange(32)
        return self.shfl(v, np.where(lane + d < 32, lane + d, lane))

    def seg(self, v, op):
        """``seg_or`` and the ALU's reductions: log-step shuffles down,
        a lane taking its partner only inside its router, then lane
        ``base``'s result to the router (``op`` on int64; sums are wrapped
        by the caller)."""
        v = np.asarray(v, np.int64)
        d = 1
        while d < self.P:
            v = np.where(self.p + d < self.P, op(v, self.shfl_down(v, d)), v)
            d *= 2
        return self.shfl(v, self.base)

    def ballot(self, pred):
        """``__ballot_sync(FULL_MASK, pred)`` at every lane."""
        bits = (np.asarray(pred, np.int64) << np.arange(32)).sum(axis=1)
        return np.broadcast_to(bits[:, None], pred.shape)

    def load(self, flat, idx, default):
        """A guarded global load: ``flat[idx]`` on live lanes."""
        idx = np.where(self.live, idx, 0)
        out = np.where(self.live, flat[idx], default)
        return out if out.dtype == bool else out.astype(np.int64)


def rr_winner(m, ptr, P):
    """``rr_winner``: the first eligible pin at or after ``ptr`` mod P,
    cyclically; 0 when nothing is eligible."""
    late = m & ((FULL << np.mod(ptr, P)) & FULL)
    low = lambda x: np.log2(np.where(x == 0, 1, x & -x)).astype(np.int64)
    return np.where(late != 0, low(late), np.where(m != 0, low(m), 0))


def _store(out, lanes, t, value):
    """Live lanes write ``value`` at slot ``t`` (each slot once)."""
    live = lanes.live
    idx = t[live]
    assert len(np.unique(idx)) == len(idx)
    out[idx] = np.asarray(value)[live]


def _heads(lanes, in_buf, t):
    Din = in_buf.shape[3]
    flat = in_buf.reshape(-1)
    return [lanes.load(flat, t * Din * NF + f, 0) for f in range(NF)]


def _decisions(C, R, P):
    """The kernel's output arrays, filled with a marker no slot keeps."""
    mark = -12345
    return dict(arb_pop=np.full(C * R * P, mark), granted=np.full(C * R * P, mark),
                in_space=np.full(C * R * P, mark), rr=np.full(C * R * P, mark),
                wh=np.full(C * R * P, mark), chosen=np.full((C * R * P, NF), mark))


def _finish(o, C, R, P):
    """The output arrays as ``ArbDecisions``-ordered arrays; every slot
    written."""
    for k, v in o.items():
        assert (v != -12345).all(), f"{k}: a slot was not written"
    s = (C, R, P)
    return (o["arb_pop"].reshape(s).astype(bool), o["granted"].reshape(s).astype(bool),
            o["chosen"].reshape(s + (NF,)).astype(np.int32),
            o["rr"].reshape(s).astype(np.int32), o["wh"].reshape(s).astype(np.int32),
            o["in_space"].reshape(s).astype(bool))


def emulate_arb(in_buf, in_cnt, out_cnt, rr, wh, route, Dout, vc_out=None, V=1):
    """``noc_arb_kernel``, lane by lane; returns the ``ArbDecisions``
    fields as numpy arrays."""
    C, R, P, Din, _ = in_buf.shape
    E = route.shape[1]
    L = Lanes(C * R, P)
    p, base = L.p, L.base
    t = L.cr * P + p
    r = L.cr % R
    head = _heads(L, in_buf, t)
    cnt = L.load(in_cnt.reshape(-1), t, 0)
    lock = L.load(wh.reshape(-1), t, -1)
    ptr = L.load(rr.reshape(-1), t, 0)
    space = L.live & (L.load(out_cnt.reshape(-1), t, Dout) < Dout)
    dst = np.maximum(head[F_DST], 0)
    port = np.where(dst < E, L.load(route.reshape(-1), r * E + np.minimum(dst, E - 1), 0),
                    INT_MIN)
    if V > 1:
        Pp = P // V
        vout = L.load(vc_out.reshape(-1), (r * P + p) * Pp + np.clip(port, 0, Pp - 1), 0)
        port = _wrap32((port % 2**32) * V + vout)
    req = np.where(L.live & (cnt > 0), port, -1)

    m = np.zeros_like(p, dtype=np.int64)
    for pin in range(P):
        m |= (L.shfl(req, base + pin) == p).astype(np.int64) << pin
    m = np.where(lock >= 0, m & np.where(lock < P, 1 << np.clip(lock, 0, 31), 0), m)
    m = np.where(space, m, 0)
    winner = rr_winner(m, ptr, P)
    g = m != 0
    pops = L.seg(np.where(g, 1 << winner, 0), np.bitwise_or)
    ch = [L.shfl(head[f], base + winner) for f in range(NF)]

    o = _decisions(C, R, P)
    pop = (pops >> p) & 1 == 1
    _store(o["arb_pop"], L, t, pop)
    _store(o["in_space"], L, t, (cnt - pop) < Din)
    _store(o["granted"], L, t, g)
    _store(o["rr"], L, t, np.where(g, np.where(winner + 1 == P, 0, winner + 1), ptr))
    _store(o["wh"], L, t, np.where(g, np.where(ch[F_LAST] > 0, -1, winner), lock))
    _store(o["chosen"], L, t, np.stack(ch, -1))
    return _finish(o, C, R, P)


def emulate_offload(in_buf, in_cnt, out_cnt, rr, wh, route, Dout, fork_out,
                    red_parent, red_need, red_acc, red_got, vc_out=None, V=1,
                    seen=None):
    """``noc_arb_offload_kernel``, lane by lane; returns the decisions,
    ``red_acc'`` and ``red_got'``. ``seen`` counts the cases reached."""
    C, R, P, Din, _ = in_buf.shape
    E, G = route.shape[1], red_need.shape[1]
    L = Lanes(C * R, P)
    p, base = L.p, L.base
    t = L.cr * P + p
    r = L.cr % R
    rg, crg = r * G, L.cr * G
    head = _heads(L, in_buf, t)
    cnt = L.load(in_cnt.reshape(-1), t, 0)
    oc = L.load(out_cnt.reshape(-1), t, 0)
    lock = L.load(wh.reshape(-1), t, -1)
    ptr = L.load(rr.reshape(-1), t, 0)
    g_of = np.where(L.live, np.clip(_wrap32(head[F_DST] - E), 0, G - 1), 0)
    valid = L.live & (cnt > 0)
    is_mc = valid & (head[F_KIND] == KIND_MC)
    is_red = valid & (head[F_KIND] == KIND_RED)
    uni = valid & ~is_mc & ~is_red
    req = np.zeros_like(p, dtype=np.int64)
    port = L.load(route.reshape(-1), r * E + np.clip(head[F_DST], 0, E - 1), 0)
    if V > 1:
        Pp = P // V
        vout = L.load(vc_out.reshape(-1), (r * P + p) * Pp + np.clip(port, 0, Pp - 1), 0)
        port = _wrap32((port % 2**32) * V + vout)
    req = np.where(uni & (port >= 0) & (port < P), 1 << np.clip(port, 0, 31), req)
    fork = fork_out.reshape(-1)
    for pout in range(P):
        bit = L.load(fork, (rg + g_of) * P + pout, False)
        req |= np.where(is_mc & bit, 1 << pout, 0)

    # ---- the reduction ALU ----
    emit_mask = np.zeros_like(req)
    red_pop = np.zeros(p.shape, bool)
    emit_g = np.zeros_like(req)
    emit_acc = [np.zeros_like(req) for _ in range(NRED)]
    acc_out = np.full(C * R * G * NRED, -12345)
    got_out = np.full(C * R * G * P, -12345)
    acc_flat, got_flat = red_acc.reshape(-1), red_got.reshape(-1)
    for g in range(G):
        need = L.load(red_need.reshape(-1), rg + g, 0)
        par = L.load(red_parent.reshape(-1), rg + g, -1)
        acc = [L.load(acc_flat, (crg + g) * NRED + f, 0) for f in range(NRED)]
        got = L.load(got_flat, (crg + g) * P + p, False)
        on_tree = need > 0
        full = on_tree & (acc[A_CNT] >= need)
        pc = np.clip(par, 0, P - 1)
        par_cnt = L.shfl(oc, base + pc)
        par_lock = L.shfl(lock, base + pc)
        can = full & (par >= 0) & (par_cnt < Dout) & (par_lock < 0)
        emitting = can & ((emit_mask >> pc) & 1 == 0)
        if seen is not None:  # another group took the parent port first
            seen["shared_parent"] += int((L.live & can & ~emitting & (p == pc)).sum())
        emit_mask = np.where(emitting, emit_mask | (1 << pc), emit_mask)
        mine = emitting & (p == pc)
        emit_g = np.where(mine, g, emit_g)
        emit_acc = [np.where(mine, acc[f], emit_acc[f]) for f in range(NRED)]
        accept = on_tree & (~full | emitting)
        take = is_red & (g_of == g) & ~got & accept
        if seen is not None:
            seen["red_already_got"] += int((is_red & (g_of == g) & got).sum())
        red_pop |= take
        takers = L.ballot(take)
        any_ = takers[:, :1] != 0  # warp-uniform: no taker, zeros
        s_ = np.where(any_, L.seg(np.where(take, head[F_META] % 2**32, 0), np.add), 0)
        s_ = s_ % 2**32
        n_ = np.vectorize(lambda x: bin(x).count("1"))(takers & L.group)
        keep = lambda f: np.where(emitting, 0, acc[f])
        mx = lambda v: np.where(any_, L.seg(np.where(take, v, 0), np.maximum), 0)
        out = [None] * NRED
        out[A_VAL] = _wrap32((keep(A_VAL) % 2**32 + s_) % 2**32)
        out[A_CNT] = _wrap32((keep(A_CNT) % 2**32 + n_) % 2**32)
        out[A_NLAST] = np.maximum(keep(A_NLAST), mx(_wrap32(1 - head[F_LAST])))
        out[A_TXN] = np.maximum(keep(A_TXN), mx(head[F_TXN]))
        out[A_TS] = np.maximum(keep(A_TS), mx(head[F_TS]))
        out[A_SRC] = np.maximum(keep(A_SRC), mx(head[F_SRC]))
        _store(got_out, L, (crg + g) * P + p, (got & ~emitting) | take)
        for f in range(NRED):  # lane p writes the fields f = p mod P
            writer = L.live & (f % P == p)
            idx = ((crg + g) * NRED + f)[writer]
            assert (acc_out[idx] == -12345).all()
            acc_out[idx] = out[f][writer]

    # ---- arbitration with multicast fork requests ----
    m = np.zeros_like(req)
    for pin in range(P):
        m |= ((L.shfl(req, base + pin) >> p) & 1) << pin
    m = np.where(lock >= 0, m & np.where(lock < P, 1 << np.clip(lock, 0, 31), 0), m)
    emit = (emit_mask >> p) & 1 == 1
    m = np.where((oc >= Dout) | emit, 0, m)
    winner = rr_winner(m, ptr, P)
    granted0 = m != 0
    win = np.zeros_like(req)
    for pout in range(P):
        w = L.shfl(np.where(granted0, winner, -1), base + pout)
        win |= (w == p).astype(np.int64) << pout
    fire = is_mc & (req != 0) & ((req & ~win) == 0)
    if seen is not None:  # a multicast head that won a branch but not all
        seen["mc_lost_branch"] += int((is_mc & (win != 0) & ~fire).sum())
    pop = red_pop | fire | (uni & (win != 0))
    wkind = L.shfl(is_mc.astype(np.int64) | 2 * fire, base + winner)
    g = granted0 & (((wkind & 1) == 0) | ((wkind & 2) != 0))
    ch = [L.shfl(head[f], base + winner) for f in range(NF)]

    o = _decisions(C, R, P)
    _store(o["arb_pop"], L, t, pop)
    _store(o["in_space"], L, t, (cnt - pop) < Din)
    _store(o["granted"], L, t, g | emit)
    _store(o["rr"], L, t, np.where(g, np.where(winner + 1 == P, 0, winner + 1), ptr))
    _store(o["wh"], L, t, np.where(g, np.where(ch[F_LAST] > 0, -1, winner), lock))
    flit = {F_DST: E + emit_g, F_SRC: emit_acc[A_SRC], F_KIND: KIND_RED,
            F_TXN: emit_acc[A_TXN], F_LAST: _wrap32(1 - emit_acc[A_NLAST]),
            F_TS: emit_acc[A_TS], F_META: emit_acc[A_VAL]}
    ch = [np.where(emit, flit[f], ch[f]) for f in range(NF)]
    _store(o["chosen"], L, t, np.stack(ch, -1))
    assert (acc_out != -12345).all() and (got_out != -12345).all()
    return (_finish(o, C, R, P),
            acc_out.reshape(C, R, G, NRED).astype(np.int32),
            got_out.reshape(C, R, G, P).astype(bool))


# ---------------------------------------------------------------------------
# the cases

# (physical ports, V, C, R, depth): P = ports * V slots in {1, 5, 10, 30, 32}
ARB_CASES = [(1, 1, 2, 7, 2), (5, 1, 2, 7, 2), (5, 1, 3, 11, 4), (5, 2, 2, 7, 2),
             (10, 1, 3, 11, 2), (5, 6, 2, 7, 2), (30, 1, 1, 5, 2), (32, 1, 2, 7, 2),
             (16, 2, 3, 3, 2)]


def _case(seed, n_ports, V, C, R, depth):
    rng = np.random.default_rng(seed)
    E = min(40, R * n_ports)
    tb = _tables(rng, R, E, V, n_ports=n_ports)
    s = _snapshot(rng, (C,), R, E, depth, depth, V, n_ports=n_ports)
    return rng, E, tb, s


def _ids(cases):
    return [f"p{n * v}-v{v}-c{c}r{r}" + (f"-d{d}" if d != 2 else "") + (
        f"-g{rest[0]}" if rest else "") for n, v, c, r, d, *rest in cases]


ARB = ("in_buf", "in_cnt", "out_cnt", "rr_ptr", "wh_lock")


@pytest.mark.parametrize("n_ports,V,C,R,depth", ARB_CASES, ids=_ids(ARB_CASES))
def test_arb_warp_schedule(n_ports, V, C, R, depth):
    """The emulated ``noc_arb_kernel`` equal to the port's
    ``arb_decisions`` and that equal to JAX's, channel by channel."""
    P = n_ports * V
    assert not Lanes(C * R, P).live.all()  # unused lanes or a ragged last warp
    _, E, tb, s = _case(7 * P + R + V, n_ports, V, C, R, depth)
    vc = tb.get("vc_out")
    got = emulate_arb(*(s[k] for k in ARB), tb["route"], depth, vc_out=vc, V=V)
    T = torch.as_tensor
    want = tref.arb_decisions(*(T(s[k]) for k in ARB), T(tb["route"]), depth_out=depth,
                              vc_out=None if vc is None else T(vc), n_vcs=V)
    for name, a, b in zip(want._fields, want, got):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert a.numpy().dtype == b.dtype, name
    jvc = None if vc is None else jnp.asarray(vc)

    def one(*x):  # JAX's decisions are per channel
        return jref.arb_decisions(*x, jnp.asarray(tb["route"]), depth_out=depth,
                                  vc_out=jvc, n_vcs=V)

    j = jax.jit(jax.vmap(one))(*(jnp.asarray(s[k]) for k in ARB))
    for name, a, b in zip(j._fields, j, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"JAX {name}")
    assert want.granted.any() and (~want.granted).any()


# (physical ports, V, C, R, depth, G)
OFFLOAD_CASES = [(5, 1, 2, 7, 2, 1), (5, 1, 3, 11, 2, 3), (5, 2, 2, 7, 2, 40),
                 (1, 1, 3, 11, 2, 3), (5, 6, 2, 5, 2, 3), (32, 1, 2, 3, 2, 40),
                 (10, 1, 3, 5, 4, 3)]


@pytest.mark.parametrize("n_ports,V,C,R,depth,G", OFFLOAD_CASES,
                         ids=_ids(OFFLOAD_CASES))
def test_offload_warp_schedule(n_ports, V, C, R, depth, G):
    """The emulated ``noc_arb_offload_kernel`` equal to the port's
    ``offload_decisions`` and that equal to JAX's, channel by channel;
    groups sharing a parent, multicast heads that lose a branch and
    reduction heads already taken reached."""
    P = n_ports * V
    rng, E, tb, s = _case(11 * P + R + G, n_ports, V, C, R, depth)
    otb, ost = _offload(rng, s, R, E, G, V, n_ports=n_ports)
    vc = tb.get("vc_out")
    seen = dict.fromkeys(("shared_parent", "red_already_got", "mc_lost_branch"), 0)
    arb, acc, got = emulate_offload(*(s[k] for k in ARB), tb["route"], depth,
                                    otb["fork_out"], otb["red_parent"], otb["red_need"],
                                    ost["red_acc"], ost["red_got"], vc_out=vc, V=V,
                                    seen=seen)
    T = torch.as_tensor
    kw = dict(depth_out=depth, n_endpoints=E, n_vcs=V,
              vc_out=None if vc is None else T(vc),
              **{k: T(v) for k, v in (*otb.items(), *ost.items())})
    want, acc_p, got_p = tref.offload_decisions(*(T(s[k]) for k in ARB), T(tb["route"]),
                                                **kw)
    for name, a, b in zip((*want._fields, "red_acc", "red_got"),
                          (*want, acc_p, got_p), (*arb, acc, got)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        assert a.numpy().dtype == b.dtype, name
    jvc = None if vc is None else jnp.asarray(vc)

    def one(*x):  # JAX's decisions are per channel; the tables are shared
        return jref.offload_decisions(
            *x[:5], jnp.asarray(tb["route"]), depth_out=depth, red_acc=x[5],
            red_got=x[6], n_endpoints=E, vc_out=jvc, n_vcs=V,
            **{k: jnp.asarray(v) for k, v in otb.items()})

    j, j_acc, j_got = jax.jit(jax.vmap(one))(
        *(jnp.asarray(s[k]) for k in ARB), jnp.asarray(ost["red_acc"]),
        jnp.asarray(ost["red_got"]))
    for name, a, b in zip((*want._fields, "red_acc", "red_got"),
                          (*j, j_acc, j_got), (*want, acc_p, got_p)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"JAX {name}")
    assert seen["red_already_got"], seen
    if P > 1:
        assert seen["mc_lost_branch"], seen
    if G > 1 and P > 1:
        assert seen["shared_parent"], seen
