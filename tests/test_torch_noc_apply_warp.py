"""The per-cycle apply kernel's warp schedule, emulated on the CPU.

``noc_apply_kernel`` runs only on the card. Here it is emulated lane by
lane in numpy, as the CUDA source runs it: CTAs of four warps of 32 lanes;
with P slots a warp holds ``32 // P`` routers, lane ``sub * P + p`` being
slot p of router ``sub``, so the warp's live slots are contiguous and lane
j holds its j-th; lanes past the last whole router and the routers past
C * R in the last warp load, copy and write nothing but take part in the
ballots. Each lane loads its table rows, counts, arb scratch and
``chosen``, and the warp reads its old FIFO rows of both sides with
consecutive lanes on consecutive ints; then each lane makes one remote
load per side (the upstream output count and head of its own VC, the
downstream post-pop ``in_space``); one ballot per side gives each lane its
port group's eligibility bits (lowest eligible VC wins the wire); the old
rows go to the warp's span of shared memory, each lane pops and pushes
its slot's rows there in place, and the warp writes its spans back
coalesced.

The emulation is held bit for bit against the port's
``ref.apply_phase(fused=...)`` and against the JAX package's
``link_inputs`` + ``sent_mask`` + ``apply_cycle(fused=...)`` on the same
numpy snapshots, dead FIFO slots included, in both FIFO modes (fused, and
the naive step's unfused pop then push, whose roll moves the old head,
kept in registers before row 0 is rewritten, into row D - 1), at P in {1,
5, 10, 30, 32} (V in {1, 2, 6}), depths 2 and 4, with missing links,
endpoint slots and C * R not a multiple of the routers per warp. Integer
state, so the tolerance is exact equality.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.noc_router import ref as jref
from repro_torch.kernels.noc_router import ref as tref
from repro_torch.kernels.noc_router.ref import NF
from test_torch_cuda_kernels import _snapshot, _tables
from test_torch_noc_arb_warp import FULL, Lanes

torch.set_num_threads(1)

MARK = -12345  # a word no slot keeps: every output word is written once


def _rounds(W, span):
    """The coalesced copy rounds of a warp span: word ``k = i * 32 + lane``
    in round i; ``span`` [W] words per warp."""
    lane = np.arange(32)
    for i in range(-(-int(span.max(initial=0)) // 32)):
        k = i * 32 + lane
        yield np.broadcast_to(k, (W, 32)), k[None, :] < span[:, None]


def emulate_apply(in_buf, in_cnt, out_buf, out_cnt, arb, link_src, link_dst,
                  port_ep, ep_space, V=1, seen=None, fused=True):
    """``noc_apply_kernel``, lane by lane, in the FIFO mode ``fused``;
    ``arb`` holds the numpy arb scratch (``arb_pop``, ``granted``,
    ``chosen``, ``in_space``). Returns ``(in_buf', in_cnt', out_buf',
    out_cnt')``; ``seen`` counts the cases reached."""
    C, R, P, Din, _ = in_buf.shape
    Dout, E = out_buf.shape[3], ep_space.shape[-1]
    fin, fout = Din * NF, Dout * NF
    L = Lanes(C * R, P)
    lane = np.arange(32)
    p, cr, live = L.p, L.cr, L.live
    W = p.shape[0]
    rpw = 32 // P
    cr0 = (cr - lane // P)[:, 0]  # the warp's first router
    ns = np.clip(C * R - cr0, 0, rpw) * P  # its live slots, lanes 0 .. ns - 1
    assert (live == (lane[None, :] < ns[:, None])).all()
    slot0 = cr0 * P

    # 1. the warp's old rows, both sides, read coalesced (parked in shared
    #    memory once the decisions are made)
    s_in = np.full((W, 32 * fin), MARK, np.int64)
    s_out = np.full((W, 32 * fout), MARK, np.int64)
    for sm, buf, n in ((s_in, in_buf, fin), (s_out, out_buf, fout)):
        flat = buf.reshape(-1)
        for k, ok in _rounds(W, ns * n):
            w, kk = np.nonzero(ok)
            sm[w, k[w, kk]] = flat[slot0[w] * n + k[w, kk]]

    # 2. own slot, tables, arb scratch
    t = cr * P + p
    r = cr % R
    Pp = P // V
    pp = p // V
    v = p - pp * V
    lp = (r * Pp + pp) * 2
    src_r = L.load(link_src.reshape(-1), lp, -1)
    src_p = L.load(link_src.reshape(-1), lp + 1, 0)
    dst_r = L.load(link_dst.reshape(-1), lp, -1)
    dst_p = L.load(link_dst.reshape(-1), lp + 1, 0)
    pe = L.load(port_ep.reshape(-1), r * P + p, -1)
    icnt = L.load(in_cnt.reshape(-1), t, 0)
    ocnt = L.load(out_cnt.reshape(-1), t, 0)
    pop_in = L.load(arb["arb_pop"].reshape(-1), t, False)
    grant = L.load(arb["granted"].reshape(-1), t, False)
    space = L.load(arb["in_space"].reshape(-1), t, False)
    ch = [L.load(arb["chosen"].reshape(-1), t * NF + f, 0) for f in range(NF)]

    # 3. one remote load per side (and the upstream head, speculatively)
    chan = (cr - r) * P
    up = chan + np.clip(src_r, 0, R - 1) * P + np.clip(src_p, 0, Pp - 1) * V + v
    down = chan + np.clip(dst_r, 0, R - 1) * P + np.clip(dst_p, 0, Pp - 1) * V + v
    up_cnt = L.load(out_cnt.reshape(-1), up, 0)
    dn_space = L.load(arb["in_space"].reshape(-1), down, False)
    flit = [L.load(out_buf.reshape(-1), up * fout + f, 0) for f in range(NF)]
    ep_ok = (pe >= 0) & L.load(ep_space.reshape(-1), (cr // R) * E + np.clip(pe, 0, E - 1),
                               False)

    # 4. a wire's lowest eligible VC, from the port group's ballot bits
    in_elig = L.ballot((src_r >= 0) & (up_cnt > 0) & space)
    out_elig = L.ballot((dst_r >= 0) & (ocnt > 0) & dn_space)
    upto = ((2 << v) - 1) & FULL
    me = 1 << v
    accept = ((in_elig >> (lane - v)) & upto) == me
    sent_link = ((out_elig >> (lane - v)) & upto) == me
    sent = sent_link | ((ocnt > 0) & ep_ok)
    if seen is not None:
        seen["missing_link"] += int((live & (src_r < 0)).sum())
        seen["accept"] += int((live & accept).sum())
        seen["endpoint_send"] += int((live & ~sent_link & sent).sum())
        # a lower VC of the same wire took it: eligible here but not accepted
        own = ((in_elig >> lane) & 1) == 1
        seen["lower_vc_won"] += int((live & own & ~accept).sum())

    # 5. each lane pops and pushes its rows in place (ascending d); the
    #    unfused mode's row D - 1 takes the old head, read before row 0 is
    #    rewritten
    for sm, D, cnt, pop, push, f_ in ((s_in, Din, icnt, pop_in, accept, flit),
                                      (s_out, Dout, ocnt, sent, grant, ch)):
        rows = sm.reshape(W, 32, D, NF)
        tail = np.clip(cnt - pop, 0, D - 1)
        new = np.stack(f_, -1)
        head = rows[:, :, 0].copy()
        for d in range(D):
            src = rows[:, :, d + 1] if d + 1 < D else (rows[:, :, d] if fused else head)
            rows[:, :, d] = np.where((live & push & (d == tail))[..., None], new,
                                     np.where((live & pop)[..., None], src, rows[:, :, d]))
            if seen is not None and not fused and d == D - 1:
                seen["head_wrapped"] += int((live & pop & ~(push & (tail == d))).sum())

    # 6. the counts by lane, the rows coalesced
    outs = []
    for sm, n, cnt, pop, push in ((s_in, fin, icnt, pop_in, accept),
                                  (s_out, fout, ocnt, sent, grant)):
        buf = np.full(C * R * P * n, MARK, np.int64)
        for k, ok in _rounds(W, ns * n):
            w, kk = np.nonzero(ok)
            at = slot0[w] * n + k[w, kk]
            assert (buf[at] == MARK).all()
            buf[at] = sm[w, k[w, kk]]
        new_cnt = np.full(C * R * P, MARK, np.int64)
        new_cnt[t[live]] = (cnt - pop + push)[live]
        assert (buf != MARK).all() and (new_cnt != MARK).all()
        outs.append(buf.reshape((C, R, P, n // NF, NF)).astype(np.int32))
        outs.append(new_cnt.reshape(C, R, P).astype(np.int32))
    return tuple(outs)


# (physical ports, V, C, R, depth in, depth out): P = ports * V slots in
# {1, 5, 10, 30, 32}
CASES = [(1, 1, 2, 7, 2, 2), (5, 1, 2, 7, 2, 2), (5, 1, 3, 11, 4, 4), (5, 2, 2, 7, 2, 2),
         (5, 2, 3, 11, 4, 2), (10, 1, 3, 11, 2, 2), (5, 6, 2, 7, 2, 2), (5, 6, 2, 5, 2, 4),
         (30, 1, 1, 5, 2, 2), (32, 1, 2, 7, 2, 2), (16, 2, 3, 3, 2, 2)]


def _id(n, v, c, r, din, dout):
    return f"p{n * v}-v{v}-c{c}r{r}" + ("" if din == dout == 2 else f"-d{din}{dout}")


@pytest.mark.parametrize("n_ports,V,C,R,din,dout", CASES,
                         ids=[_id(*c) for c in CASES])
def test_apply_warp_schedule(n_ports, V, C, R, din, dout):
    """The emulated ``noc_apply_kernel`` equal to the port's
    ``apply_phase(fused=True)`` and that equal to JAX's ``link_inputs`` +
    ``sent_mask`` + ``apply_cycle(fused=True)``, channel by channel, dead
    FIFO slots included; missing links, accepted flits, endpoint sends and
    (with V > 1) lower VCs winning a wire reached."""
    _warp_case(n_ports, V, C, R, din, dout, fused=True)


@pytest.mark.parametrize("n_ports,V,C,R,din,dout", CASES,
                         ids=[_id(*c) for c in CASES])
def test_apply_warp_schedule_unfused(n_ports, V, C, R, din, dout):
    """The same in the unfused FIFO mode (the naive step): the emulation
    equal to ``apply_phase(fused=False)`` and to JAX's ``apply_cycle(fused=
    False)``, dead slots included; pops whose old head wraps into row
    D - 1 reached."""
    _warp_case(n_ports, V, C, R, din, dout, fused=False)


def _warp_case(n_ports, V, C, R, din, dout, fused):
    P = n_ports * V
    assert not Lanes(C * R, P).live.all()  # unused lanes or a ragged last warp
    rng = np.random.default_rng(13 * P + R + V + din)
    E = min(40, R * n_ports)
    tb = _tables(rng, R, E, V, n_ports=n_ports)
    s = _snapshot(rng, (C,), R, E, din, dout, V, n_ports=n_ports)
    T = torch.as_tensor
    arb = tref.arb_decisions(*(T(s[k]) for k in ("in_buf", "in_cnt", "out_cnt", "rr_ptr",
                                                 "wh_lock")),
                             T(tb["route"]), depth_out=dout,
                             vc_out=T(tb["vc_out"]) if V > 1 else None, n_vcs=V)
    a = {k: getattr(arb, k).numpy() for k in ("arb_pop", "granted", "chosen", "in_space")}
    state = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"])
    tabs = (tb["link_src"], tb["link_dst"], tb["port_ep"], s["ep_space"])
    seen = dict.fromkeys(("missing_link", "accept", "endpoint_send", "lower_vc_won",
                          "head_wrapped"), 0)
    got = emulate_apply(*state, a, *tabs, V=V, seen=seen, fused=fused)
    want = tref.apply_phase(*map(T, state), arb, *map(T, tabs), fused=fused, n_vcs=V)
    for name, x, y in zip(("in_buf", "in_cnt", "out_buf", "out_cnt"), want, got):
        np.testing.assert_array_equal(x.numpy(), y, err_msg=name)
        assert x.numpy().dtype == y.dtype, name

    ls, ld, pe = (jnp.asarray(x) for x in tabs[:3])

    def one(in_buf, in_cnt, out_buf, out_cnt, arb_pop, granted, chosen, in_space,
            ep_space):  # JAX's phases are per channel; the tables are shared
        up, acc = jref.link_inputs(jref.heads(out_buf), out_cnt > 0, ls, in_space, n_vcs=V)
        sent = jref.sent_mask(out_cnt > 0, ld, pe, in_space, ep_space, n_vcs=V)
        return jref.apply_cycle(in_buf, in_cnt, out_buf, out_cnt, arb_pop, granted,
                                chosen, acc, up, sent, fused=fused)

    j = jax.jit(jax.vmap(one))(*(jnp.asarray(x) for x in state),
                               *(jnp.asarray(a[k]) for k in ("arb_pop", "granted",
                                                             "chosen", "in_space")),
                               jnp.asarray(s["ep_space"]))
    for name, x, y in zip(("in_buf", "in_cnt", "out_buf", "out_cnt"), j, want):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=f"JAX {name}")
    assert seen["missing_link"] and seen["accept"] and seen["endpoint_send"], seen
    if V > 1:
        assert seen["lower_vc_won"], seen
    if not fused:
        assert seen["head_wrapped"], seen
