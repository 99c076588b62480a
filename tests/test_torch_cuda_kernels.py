"""The CUDA router kernels against their plain PyTorch version, on the card:
arb and apply with and without virtual channels (apply in both FIFO modes:
fused, and the naive step's unfused pop then push), the fused window, and
the collective-offload arb kernel.

These tests need a CUDA device and skip without one (the kernels have no
CPU mode); run them on the GPU host with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``.
This file imports neither JAX nor ``repro``, so it runs where only PyTorch
is installed. The random snapshot and table builders here are shared with
the CPU parity tests in ``test_torch_noc_*.py``. Integer state, so the
tolerance is exact equality.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.noc_router import noc_router as tkern
from repro_torch.kernels.noc_router import ref as tref
from repro_torch.kernels.noc_router.ref import (
    A_CNT,
    F_DST,
    F_KIND,
    F_LAST,
    KIND_MC,
    KIND_RED,
    NF,
    NRED,
)

P = 5


def _tables(rng, R, E, V=1, n_ports=P):
    """Random routing/wiring tables for ``n_ports`` physical ports (P) and
    ``V`` virtual channels; endpoint attachments are unique VC0 slots and
    ``port_ep`` (slot-level) is their inverse, as on every real topology.
    With ``V > 1`` a random dateline table ``vc_out`` [R, P * V, P]."""
    P = n_ports
    route = rng.integers(0, P, (R, E)).astype(np.int32)
    # bias a third of the destinations to port 0 so heads contend for it
    route[:, : E // 3] = 0
    def links():
        t = np.stack([rng.integers(0, R, (R, P)), rng.integers(0, P, (R, P))],
                     -1).astype(np.int32)
        t[rng.random((R, P)) < 0.3] = -1
        return t
    ports = rng.permutation(R * P)[:E]
    ep_attach = np.stack([ports // P, ports % P * V], -1).astype(np.int32)
    port_ep = np.full((R, P * V), -1, np.int32)
    port_ep[ep_attach[:, 0], ep_attach[:, 1]] = np.arange(E)
    tb = dict(route=route, link_src=links(), link_dst=links(),
              port_ep=port_ep, ep_attach=ep_attach)
    if V > 1:
        tb["vc_out"] = rng.integers(0, V, (R, P * V, P)).astype(np.int32)
    return tb


def _snapshot(rng, lead, R, E, din, dout, V=1, n_ports=P):
    """Random consistent state of shape ``lead + [R, n_ports * V, ...]``."""
    P = n_ports
    s = tuple(lead) + (R, P * V)

    def flits(d):
        f = rng.integers(-50, 50, s + (d, NF)).astype(np.int32)
        f[..., F_DST] = rng.integers(-2, E + 2, s + (d,))  # incl. clipped
        f[..., F_LAST] = rng.integers(0, 2, s + (d,))
        return f

    wh = rng.integers(-1, P * V, s).astype(np.int32)
    wh[rng.random(s) < 0.5] = -1
    return dict(
        in_buf=flits(din), in_cnt=rng.integers(0, din + 1, s).astype(np.int32),
        out_buf=flits(dout),
        out_cnt=rng.integers(0, dout + 1, s).astype(np.int32),
        rr_ptr=rng.integers(0, P * V, s).astype(np.int32), wh_lock=wh,
        ep_space=rng.random(tuple(lead) + (E,)) < 0.7)


def _egress(rng, C, E, Q, cycle0, N):
    """Random circular egress queues: counts 0..Q (empty and full), heads
    anywhere, ready stamps before, inside and after the window."""
    eg = rng.integers(-50, 50, (C, E, Q, NF)).astype(np.int32)
    eg[..., F_DST] = rng.integers(0, E, (C, E, Q))
    return dict(eg=eg,
                eg_ready=rng.integers(cycle0 - 3, cycle0 + N + 3,
                                      (C, E, Q)).astype(np.int32),
                eg_head=rng.integers(0, Q, (C, E)).astype(np.int32),
                eg_cnt=rng.integers(0, Q + 1, (C, E)).astype(np.int32))


def _offload(rng, s, R, E, G, V=1, n_ports=P):
    """Random collective-offload tables and ALU state for the snapshot
    ``s`` (made by ``_snapshot``), whose input heads it turns into
    group-addressed multicast and reduction heads in part.

    The cases the offload arbitration must get right are made common:
    fork slots on a third of the ports (multicast heads contend with
    unicast heads and each other, so partial wins are frequent), groups 0
    and 1 sharing a parent slot on half the routers, full ALU slots,
    contributions already taken, and heads of every kind addressed to
    groups past ``G``. Returns ``(tables, state)`` dicts of numpy arrays.
    """
    PV = n_ports * V
    heads = s["in_buf"][..., 0, :]
    roll = rng.random(heads.shape[:-1])
    heads[..., F_KIND] = np.where(roll < 0.3, KIND_MC,
                                  np.where(roll < 0.6, KIND_RED,
                                           heads[..., F_KIND]))
    group = roll < 0.65
    heads[..., F_DST] = np.where(
        group, E + rng.integers(0, 2 * G + 1, roll.shape), heads[..., F_DST])
    parent = rng.integers(-1, PV, (R, G)).astype(np.int32)
    for g, p_share in ((1, 0.8), (2, 0.3))[:G - 1]:
        share = rng.random(R) < p_share
        parent[share, g] = parent[share, 0]
    need = rng.integers(0, 4, (R, G)).astype(np.int32)
    lead = s["in_cnt"].shape[:-2]
    acc = rng.integers(-9, 9, lead + (R, G, NRED)).astype(np.int32)
    # most slots full (count >= need), and most parent slots unlocked, so
    # that emissions are common
    acc[..., A_CNT] = np.where(rng.random(lead + (R, G)) < 0.7,
                               need + rng.integers(0, 2, lead + (R, G)),
                               rng.integers(0, 4, lead + (R, G)))
    wh = s["wh_lock"].reshape(-1, R, PV)
    for c in range(wh.shape[0]):
        r, g = np.nonzero((rng.random((R, G)) < 0.6) & (parent >= 0))
        wh[c, r, parent[r, g]] = -1
    tables = dict(fork_out=rng.random((R, G, PV)) < 0.35, red_parent=parent,
                  red_need=need)
    state = dict(red_acc=acc, red_got=rng.random(lead + (R, G, PV)) < 0.3)
    return tables, state


def _on_card(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return {k: torch.as_tensor(v, device="cuda") for k, v in d.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("R,depth,V,n_ports", [
    (32, 2, 1, P), (32, 4, 1, P), (1024, 2, 1, P), (32, 2, 2, P), (32, 4, 2, P),
    (1024, 2, 2, P), (32, 2, 6, P), (7, 2, 1, P), (7, 2, 1, 1), (11, 2, 1, 32),
    (11, 2, 2, 16), (5, 2, 6, P)],
    ids=["32-2", "32-4", "1024-2", "32-2-vc2", "32-4-vc2", "1024-2-vc2", "32-2-vc6",
         "7-2-ragged", "7-2-p1", "11-2-p32", "11-2-p32-vc2", "5-2-vc6"])
def test_cuda_kernels_match_plain(R, depth, V, n_ports):
    """The CUDA arb and apply kernels against the plain version on the
    card, bit for bit, and one launch of each per router cycle; the arb
    kernel's lane layouts at their edges (a warp holds 32 // P routers, a
    lane per slot): a ragged last warp (3 x 7 routers over warps of 6 at
    P = 5, over one warp of 32 at P = 1), 30 slots (V = 6: two unused
    lanes) and 32 (one router a warp, every lane used; 32 ports, and 16 at
    n_vcs=2)."""
    rng = np.random.default_rng(R + depth + 100 * V)
    E = 1056 if R == 1024 else min(40, R * n_ports)
    tb = _on_card(_tables(rng, R, E, V, n_ports=n_ports))
    s = _on_card(_snapshot(rng, (3,), R, E, depth, depth, V, n_ports=n_ports))
    args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], s["rr_ptr"],
            s["wh_lock"], tb["route"], tb["link_src"], tb["link_dst"],
            tb["port_ep"], tb["ep_attach"], s["ep_space"])
    kw = dict(vc_out=tb.get("vc_out"), n_vcs=V)
    before = dict(tkern.LAUNCHES)
    got = tkern.router_cycle_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = tref.router_cycle_reference(*args, fused=True, **kw)
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"output {i} differs"
    for k in (tkern.mode("arb", V), tkern.mode("apply", V)):
        assert tkern.LAUNCHES[k] == before[k] + 1


APPLY_CASES = [
    (32, 2, 2, 1, P, "random"), (32, 4, 4, 1, P, "random"), (32, 4, 2, 2, P, "random"),
    (1024, 2, 2, 2, P, "random"), (7, 2, 2, 1, P, "random"), (7, 2, 2, 1, 1, "random"),
    (11, 2, 2, 1, 32, "random"), (5, 2, 2, 6, P, "random"), (32, 2, 2, 1, P, "none"),
    (32, 2, 4, 2, P, "half"), (32, 16, 16, 1, P, "random")]
APPLY_IDS = ["32-2", "32-4", "32-42-vc2", "1024-2-vc2", "7-2-ragged", "7-2-p1", "11-2-p32",
             "5-2-vc6", "32-2-no-links", "32-24-vc2-half-links", "32-16-deep"]


@pytest.mark.gpu
@pytest.mark.parametrize("R,din,dout,V,n_ports,links", APPLY_CASES, ids=APPLY_IDS)
def test_cuda_apply_matches_plain(R, din, dout, V, n_ports, links):
    """The apply kernel alone against ``ref.apply_phase(fused=True)`` on
    the card, bit for bit (dead FIFO slots included), on the plain arb
    decisions of a random snapshot: its inputs untouched and one launch
    counted. At the warp layout's edges (a ragged last warp, 1, 30 and 32
    slots), at depths 4 and 2 + 4, with no links at all and with half of
    them missing, and at depths 16 + 16, whose staged rows need more than
    48 KB of shared memory a CTA."""
    _apply_case(R, din, dout, V, n_ports, links, fused=True)


@pytest.mark.gpu
@pytest.mark.parametrize("R,din,dout,V,n_ports,links", APPLY_CASES, ids=APPLY_IDS)
def test_cuda_apply_unfused_matches_plain(R, din, dout, V, n_ports, links):
    """The apply kernel's unfused FIFO mode (the naive step) against
    ``ref.apply_phase(fused=False)`` at the same shapes, bit for bit, dead
    slots included (row D - 1 takes the old head on a pop it is not pushed
    into): inputs untouched, one ``apply_unfused`` launch counted and no
    fused-mode launch."""
    _apply_case(R, din, dout, V, n_ports, links, fused=False)


def _apply_case(R, din, dout, V, n_ports, links, fused):
    rng = np.random.default_rng(17 * R + din + 10 * dout + 100 * V)
    E = 1056 if R == 1024 else min(40, R * n_ports)
    tb = _tables(rng, R, E, V, n_ports=n_ports)
    if links != "random":
        cut = rng.random(tb["link_src"].shape[:2]) < (1.0 if links == "none" else 0.5)
        tb["link_src"][cut] = -1
        tb["link_dst"][cut[::-1]] = -1
    tb = _on_card(tb)
    s = _on_card(_snapshot(rng, (3,), R, E, din, dout, V, n_ports=n_ports))
    vc = dict(vc_out=tb.get("vc_out"), n_vcs=V)
    arb = tref.arb_decisions(s["in_buf"], s["in_cnt"], s["out_cnt"], s["rr_ptr"],
                             s["wh_lock"], tb["route"], depth_out=dout, **vc)
    args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], arb, tb["link_src"],
            tb["link_dst"], tb["port_ep"], s["ep_space"])
    copies = [t.clone() for t in (*args[:4], *arb, *args[5:])]
    key = tkern.mode("apply" if fused else "apply_unfused", V)
    other = tkern.mode("apply_unfused" if fused else "apply", V)
    before = dict(tkern.LAUNCHES)
    got = tkern.apply_cuda(*args, n_vcs=V, fused=fused)
    torch.cuda.synchronize()
    assert tkern.LAUNCHES[key] == before[key] + 1
    assert tkern.LAUNCHES[other] == before[other]
    want = tref.apply_phase(*args, fused=fused, n_vcs=V)
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"output {i} differs"
    for i, (a, b) in enumerate(zip(copies, (*args[:4], *arb, *args[5:]))):
        assert torch.equal(a, b), f"input {i} modified"


@pytest.mark.gpu
def test_cuda_apply_refuses_deep_fifos():
    """Depths past what a CTA's shared memory stages raise before any
    launch."""
    rng = np.random.default_rng(3)
    tb = _on_card(_tables(rng, 4, 8))
    s = _on_card(_snapshot(rng, (1,), 4, 8, 40, 40))
    arb = tref.arb_decisions(s["in_buf"], s["in_cnt"], s["out_cnt"], s["rr_ptr"],
                             s["wh_lock"], tb["route"], depth_out=40)
    before = tkern.LAUNCHES["apply"]
    with pytest.raises(ValueError, match="depths"):
        tkern.apply_cuda(s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], arb,
                         tb["link_src"], tb["link_dst"], tb["port_ep"], s["ep_space"])
    assert tkern.LAUNCHES["apply"] == before


def _fused_case(R, N, V, seed, plan=None):
    """One launch of the fused kernel (``plan``, default the wrapper's)
    against N cycles of the plain ``router_cycles_scan`` on random state,
    bit for bit; its inputs stay untouched and it counts one launch."""
    rng = np.random.default_rng(seed)
    E, C, Q, cycle0 = (40 if R <= 32 else min(1056, 2 * R)), 3, 8, 50
    tb = _on_card(_tables(rng, R, E, V))
    s = _on_card(_snapshot(rng, (C,), R, E, 2, 2, V))
    q = _on_card(_egress(rng, C, E, Q, cycle0, N))
    args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], s["rr_ptr"],
            s["wh_lock"], q["eg"], q["eg_ready"], q["eg_head"], q["eg_cnt"],
            tb["route"], tb["link_src"], tb["link_dst"], tb["port_ep"],
            tb["ep_attach"], s["ep_space"], cycle0, N)
    kw = dict(vc_out=tb.get("vc_out"), n_vcs=V)
    copies = [a.clone() for a in args[:10]]
    before = dict(tkern.LAUNCHES)
    got = tkern.router_cycles_fused_cuda(*args, **kw, plan=plan)
    torch.cuda.synchronize()
    want = tref.router_cycles_scan(*args, **kw)
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"output {i} differs"
    for i, (a, b) in enumerate(zip(copies, args)):
        assert torch.equal(a, b), f"input {i} modified"
    key = "fused" if V == 1 else "fused_vc"
    assert tkern.LAUNCHES[key] == before[key] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("R,N,V", [(32, 1, 1), (32, 4, 1), (32, 16, 2),
                                   (1024, 4, 1), (1024, 4, 2), (256, 4, 1),
                                   (512, 4, 1), (437, 4, 1), (1024, 16, 1),
                                   (1024, 16, 2), (4096, 4, 1), (128, 4, 1)])
def test_cuda_fused_matches_plain(R, N, V):
    """The fused window as the wrapper plans it, at every cluster size the
    plan picks (1: R = 32; 2: 128; 4: 256; 8: 512 and the ragged 437; 16:
    1024) and past a 16-CTA cluster (4096: the global-memory kernel),
    against the plain version."""
    P = 5 * V
    plan = tkern.fused_plan(R, P, 2, 2, V)
    want = {32: 1, 128: 2, 256: 4, 437: 8, 512: 8, 1024: 16}
    if R in want:
        assert (plan.kernel, plan.cluster) == ("cluster", want[R]), plan
    else:
        assert plan.kernel == "global", plan
    if R == 437:
        assert plan.ranges[-1] == (385, 437)
    _fused_case(R, N, V, 7 * R + N + V)


@pytest.mark.gpu
@pytest.mark.parametrize("R,V,cluster,k", [
    (32, 1, 2, 1), (32, 2, 4, 1), (1024, 1, 8, 1), (1024, 1, 8, 2),
    (1024, 2, 16, 2), (20, 1, 16, 1), (256, 2, 16, 2), (437, 1, 4, 2)],
    ids=lambda x: str(x))
def test_cuda_fused_variants_match_plain(R, V, cluster, k):
    """The window at other cluster sizes and router groups per warp than
    the plan's (the variants ``tools/fused_chip.py`` times), CTAs with no
    routers (R = 20 on 16 CTAs) and a ragged split with two groups a warp
    (437 on 4 CTAs) included, against the plain version at N = 4."""
    plan = tkern.fused_plan(R, 5 * V, 2, 2, V, cluster=cluster,
                            slots_per_thread=k)
    _fused_case(R, 4, V, 13 * R + V + cluster, plan)


@pytest.mark.gpu
@pytest.mark.parametrize("R,G,V,n_ports", [
    (32, 1, 1, P), (32, 3, 1, P), (32, 2, 2, P), (1024, 2, 1, P), (1024, 1, 2, P),
    (32, 3, 6, P), (7, 40, 1, P), (7, 40, 2, P), (7, 3, 1, 1), (11, 3, 1, 32),
    (5, 40, 6, P)],
    ids=["32-1", "32-3", "32-2-vc2", "1024-2", "1024-1-vc2", "32-3-vc6", "7-40-ragged",
         "7-40-ragged-vc2", "7-3-p1", "11-3-p32", "5-40-vc6"])
def test_cuda_offload_arb_matches_plain(R, G, V, n_ports):
    """The offload arb kernel and the offload router cycle (offload arb +
    the unchanged apply kernel) against the plain version on the card, bit
    for bit, with random reduction-ALU state; the inputs stay untouched,
    and one launch of each kernel per cycle. Also at the lane layouts'
    edges (a ragged last warp; 1, 30 and 32 slots) and with 40 groups,
    walked by each router's lanes in step."""
    rng = np.random.default_rng(11 * R + G + 100 * V)
    E = 1056 if R == 1024 else min(40, R * n_ports)
    tb = _tables(rng, R, E, V, n_ports=n_ports)
    s = _snapshot(rng, (3,), R, E, 2, 2, V, n_ports=n_ports)
    otb, ost = _offload(rng, s, R, E, G, V, n_ports=n_ports)
    tb, s, otb, ost = (_on_card(d) for d in (tb, s, otb, ost))
    args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], s["rr_ptr"],
            s["wh_lock"], tb["route"], tb["link_src"], tb["link_dst"],
            tb["port_ep"], tb["ep_attach"], s["ep_space"])
    kw = dict(vc_out=tb.get("vc_out"), n_vcs=V, n_endpoints=E, **otb, **ost)
    copies = [a.clone() for a in (*args[:6], *ost.values())]
    arb_args = (s["in_buf"], s["in_cnt"], s["out_cnt"], s["rr_ptr"],
                s["wh_lock"], tb["route"])
    arb_k = tkern.arb_offload_cuda(*arb_args, depth_out=2, **kw)
    arb_p = tref.offload_decisions(*arb_args, depth_out=2, **kw)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip((*arb_p[0], *arb_p[1:]),
                                   (*arb_k[0], *arb_k[1:]))):
        assert torch.equal(a, b), f"arb output {i} differs"
    before = dict(tkern.LAUNCHES)
    got = tkern.router_cycle_offload_cuda(*args, **kw)
    torch.cuda.synchronize()
    want = tref.router_cycle_offload_reference(
        *args[:6], ost["red_acc"], ost["red_got"], *args[6:11],
        otb["fork_out"], otb["red_parent"], otb["red_need"], s["ep_space"],
        n_endpoints=E, fused=True, vc_out=tb.get("vc_out"), n_vcs=V)
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"cycle output {i} differs"
    for i, (a, b) in enumerate(zip(copies, (*args[:6], *ost.values()))):
        assert torch.equal(a, b), f"input {i} modified"
    for k in (tkern.mode("arb_offload", V), tkern.mode("apply", V)):
        assert tkern.LAUNCHES[k] == before[k] + 1
    assert tkern.LAUNCHES[tkern.mode("arb", V)] == before[tkern.mode("arb", V)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,G,V,n_ports", [
    (32, 3, 1, P), (32, 2, 2, P), (1024, 2, 1, P), (7, 40, 2, P), (11, 3, 1, 32),
    (5, 40, 6, P)],
    ids=["32-3", "32-2-vc2", "1024-2", "7-40-ragged-vc2", "11-3-p32", "5-40-vc6"])
def test_cuda_apply_unfused_after_offload_arb(R, G, V, n_ports):
    """The unfused apply mode on the offload arb kernel's decisions (fork
    copies and emitted reduction flits in ``granted`` / ``chosen``): the
    apply kernel alone against ``apply_phase(fused=False)`` and the naive
    offload router cycle against ``router_cycle_offload_reference(fused=
    False)``, bit for bit, inputs untouched, one ``apply_unfused`` launch
    per cycle."""
    rng = np.random.default_rng(13 * R + G + 100 * V)
    E = 1056 if R == 1024 else min(40, R * n_ports)
    tb = _tables(rng, R, E, V, n_ports=n_ports)
    s = _snapshot(rng, (3,), R, E, 2, 2, V, n_ports=n_ports)
    otb, ost = _offload(rng, s, R, E, G, V, n_ports=n_ports)
    tb, s, otb, ost = (_on_card(d) for d in (tb, s, otb, ost))
    args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], s["rr_ptr"],
            s["wh_lock"], tb["route"], tb["link_src"], tb["link_dst"],
            tb["port_ep"], tb["ep_attach"], s["ep_space"])
    kw = dict(vc_out=tb.get("vc_out"), n_vcs=V, n_endpoints=E, **otb, **ost)
    copies = [a.clone() for a in (*args[:6], *ost.values())]
    arb, _, _ = tkern.arb_offload_cuda(s["in_buf"], s["in_cnt"], s["out_cnt"],
                                       s["rr_ptr"], s["wh_lock"], tb["route"],
                                       depth_out=2, **kw)
    app = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], arb, tb["link_src"],
           tb["link_dst"], tb["port_ep"], s["ep_space"])
    got = tkern.apply_cuda(*app, n_vcs=V, fused=False)
    want = tref.apply_phase(*app, fused=False, n_vcs=V)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"apply output {i} differs"
    before = dict(tkern.LAUNCHES)
    got = tkern.router_cycle_offload_cuda(*args, **kw, fused=False)
    torch.cuda.synchronize()
    want = tref.router_cycle_offload_reference(
        *args[:6], ost["red_acc"], ost["red_got"], *args[6:11],
        otb["fork_out"], otb["red_parent"], otb["red_need"], s["ep_space"],
        n_endpoints=E, fused=False, vc_out=tb.get("vc_out"), n_vcs=V)
    for i, (a, b) in enumerate(zip(want, got)):
        assert torch.equal(a, b), f"cycle output {i} differs"
    for i, (a, b) in enumerate(zip(copies, (*args[:6], *ost.values()))):
        assert torch.equal(a, b), f"input {i} modified"
    for k in (tkern.mode("arb_offload", V), tkern.mode("apply_unfused", V)):
        assert tkern.LAUNCHES[k] == before[k] + 1
    assert tkern.LAUNCHES[tkern.mode("apply", V)] == before[tkern.mode("apply", V)]


@pytest.mark.gpu
def test_cuda_naive_step_raises_when_unfused_launch_is_refused(monkeypatch):
    """A naive simulator step on the card whose unfused apply launch is
    refused raises, counts no apply launch and does not fall back to the
    plain version or the fused mode (the library's launcher replaced by
    one that refuses every unfused launch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.core.noc import sim as TS
    from repro_torch.core.noc import traffic as TT
    from repro_torch.core.noc.params import NocParams
    from repro_torch.core.noc.topology import build_mesh
    from repro_torch.kernels.noc_router import ops as tops

    lib = tkern.LIBRARY.load()
    real = lib.noc_apply_launch
    modes = []

    def refuse_unfused(*a):
        modes.append(a[-2])
        return 700 if a[-2] == 0 else real(*a)

    monkeypatch.setattr(lib, "noc_apply_launch", refuse_unfused)
    for name in ("router_cycle_reference", "router_cycle_offload_reference"):
        monkeypatch.setattr(tops, name, lambda *a, **k: pytest.fail("plain version ran"))
    topo = build_mesh(nx=4, ny=2)
    wl = TT.dma_workload(topo, "uniform", transfer_kb=1, n_txns=1)
    before = dict(tkern.LAUNCHES)
    TS.run(TS.build_sim(topo, NocParams(), wl, device="cuda"), 2)  # fused: launches
    sim = TS.build_sim(topo, NocParams(step_impl="naive"), wl, device="cuda")
    with pytest.raises(RuntimeError, match="noc_apply_kernel launch failed"):
        TS.run(sim, 2)
    assert modes == [1, 1, 0]
    assert tkern.LAUNCHES["apply"] == before["apply"] + 2
    assert tkern.LAUNCHES["apply_unfused"] == before["apply_unfused"]
