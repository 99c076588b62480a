"""NoC invariants through the port: ``tests/test_noc_invariants.py`` and
``tests/test_noc_sim_fixes.py`` (all but its two ``run_sweep`` cases,
which wait for the port's ``run_sweep``) mirrored. Each configuration
runs in both packages; the port's SimState equals JAX's leaf for leaf,
every stats entry is equal, and the JAX test's claim holds on the port.

Horizons: where a JAX test runs past completion, the mirror stops at the
completion cycle measured in the JAX simulator plus at least 10% and
asserts completion (drained narrow traffic: every request answered, the
NIs empty; DMAs: every transfer done), so the claims read the numbers of
the JAX horizon. The drains after 400 cycles of narrow traffic end within
40 cycles (JAX) and run 60 (of 400); the write bursts end by 180 (runs
200 of 3000), the merging bursts by 70 (80 of 600), the uniform reads by
260 (290 of 500), the mixed-size RoB writes and reads by 40 and 60 (60 and
70 of 600), the RoB-less all-reduce by 200 (230 of 900), the hot spot's
drain by 120 (140 of 600).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.noc import engine as Jeng
from repro.core.noc.params import CH_WIDE, WIDE_AW_W, NocParams
from repro_torch import convert
from test_torch_noc_sim import assert_states_equal, jax_state_dict
from torch_mirror import JAX, PORT, build_both, run_both

torch.set_num_threads(1)


def _mesh(pkg):
    return pkg.top.build_mesh(nx=4, ny=4)


def _drained(st) -> bool:
    return int(st.eps.ni_cnt.sum()) == 0 and int(st.eps.lat_cnt.sum()) == int(
        st.eps.n_sent.sum())


# ----------------------------------------------------------------------
# tests/test_noc_invariants.py
# ----------------------------------------------------------------------
def _narrow(pattern, rate):
    def make(pkg):
        topo = _mesh(pkg)
        return topo, pkg.T.narrow_workload(topo, pattern, rate)
    return make


@functools.lru_cache(maxsize=None)
def _drain_sims(pattern):
    """The drain (rate 0): the same workload for every load rate of a
    pattern, so one pair of sims (and one JAX compile) serves all three."""
    return build_both(_narrow(pattern, 0.0))


@pytest.mark.parametrize("rate", [0.01, 0.05, 0.1])
@pytest.mark.parametrize("pattern", ["uniform", "bit-complement", "neighbor"])
def test_request_response_conservation(rate, pattern):
    """After drain, every narrow request produced exactly one response."""
    jst, tst, _ = run_both(build_both(_narrow(pattern, rate)), 400, tag="load")
    # drain: stop generating (rate 0) and run until quiescent
    _, st2, out = run_both(_drain_sims(pattern), 60, (jst, tst), tag="drain")
    assert _drained(st2)
    assert out["narrow_lat_cnt"].sum() == st2.eps.n_sent.sum().item()
    assert out["mq_max"] < NocParams().memq_depth, "mem queue overflow"


def test_wormhole_write_burst_integrity():
    """All write beats arrive; exactly one B per transfer; no beat loss."""
    txns = 4

    def make(pkg):
        topo = _mesh(pkg)
        return topo, pkg.T.dma_workload(topo, "bit-complement", transfer_kb=1,
                                        n_txns=txns, write=True)
    _, _, out = run_both(build_both(make), 200)
    nt = 16
    per_tile_beats = 1 * 1024 // 64 * txns
    assert out["beats_sent"][:nt].sum() == nt * per_tile_beats
    assert out["beats_rcvd"][:nt].sum() == nt * per_tile_beats
    assert out["dma_done"][:nt].sum() == nt * txns


def test_wormhole_no_interleave():
    """Two tiles write bursts through a shared column link; the delivered
    beat streams at each destination must never interleave different sources
    mid-burst (wormhole lock). The per-cycle deliveries are equal too."""
    def make(pkg):
        topo = _mesh(pkg)
        E = topo.n_endpoints
        wl = pkg.epm.idle_workload(E, n_tiles=16)
        dd = np.full((E, 1), -1, np.int32)
        dt = np.zeros((E, 1), np.int32)
        # tiles 1 and 2 (same row) both write to tile 0 -> merge at tile 0's router
        dd[1, 0] = 0
        dd[2, 0] = 0
        dt[1, 0] = dt[2, 0] = 3
        return topo, dataclasses.replace(wl, dma_dst=dd, dma_txns=dt, dma_beats=8,
                                         dma_write=True)
    sims = build_both(make)
    jst, (jf, jv) = JAX.S.run_trace(sims[0], 80)
    tst, (flits, valid) = PORT.S.run_trace(sims[1], 80)
    np.testing.assert_array_equal(np.asarray(jv), valid.numpy())
    np.testing.assert_array_equal(np.asarray(jf), flits.numpy())
    assert_states_equal(jax_state_dict(jst), convert.sim_state_to_numpy(tst))
    ep0 = flits.numpy()[:, CH_WIDE, 0]  # [T, NF] deliveries at endpoint 0
    srcs = ep0[:, Jeng.F_SRC]
    kinds = ep0[:, Jeng.F_KIND]
    lasts = ep0[:, Jeng.F_LAST]
    ok = valid.numpy()[:, CH_WIDE, 0]
    current = None
    for t in range(len(srcs)):
        if not ok[t] or kinds[t] != WIDE_AW_W:
            continue
        if current is None:
            current = srcs[t]
        assert srcs[t] == current, f"interleaved burst at cycle {t}"
        if lasts[t]:
            current = None
    # all beats delivered
    assert tst.eps.beats_rcvd[0].item() == 2 * 3 * 8


def test_deterministic_replay():
    def make(pkg):
        topo = _mesh(pkg)
        return topo, pkg.T.dma_workload(topo, "uniform", transfer_kb=1, n_txns=4)
    sims = build_both(make)
    _, _, a = run_both(sims, 290)
    b = PORT.S.stats(sims[1], PORT.S.run(sims[1], 290))
    assert a["dma_done"][:16].sum() == 16 * 4
    np.testing.assert_array_equal(a["beats_rcvd"], b["beats_rcvd"])
    np.testing.assert_array_equal(a["narrow_lat_cnt"], b["narrow_lat_cnt"])


# ----------------------------------------------------------------------
# tests/test_noc_sim_fixes.py 1: RoB credit accounting with mixed-size
# scheduled steps
# ----------------------------------------------------------------------
def _square(pkg):
    return pkg.top.build_mesh(nx=2, ny=2, hbm_west=False)


def _mixed_ring_schedule(pkg, topo, beats=(8, 2)):
    """Ring all-gather whose steps alternate between burst sizes."""
    sched = pkg.CT.build(topo, "all-gather", data_kb=4)
    bts = sched.beats_seq.copy()
    K = bts.shape[-1]
    sizes = np.asarray([beats[k % len(beats)] for k in range(K)], np.int32)
    bts[bts > 0] = 0
    bts[sched.dst_seq >= 0] = np.broadcast_to(
        sizes, sched.dst_seq.shape)[sched.dst_seq >= 0]
    return dataclasses.replace(sched, beats_seq=bts)


def test_rob_credits_balance_with_mixed_size_scheduled_writes():
    """After a mixed-size scheduled collective drains, every endpoint's
    RoB credit must return exactly to its initial value."""
    params = NocParams(ni_order="rob")
    scheds = {}

    def make(pkg):
        topo = _square(pkg)
        scheds[pkg.S] = sched = _mixed_ring_schedule(pkg, topo)
        return topo, pkg.CT.to_workload(topo, sched)
    sims = build_both(make, ni_order="rob")
    sched = scheds[PORT.S]
    assert len(np.unique(sched.beats_seq[sched.dst_seq >= 0])) > 1
    _, st, out = run_both(sims, 60)
    np.testing.assert_array_equal(out["rx_bursts"], sched.expect_rx)
    assert int(st.eps.d_txns_left.sum()) == 0  # fully drained
    np.testing.assert_array_equal(
        st.eps.rob_credit.numpy(),
        np.full((sims[1].topo.n_endpoints,), params.rob_beats, np.int32))


def test_rob_credits_balance_with_mixed_size_scheduled_reads():
    """Same property on the read path: WIDE_R responses carry the issued
    burst size back to the requester."""
    params = NocParams(ni_order="rob")
    K = 4

    def make(pkg):
        topo = _square(pkg)
        E = topo.n_endpoints
        dst = np.full((E, 1, K), -1, np.int32)
        bts = np.zeros((E, 1, K), np.int32)
        for e in range(4):
            dst[e, 0] = (e + 1) % 4
            bts[e, 0] = [8, 2, 8, 2]
        wl = pkg.epm.idle_workload(E, n_tiles=4)
        txns = np.zeros((E, 1), np.int32)
        txns[:4] = K
        return topo, dataclasses.replace(
            wl, dma_txns=txns, dma_beats=8, dma_write=False,
            dma_dst_seq=dst, dma_gate=np.zeros((E, 1, K), np.int32),
            dma_beats_seq=bts)
    sims = build_both(make, ni_order="rob")
    _, st, _ = run_both(sims, 70)
    assert int(st.eps.d_txns_left.sum()) == 0
    assert int(st.eps.d_done.sum()) == 4 * K
    np.testing.assert_array_equal(
        st.eps.rob_credit.numpy(),
        np.full((sims[1].topo.n_endpoints,), params.rob_beats, np.int32))


def test_robless_collective_unaffected_by_meta_plumbing():
    """The golden-pinned robless datapath must not shift: META carries
    burst sizes, but robless retirement ignores beats entirely."""
    scheds = {}

    def make(pkg):
        topo = _mesh(pkg)
        scheds[pkg.S] = sched = pkg.CT.build(topo, "all-reduce", data_kb=4, streams=2)
        return topo, pkg.CT.to_workload(topo, sched)
    sims = build_both(make)
    _, _, out = run_both(sims, 230)
    assert (out["rx_bursts"] >= scheds[PORT.S].expect_rx).all()  # complete
    assert PORT.CT.measured_cycles(out, sims[1].topo) == 190  # the golden pin


# ----------------------------------------------------------------------
# tests/test_noc_sim_fixes.py 3: rsp egress overflow guard
# ----------------------------------------------------------------------
def _hot_spot(rate):
    """Three tiles fire narrow requests at tile 0 as fast as they can (the
    JAX test's ``_hot_spot_sim``); ``rate`` 0 is its drain."""
    def make(pkg):
        topo = _square(pkg)
        E = topo.n_endpoints
        nr = np.zeros((E,), np.float32)
        nd = np.full((E,), -1, np.int32)
        nr[1:4] = rate
        nd[1:4] = 0
        return topo, dataclasses.replace(pkg.epm.idle_workload(E, n_tiles=4),
                                         narrow_rate=nr, narrow_dst=nd)
    return make


def test_rsp_egress_overflow_stalls_instead_of_corrupting():
    jst, tst, _ = run_both(build_both(_hot_spot(1.0), egress_depth=2), 300, tag="load")
    jst, st2, out = run_both(build_both(_hot_spot(0.0), egress_depth=2), 140,
                             (jst, tst), tag="drain")
    # the adversarial condition actually occurred...
    assert out["eg_overflow"][0] > 0, "hot spot never filled the rsp queue"
    # ...and not a single flit was lost: every request got exactly one response
    sent = int(st2.eps.n_sent.sum())
    assert sent > 0
    assert int(out["narrow_lat_cnt"].sum()) == sent
    assert int(st2.eps.ni_cnt.sum()) == 0  # all retired
    assert int(st2.fabric.in_cnt.sum()) == 0
    assert int(st2.fabric.out_cnt.sum()) == 0


def test_egress_queues_never_exceed_capacity():
    """Occupancy invariant under the hot spot: eg_cnt stays <= depth on
    every (channel, endpoint) queue, every cycle; the per-cycle occupancy
    equals JAX's."""
    params = NocParams(egress_depth=2)
    jsim, tsim = build_both(_hot_spot(1.0), egress_depth=2)
    jst, tst = jsim.init_state(), tsim.init_state()
    step = jax.jit(jsim.step)
    for _ in range(120):
        jst, _ = step(jst)
        tst, _ = tsim.step(tst)
        np.testing.assert_array_equal(np.asarray(jst.eps.eg_cnt), tst.eps.eg_cnt.numpy())
        assert int(tst.eps.eg_cnt.max()) <= params.egress_depth
    assert_states_equal(jax_state_dict(jst), convert.sim_state_to_numpy(tst))
