"""In-network collective offload in the port against the JAX package.

* ``ref.offload_decisions`` and ``ref.router_cycle_offload_reference`` bit
  for bit against JAX on random snapshots (R in {9, 32}, G in {1, 3},
  V in {1, 2}) that reach partial multicast wins, emissions onto contested
  ports and groups sharing a parent port;
* ``ops.router_cycle`` with the offload tables against the JAX Pallas
  ``_arb_kernel_offload`` path in interpret mode;
* ``make_tables(groups=...)`` against JAX on a mesh, a torus at
  ``n_vcs=2``, a multi-die fabric and Occamy;
* the full SimState of an in-fabric all-reduce, leaf for leaf, after 160
  cycles on the three fabrics of the JAX offload equivalence test;
* port-side mirrors of the JAX exactly-once and reduction-sum tests.

Inputs are made with numpy from a seed. All state is integer, so the
tolerance is exact equality.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import collective_traffic as JCT
from repro.core.noc import engine as jeng
from repro.core.noc import sim as JS
from repro.core.noc import topology as JTop
from repro.core.noc.params import NocParams as JParams
from repro.kernels.noc_router import ops as jops
from repro.kernels.noc_router import ref as jref
from repro_torch import convert
from repro_torch.core.noc import collective_traffic as TCT
from repro_torch.core.noc import endpoints as tepm
from repro_torch.core.noc import engine as teng
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import topology as TTop
from repro_torch.core.noc.params import (
    CH_WIDE,
    KIND_CHANNEL,
    WIDE_MC,
    WIDE_RED,
    NocParams,
)
from repro_torch.kernels.noc_router import ops as tops
from repro_torch.kernels.noc_router import ref as tref
from test_torch_cuda_kernels import P, _offload, _snapshot, _tables
from test_torch_noc_sim import assert_states_equal, jax_state_dict

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _eq(a, b, tag=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=tag)


def _reached(s, tb, otb, ost, E, V, granted):
    """How often the snapshot reaches the cases that matter, recomputed in
    numpy from the inputs: ports two can-emit groups want (shared parent),
    emissions onto a port some head requests (contested), ports where a
    multicast win was cancelled (a head was eligible, nothing granted), and
    ports nobody is eligible for (the first-min tie at P + 1)."""
    h = s["in_buf"][..., 0, :]
    C, R, PV = s["in_cnt"].shape
    dout = s["out_buf"].shape[-2]
    G = otb["red_need"].shape[1]
    valid = s["in_cnt"] > 0
    is_mc = valid & (h[..., tref.F_KIND] == tref.KIND_MC)
    is_red = valid & (h[..., tref.F_KIND] == tref.KIND_RED)
    uni = valid & ~is_mc & ~is_red
    g_of = np.clip(h[..., tref.F_DST] - E, 0, G - 1)
    need, par = otb["red_need"], otb["red_parent"]
    full = (need > 0) & (ost["red_acc"][..., tref.A_CNT] >= need)
    pc = np.broadcast_to(np.clip(par, 0, PV - 1), (C, R, G))
    can = (full & (par >= 0)
           & np.take_along_axis(s["out_cnt"] < dout, pc, -1)
           & (np.take_along_axis(s["wh_lock"], pc, -1) < 0))
    wants = (pc[..., None] == np.arange(PV)) & can[..., None]  # [C,R,G,PV]
    emit_port = wants.any(-2)
    r_idx = np.arange(R)[:, None]
    port = tb["route"][r_idx, np.clip(h[..., tref.F_DST], 0, E - 1)]
    if V > 1:
        Pp = PV // V
        port = port * V + tb["vc_out"][r_idx, np.arange(PV),
                                       np.clip(port, 0, Pp - 1)]
    req = ((uni[..., None] & (port[..., None] == np.arange(PV)))
           | (is_mc[..., None] & otb["fork_out"][r_idx, g_of]))
    lock = s["wh_lock"][..., None, :]
    elig = (req & ((lock < 0) | (lock == np.arange(PV)[:, None]))
            & (s["out_cnt"] < dout)[..., None, :] & ~emit_port[..., None, :])
    return {"shared_parent": int((wants.sum(-2) >= 2).sum()),
            "contested_emission": int((emit_port & req.any(-2)).sum()),
            "cancelled_mc_win": int((elig.any(-2) & ~granted).sum()),
            "nothing_eligible": int((~elig.any(-2)).sum())}


def _offload_case(R, G, V, seed):
    rng = np.random.default_rng(seed)
    E = R + 7
    tb = _tables(rng, R, E, V)
    s = _snapshot(rng, (3,), R, E, 2, 2, V)
    otb, ost = _offload(rng, s, R, E, G, V)
    return E, tb, s, otb, ost


DECISION_CASES = [(R, G, V) for R in (9, 32) for G in (1, 3) for V in (1, 2)]


@pytest.mark.parametrize("R,G,V", DECISION_CASES)
def test_offload_decisions_match_jax(R, G, V):
    """``offload_decisions`` over a [3, R, ...] batch against the JAX
    function vmapped over the channels: decisions and the ALU state, bit
    for bit."""
    E, tb, s, otb, ost = _offload_case(R, G, V, 10 * R + G + 100 * V)
    names = ("in_buf", "in_cnt", "out_cnt", "rr_ptr", "wh_lock")
    t = lambda a: None if a is None else torch.as_tensor(a)
    arb, acc2, got2 = tref.offload_decisions(
        *(t(s[k]) for k in names), t(tb["route"]), depth_out=2,
        red_acc=t(ost["red_acc"]), red_got=t(ost["red_got"]),
        vc_out=t(tb.get("vc_out")), n_endpoints=E, n_vcs=V,
        **{k: t(v) for k, v in otb.items()})

    def jax_fn(in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, red_acc, red_got):
        """One channel; the tables are shared."""
        return jref.offload_decisions(
            in_buf, in_cnt, out_cnt, rr_ptr, wh_lock, tb["route"],
            depth_out=2, red_acc=red_acc, red_got=red_got, n_endpoints=E,
            vc_out=tb.get("vc_out"), n_vcs=V, **otb)

    jarb, jacc, jgot = jax.jit(jax.vmap(jax_fn))(
        *(s[k] for k in names), ost["red_acc"], ost["red_got"])
    for i, (a, b) in enumerate(zip((*jarb, jacc, jgot), (*arb, acc2, got2))):
        assert np.asarray(a).dtype == b.numpy().dtype, i
        _eq(a, b, f"output {i}")
    seen = _reached(s, tb, otb, ost, E, V, arb.granted.numpy())
    assert seen["cancelled_mc_win"] and seen["contested_emission"], seen
    assert seen["nothing_eligible"], seen
    if G > 1:
        assert seen["shared_parent"], seen


@pytest.mark.parametrize("R,G,V", [(9, 3, 1), (32, 1, 2)])
def test_router_cycle_offload_reference_matches_jax(R, G, V):
    """The whole offload cycle (decisions, links, FIFOs, deliveries, ALU
    state) over the batch against the JAX reference vmapped over the
    channels."""
    E, tb, s, otb, ost = _offload_case(R, G, V, 7 * R + G + V)
    t = lambda a: None if a is None else torch.as_tensor(a)
    order = ("in_buf", "in_cnt", "out_buf", "out_cnt", "rr_ptr", "wh_lock")
    tabs = ("route", "link_src", "link_dst", "port_ep", "ep_attach")
    got = tref.router_cycle_offload_reference(
        *(t(s[k]) for k in order), t(ost["red_acc"]), t(ost["red_got"]),
        *(t(tb[k]) for k in tabs), t(otb["fork_out"]), t(otb["red_parent"]),
        t(otb["red_need"]), t(s["ep_space"]), n_endpoints=E, fused=True,
        vc_out=t(tb.get("vc_out")), n_vcs=V)

    def jax_fn(*state_and_space):
        """One channel; the tables are shared."""
        *state, ep_space = state_and_space
        return jref.router_cycle_offload_reference(
            *state, *(tb[k] for k in tabs), otb["fork_out"],
            otb["red_parent"], otb["red_need"], ep_space, n_endpoints=E,
            fused=True, vc_out=tb.get("vc_out"), n_vcs=V)

    want = jax.jit(jax.vmap(jax_fn))(
        *(s[k] for k in order), ost["red_acc"], ost["red_got"], s["ep_space"])
    for i, (a, b) in enumerate(zip(want, got)):
        _eq(a, b, f"output {i}")


def _fabric(name):
    """(JAX topology, port topology, n_vcs) of a small test fabric."""
    builds = {
        "mesh": (lambda T: T.build_mesh(3, 3, hbm_west=False), 1),
        "torus_v2": (lambda T: T.build_torus(3, 3), 2),
        "multi_die": (lambda T: T.build_multi_die(2, nx=2, ny=2, d2d=2), 1),
        "occamy": (lambda T: T.build_occamy(), 2),
    }
    build, V = builds[name]
    return build(JTop), build(TTop), V


def test_ops_router_cycle_offload_matches_pallas_interpret():
    """``ops.router_cycle`` with the offload tables of the 3x3 torus at
    ``n_vcs=2`` (two all-reduce groups) against the JAX Pallas offload path
    (``_arb_kernel_offload``) in interpret mode and the vmapped jnp
    reference, on random channel-batched state."""
    jtopo, ttopo, V = _fabric("torus_v2")
    groups = JCT.all_reduce(jtopo, data_kb=1, streams=2,
                            algo="infabric").meta["groups"]
    jt = jeng.make_tables(jtopo, n_vcs=V, groups=groups)
    tb = {k: np.array(getattr(jt, k)) for k in
          ("route", "link_src", "link_dst", "port_ep", "ep_attach",
           "vc_out", "fork_out", "red_parent", "red_need")
          if getattr(jt, k) is not None}
    R, E, G = jtopo.n_routers, jtopo.n_endpoints, len(groups)
    rng = np.random.default_rng(5 + V)
    s = _snapshot(rng, (3,), R, E, 2, 2, V)
    s.update(_offload(rng, s, R, E, G, V)[1])
    J = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    T = lambda d: {k: torch.as_tensor(v) for k, v in d.items()}

    def call(fn, d, t, **kw):
        return fn(d["in_buf"], d["in_cnt"], d["out_buf"], d["out_cnt"],
                  d["rr_ptr"], d["wh_lock"], t["route"], t["link_src"],
                  t["link_dst"], t["port_ep"], t["ep_attach"], d["ep_space"],
                  vc_out=t.get("vc_out"), n_vcs=V, fork_out=t["fork_out"],
                  red_parent=t["red_parent"], red_need=t["red_need"],
                  red_acc=d["red_acc"], red_got=d["red_got"], n_endpoints=E,
                  **kw)

    want_pallas = call(jops.router_cycle, J(s), J(tb), backend="pallas",
                       interpret=True, fused_fifo=True)
    want_jnp = call(jops.router_cycle, J(s), J(tb), backend="jnp",
                    fused_fifo=True)
    got = call(tops.router_cycle, T(s), T(tb))
    assert len(got) == 10
    for i, (a, c, b) in enumerate(zip(want_pallas, want_jnp, got)):
        _eq(a, b, f"router_cycle[{i}] vs pallas")
        _eq(c, b, f"router_cycle[{i}] vs jnp")


@pytest.mark.parametrize("name", ["mesh", "torus_v2", "multi_die", "occamy"])
def test_offload_tables_match_jax(name):
    """The fork / reduction trees of an in-fabric all-reduce's groups plus
    a multicast group, equal to JAX's, and carried through ``convert``."""
    jtopo, ttopo, V = _fabric(name)
    groups = (JCT.all_reduce(jtopo, data_kb=1, streams=2,
                             algo="infabric").meta["groups"]
              + JCT.multicast(jtopo, root=1, offload=True).meta["groups"])
    jt = jeng.make_tables(jtopo, n_vcs=V, groups=groups)
    tt = teng.make_tables(ttopo, n_vcs=V, groups=groups, device="cpu")
    assert tt.n_groups == jt.n_groups == 3
    for k in ("route", "link_src", "link_dst", "port_ep", "ep_attach",
              "vc_out", "fork_out", "red_parent", "red_need"):
        a, b = getattr(jt, k), getattr(tt, k)
        if a is None:
            assert b is None, k
            continue
        assert np.asarray(a).dtype == b.numpy().dtype, k
        _eq(a, b, k)
    assert tt.red_need.sum() > 0 and tt.fork_out.sum() > 0
    back = convert.tables_from_numpy(convert.tables_to_numpy(tt), "cpu")
    assert back.n_groups == 3 and back.fork_out.dtype == torch.bool
    for k in ("fork_out", "red_parent", "red_need"):
        assert torch.equal(getattr(back, k), getattr(tt, k)), k


@pytest.mark.parametrize("name", ["mesh", "torus_v2", "multi_die"])
def test_offload_state_matches_jax_after_160_cycles(name):
    """An in-fabric all-reduce (two streams, two groups) on each fabric
    class of the JAX equivalence test: the port's SimState after 160 cycles
    equals the JAX fast jnp step's, leaf for leaf (ALU state included), and
    a mid-run JAX state handed over through ``convert`` continues equal."""
    jtopo, ttopo, V = _fabric(name)
    jsc = JCT.all_reduce(jtopo, data_kb=1, streams=2, algo="infabric")
    tsc = TCT.all_reduce(ttopo, data_kb=1, streams=2, algo="infabric")
    jp = JParams(collective_offload=True, n_vcs=V)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    jsim = JS.build_sim(jtopo, jp, JCT.to_workload(jtopo, jsc),
                        groups=jsc.meta["groups"])
    tsim = TS.build_sim(ttopo, tp, TCT.to_workload(ttopo, tsc),
                        groups=tsc.meta["groups"], device="cpu")
    jmid = JS.run(jsim, 80)
    handed = convert.sim_state_from_numpy(jax_state_dict(jmid), "cpu")
    want = jax_state_dict(JS.run(jsim, 80, jmid))
    got = convert.sim_state_to_numpy(TS.run(tsim, 160))
    assert_states_equal(want, got, name)
    assert "fabric.red_acc" in got and "fabric.red_got" in got
    assert got["eps.rx_bursts"].sum() > 0
    assert_states_equal(want, convert.sim_state_to_numpy(
        TS.run(tsim, 80, handed)), f"{name} handed over")


# ---------------------------------------------------------------------------
# port-side mirrors of tests/test_noc_offload.py


def _run_sched(topo, sc, params, slack=500):
    """Build + run an offloaded schedule on the port (CPU) for the model's
    estimate x 1.5 + ``slack`` cycles; return ``(stats, state)``."""
    est = TCT.analytical_cycles(sc, params, topo)
    sim = TS.build_sim(topo, params, TCT.to_workload(topo, sc),
                       groups=sc.meta.get("groups"), device="cpu")
    st = TS.run(sim, int(est * 1.5) + slack)
    return TS.stats(sim, st), st


def test_offloaded_multicast_exactly_once():
    """Tree multicast delivers every member exactly one burst of exactly
    ``beats`` beats: no duplicate forks, no missing branches."""
    topo = TTop.build_mesh(4, 4, hbm_west=False)
    sc = TCT.multicast(topo, data_kb=4, offload=True)
    out, _ = _run_sched(topo, sc, NocParams(collective_offload=True))
    np.testing.assert_array_equal(out["rx_bursts"], sc.expect_rx)
    want = np.zeros(topo.n_endpoints, np.int64)
    want[1:topo.meta["n_tiles"]] = sc.meta["beats"]  # every member but root
    np.testing.assert_array_equal(out["beats_rcvd"], want)


def test_offloaded_all_reduce_exactly_once():
    """In-fabric all-reduce: the root receives exactly one combined burst
    per stream and every contributor exactly one broadcast burst back."""
    topo = TTop.build_mesh(4, 4, hbm_west=False)
    sc = TCT.all_reduce(topo, data_kb=1, streams=4, algo="infabric")
    out, _ = _run_sched(topo, sc, NocParams(collective_offload=True))
    np.testing.assert_array_equal(out["rx_bursts"], sc.expect_rx)
    assert (out["rx_bursts"][:topo.meta["n_tiles"]] == 1).all()


def test_reduction_sum_correctness():
    """The combined flits arriving at the root carry the sum of every
    contributor's F_META payload, with the last flag only on the final
    beat (stepped cycle by cycle to observe the delivered flits)."""
    topo = TTop.build_mesh(3, 3, hbm_west=False)
    E, beats = topo.n_endpoints, 4
    groups = [{"root": 0, "members": list(range(E)),
               "reduce": list(range(1, E))}]
    wl = tepm.idle_workload(E, E, streams=1)
    dst = np.full((E, 1, 2), -1, np.int32)
    dst[1:, 0, 0] = E + 1  # reduction contribution to group 0
    wl = dataclasses.replace(
        wl, dma_dst_seq=dst, dma_gate=np.zeros((E, 1, 2), np.int32),
        dma_beats_seq=np.full((E, 1, 2), beats, np.int32),
        dma_txns=(dst[:, :, 0] >= 0).astype(np.int32), dma_write=True,
        n_groups=1)
    sim = TS.build_sim(topo, NocParams(collective_offload=True), wl,
                       groups=groups, device="cpu")
    st, got = sim.init_state(), []
    for _ in range(120):
        st, (flit, valid) = sim.step(st)
        f, v = flit.numpy(), valid.numpy()
        for c in range(f.shape[0]):
            if v[c, 0] and f[c, 0, tref.F_KIND] == WIDE_RED:
                got.append((int(f[c, 0, tref.F_META]),
                            int(f[c, 0, tref.F_LAST])))
    # each contributor's beat carries the burst length in F_META
    assert [m for m, _ in got] == [(E - 1) * beats] * beats
    assert [last for _, last in got] == [0] * (beats - 1) + [1]
    assert int(st.eps.rx_bursts[0, 0]) == 1  # exactly once


def test_kind_constants_paired_across_packages():
    """The kernel package's kind constants mirror the simulator's (and the
    JAX package's), and both offload kinds ride a wide channel."""
    assert tref.KIND_MC == WIDE_MC == jref.KIND_MC
    assert tref.KIND_RED == WIDE_RED == jref.KIND_RED
    assert tref.RED_FIELDS == jref.RED_FIELDS
    assert KIND_CHANNEL[WIDE_MC] == KIND_CHANNEL[WIDE_RED] == CH_WIDE
    assert P == 5
