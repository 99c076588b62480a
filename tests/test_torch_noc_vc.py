"""Virtual-channel parity: the port's VC datapath (``n_vcs > 1``) against
the JAX package.

* the VC branches of ``arb_decisions`` / ``link_inputs`` / ``sent_mask``
  on random snapshots (ties, full buffers, destinations past the table,
  where JAX's INT_MIN fill wraps to a real slot at V = 2);
* ``make_tables(n_vcs=2)`` on the topology zoo, Occamy included;
* the full SimState, leaf for leaf, after 300 cycles on the zoo at
  ``n_vcs=2``, and the 8x1 ring workload that wedges the VC-less torus.

Inputs are made with numpy from a seed; all state is integer, so the
tolerance is exact equality everywhere.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import engine as jeng
from repro.core.noc import sim as JS
from repro.core.noc import traffic as JT
from repro.core.noc.endpoints import idle_workload as jax_idle_workload
from repro.core.noc.params import NocParams as JParams
from repro.core.noc.topology import build_occamy as jax_build_occamy
from repro.core.noc.topology import build_topology as jax_build_topology
from repro.kernels.noc_router import ref as jref
from repro_torch import convert
from repro_torch.core.noc import engine as teng
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import traffic as TT
from repro_torch.core.noc.endpoints import idle_workload as torch_idle_workload
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import build_occamy as torch_build_occamy
from repro_torch.core.noc.topology import build_topology as torch_build_topology
from repro_torch.kernels.noc_router import ref as tref
from test_torch_cuda_kernels import _snapshot, _tables
from test_torch_noc_sim import assert_states_equal, jax_state_dict

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

TABLES = ("route", "link_src", "link_dst", "port_ep", "ep_attach", "vc_out")


def _eq(a, b, tag=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=tag)


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


@pytest.mark.parametrize("R,V,depth", [(R, V, d) for R in (1, 16)
                                       for V in (2, 3) for d in (2, 4)])
def test_vc_decision_functions_match_jax(R, V, depth):
    rng = np.random.default_rng(300 + 10 * R + V + depth)
    E = 3 if R == 1 else 24
    tb = _tables(rng, R, E, V)
    s = _snapshot(rng, (), R, E, depth, depth, V)
    (js, ts), (jt, tt) = _both(s), _both(tb)
    args = lambda d, t: (d["in_buf"], d["in_cnt"], d["out_cnt"], d["rr_ptr"],
                         d["wh_lock"], t["route"])
    ja = jref.arb_decisions(*args(js, jt), depth_out=depth,
                            vc_out=jt["vc_out"], n_vcs=V)
    ta = tref.arb_decisions(*args(ts, tt), depth_out=depth,
                            vc_out=tt["vc_out"], n_vcs=V)
    for name, a, b in zip(ja._fields, ja, ta):
        _eq(a, b, f"arb_decisions.{name}")
    if R > 1:  # the snapshot exercises both outcomes and past-table heads
        assert ta.granted.any() and (~ta.granted).any()
        assert ((ts["in_buf"][..., 0, 0] >= E) & (ts["in_cnt"] > 0)).any()

    jup, jacc = jref.link_inputs(jref.heads(js["out_buf"]), js["out_cnt"] > 0,
                                 jt["link_src"], ja.in_space, n_vcs=V)
    tup, tacc = tref.link_inputs(tref.heads(ts["out_buf"]), ts["out_cnt"] > 0,
                                 tt["link_src"], ta.in_space, n_vcs=V)
    _eq(jup, tup, "link_inputs.up_head")
    _eq(jacc, tacc, "link_inputs.accept")
    jsent = jref.sent_mask(js["out_cnt"] > 0, jt["link_dst"], jt["port_ep"],
                           ja.in_space, js["ep_space"], n_vcs=V)
    tsent = tref.sent_mask(ts["out_cnt"] > 0, tt["link_dst"], tt["port_ep"],
                           ta.in_space, ts["ep_space"], n_vcs=V)
    _eq(jsent, tsent, "sent_mask")
    cyc = lambda ref, d, t: ref.router_cycle_reference(
        d["in_buf"], d["in_cnt"], d["out_buf"], d["out_cnt"], d["rr_ptr"],
        d["wh_lock"], t["route"], t["link_src"], t["link_dst"], t["port_ep"],
        t["ep_attach"], d["ep_space"], fused=True, vc_out=t["vc_out"],
        n_vcs=V)
    for i, (a, b) in enumerate(zip(cyc(jref, js, jt), cyc(tref, ts, tt))):
        _eq(a, b, f"router_cycle_reference[{i}]")


def test_past_table_heads_request_a_wrapped_slot():
    """JAX fills a past-table route with INT_MIN; at V = 2 the int32
    product wraps to 0, so the head requests slot vc_out[r, slot, 0]. The
    port copies the quirk (at V = 3 the sum stays negative: no slot)."""
    route = torch.ones((1, 4), dtype=torch.int32)
    dst = torch.tensor([[4, 9, 1, -3]], dtype=torch.int32)
    vc_out = torch.tensor([[[1, 0], [0, 0], [1, 1], [0, 1]]], dtype=torch.int32)
    got = tref.request_slots(route, dst, vc_out, n_vcs=2)
    assert got.tolist() == [[1, 0, 3, 3]]
    got3 = tref.request_slots(torch.zeros((1, 4), dtype=torch.int32),
                              torch.tensor([[4, 0, 5]], dtype=torch.int32),
                              torch.zeros((1, 3, 1), dtype=torch.int32),
                              n_vcs=3)
    assert got3.tolist() == [[-(2**31), 0, -(2**31)]]


# the zoo of tests/test_noc_vc.py
ZOO = [
    ("mesh", dict(nx=4, ny=2)),
    ("torus", dict(nx=4, ny=2)),
    ("multi_die", dict(n_dies=2, nx=2, ny=2, d2d=2)),
]
TABLE_ZOO = [
    ("mesh", dict(nx=4, ny=2)),
    ("torus", dict(nx=4, ny=4)),
    ("torus", dict(nx=8, ny=1)),
    ("multi_die", dict(n_dies=2, nx=2, ny=2, d2d=2)),
    ("occamy", {}),
]


@pytest.mark.parametrize("name,kw", TABLE_ZOO,
                         ids=["mesh4x2", "torus4x4", "torus8x1", "multi_die",
                              "occamy"])
def test_vc_tables_match_jax(name, kw):
    if name == "occamy":
        jtopo, ttopo = jax_build_occamy(), torch_build_occamy()
    else:
        jtopo = jax_build_topology(name, **kw)
        ttopo = torch_build_topology(name, **kw)
    jt = jeng.make_tables(jtopo, n_vcs=2)
    tt = teng.make_tables(ttopo, n_vcs=2, device="cpu")
    assert tt.n_vcs == jt.n_vcs == 2
    for name_ in TABLES:
        got = getattr(tt, name_)
        assert got.dtype == torch.int32, name_
        np.testing.assert_array_equal(np.asarray(getattr(jt, name_)),
                                      got.numpy(), err_msg=name_)
    # the tables travel through convert's numpy dicts, vc_out and n_vcs too
    back = convert.tables_from_numpy(convert.tables_to_numpy(tt), "cpu")
    assert back.n_vcs == 2
    for name_ in TABLES:
        assert torch.equal(getattr(back, name_), getattr(tt, name_)), name_


def _pair(name, kw, build_wl, **params_kw):
    jtopo = jax_build_topology(name, **kw)
    ttopo = torch_build_topology(name, **kw)
    jp = JParams(**params_kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    return (JS.build_sim(jtopo, jp, build_wl(JT, jtopo)),
            TS.build_sim(ttopo, tp, build_wl(TT, ttopo), device="cpu"))


@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_two_vc_state_matches_jax_after_300_cycles(name, kw):
    """The zoo of ``tests/test_noc_vc.py`` at n_vcs=2: uniform 1 kB x 2
    DMA reads, the full SimState leaf for leaf (dead slots included)."""
    jsim, tsim = _pair(name, kw, lambda T, t: T.dma_workload(
        t, "uniform", transfer_kb=1, n_txns=2), n_vcs=2)
    want = jax_state_dict(JS.run(jsim, 300))
    got = convert.sim_state_to_numpy(TS.run(tsim, 300))
    assert_states_equal(want, got, f"{name} n_vcs=2")
    assert got["fabric.in_buf"].shape[2] == 2 * tsim.topo.n_ports
    assert got["eps.beats_rcvd"].sum() > 0


def _ring_workload(mod_idle, topo, beats=64):
    """Every tile of the 8x1 torus sends one write burst three hops east
    (``tests/test_noc_vc.py``: the wormhole cycle of the wrap ring)."""
    E = topo.n_endpoints
    wl = mod_idle(E, n_tiles=E)
    dst = np.array([[(x + 3) % E] for x in range(E)], np.int32)
    return dataclasses.replace(wl, dma_dst=dst,
                               dma_txns=np.ones((E, 1), np.int32),
                               dma_beats=beats, dma_write=True)


@pytest.mark.parametrize("n_vcs", [1, 2])
def test_ring_8x1_matches_jax_400_cycles(n_vcs):
    """The deadlock regression's workload, 400 cycles, equal to JAX (the
    4000-cycle wedge/drain check itself runs on the card in
    ``chip_smoke.py``)."""
    jtopo = jax_build_topology("torus", nx=8, ny=1)
    ttopo = torch_build_topology("torus", nx=8, ny=1)
    jp = JParams(n_vcs=n_vcs)
    jsim = JS.build_sim(jtopo, jp, _ring_workload(jax_idle_workload, jtopo))
    tsim = TS.build_sim(ttopo, convert.params_from_dict(dataclasses.asdict(jp)),
                        _ring_workload(torch_idle_workload, ttopo),
                        device="cpu")
    want = jax_state_dict(JS.run(jsim, 400))
    got = convert.sim_state_to_numpy(TS.run(tsim, 400))
    assert_states_equal(want, got, f"ring n_vcs={n_vcs}")
    assert got["eps.beats_sent"].sum() > 0


def _chip_smoke():
    """``chip_smoke.py`` at the repo's root, as a module (it imports no
    package at its top)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_horizons", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [dict(), dict(fused_cycles=4), dict(step_impl="naive")],
                         ids=["per_cycle", "fused_4", "naive"])
def test_smoke_torus_horizon_crosses_the_dateline(kw):
    """``chip_smoke.py``'s 8x4 torus runs at ``n_vcs=2`` (``torus_vc_8x4``,
    ``torus_8x4``, ``naive_torus_vc_8x4``) stop after ``SUPER_CYCLES``: within
    that horizon flits cross the dateline (a VC 1 slot holds a flit) well
    before its half, so the card-against-CPU state check covers the VC
    switch."""
    CS = _chip_smoke()
    ttopo = torch_build_topology("torus", nx=4, ny=8)
    twl = CS.mesh_workload(TT, ttopo, transfer_kb=8, narrow_rate=0.05)
    p = NocParams(n_vcs=2, **kw)
    sim = TS.build_sim(ttopo, p, twl, device="cpu")
    st, first, on_vc1 = sim.init_state(), None, 0
    for c in range(0, CS.SUPER_CYCLES, p.fused_cycles):
        st = TS.run(sim, p.fused_cycles, st)
        n = int((st.fabric.in_cnt[..., 1::2] > 0).sum() + (st.fabric.out_cnt[..., 1::2] > 0).sum())
        on_vc1 += n
        if n and first is None:
            first = c + p.fused_cycles
    assert first is not None and first <= CS.SUPER_CYCLES // 2, first
    assert on_vc1 > 0
