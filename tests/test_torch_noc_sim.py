"""Full-simulator parity: the port (``repro_torch.core.noc.sim`` on the CPU)
against the JAX simulator's fast path.

* the golden stat pins of ``test_noc_channels`` (4x2 mesh, 1200 cycles);
* the paper's Fig. 7 on the 8x4 mesh (22 / 58 / +4 cycles per hop);
* the full SimState, leaf for leaf (dead slots included), after 300
  cycles on the 4x2 mesh for several workloads;
* the per-cycle delivery trace;
* a mid-run handover through ``repro_torch.convert``.

The state is integer or float32 accumulated in the reference's operation
order, so the tolerance is exact equality everywhere.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.noc import collective_traffic as JCT
from repro.core.noc import sim as JS
from repro.core.noc import traffic as JT
from repro.core.noc.params import NocParams as JParams
from repro.core.noc.topology import build_mesh as jax_build_mesh
from repro_torch import convert
from repro_torch.core.noc import endpoints as tepm
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import traffic as TT
from repro_torch.core.noc.topology import build_mesh as torch_build_mesh
from test_noc_channels import GOLDEN

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def jax_state_dict(st) -> dict:
    """A JAX SimState as the flat numpy dict ``repro_torch.convert`` takes."""
    out = {}
    for prefix, part in (("fabric", st.fabric), ("eps", st.eps)):
        for f in dataclasses.fields(part):
            v = getattr(part, f.name)
            if v is not None:
                out[f"{prefix}.{f.name}"] = np.asarray(v)
    out["cycle"] = np.asarray(st.cycle)
    return out


def assert_states_equal(want: dict, got: dict, tag=""):
    assert set(want) == set(got), tag
    for k in want:
        assert want[k].dtype == got[k].dtype, f"{tag} {k}: dtype"
        np.testing.assert_array_equal(want[k], got[k], err_msg=f"{tag} {k}")


def _narrow(wl, topo, rate, dst):
    E, nt = topo.n_endpoints, topo.meta["n_tiles"]
    nr = np.zeros((E,), np.float32)
    nr[:nt] = rate
    nd = np.full((E,), -1, np.int32)
    nd[:nt] = dst
    return dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)


# (name, workload builder taking the traffic module and topology, NocParams
# kwargs); each builder runs on both packages' own copies of traffic.py
WORKLOADS = [
    ("reads_narrow", lambda T, t: _narrow(
        T.dma_workload(t, "uniform", transfer_kb=1, n_txns=4), t, 0.05, -2),
     {}),
    ("writes", lambda T, t: T.dma_workload(t, "uniform", transfer_kb=1,
                                           n_txns=2, write=True), {}),
    ("hbm_full", lambda T, t: T.hbm_workload(t, full_load=True), {}),
    ("ordering_robless", lambda T, t: T.ordering_workload(
        t, streams=1, alternate=True, unique_txn=False),
     {"ni_order": "robless"}),
    ("ordering_rob", lambda T, t: T.ordering_workload(
        t, streams=1, alternate=True, unique_txn=False), {"ni_order": "rob"}),
    ("reads_4ch", lambda T, t: T.dma_workload(t, "transpose", transfer_kb=1,
                                              n_txns=2, streams=2),
     {"n_channels": 4}),
    ("writes_4ch", lambda T, t: T.dma_workload(t, "uniform", transfer_kb=1,
                                               n_txns=2, streams=2, write=True),
     {"n_channels": 4, "ni_order": "rob"}),
]


def _pair(build_wl, params_kw):
    """The same configuration built in both packages (port on the CPU)."""
    jtopo, ttopo = jax_build_mesh(nx=4, ny=2), torch_build_mesh(nx=4, ny=2)
    jwl, twl = build_wl(JT, jtopo), build_wl(TT, ttopo)
    jp = JParams(**params_kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    return (JS.build_sim(jtopo, jp, jwl),
            TS.build_sim(ttopo, tp, twl, device="cpu"))


@pytest.mark.parametrize("name,build_wl,params_kw", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_state_matches_jax_after_300_cycles(name, build_wl, params_kw):
    jsim, tsim = _pair(build_wl, params_kw)
    want = jax_state_dict(JS.run(jsim, 300))
    got = convert.sim_state_to_numpy(TS.run(tsim, 300))
    assert_states_equal(want, got, name)
    assert got["eps.beats_rcvd"].sum() + got["eps.n_sent"].sum() > 0


def test_scheduled_collective_matches_jax():
    """Scheduled multi-phase DMA (a ring all-reduce lowered by the JAX
    package's collective compiler): receive-gated issue, same final state."""
    jtopo = jax_build_mesh(nx=4, ny=2)
    jwl = JCT.to_workload(jtopo, JCT.build(jtopo, "all-reduce", data_kb=1))
    twl = tepm.Workload(**{f.name: getattr(jwl, f.name)
                           for f in dataclasses.fields(jwl)})
    jsim = JS.build_sim(jtopo, JParams(), jwl)
    tsim = TS.build_sim(torch_build_mesh(nx=4, ny=2), TS.NocParams(), twl,
                        device="cpu")
    want = jax_state_dict(JS.run(jsim, 300))
    got = convert.sim_state_to_numpy(TS.run(tsim, 300))
    assert_states_equal(want, got, "all-reduce")
    assert got["eps.rx_bursts"].sum() > 0


def test_golden_stat_pins():
    """The seed-commit golden stats (``test_noc_channels.GOLDEN``)."""
    jsim, tsim = _pair(WORKLOADS[0][1], {})
    st = TS.run(tsim, 1200)
    out = TS.stats(tsim, st)
    np.testing.assert_array_equal(out["beats_rcvd"], GOLDEN["beats_rcvd"])
    np.testing.assert_array_equal(out["beats_sent"], GOLDEN["beats_sent"])
    np.testing.assert_array_equal(out["dma_done"].sum(axis=-1),
                                  GOLDEN["dma_done"])
    np.testing.assert_array_equal(out["narrow_lat_cnt"],
                                  GOLDEN["narrow_lat_cnt"])
    np.testing.assert_array_equal(st.eps.lat_sum.numpy(),
                                  np.float32(GOLDEN["narrow_lat_sum"]))
    np.testing.assert_array_equal(st.eps.n_sent.numpy(), GOLDEN["n_sent"])
    np.testing.assert_array_equal(out["ni_stalls"], GOLDEN["ni_stalls"])
    np.testing.assert_array_equal(out["last_rx"], GOLDEN["last_rx"])
    np.testing.assert_array_equal(out["first_rx"], GOLDEN["first_rx"])
    np.testing.assert_array_equal(out["hbm_served"], GOLDEN["hbm_served"])


def _narrow_lat(topo, src, dst, cycles=380):
    E = topo.n_endpoints
    wl = tepm.idle_workload(E, n_tiles=topo.meta["n_tiles"])
    nr = np.zeros((E,), np.float32)
    nr[src] = 0.02
    nd = np.full((E,), -1, np.int32)
    nd[src] = dst
    wl = dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
    sim = TS.build_sim(topo, TS.NocParams(), wl, device="cpu")
    out = TS.stats(sim, TS.run(sim, cycles))
    assert out["narrow_lat_cnt"][src] > 5
    return float(out["narrow_lat_mean"][src])


def test_fig7_latency_on_8x4_mesh():
    """Paper Fig. 7: 22 cycles to the neighbour, +4 per extra hop, 58
    corner to corner (11 routers: 22 + 9 * 4)."""
    topo = torch_build_mesh(nx=4, ny=8)
    assert _narrow_lat(topo, 0, 1) == 22.0
    assert _narrow_lat(topo, 0, 2) == 26.0
    assert _narrow_lat(topo, 0, 31) == 58.0


def test_run_trace_deliveries_match_jax():
    jsim, tsim = _pair(WORKLOADS[1][1], {})
    jst, (jf, jv) = JS.run_trace(jsim, 200)
    tst, (tf, tv) = TS.run_trace(tsim, 200)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert tv.sum() > 0
    assert_states_equal(jax_state_dict(jst), convert.sim_state_to_numpy(tst),
                        "after trace")
    _, tr = TS.run_trace(tsim, 5, fields=("deliver", "counters", "fabric"))
    assert tuple(tr["deliver"][1].shape) == (5, 3, 10)
    assert tuple(tr["counters"]["in_flight"].shape) == (5, 3)
    assert tuple(tr["fabric"].in_buf.shape) == (5, 3, 8, 5, 2, 7)
    with pytest.raises(ValueError):
        TS.run_trace(tsim, 1, fields=("nope",))


def test_midrun_handover_from_jax():
    """JAX runs 150 cycles, the port takes its state over and runs 150 more:
    equal to JAX running all 300."""
    jsim, tsim = _pair(WORKLOADS[0][1], {})
    jhalf = JS.run(jsim, 150)
    half = jax_state_dict(jhalf)  # copied out: the next JAX run consumes it
    want = jax_state_dict(JS.run(jsim, 150, jhalf))
    st = convert.sim_state_from_numpy(half, "cpu")
    got = convert.sim_state_to_numpy(TS.run(tsim, 150, st))
    assert_states_equal(want, got, "handover")
    # and back: the dict round trip is lossless
    assert_states_equal(half, convert.sim_state_to_numpy(st), "round trip")


def test_canonical_state_matches_jax():
    jsim, tsim = _pair(WORKLOADS[1][1], {})
    jst, tst = JS.run(jsim, 120), TS.run(tsim, 120)
    for scrub in (False, True):
        assert_states_equal(
            jax_state_dict(JS.canonical_state(jsim, jst, scrub=scrub)),
            convert.sim_state_to_numpy(TS.canonical_state(tsim, tst,
                                                          scrub=scrub)),
            f"canonical scrub={scrub}")
    jout, tout = JS.stats(jsim, jst), TS.stats(tsim, tst)
    for k in jout:
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k], err_msg=k)
