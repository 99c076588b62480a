"""Fused multi-cycle super-steps (``NocParams.fused_cycles = k``): the port
against the JAX package.

* ``ops.router_cycles_fused`` (plain version on the CPU) against the JAX
  ``ops.router_cycles_fused(backend="jnp")``, i.e. ``ref.router_cycles_scan``
  vmapped over channels, on random snapshots and random circular egress
  queues (full, empty, ready and not yet ready), with and without VCs. The
  JAX Pallas fused kernel cannot run on the installed jax 0.9.0 (it calls
  ``pl.store``, which that version lacks), so its jnp twin is the reference;
* the full SimState after 300 cycles at k = 4, VCs and 4 channels included;
* ``run_trace`` at k = 4 against JAX's flattened trace;
* a k = 1 super-step equal to ``step``; ``n_cycles`` not a multiple of k
  refused.

Everything is integer or float32 accumulated in the reference's order, so
the tolerance is exact equality.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import engine as jeng
from repro.core.noc import sim as JS
from repro.core.noc.topology import build_topology as jax_build_topology
from repro.kernels.noc_router import ops as jops
from repro.kernels.noc_router.ref import NF
from repro_torch import convert
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import traffic as TT
from repro_torch.core.noc.topology import build_topology as torch_build_topology
from repro_torch.kernels.noc_router import ops as tops
from test_torch_cuda_kernels import _egress, _snapshot
from test_torch_noc_sim import _narrow, assert_states_equal, jax_state_dict
from test_torch_noc_vc import _pair

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("N,V", [(1, 1), (4, 1), (1, 2), (4, 2)])
def test_ops_router_cycles_fused_matches_jax_scan(N, V):
    rng = np.random.default_rng(500 + 10 * N + V)
    topo = jax_build_topology("torus", nx=4, ny=2)
    tb = jeng.make_tables(topo, n_vcs=V)
    tables = [np.array(getattr(tb, k)) for k in
              ("route", "link_src", "link_dst", "port_ep", "ep_attach")]
    vc_out = None if V == 1 else np.array(tb.vc_out)
    C, E, Q, cycle0 = 3, topo.n_endpoints, 8, 100
    s = _snapshot(rng, (C,), topo.n_routers, E, 2, 2, V)
    q = _egress(rng, C, E, Q, cycle0, N)
    state = [s[k] for k in ("in_buf", "in_cnt", "out_buf", "out_cnt",
                            "rr_ptr", "wh_lock")]
    state += [q[k] for k in ("eg", "eg_ready", "eg_head", "eg_cnt")]
    want = jops.router_cycles_fused(
        *map(jnp.asarray, state), *map(jnp.asarray, tables),
        jnp.asarray(s["ep_space"]), cycle0, N, backend="jnp",
        vc_out=None if vc_out is None else jnp.asarray(vc_out), n_vcs=V)
    got = tops.router_cycles_fused(
        *map(torch.as_tensor, state), *map(torch.as_tensor, tables),
        torch.as_tensor(s["ep_space"]), cycle0, N,
        vc_out=None if vc_out is None else torch.as_tensor(vc_out), n_vcs=V)
    assert len(got) == len(want) == 13
    for i, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=f"output {i}")
    # the window injected something and delivered something
    assert (got[9] < torch.as_tensor(q["eg_cnt"])).any() or N == 1
    assert got[11].any()


SIMS = [
    ("mesh4x2_k4", "mesh", dict(nx=4, ny=2), lambda T, t: _narrow(
        T.dma_workload(t, "uniform", transfer_kb=1, n_txns=4), t, 0.05, -2),
     dict(fused_cycles=4)),
    ("torus4x2_vc2_k4_4ch", "torus", dict(nx=4, ny=2), lambda T, t:
        T.dma_workload(t, "uniform", transfer_kb=1, n_txns=2, streams=2),
     dict(n_vcs=2, fused_cycles=4, n_channels=4)),
]


@pytest.mark.parametrize("tag,name,kw,build_wl,params_kw", SIMS,
                         ids=[s[0] for s in SIMS])
def test_super_step_state_matches_jax_after_300_cycles(tag, name, kw,
                                                       build_wl, params_kw):
    jsim, tsim = _pair(name, kw, build_wl, **params_kw)
    want = jax_state_dict(JS.run(jsim, 300))
    got = convert.sim_state_to_numpy(TS.run(tsim, 300))
    assert_states_equal(want, got, tag)
    assert got["eps.beats_rcvd"].sum() > 0


def test_super_step_trace_matches_jax():
    """``run_trace`` at k = 4: deliveries flattened to [T, C, ...] like
    JAX's; counters stay per super-step."""
    name, kw, build_wl, params_kw = SIMS[0][1:]
    jsim, tsim = _pair(name, kw, build_wl, **params_kw)
    jst, (jf, jv) = JS.run_trace(jsim, 200)
    tst, (tf, tv) = TS.run_trace(tsim, 200)
    assert tuple(tf.shape) == (200, 3, 10, NF)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    assert tv.sum() > 0
    assert_states_equal(jax_state_dict(jst), convert.sim_state_to_numpy(tst),
                        "after trace")
    _, tr = TS.run_trace(tsim, 8, fields=("deliver", "counters"))
    assert tuple(tr["deliver"][1].shape) == (8, 3, 10)
    assert tuple(tr["counters"]["in_flight"].shape) == (2, 3)


def test_one_cycle_super_step_equals_step():
    """A 1-cycle super-step is the per-cycle step, leaf for leaf (as
    ``tests/test_noc_fastpath.py`` pins for JAX)."""
    topo = torch_build_topology("mesh", nx=4, ny=2)
    wl = _narrow(TT.dma_workload(topo, "uniform", transfer_kb=1, n_txns=2),
                 topo, 0.05, -2)
    sim = TS.build_sim(topo, TS.NocParams(fused_cycles=1), wl, device="cpu")
    a = b = sim.init_state()
    for c in range(150):
        a, _ = sim.step(a, c)
        b, _ = sim.step_super(b, c)
    assert_states_equal(convert.sim_state_to_numpy(a),
                        convert.sim_state_to_numpy(b), "k=1")
    assert convert.sim_state_to_numpy(a)["eps.beats_rcvd"].sum() > 0


def test_cycles_must_be_a_multiple_of_the_window():
    topo = torch_build_topology("mesh", nx=4, ny=2)
    wl = TT.dma_workload(topo, "uniform", transfer_kb=1, n_txns=1)
    sim = TS.build_sim(topo, TS.NocParams(fused_cycles=4), wl, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        TS.run(sim, 101)
    with pytest.raises(ValueError, match="multiple"):
        TS.run_trace(sim, 101)
    assert int(TS.run(sim, 100).cycle) == 100
