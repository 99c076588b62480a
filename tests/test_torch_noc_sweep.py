"""The port's batched sweep (``repro_torch.core.noc.sim.run_sweep``) against
the JAX package's ``run_sweep`` and the port's own sequential runs.

* the validation errors of ``tests/test_noc_sim_fixes.py`` (swept-field
  presence) and ``tests/test_noc_collectives.py`` (static attributes);
* each configuration's final state equal, leaf for leaf (dead slots
  included), to JAX's ``run_sweep`` and to the port's sequential ``run``:
  across transfer sizes (different ``dma_beats``), narrow traffic with
  per-endpoint random destinations, HBM endpoints, writes on four channels
  with RoB ordering, collective schedules (``dma_dst_seq`` / ``dma_gate``),
  a torus at ``n_vcs=2``, in-fabric offload groups, a multi-die fabric and
  ``fused_cycles=4`` params (the sweep steps per cycle, as JAX's does);
* one router cycle per simulated cycle whatever the batch size.

Integer state, float32 accumulated in the reference's order: the tolerance
is exact equality.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.noc import sim as JS
from repro.core.noc.params import NocParams as JParams
from repro_torch import convert
from repro_torch.core.noc import engine as teng
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc.params import NocParams
from test_torch_noc_sim import assert_states_equal, jax_state_dict
from torch_mirror import JAX, PORT

torch.set_num_threads(1)


def _narrow(pkg, wl, topo, rate):
    E, nt = topo.n_endpoints, topo.meta["n_tiles"]
    nr = np.zeros((E,), np.float32)
    nr[:nt] = rate
    nd = np.full((E,), -1, np.int32)
    nd[:nt] = -2  # a hash of (endpoint, sequence) per message
    return dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)


def _collective(pkg, topo, name, sizes, **kw):
    return [pkg.CT.to_workload(topo, pkg.CT.build(topo, name, data_kb=kb, **kw))
            for kb in sizes]


# (id, topology builder on a package's topology module, workloads on that
#  package, NocParams kwargs, whether the fabric carries the first
#  workload's collective groups)
CASES = [
    ("sizes_dma_beats", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: [p.T.dma_workload(t, "uniform", transfer_kb=kb, n_txns=2)
                   for kb in (1, 2, 4)], {}, False),
    ("narrow_patterns", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: [_narrow(p, p.T.dma_workload(t, pat, transfer_kb=1, n_txns=4), t, r)
                   for pat, r in (("uniform", 0.05), ("neighbor", 0.2),
                                  ("bit-complement", 0.0))], {}, False),
    ("hbm", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: [p.T.hbm_workload(t, full_load=f, n_txns=4, transfer_kb=kb)
                   for f, kb in ((True, 1), (False, 2))], {}, False),
    ("writes_4ch_rob", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: [p.T.dma_workload(t, pat, transfer_kb=kb, n_txns=2, streams=2,
                                    write=True)
                   for pat, kb in (("uniform", 1), ("transpose", 2))],
     {"n_channels": 4, "ni_order": "rob"}, False),
    ("collective_schedules", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: _collective(p, t, "all-gather", (2, 4)), {}, False),
    ("torus_vc2", lambda t: t.build_torus(nx=4, ny=2),
     lambda p, t: [p.T.dma_workload(t, pat, transfer_kb=1, n_txns=2)
                   for pat in ("uniform", "neighbor")], {"n_vcs": 2}, False),
    ("offload_groups", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: _collective(p, t, "all-reduce", (4, 8), streams=2, algo="infabric"),
     {"collective_offload": True}, True),
    ("multi_die", lambda t: t.build_multi_die(n_dies=2, nx=2, ny=2, d2d=2),
     lambda p, t: [p.T.dma_workload(t, pat, transfer_kb=1, n_txns=2)
                   for pat in ("uniform", "bit-complement")], {}, False),
    ("fused_cycles_4", lambda t: t.build_mesh(nx=4, ny=2),
     lambda p, t: [p.T.dma_workload(t, "uniform", transfer_kb=kb, n_txns=2)
                   for kb in (1, 2)], {"fused_cycles": 4}, False),
]
N_CYCLES = 300


def _groups(pkg, topo, wls, offload):
    """The collective groups of the first workload's schedule (all the
    batch's schedules share them), or None."""
    if not offload:
        return None
    return pkg.CT.build(topo, "all-reduce", data_kb=4, streams=2,
                        algo="infabric").meta["groups"]


@pytest.mark.parametrize("name,make_topo,make_wls,params_kw,offload", CASES,
                         ids=[c[0] for c in CASES])
def test_sweep_matches_jax_sweep_and_sequential_runs(name, make_topo, make_wls,
                                                     params_kw, offload):
    jtopo, ttopo = make_topo(JAX.top), make_topo(PORT.top)
    jwls, twls = make_wls(JAX, jtopo), make_wls(PORT, ttopo)
    jp = JParams(**params_kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    jsim = JS.build_sim(jtopo, jp, jwls[0], groups=_groups(JAX, jtopo, jwls, offload))
    groups = _groups(PORT, ttopo, twls, offload)
    tsim = TS.build_sim(ttopo, tp, twls[0], groups=groups, device="cpu")
    want = [jax_state_dict(s) for s in JS.run_sweep(jsim, jwls, N_CYCLES)]
    got = TS.run_sweep(tsim, twls, N_CYCLES)
    assert len(got) == len(twls)
    # the sweep steps per cycle whatever fused_cycles is, as JAX's does
    per_cycle = dataclasses.replace(tp, fused_cycles=1)
    for i, (wl, st) in enumerate(zip(twls, got)):
        g = convert.sim_state_to_numpy(st)
        assert_states_equal(want[i], g, f"{name} {i} vs JAX")
        alone = TS.run(TS.build_sim(ttopo, per_cycle, wl, groups=groups, device="cpu"),
                       N_CYCLES)
        assert_states_equal(convert.sim_state_to_numpy(alone), g, f"{name} {i} vs run")
        # stats and canonical_state take a configuration's state
        out = TS.stats(tsim, st)
        assert out["cycles"] == N_CYCLES
        TS.canonical_state(tsim, st, scrub=True)
    assert any(convert.sim_state_to_numpy(s)["eps.beats_rcvd"].sum() for s in got)


def test_sweep_runs_one_router_cycle_per_cycle(monkeypatch):
    """The batch is one state: every simulated cycle is one router cycle
    over B x C channels, however many configurations there are."""
    topo = PORT.top.build_mesh(nx=4, ny=2)
    wls = [PORT.T.dma_workload(topo, "uniform", transfer_kb=kb, n_txns=2)
           for kb in (1, 2, 4)]
    sim = TS.build_sim(topo, NocParams(), wls[0], device="cpu")
    calls = []
    real = teng.router_ops.router_cycle

    def counted(in_buf, *args, **kw):
        calls.append(tuple(in_buf.shape[:1]))
        return real(in_buf, *args, **kw)

    monkeypatch.setattr(teng.router_ops, "router_cycle", counted)
    TS.run_sweep(sim, wls, 20)
    assert calls == [(3 * 3,)] * 20


# ----------------------------------------------------------------------
# validation, as the JAX package's run_sweep validates
# ----------------------------------------------------------------------
def test_run_sweep_rejects_fields_the_reference_lacks():
    """A field set only on batch members would be silently dropped (the
    swept-field list comes from sim.wl): must raise instead."""
    topo = PORT.top.build_mesh(nx=4, ny=2)
    base = PORT.T.dma_workload(topo, "uniform", transfer_kb=1, n_txns=2)
    ref = dataclasses.replace(base, dma_alt_dst=None)
    member = dataclasses.replace(base, dma_alt_dst=np.full_like(base.dma_dst, 1))
    sim = TS.build_sim(topo, NocParams(), ref, device="cpu")
    with pytest.raises(ValueError, match="dma_alt_dst"):
        TS.run_sweep(sim, [ref, member], 50)


def test_run_sweep_rejects_fields_only_the_reference_has():
    topo = PORT.top.build_mesh(nx=4, ny=2)
    base = PORT.T.dma_workload(topo, "uniform", transfer_kb=1, n_txns=2)
    member = dataclasses.replace(base, narrow_rate=None)
    sim = TS.build_sim(topo, NocParams(), base, device="cpu")
    with pytest.raises(ValueError, match="narrow_rate"):
        TS.run_sweep(sim, [base, member], 50)


def test_run_sweep_rejects_static_mismatch():
    topo = PORT.top.build_mesh(nx=4, ny=2)
    r = PORT.T.dma_workload(topo, "uniform", transfer_kb=1, n_txns=2)
    w = PORT.T.dma_workload(topo, "uniform", transfer_kb=1, n_txns=2, write=True)
    sim = TS.build_sim(topo, NocParams(), r, device="cpu")
    with pytest.raises(ValueError, match="static workload attributes"):
        TS.run_sweep(sim, [r, w], 50)
    sched = PORT.CT.build(topo, "barrier")
    with pytest.raises(ValueError):
        TS.run_sweep(sim, [r, dataclasses.replace(
            PORT.CT.to_workload(topo, sched), dma_write=False)], 50)
