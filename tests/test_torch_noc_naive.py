"""The naive reference step (``NocParams(step_impl="naive")``) of the port
against the JAX package's naive step, and against the port's own fast step.

Mirrors ``tests/test_noc_fastpath.py`` (``test_fast_matches_naive_canonical``,
``test_canonical_state_idempotent_preserves_live``), the naive legs of
``tests/test_noc_vc.py`` (``n_vcs`` 1 and 2 on the zoo) and
``tests/test_noc_offload.py`` (the offloaded in-fabric all-reduce), plus the
endpoint workloads of ``tests/test_torch_noc_sim.py`` and a ``run_sweep``
leg. Every case holds:

* the port's naive SimState equal to the JAX package's naive SimState leaf
  for leaf, dead FIFO and queue slots included, and every ``stats`` entry
  equal;
* the port's fast and naive states of the same run equal under
  ``canonical_state(scrub=True)`` (the fast and naive steps leave different
  garbage in dead slots only), with equal stats.

The naive step refuses super-steps (``fused_cycles > 1``) with the JAX
package's ``ValueError``. Integer state, and float32 accumulated in the
reference's order: exact equality.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.noc import sim as JS
from repro.core.noc.params import NocParams as JParams
from repro_torch import convert
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc.params import NocParams
from test_torch_noc_sim import WORKLOADS, assert_states_equal
from torch_mirror import JAX, PORT, assert_same, build_both, run_both

torch.set_num_threads(1)

ZOO = [
    ("mesh", dict(nx=4, ny=2)),
    ("torus", dict(nx=4, ny=2)),
    ("multi_die", dict(n_dies=2, nx=2, ny=2, d2d=2)),
]


def _dma(name, kw, write):
    """``make(pkg)`` for ``build_both``: uniform 1 kB x 2 DMA transfers on
    a zoo topology (``tests/test_noc_fastpath.py``'s ``_sim``)."""
    def make(pkg):
        topo = pkg.top.build_topology(name, **kw)
        return topo, pkg.T.dma_workload(topo, "uniform", transfer_kb=1,
                                        n_txns=2, write=write)
    return make


def _canon(sim, st, scrub):
    return convert.sim_state_to_numpy(TS.canonical_state(sim, st, scrub=scrub))


def assert_fast_equals_naive(fast, naive, tag=""):
    """``(sim, state)`` of the fast and the naive step of one run: equal
    under ``canonical_state``, scrubbed and not, with equal stats."""
    for scrub in (False, True):
        assert_states_equal(_canon(*fast, scrub), _canon(*naive, scrub),
                            f"{tag} fast/naive scrub={scrub}")
    out_f, out_n = TS.stats(*fast), TS.stats(*naive)
    for k in out_f:
        np.testing.assert_array_equal(out_f[k], out_n[k], err_msg=f"{tag} {k}")


def _naive_and_fast(make, cycles, tag, groups=None, **params_kw):
    """Run ``make``'s configuration (``groups(pkg)``: its collective groups
    in that package) on JAX naive, port naive and port fast; hold port
    naive against JAX naive and port fast against port naive. Returns the
    port's naive ``(sim, state)``."""
    if groups is None:
        groups = lambda pkg: None
    jp = JParams(step_impl="naive", **params_kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    (jtopo, jwl), (ttopo, twl) = make(JAX), make(PORT)
    sims = (JS.build_sim(jtopo, jp, jwl, groups=groups(JAX)),
            TS.build_sim(ttopo, tp, twl, groups=groups(PORT), device="cpu"))
    _, st_n, _ = run_both(sims, cycles, tag=f"{tag} naive vs JAX")
    fsim = TS.build_sim(ttopo, dataclasses.replace(tp, step_impl="fast"), twl,
                        groups=groups(PORT), device="cpu")
    st_f = TS.run(fsim, cycles)
    assert_fast_equals_naive((fsim, st_f), (sims[1], st_n), tag)
    # the naive queues keep their head at slot 0
    assert not st_n.eps.eg_head.any() and not st_n.eps.mq_head.any(), tag
    return sims[1], st_n


@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
def test_fast_matches_naive_canonical(name, kw):
    """Write bursts on the zoo, 300 cycles: naive equal to JAX naive leaf for
    leaf, and to the port's fast step under canonical_state."""
    sim, st = _naive_and_fast(_dma(name, kw, True), 300, name)
    assert int(st.eps.beats_rcvd.sum()) > 0


def test_canonical_state_idempotent_preserves_live():
    """Canonicalizing twice is a no-op and keeps the live counters and the
    cycle, on both steps (the naive roll-based pops shift stale flits into
    the tail slot, so it is not an identity on either)."""
    make = _dma("torus", dict(nx=4, ny=2), True)
    for impl in ("fast", "naive"):
        topo, wl = make(PORT)
        sim = TS.build_sim(topo, NocParams(step_impl=impl), wl, device="cpu")
        st = TS.run(sim, 150)
        c1 = TS.canonical_state(sim, st)
        c2 = TS.canonical_state(sim, c1)
        assert_states_equal(convert.sim_state_to_numpy(c1),
                            convert.sim_state_to_numpy(c2), f"{impl} idempotent")
        for name in ("beats_rcvd", "rx_bursts", "mq_cnt", "eg_cnt", "d_txns_left"):
            assert torch.equal(getattr(st.eps, name), getattr(c1.eps, name)), name
        assert torch.equal(st.fabric.in_cnt, c1.fabric.in_cnt)
        assert int(c1.cycle) == int(st.cycle) == 150


@pytest.mark.parametrize("name,kw", ZOO, ids=[z[0] for z in ZOO])
@pytest.mark.parametrize("V", [1, 2])
def test_naive_vc_matches_jax(name, kw, V):
    """The naive legs of ``tests/test_noc_vc.py`` at ``n_vcs`` 1 and 2: DMA
    reads on the zoo, 300 cycles, every transfer delivered."""
    sim, st = _naive_and_fast(_dma(name, kw, False), 300, f"{name} V={V}", n_vcs=V)
    assert int(st.eps.d_txns_left.sum()) == 0


@pytest.mark.parametrize("name,build_wl,params_kw", WORKLOADS,
                         ids=[w[0] for w in WORKLOADS])
def test_naive_workloads_match_jax(name, build_wl, params_kw):
    """The endpoint workloads of ``tests/test_torch_noc_sim.py`` on the 4x2
    mesh (narrow requests, HBM, RoB and RoB-less ordering, 4 channels),
    300 cycles on the naive step."""
    make = lambda pkg: (lambda t: (t, build_wl(pkg.T, t)))(pkg.top.build_mesh(nx=4, ny=2))
    sim, st = _naive_and_fast(make, 300, name, **params_kw)
    assert int(st.eps.beats_rcvd.sum() + st.eps.n_sent.sum()) > 0


OFFLOAD = [
    ("mesh", lambda top: top.build_mesh(3, 3, hbm_west=False), 1),
    ("torus_v2", lambda top: top.build_torus(3, 3), 2),
    ("multi_die", lambda top: top.build_multi_die(2, nx=2, ny=2, d2d=2), 1),
]


@pytest.mark.parametrize("name,build,V", OFFLOAD, ids=[c[0] for c in OFFLOAD])
def test_naive_offload_matches_jax(name, build, V):
    """The naive legs of ``test_offload_backend_and_impl_equivalence``: an
    offloaded in-fabric all-reduce (1 kB, 2 streams), 160 cycles."""
    sched = lambda pkg: pkg.CT.all_reduce(build(pkg.top), data_kb=1, streams=2,
                                          algo="infabric")
    make = lambda pkg: (build(pkg.top), pkg.CT.to_workload(build(pkg.top), sched(pkg)))
    _naive_and_fast(make, 160, name, groups=lambda pkg: sched(pkg).meta["groups"],
                    collective_offload=True, n_vcs=V)


def test_naive_offload_allreduce_exactly_once():
    """The offloaded all-reduce on the 3x3 mesh run to its end on the naive
    step: every endpoint receives exactly ``expect_rx``."""
    topo = PORT.top.build_mesh(3, 3, hbm_west=False)
    sc = PORT.CT.all_reduce(topo, data_kb=1, streams=2, algo="infabric")
    sim = TS.build_sim(topo, NocParams(collective_offload=True, step_impl="naive"),
                       PORT.CT.to_workload(topo, sc), groups=sc.meta["groups"],
                       device="cpu")
    st = TS.run(sim, 400)
    np.testing.assert_array_equal(st.eps.rx_bursts.numpy(), sc.expect_rx)


SWEEPS = [
    ("reads_narrow", {}, lambda p, t: [
        dataclasses.replace(p.T.dma_workload(t, "uniform", transfer_kb=kb, n_txns=2),
                            narrow_rate=np.where(np.arange(t.n_endpoints) < 8, 0.05,
                                                 0.0).astype(np.float32),
                            narrow_dst=np.where(np.arange(t.n_endpoints) < 8, -2,
                                                -1).astype(np.int32))
        for kb in (1, 2, 4)]),
    ("writes_4ch_rob", {"n_channels": 4, "ni_order": "rob"}, lambda p, t: [
        p.T.dma_workload(t, pat, transfer_kb=kb, n_txns=2, streams=2, write=True)
        for pat, kb in (("uniform", 1), ("transpose", 2))]),
]


@pytest.mark.parametrize("name,params_kw,make_wls", SWEEPS, ids=[c[0] for c in SWEEPS])
def test_naive_run_sweep_matches_jax(name, params_kw, make_wls):
    """``run_sweep`` on the naive step (B configurations of the 4x2 mesh as
    one state, per-cycle steps): each configuration equal to the JAX
    package's naive sweep and to its own sequential naive run leaf for leaf,
    and to the fast sweep under canonical_state."""
    jtopo, ttopo = JAX.top.build_mesh(nx=4, ny=2), PORT.top.build_mesh(nx=4, ny=2)
    jwls, twls = make_wls(JAX, jtopo), make_wls(PORT, ttopo)
    jp = JParams(step_impl="naive", **params_kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    want = JS.run_sweep(JS.build_sim(jtopo, jp, jwls[0]), jwls, 300)
    tsim = TS.build_sim(ttopo, tp, twls[0], device="cpu")
    got = TS.run_sweep(tsim, twls, 300)
    fsim = TS.build_sim(ttopo, dataclasses.replace(tp, step_impl="fast"), twls[0],
                        device="cpu")
    fast = TS.run_sweep(fsim, twls, 300)
    for i, wl in enumerate(twls):
        jsim_i = JS.build_sim(jtopo, jp, jwls[i])
        tsim_i = TS.build_sim(ttopo, tp, wl, device="cpu")
        assert_same((jsim_i, tsim_i), (want[i], got[i]), f"{name} {i} vs JAX")
        alone = TS.run(tsim_i, 300)
        assert_states_equal(convert.sim_state_to_numpy(alone),
                            convert.sim_state_to_numpy(got[i]), f"{name} {i} vs run")
        assert_fast_equals_naive((fsim, fast[i]), (tsim_i, got[i]), f"{name} {i}")
    assert all(int(s.eps.beats_rcvd.sum()) > 0 for s in got)


def test_naive_super_step_raises():
    """``step_super``, and ``run`` / ``run_trace`` at ``fused_cycles > 1``,
    raise the JAX package's ``ValueError`` on the naive step; ``run_sweep``
    steps per cycle and takes it."""
    make = _dma("mesh", dict(nx=4, ny=2), True)
    jsim, tsim = build_both(make, step_impl="naive", fused_cycles=4)
    msg = "step_super requires step_impl='fast'"
    with pytest.raises(ValueError, match=msg):
        JS.run(jsim, 8)
    with pytest.raises(ValueError, match=msg):
        TS.run(tsim, 8)
    with pytest.raises(ValueError, match=msg):
        TS.run_trace(tsim, 8)
    with pytest.raises(ValueError, match=msg):
        tsim.step_super(tsim.init_state(), 0)
    want = JS.run_sweep(jsim, [jsim.wl], 40)
    got = TS.run_sweep(tsim, [tsim.wl], 40)
    assert_same((jsim, tsim), (want[0], got[0]), "sweep at fused_cycles=4")
