"""The collective compiler of the port against the JAX package's.

``repro_torch.core.noc.collective_traffic``, ``repro_torch.core.collectives``
(``FabricCollectiveModel``) and ``repro_torch.core.scheduler`` are numpy /
pure-Python copies. Every schedule builder must give the same transfer
programme (``dst_seq``, ``gate``, ``beats_seq``, ``txns``, ``expect_rx``),
the same ``meta`` and the same lowered ``Workload`` on a 4x4 mesh and a 4x4
torus; the cycle models and the scheduler the same numbers; and a ring
all-reduce compiled by the port runs in the port's simulator to the JAX
simulator's state. Integer schedules and float64 model arithmetic in the
same order, so the tolerance is exact equality.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import collectives as JC
from repro.core import scheduler as JSch
from repro.core.noc import collective_traffic as JCT
from repro.core.noc import sim as JS
from repro.core.noc import topology as JTop
from repro.core.noc.params import NocParams as JParams
from repro_torch import convert
from repro_torch.core import collectives as TC
from repro_torch.core import scheduler as TSch
from repro_torch.core.noc import collective_traffic as TCT
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import topology as TTop
from test_torch_noc_sim import assert_states_equal, jax_state_dict

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)

SCHED_ARRAYS = ("dst_seq", "gate", "beats_seq", "txns", "expect_rx")


def assert_same(want, got, tag):
    """Recursive equality of schedule metadata: numpy arrays (dtype too),
    dataclasses (``Phase``, member ``CollectiveSchedule``\\ s), dicts,
    sequences and scalars."""
    if dataclasses.is_dataclass(want):
        assert type(want).__name__ == type(got).__name__, tag
        for f in dataclasses.fields(want):
            assert_same(getattr(want, f.name), getattr(got, f.name),
                        f"{tag}.{f.name}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and want.dtype == got.dtype, tag
        np.testing.assert_array_equal(want, got, err_msg=tag)
    elif isinstance(want, dict):
        assert set(want) == set(got), tag
        for k in want:
            assert_same(want[k], got[k], f"{tag}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(want) is type(got) and len(want) == len(got), tag
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{tag}[{i}]")
    else:
        assert type(want) is type(got) and want == got, (tag, want, got)


def _rows(nx, ny):
    return [np.arange(nx, dtype=np.int32) + y * nx for y in range(ny)]


# (id, builder taking the collective_traffic module and a topology)
BUILDERS = [
    ("all_gather", lambda CT, t: CT.all_gather(t, data_kb=2, streams=2)),
    ("reduce_scatter", lambda CT, t: CT.reduce_scatter(t, data_kb=2)),
    ("all_reduce_ring", lambda CT, t: CT.all_reduce(t, data_kb=2, streams=2)),
    ("all_reduce_2d", lambda CT, t: CT.all_reduce_2d(t, data_kb=2)),
    ("all_reduce_infabric", lambda CT, t: CT.all_reduce(
        t, data_kb=1, streams=2, algo="infabric")),
    ("multicast", lambda CT, t: CT.multicast(t, data_kb=2, streams=2)),
    ("multicast_offload", lambda CT, t: CT.multicast(
        t, root=5, data_kb=2, streams=2, offload=True)),
    ("barrier", lambda CT, t: CT.barrier(t, streams=2)),
    ("all_to_all", lambda CT, t: CT.all_to_all(t, data_kb=2, n_vcs=2)),
    ("all_to_all_ring", lambda CT, t: CT.all_to_all(t, data_kb=2,
                                                    algo="ring")),
    ("p2p", lambda CT, t: CT.p2p(t, data_kb=2, rounds=2, streams=2)),
    ("merge_disjoint", lambda CT, t: CT.merge_disjoint(
        t, [CT.all_reduce(t, data_kb=2, order=r) for r in _rows(4, 4)])),
]
TOPOS = [("mesh4x4", lambda T: T.build_mesh(4, 4, hbm_west=False)),
         ("torus4x4", lambda T: T.build_torus(4, 4))]


@pytest.mark.parametrize("topo_name,build_topo", TOPOS,
                         ids=[t[0] for t in TOPOS])
@pytest.mark.parametrize("name,build", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_schedule_and_workload_match_jax(name, build, topo_name, build_topo):
    jtopo, ttopo = build_topo(JTop), build_topo(TTop)
    want, got = build(JCT, jtopo), build(TCT, ttopo)
    for f in SCHED_ARRAYS:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert (want.name, want.model, want.n_streams, want.n_steps) == (
        got.name, got.model, got.n_streams, got.n_steps)
    assert_same(want.phases, got.phases, "phases")
    assert_same(want.meta, got.meta, "meta")
    jwl, twl = JCT.to_workload(jtopo, want), TCT.to_workload(ttopo, got)
    for f in dataclasses.fields(jwl):
        assert_same(getattr(jwl, f.name), getattr(twl, f.name), f.name)
    for n_vcs in (1, 2):
        jp, tp = JParams(n_vcs=n_vcs), TS.NocParams(n_vcs=n_vcs)
        assert JCT.analytical_cycles(want, jp, jtopo) == \
            TCT.analytical_cycles(got, tp, ttopo)
        assert JCT.analytical_cycles(want, jp) == TCT.analytical_cycles(got, tp)


def test_cycle_model_methods_match_jax():
    """Every ``FabricCollectiveModel`` method on the same inputs, through
    ``from_noc_params`` and a ``for_topology`` override."""
    rng = np.random.default_rng(3)
    paths = rng.integers(1, 8, (6, 5))
    hop_mat = rng.integers(1, 8, (6, 5))
    cong = rng.integers(0, 3, (6, 5))
    block = rng.integers(0, 3, (6, 5))
    chains = [[2, 3, 4], [1, 5]]
    topo_meta = type("T", (), {"meta": {"hop_cycles": 3.0, "rt_cycles": 7}})
    pairs = [
        (JC.FabricCollectiveModel.from_noc_params(JParams(mem_lat=5)),
         TC.FabricCollectiveModel.from_noc_params(TS.NocParams(mem_lat=5))),
        (JC.FabricCollectiveModel.for_topology(topo_meta, JParams()),
         TC.FabricCollectiveModel.for_topology(topo_meta, TS.NocParams())),
    ]
    calls = [
        ("edge_cycles", (16, 5), dict(streams=3)),
        ("pipelined_ring_cycles", (8, paths), dict(streams=2, occupancy=1.5)),
        ("rotation_all_to_all_cycles", (4, hop_mat, cong, block),
         dict(streams=2, vc_chain=np.array([0, 1, 0, 1, 1]))),
        ("ring_all_to_all_cycles", (np.array([5, 4, 3]), np.array([2, 3, 2])),
         dict(streams=2)),
        ("pipeline_chain_cycles", (8, chains, 3),
         dict(streams=2, chains_cong=[[0, 1, 0], [1, 0]])),
        ("tree_multicast_cycles", (32, [2, 3, 5, 4]), dict(streams=2)),
        ("infabric_all_reduce_cycles", (32, [2, 3, 5], [2, 3, 5]),
         dict(streams=2)),
        ("serial_unicast_cycles", (16, [[2, 3], [4, 5, 6]]), {}),
    ]
    assert JC.MERGED_A2A_CHAIN_RTOL == TC.MERGED_A2A_CHAIN_RTOL
    for jm, tm in pairs:
        assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
        for name, args, kw in calls:
            want = getattr(jm, name)(*args, **kw)
            got = getattr(tm, name)(*args, **kw)
            assert want == got, (name, want, got)


@pytest.mark.parametrize("kw", [
    dict(data_shards=8), dict(data_shards=16, pods=4, compute_s=1e-3),
    dict(data_shards=4, pods=2, allow_compress=False)])
def test_scheduler_matches_jax(kw):
    assert JSch.HOP_LAT == TSch.HOP_LAT
    assert JSch.suggest(64 << 20, **kw) == TSch.suggest(64 << 20, **kw)
    cost = dict(n_streams=4, data_shards=kw["data_shards"],
                pods=kw.get("pods", 1), compress_pod=True, compute_s=1e-3)
    assert dataclasses.asdict(JSch.cost(1 << 24, **cost)) == \
        dataclasses.asdict(TSch.cost(1 << 24, **cost))


def test_port_compiled_all_reduce_runs_equal_to_jax():
    """A ring all-reduce compiled by each package's own compiler runs in
    its own simulator (the port on the CPU) to the same SimState, leaf for
    leaf, after 300 cycles on the 4x2 mesh."""
    jtopo, ttopo = JTop.build_mesh(nx=4, ny=2), TTop.build_mesh(nx=4, ny=2)
    jwl = JCT.to_workload(jtopo, JCT.build(jtopo, "all-reduce", data_kb=1))
    twl = TCT.to_workload(ttopo, TCT.build(ttopo, "all-reduce", data_kb=1))
    jsim = JS.build_sim(jtopo, JParams(), jwl)
    tsim = TS.build_sim(ttopo, TS.NocParams(), twl, device="cpu")
    want = jax_state_dict(JS.run(jsim, 300))
    got = convert.sim_state_to_numpy(TS.run(tsim, 300))
    assert_states_equal(want, got, "all-reduce")
    assert got["eps.rx_bursts"].sum() > 0
