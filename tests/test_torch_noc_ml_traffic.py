"""The port's ML-parallelism traffic compiler
(``repro_torch.core.noc.ml_traffic``) against the JAX package's, mirroring
``tests/test_noc_ml_traffic.py``.

* the all-to-all and p2p primitives replay exactly once, their schedules
  equal to JAX's;
* ``compile_traffic`` phase schedules (both the true-size and the
  sim-capped one), counts, notes and ``step_report`` rows equal to JAX's on
  the 4x4 mesh and torus, wrap-safety refusals alike;
* ``validate_phase`` (the port's simulator on the CPU) equal to JAX's;
* the explorer's ``--workload ddp`` output equal to the JAX explorer's on
  the 4x4 mesh and torus;
* the MoE sweep: the port's ``run_sweep`` over two compiled MoE configs
  equal to its sequential runs and to JAX's ``run_sweep``.

The moe and ddp phases use ``llama4-scout-17b-a16e`` reduced, as the JAX
tests and both explorers do (the ddp gradient bytes are its parameter
count, ``count_params`` of the MoE schema); tp / pp and the torus's ddp
use ``phi4-mini-3.8b`` reduced in both packages. Integer schedules and
state, the JAX package's float formulas: exact equality.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core.noc import collective_traffic as JCT
from repro.core.noc import ml_traffic as JML
from repro.core.noc import sim as JS
from repro.core.noc.params import NocParams as JParams
from repro.core.noc.topology import build_mesh as jmesh
from repro.core.noc.topology import build_torus as jtorus
from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.core.noc import collective_traffic as CT
from repro_torch.core.noc import ml_traffic as ML
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import build_mesh, build_torus
from repro_torch.noc_explore import main as explore
from test_torch_noc_sim import assert_states_equal, jax_state_dict

torch.set_num_threads(1)

MOE = "llama4-scout-17b-a16e"
DENSE = "phi4-mini-3.8b"
ROOT = Path(__file__).resolve().parents[1]


def _plain(x):
    """A schedule (or any nest of dataclasses, dicts, sequences and numpy
    arrays) as plain Python values, with each array's dtype kept, so the
    two packages' objects compare with ``==``."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def _sched_equal(j, t, tag=""):
    assert _plain(j) == _plain(t), tag


def _phases_equal(jph, tph):
    assert [p.name for p in jph] == [p.name for p in tph]
    for j, t in zip(jph, tph):
        assert (j.pattern, j.count, j.data_kb, j.note) == \
               (t.pattern, t.count, t.data_kb, t.note)
        _sched_equal(j.schedule, t.schedule, t.name)
        _sched_equal(j.sim_schedule, t.sim_schedule, t.name + " sim")


# ----------------------------------------------------------------------
# schedule level: the primitives replay exactly once, as JAX's do
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(data_kb=8),
    dict(data_kb=16, streams=2),
    dict(data_kb=8, algo="ring"),
    dict(data_kb=8, streams=2, order=np.arange(4, dtype=np.int32)),
])
def test_all_to_all_schedule_exactly_once(kw):
    sched = CT.build(build_mesh(nx=4, ny=4), "all-to-all", **kw)
    CT.check_schedule(sched)
    n = len(sched.meta["order"])
    assert sched.txns.sum() == sched.n_streams * n * (n - 1)
    _sched_equal(JCT.build(jmesh(nx=4, ny=4), "all-to-all", **kw), sched)


@pytest.mark.parametrize("kw", [
    dict(data_kb=4, rounds=4),
    dict(data_kb=8, rounds=8, streams=2),
])
def test_p2p_schedule_exactly_once(kw):
    sched = CT.build(build_mesh(nx=4, ny=4), "p2p", **kw)
    CT.check_schedule(sched)
    heads = {a for a, _ in sched.meta["pairs"]} - {b for _, b in sched.meta["pairs"]}
    for a, _ in sched.meta["pairs"]:
        assert sched.gate[a, 0, 0] == (0 if a in heads else 1)
    _sched_equal(JCT.build(jmesh(nx=4, ny=4), "p2p", **kw), sched)


def test_p2p_rejects_cycles_and_fan_in():
    topo = build_mesh(nx=4, ny=4)
    with pytest.raises(ValueError, match="cycle"):
        CT.p2p(topo, [(0, 1), (1, 2), (2, 0)])
    with pytest.raises(ValueError, match="predecessor"):
        CT.p2p(topo, [(0, 2), (1, 2)])
    with pytest.raises(ValueError, match="successor"):
        CT.p2p(topo, [(0, 1), (0, 2)])


def test_all_to_all_auto_picks_ring_on_torus():
    assert CT.all_to_all(build_mesh(nx=4, ny=4), data_kb=4).meta["algo"] == "direct"
    assert CT.all_to_all(build_torus(nx=4, ny=4), data_kb=4).meta["algo"] == "ring"


# ----------------------------------------------------------------------
# compiled phases and step reports equal to JAX's
# ----------------------------------------------------------------------
def test_dense_parameter_counts_agree():
    assert tget(DENSE).reduced().n_params() == jget(DENSE).reduced().n_params()
    assert tget(MOE).reduced().n_params() == jget(MOE).reduced().n_params()


@pytest.mark.parametrize("workload", ML.WORKLOADS)
def test_demo_phase_equal_jax_on_mesh(workload):
    """The shared demo jobs (``DEMO_SPECS``) on the 4x4 mesh (ddp and moe
    on the explorer's MoE model)."""
    arch = MOE if workload in ("moe", "ddp") else DENSE
    par_kw, tokens = ML.DEMO_SPECS[workload]
    assert JML.DEMO_SPECS[workload] == (par_kw, tokens)
    kw = dict(tokens_per_device=tokens, sim_cap_kb=16, workloads=[workload])
    jph = JML.compile_traffic(jget(arch).reduced(), JML.ParallelismSpec(**par_kw),
                              jmesh(nx=4, ny=4), **kw)
    tph = ML.compile_traffic(tget(arch).reduced(), ML.ParallelismSpec(**par_kw),
                             build_mesh(nx=4, ny=4), **kw)
    _phases_equal(jph, tph)
    CT.check_schedule(tph[0].sim_schedule)
    assert ML.step_report(tph, NocParams(), build_mesh(nx=4, ny=4)) == \
        JML.step_report(jph, JParams(), jmesh(nx=4, ny=4))


def test_compiled_step_on_torus_equal_jax():
    """Grid-aligned degrees on the torus: the ddp, tp and pp phases (dense
    model) and the moe phase (MoE model), their step reports, and the
    in-fabric pick of the ddp all-reduce under collective offload."""
    par = dict(dp=2, tp=4, pp=2, ep=2, microbatches=4)
    kw = dict(tokens_per_device=256, sim_cap_kb=8)
    for arch, wls, extra in ((DENSE, ["ddp", "tp", "pp"], {}), (MOE, ["moe"], {}),
                             (DENSE, ["ddp"], {"collective_offload": True})):
        jp, tp = JParams(**extra), NocParams(**extra)
        pk = dict(params=jp) if extra else {}
        jph = JML.compile_traffic(jget(arch).reduced(), JML.ParallelismSpec(**par),
                                  jtorus(nx=4, ny=4), workloads=wls, **kw, **pk)
        pk = dict(params=tp) if extra else {}
        tph = ML.compile_traffic(tget(arch).reduced(), ML.ParallelismSpec(**par),
                                 build_torus(nx=4, ny=4), workloads=wls, **kw, **pk)
        _phases_equal(jph, tph)
        assert ML.step_report(tph, tp, build_torus(nx=4, ny=4)) == \
            JML.step_report(jph, jp, jtorus(nx=4, ny=4))
        for ph in tph:
            CT.check_schedule(ph.sim_schedule)


def test_wrap_safety_rejects_strided_groups_on_torus():
    cfg = tget(DENSE).reduced()
    with pytest.raises(ValueError, match="channel-dependency cycle"):
        ML.compile_traffic(cfg, ML.ParallelismSpec(dp=4, tp=2, pp=2),
                           build_torus(nx=4, ny=4), tokens_per_device=256)
    phases = ML.compile_traffic(cfg, ML.ParallelismSpec(dp=4, tp=2, pp=2),
                                build_mesh(nx=4, ny=4), tokens_per_device=256)
    assert [ph.name for ph in phases] == ["ddp", "tp", "pp"]
    with pytest.raises(ValueError, match="inactive"):
        ML.compile_traffic(cfg, ML.ParallelismSpec(dp=4), build_mesh(nx=4, ny=4),
                           workloads=["moe"])


@pytest.mark.parametrize("workload", ["tp", "moe", "ddp"])
def test_validate_phase_equal_jax(workload):
    """The shared simulate-and-compare step on the port's simulator (CPU):
    measured cycles, model estimate and delivery equal to JAX's (ddp and
    moe on the explorer's MoE model)."""
    arch = MOE if workload in ("moe", "ddp") else DENSE
    par_kw, tokens = ML.DEMO_SPECS[workload]
    kw = dict(tokens_per_device=tokens, sim_cap_kb=4, workloads=[workload])
    (jph,) = JML.compile_traffic(jget(arch).reduced(), JML.ParallelismSpec(**par_kw),
                                 jmesh(nx=4, ny=4), **kw)
    (tph,) = ML.compile_traffic(tget(arch).reduced(), ML.ParallelismSpec(**par_kw),
                                build_mesh(nx=4, ny=4), **kw)
    want = JML.validate_phase(jmesh(nx=4, ny=4), jph, JParams())
    got = ML.validate_phase(build_mesh(nx=4, ny=4), tph, NocParams(), device="cpu")
    assert got == want and got["delivered"]


@pytest.mark.parametrize("topology", ["mesh", "torus"])
def test_explorer_ddp_prints_what_the_jax_explorer_prints(topology, capsys):
    """``--workload ddp`` on the MoE demo model: the port's explorer (CPU)
    and the JAX package's ``examples/noc_explore.py`` print the same
    phases, cycles, notes and step report."""
    spec = importlib.util.spec_from_file_location(
        "jax_noc_explore", ROOT / "examples" / "noc_explore.py")
    jexplore = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexplore)
    jexplore.workload_demo("ddp", topology)
    want = capsys.readouterr().out
    explore(["--workload", "ddp", "--topology", topology, "--device", "cpu"])
    got = capsys.readouterr().out
    assert "llama4-scout-17b-a16e-reduced" in got and "delivered=yes" in got
    assert got == want


# ----------------------------------------------------------------------
# the MoE sweep: one batched state, equal to sequential runs and to JAX's
# ----------------------------------------------------------------------
def _moe_workloads(ml, get_config, topo):
    par = ml.ParallelismSpec(dp=4, ep=4, streams=2)
    wls = []
    for tokens in (128, 256):
        (ph,) = ml.compile_traffic(get_config(MOE).reduced(), par, topo,
                                   tokens_per_device=tokens, sim_cap_kb=8,
                                   workloads=["moe"])
        wls.append(ml.phase_workload(topo, ph))
    return wls


def test_moe_sweep_matches_sequential_and_jax():
    topo, jtopo = build_mesh(nx=2, ny=2), jmesh(nx=2, ny=2)
    wls = _moe_workloads(ML, tget, topo)
    jwls = _moe_workloads(JML, jget, jtopo)
    swept = TS.run_sweep(TS.build_sim(topo, NocParams(), wls[0], device="cpu"), wls, 400)
    jswept = JS.run_sweep(JS.build_sim(jtopo, JParams(), jwls[0]), jwls, 400)
    for wl, st, jst in zip(wls, swept, jswept):
        got = convert.sim_state_to_numpy(st)
        alone = TS.run(TS.build_sim(topo, NocParams(), wl, device="cpu"), 400)
        assert_states_equal(convert.sim_state_to_numpy(alone), got, "sequential")
        assert_states_equal(jax_state_dict(jst), got, "jax")
