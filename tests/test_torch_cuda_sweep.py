"""The batched sweep on the card: ``run_sweep`` of several workloads as one
state against each workload's own sequential run on the card, leaf for
leaf, with the router kernels launched as for one configuration (on the
naive step too: the apply kernel's unfused mode).

These tests need a CUDA device and skip without one (the design-space
run over several cards skips with fewer than two); run them on the GPU
host with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_cuda_sweep.py``. This file imports neither JAX nor
``repro``. Integer state, so the tolerance is exact equality.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core.noc import collective_traffic as CT
from repro_torch.core.noc import dse
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import traffic as TT
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import build_mesh, build_torus
from repro_torch.kernels.noc_router import noc_router as K

ROOT = Path(__file__).resolve().parents[1]

pytestmark = [
    pytest.mark.gpu,
    pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device"),
]


def _sizes(topo):
    return [TT.dma_workload(topo, "uniform", transfer_kb=kb, n_txns=2) for kb in (1, 2, 4)]


def _allreduce(topo):
    return [CT.to_workload(topo, CT.all_reduce(topo, data_kb=kb, streams=2, algo="infabric"))
            for kb in (8, 16)]


CASES = [
    ("mesh_sizes", lambda: build_mesh(nx=4, ny=8), _sizes, {}, None),
    ("torus_vc", lambda: build_torus(nx=4, ny=8), _sizes, {"n_vcs": 2}, None),
    ("offload", lambda: build_mesh(nx=4, ny=8), _allreduce,
     {"collective_offload": True}, "groups"),
    ("naive", lambda: build_mesh(nx=4, ny=8), _sizes, {"step_impl": "naive"}, None),
    ("naive_torus_vc", lambda: build_torus(nx=4, ny=8), _sizes,
     {"step_impl": "naive", "n_vcs": 2}, None),
    ("naive_offload", lambda: build_mesh(nx=4, ny=8), _allreduce,
     {"step_impl": "naive", "collective_offload": True}, "groups"),
]


@pytest.mark.parametrize("name,make_topo,make_wls,params_kw,groups", CASES,
                         ids=[c[0] for c in CASES])
def test_sweep_on_card_matches_sequential_card_runs(name, make_topo, make_wls,
                                                    params_kw, groups):
    topo = make_topo()
    wls = make_wls(topo)
    params = NocParams(**params_kw)
    grp = None
    if groups:
        grp = CT.all_reduce(topo, data_kb=8, streams=2, algo="infabric").meta["groups"]
    sim = TS.build_sim(topo, params, wls[0], groups=grp, device="cuda")
    torch.cuda.synchronize()
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    swept = TS.run_sweep(sim, wls, 300)
    torch.cuda.synchronize()
    arb = "arb_offload" if params.collective_offload else "arb"
    apply = K.apply_mode(params.fast)
    want = dict.fromkeys(K.LAUNCHES, 0)
    want.update({K.mode(arb, params.n_vcs): 300, K.mode(apply, params.n_vcs): 300})
    assert dict(K.LAUNCHES) == want
    for wl, st in zip(wls, swept):
        one = TS.run(TS.build_sim(topo, params, wl, groups=grp, device="cuda"), 300)
        a, b = convert.sim_state_to_numpy(st), convert.sim_state_to_numpy(one)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        assert int(TS.stats(sim, st)["beats_rcvd"].sum()) > 0


def test_sweep_on_card_steps_per_cycle_at_fused_cycles_4():
    """The sweep steps cycle by cycle whatever ``fused_cycles`` is (as the
    JAX package's does): no fused window is launched."""
    topo = build_mesh(nx=4, ny=8)
    wls = _sizes(topo)
    sim = TS.build_sim(topo, NocParams(fused_cycles=4), wls[0], device="cuda")
    torch.cuda.synchronize()
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    swept = TS.run_sweep(sim, wls, 200)
    torch.cuda.synchronize()
    assert K.LAUNCHES["fused"] == 0 and K.LAUNCHES["arb"] == 200
    per_cycle = dataclasses.replace(sim.params, fused_cycles=1)
    for wl, st in zip(wls, swept):
        one = TS.run(TS.build_sim(topo, per_cycle, wl, device="cuda"), 200)
        a, b = convert.sim_state_to_numpy(st), convert.sim_state_to_numpy(one)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.skipif(torch.cuda.device_count() < 2, reason="needs two CUDA devices")
def test_dse_spreads_groups_over_the_cards():
    """``run_dse`` on ``cuda`` sends group j to card j mod the card count:
    the smoke grid's two groups (mesh, dateline torus) run on cards 0 and
    1, each while its card is the current device, and the frontier
    artifact equals the JAX package's byte for byte."""
    specs = dse.default_grid(smoke=True)
    assert len(dse.build_jobs(specs)) == 2
    results = dse.run_dse(specs, device="cuda", return_states=True)
    assert {r.pop("state").cycle.device.index for r in results} == {0, 1}
    got = json.dumps(dse.frontier_artifact(results, grid="smoke"), indent=1,
                     sort_keys=True)
    assert got == (ROOT / "src/repro_torch/benchmarks/dse_smoke_jax.json").read_text()
