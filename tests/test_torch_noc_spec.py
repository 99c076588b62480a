"""The port's FabricSpec pipeline (``repro_torch.core.noc.spec``) and
design-space exploration (``repro_torch.core.noc.dse``) against the JAX
package's, mirroring ``tests/test_noc_spec.py``.

* round trips, rejections that name the field, ``group_key``;
* for every preset and every ``default_grid()`` point: ``to_json`` and
  ``spec_hash`` equal to JAX's (the DSE artifact is sorted and keyed by the
  hash), and ``lower()`` equal to JAX's in its topology arrays and in every
  ``NocParams`` field the port has;
* ``run_dse`` on the smoke grid (CPU): each point's state equal to
  ``run_sweep`` on that point alone, the frontier artifact equal to the JAX
  package's ``run_dse`` byte for byte, at one and at two worker processes;
  the committed ``dse_smoke_jax.json`` equal to a fresh JAX run; and the
  explorer (``python -m repro_torch.noc_explore --dse --smoke --device cpu
  --json``) writing that file's bytes.

Integer state and the JAX package's own float formulas: exact equality.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.noc import dse as Jdse
from repro.core.noc import spec as Jspec
from repro_torch import convert
from repro_torch.core.noc import dse
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import spec as Tspec
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.spec import FabricSpec, preset
from repro_torch.core.noc.topology import (
    build_mesh,
    build_multi_die,
    build_occamy,
    build_topology,
    build_torus,
)
from repro_torch.noc_explore import main as explore

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SMOKE_JAX = ROOT / "src/repro_torch/benchmarks/dse_smoke_jax.json"


# ----------------------------------------------------------------------
# serialization round-trips
# ----------------------------------------------------------------------
def test_roundtrip_dict_json_yaml():
    sp = preset("torus", n_vcs=2, workload="uniform", transfer_kb=2)
    assert FabricSpec.from_dict(sp.to_dict()) == sp
    assert FabricSpec.from_json(sp.to_json()) == sp
    assert FabricSpec.from_yaml(sp.to_yaml()) == sp
    h = sp.spec_hash()
    assert len(h) == 12 and int(h, 16) >= 0
    assert FabricSpec.from_json(sp.to_json()).spec_hash() == h


def test_hash_independent_of_key_order():
    sp = preset("mesh", workload="neighbor")
    shuffled = dict(reversed(list(sp.to_dict().items())))
    assert FabricSpec.from_dict(shuffled).spec_hash() == sp.spec_hash()


def test_yaml_comments_and_partial():
    sp = FabricSpec.from_yaml(
        "# a torus point\ntopology: torus\nnx: 4\nny: 4\nn_vcs: 2\n\n"
        "workload: 'uniform'\n")
    assert sp == FabricSpec(topology="torus", nx=4, ny=4, n_vcs=2,
                            workload="uniform")


# ----------------------------------------------------------------------
# validation: bad configs rejected at construction, fields named
# ----------------------------------------------------------------------
REJECTIONS = [
    (dict(topology="ring"), "unknown topology"),
    (dict(topology="torus", hbm_west=True), r"\['hbm_west'\] do not apply"),
    (dict(topology="mesh", nx=4, ny=4, express=4), "express span 4"),
    (dict(n_channels=2), "n_channels"),
    (dict(topology="torus", nx=4, ny=4, workload="uniform"), "n_vcs >= 2"),
    (dict(topology="occamy", workload="uniform"), "no grid coordinates"),
    (dict(topology="mesh", hbm_west=False, workload="tiled-matmul"),
     "tiled-matmul"),
    (dict(workload="nope"), "unknown workload"),
    (dict(nx=0), "nx must be >= 1"),
    (dict(ni_order="reorder"), "ni_order"),
    # the two Pallas knobs: kept in the schema, validated as JAX does
    (dict(backend="triton"), "backend must be 'jnp' or 'pallas'"),
    (dict(router_tile=-1), "router_tile must be >= 0"),
]


@pytest.mark.parametrize("kw, msg", REJECTIONS)
def test_rejections(kw, msg):
    with pytest.raises(ValueError, match=msg):
        FabricSpec(**kw)
    with pytest.raises(ValueError, match=msg):  # the JAX package's message
        Jspec.FabricSpec(**kw)


def test_from_dict_rejects_unknown_keys():
    with pytest.raises(ValueError, match=r"\['bogus'\]"):
        FabricSpec.from_dict({"topology": "mesh", "bogus": 1})
    with pytest.raises(ValueError, match="field: value"):
        FabricSpec.from_yaml("topology\n")


def test_torus_vc_check_is_exact_not_heuristic():
    sp = FabricSpec(topology="torus", nx=4, ny=4, workload="bit-complement")
    assert sp.required_vcs() == 1
    sp2 = FabricSpec(topology="torus", nx=4, ny=4, n_vcs=2, workload="uniform")
    assert sp2.required_vcs() == 2


def test_build_topology_names_unknown_kwargs():
    with pytest.raises(ValueError, match=r"\['hbm_west'\].*torus"):
        build_topology("torus", hbm_west=True)
    with pytest.raises(ValueError, match="unknown topology"):
        build_topology("hypercube")


# ----------------------------------------------------------------------
# lowering: bit-identical to the hand-built zoo and to the JAX package's
# ----------------------------------------------------------------------
def _assert_topo_equal(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, f.name
            assert np.array_equal(va, vb), f.name
        else:
            assert va == vb, f.name


@pytest.mark.parametrize("spec, build", [
    (preset("mesh"), lambda: build_mesh(nx=4, ny=4)),
    (preset("mesh", big=True), lambda: build_mesh(nx=4, ny=8)),
    (preset("mesh", express=2), lambda: build_mesh(nx=4, ny=4, express=2)),
    (preset("torus"), lambda: build_torus(nx=4, ny=4)),
    (preset("multi_die"), lambda: build_multi_die(n_dies=2, nx=2, ny=4)),
    (preset("occamy"), lambda: build_occamy()),
], ids=["mesh", "mesh_big", "mesh_express", "torus", "multi_die", "occamy"])
def test_lowering_matches_zoo(spec, build):
    topo, params = spec.lower()
    _assert_topo_equal(topo, build())
    assert params == NocParams()


def test_preset_knob_overrides_lower_to_params():
    p = preset("mesh", n_channels=4, n_vcs=2, ni_order="rob",
               fused_cycles=8).params()
    assert p == NocParams(n_channels=4, n_vcs=2, ni_order="rob", fused_cycles=8)
    # the Pallas knobs stay in the spec (and its hash) but not in NocParams
    sp = preset("mesh", backend="pallas", router_tile=4)
    assert sp.params() == NocParams()
    assert sp.spec_hash() != preset("mesh").spec_hash()


def test_naive_step_is_refused_through_params():
    """The naive step is ported: a ``step_impl="naive"`` spec is accepted,
    serialises and hashes as the JAX package's does (its hash differs from
    the fast spec's), and lowers to the naive ``NocParams``."""
    for kw in ({}, {"n_vcs": 2, "workload": "uniform", "transfer_kb": 4}):
        t = preset("mesh", step_impl="naive", **kw)
        j = Jspec.preset("mesh", step_impl="naive", **kw)
        assert t.to_json() == j.to_json()
        assert t.spec_hash() == j.spec_hash()
        assert t.spec_hash() != preset("mesh", **kw).spec_hash()
        assert FabricSpec.from_json(t.to_json()) == t
        topo, params = t.lower()
        assert params == NocParams(step_impl="naive", n_vcs=kw.get("n_vcs", 1))
        jtopo, jparams = j.lower()
        assert convert.params_from_dict(dataclasses.asdict(jparams)) == params


def test_group_key_batches_only_sweepables():
    a = preset("mesh", workload="uniform", transfer_kb=1)
    b = preset("mesh", workload="neighbor", transfer_kb=4, n_txns=2)
    assert a.group_key() == b.group_key()
    assert a.group_key() != preset("mesh", n_channels=4, workload="uniform").group_key()
    assert a.group_key() != preset("mesh", workload="all-to-all").group_key()


def _presets(pkg):
    return [pkg.preset(name, big=big) for name in ("mesh", "torus", "multi_die", "occamy")
            for big in (False, True)] + [
        pkg.preset("torus", n_vcs=2, workload="uniform", transfer_kb=2),
        pkg.preset("mesh", workload="all-to-all", streams=2, backend="pallas",
                   router_tile=0, collective_offload=True),
        pkg.preset("multi_die", big=True, n_channels=5, fused_cycles=4, write=True,
                   workload="transpose", seed=3)]


@pytest.mark.parametrize("grid", ["presets", "default_grid"])
def test_spec_json_and_hash_equal_jax(grid):
    if grid == "presets":
        pairs = list(zip(_presets(Jspec), _presets(Tspec)))
    else:
        pairs = list(zip(Jdse.default_grid(), dse.default_grid()))
        assert len(pairs) == 136
    for j, t in pairs:
        assert t.to_json() == j.to_json()
        assert t.to_yaml() == j.to_yaml()
        assert t.spec_hash() == j.spec_hash()
        assert t.group_key() == j.group_key()


@pytest.mark.parametrize("grid", ["presets", "default_grid"])
def test_lower_equal_jax(grid):
    if grid == "presets":
        pairs = list(zip(_presets(Jspec), _presets(Tspec)))
    else:
        pairs = list(zip(Jdse.default_grid(), dse.default_grid()))
    for j, t in pairs:
        (jt, jp), (tt, tp) = j.lower(), t.lower()
        _assert_topo_equal(jt, tt)
        assert dataclasses.asdict(tp) == {
            k: v for k, v in dataclasses.asdict(jp).items()
            if k not in convert.DROPPED_PARAMS}
        if t.workload is not None:
            jw, tw = j.build_workload(jt), t.build_workload(tt)
            for f in dataclasses.fields(tw):
                a, b = getattr(jw, f.name), getattr(tw, f.name)
                assert (a is None) == (b is None), f.name
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------
# run_dse: against sequential run_sweep, the JAX package's artifact, workers
# ----------------------------------------------------------------------
def _artifact(rows, grid="smoke"):
    rows = [{k: v for k, v in r.items() if k != "state"} for r in rows]
    return json.dumps(dse.frontier_artifact(rows, grid=grid), indent=1, sort_keys=True)


@pytest.fixture(scope="module")
def dse_smoke():
    specs = dse.default_grid(smoke=True)
    return specs, dse.run_dse(specs, workers=1, return_states=True, device="cpu")


@pytest.fixture(scope="module")
def jax_smoke_artifact():
    rows = Jdse.run_dse(Jdse.default_grid(smoke=True), workers=1)
    return json.dumps(Jdse.frontier_artifact(rows, grid="smoke"), indent=1,
                      sort_keys=True)


def test_run_dse_matches_sequential_run_sweep(dse_smoke):
    specs, results = dse_smoke
    assert len(results) == len(specs) >= 4
    for sp, res in zip(specs, results):
        topo, params = sp.lower()
        wl = sp.build_workload(topo)
        sim = TS.build_sim(topo, params, wl, device="cpu")
        st = TS.run_sweep(sim, [wl], res["n_cycles_run"])[0]
        a, b = convert.sim_state_to_numpy(st), convert.sim_state_to_numpy(res["state"])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_frontier_artifact_deterministic(dse_smoke):
    specs, results = dse_smoke
    rows = [{k: v for k, v in r.items() if k != "state"} for r in results]
    art1 = dse.frontier_artifact(rows, grid="smoke")
    art2 = dse.frontier_artifact(list(reversed(rows)), grid="smoke")
    assert json.dumps(art1, sort_keys=True) == json.dumps(art2, sort_keys=True)
    assert art1["schema"] == dse.SCHEMA
    assert art1["n_points"] == len(specs)
    hashes = [p["spec_hash"] for p in art1["points"]]
    assert hashes == sorted(hashes)
    assert set(art1["frontier"]) <= set(hashes) and art1["frontier"]
    assert all(r["delivered"] for r in rows)


def test_run_dse_artifact_equals_jax(dse_smoke, jax_smoke_artifact):
    assert _artifact(dse_smoke[1]) == jax_smoke_artifact
    # the committed copy the card's smoke run checks against is current
    assert SMOKE_JAX.read_text() == jax_smoke_artifact


def test_explorer_two_workers_writes_the_jax_artifact(tmp_path, dse_smoke, capsys):
    """``noc_explore --dse --smoke --device cpu --json`` over a pool of two
    spawn workers: the JAX package's file, byte for byte, and the same as
    one worker's artifact."""
    out = tmp_path / "x.json"
    explore(["--dse", "--smoke", "--device", "cpu", "--workers", "2",
             "--json", str(out)])
    assert "over 2 worker processes" in capsys.readouterr().out
    assert out.read_text() == SMOKE_JAX.read_text() == _artifact(dse_smoke[1])


def test_run_dse_requires_workload_binding():
    with pytest.raises(ValueError, match="workload binding"):
        dse.run_dse([preset("mesh")], device="cpu")


def test_run_dse_refuses_a_pool_on_a_card():
    with pytest.raises(ValueError, match="CPU only"):
        dse.run_dse(dse.default_grid(smoke=True), workers=2, device="cuda")
