"""The port's analytical PPA models (``repro_torch.core.noc.analytical``)
against the JAX package's: every public constant, table and function equal
(``fabric_area_mm2`` on each package's own mesh, torus and Occamy), and
``tests/test_analytical.py``'s paper targets asserted on the port. The
models are pure Python arithmetic in the same order, so the tolerance is
exact equality."""
import dataclasses
import inspect
import types

import pytest

import test_analytical
from repro.core.noc import analytical as JA
from repro.core.noc import topology as JTOP
from repro.core.noc.params import NocParams as JParams
from repro_torch.core.noc import analytical as TA
from repro_torch.core.noc import topology as TTOP
from repro_torch.core.noc.params import NocParams as TParams


def _public(mod):
    return {n for n in vars(mod) if not n.startswith("_") and n not in (
        "annotations", "dataclass")}


def test_same_public_names():
    assert _public(TA) == _public(JA)


@pytest.mark.parametrize("name", sorted(n for n in _public(JA) if n.isupper()))
def test_constants_and_tables_equal(name):
    assert getattr(TA, name) == getattr(JA, name)
    assert type(getattr(TA, name)) is type(getattr(JA, name))


# (function, argument tuples); every public function of the module but
# fabric_area_mm2, which has its own test
CALLS = {
    "header_bits": [()],
    "link_widths": [()],
    "peak_link_bandwidth_gbps": [(), (1.0,), (1.26, 256)],
    "tile_to_tile_bandwidth_gbps": [(), (0.9,)],
    "aggregate_bandwidth_tbps": [(), (8, 8), (3, 8, 1.1)],
    "ni_area_kge": [(), ("rob",), ("robless",)],
    "tile_ordering_area_kge": [(o, c) for o in ("rob", "robless") for c in (1, 2, 3, 4)],
    "rob_savings_kge": [()],
    "floonoc_system": [(), (3, 8), (2, 2)],
    "occamy_system": [()],
    "gflops_dp": [(24, 1.14), (32, 1.26), (8, 1.0, 4, 4)],
    "energy_per_byte_per_hop_pj": [(), (0.4,), (0.9,)],
    "transfer_energy_pj": [(4096, 1), (1024, 3, 0.6)],
    "router_energy_4kb_neighbor_pj": [()],
    "router_area_mm2": [(), (9, 4, 2), (2, 3, 1)],
    "noc_pj_per_byte": [(3.5,), (2.0, 2), (1.0, 4, 0.7)],
}


def test_every_function_is_called():
    funcs = {n for n in _public(JA) if inspect.isfunction(getattr(JA, n))}
    assert funcs == set(CALLS) | {"fabric_area_mm2"}


def _plain(v):
    return dataclasses.asdict(v) | {"die_mm2": v.die_mm2} if dataclasses.is_dataclass(v) else v


@pytest.mark.parametrize("name", sorted(CALLS))
def test_functions_equal(name):
    for args in CALLS[name]:
        want, got = getattr(JA, name)(*args), getattr(TA, name)(*args)
        assert _plain(got) == _plain(want), (name, args)
        assert type(got).__name__ == type(want).__name__


FABRICS = [("build_mesh", {}), ("build_mesh", {"nx": 2, "ny": 2, "hbm_west": False}),
           ("build_torus", {}), ("build_torus", {"nx": 8, "ny": 4}),
           ("build_occamy", {}),
           ("build_occamy", {"n_groups": 6, "clusters_per_group": 4, "n_hbm": 8, "spill": 4})]
PARAMS = [{}, {"n_channels": 4}, {"n_vcs": 2}, {"ni_order": "rob"}]


@pytest.mark.parametrize("builder,kw", FABRICS,
                         ids=[f"{b}{i}" for i, (b, _) in enumerate(FABRICS)])
def test_fabric_area_equal(builder, kw):
    jtopo, ttopo = getattr(JTOP, builder)(**kw), getattr(TTOP, builder)(**kw)
    for p in PARAMS:
        want = JA.fabric_area_mm2(jtopo, JParams(**p))
        assert TA.fabric_area_mm2(ttopo, TParams(**p)) == want, p
        assert want > 0


PAPER_TESTS = sorted(n for n in vars(test_analytical) if n.startswith("test_"))


@pytest.mark.parametrize("name", PAPER_TESTS)
def test_paper_targets_hold_on_the_port(name):
    """Each ``tests/test_analytical.py`` test, run with its ``A`` bound to
    the port's module."""
    fn = getattr(test_analytical, name)
    types.FunctionType(fn.__code__, {**fn.__globals__, "A": TA}, name)()
