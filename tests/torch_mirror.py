"""Helpers of the port-against-JAX simulator mirrors
(``tests/test_torch_noc_*.py``): one configuration built in both
packages, each from its own modules, the port on the CPU; after a run the
port's SimState equal to JAX's leaf for leaf (dead slots included) and
every ``stats`` entry equal. The state is integer, or float32 accumulated
in the reference's order, so equality is exact."""
import dataclasses
from types import SimpleNamespace

import numpy as np

from repro.core.noc import collective_traffic as JCT
from repro.core.noc import endpoints as Jepm
from repro.core.noc import sim as JS
from repro.core.noc import topology as JTOP
from repro.core.noc import traffic as JT
from repro.core.noc.params import NocParams as JParams
from repro_torch import convert
from repro_torch.core.noc import collective_traffic as TCT
from repro_torch.core.noc import endpoints as Tepm
from repro_torch.core.noc import sim as TS
from repro_torch.core.noc import topology as TTOP
from repro_torch.core.noc import traffic as TT
from test_torch_noc_sim import assert_states_equal, jax_state_dict

# each package's own modules, for workload builders that take either
JAX = SimpleNamespace(S=JS, T=JT, epm=Jepm, top=JTOP, CT=JCT)
PORT = SimpleNamespace(S=TS, T=TT, epm=Tepm, top=TTOP, CT=TCT)


def build_both(make, **params_kw):
    """``make(pkg) -> (topo, workload)`` run for each package; returns the
    JAX and the port (CPU) ``Sim`` of that configuration."""
    jtopo, jwl = make(JAX)
    ttopo, twl = make(PORT)
    jp = JParams(**params_kw)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    return JS.build_sim(jtopo, jp, jwl), TS.build_sim(ttopo, tp, twl, device="cpu")


def assert_same(sims, states, tag=""):
    """Port state equal to JAX's leaf for leaf, and every stats entry
    equal; returns the port's stats."""
    (jsim, tsim), (jst, tst) = sims, states
    assert_states_equal(jax_state_dict(jst), convert.sim_state_to_numpy(tst), tag)
    jout, tout = JS.stats(jsim, jst), TS.stats(tsim, tst)
    assert set(jout) == set(tout), tag
    for k in jout:
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k], err_msg=f"{tag} {k}")
    return tout


def run_both(sims, cycles, states=(None, None), tag=""):
    """Run both sims ``cycles`` cycles (from ``states``), check them equal;
    returns ``(jax_state, port_state, port_stats)``. A JAX state passed in
    is consumed by its run."""
    jst = JS.run(sims[0], cycles, states[0])
    tst = TS.run(sims[1], cycles, states[1])
    return jst, tst, assert_same(sims, (jst, tst), tag)
