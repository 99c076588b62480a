"""Fabric-engine parity: the port's ``make_tables`` and its ``fabric_cycle``
+ ``inject`` against the JAX engine (fused FIFO datapath, scatter
injection), over replayed random injections made with numpy from a seed.
All state is integer, so every leaf must be exactly equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import engine as jeng
from repro.core.noc.topology import build_mesh as jax_build_mesh
from repro_torch import convert
from repro_torch.core.noc import engine as teng
from repro_torch.core.noc.topology import build_mesh as torch_build_mesh

TABLES = ("route", "link_src", "link_dst", "port_ep", "ep_attach")

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("nx,ny", [(4, 2), (4, 8)])
def test_make_tables_match_jax(nx, ny):
    jt = jeng.make_tables(jax_build_mesh(nx=nx, ny=ny))
    tt = teng.make_tables(torch_build_mesh(nx=nx, ny=ny), device="cpu")
    for name in TABLES:
        got = getattr(tt, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(getattr(jt, name)),
                                      got.numpy(), err_msg=name)


def test_tables_travel_as_numpy_dicts():
    """``convert`` carries JAX tables over to the port and back."""
    jt = jeng.make_tables(jax_build_mesh(nx=4, ny=2))
    arrays = {name: np.asarray(getattr(jt, name)) for name in TABLES}
    tt = convert.tables_from_numpy(arrays, "cpu")
    own = teng.make_tables(torch_build_mesh(nx=4, ny=2), device="cpu")
    for name in TABLES:
        assert torch.equal(getattr(tt, name), getattr(own, name)), name
    back = convert.tables_to_numpy(tt)
    for name in TABLES:
        np.testing.assert_array_equal(back[name], arrays[name], err_msg=name)


def test_make_tables_refuses_unported_options():
    """VC tables are built (slot-level endpoint tables, physical links,
    all-VC0 dateline table on the mesh); collective groups build the
    offload trees, and without groups there are none."""
    topo = torch_build_mesh(nx=4, ny=2)
    tb = teng.make_tables(topo, n_vcs=2, device="cpu")
    R, P = topo.n_routers, topo.n_ports
    assert tb.n_vcs == 2 and tuple(tb.vc_out.shape) == (R, 2 * P, P)
    assert tuple(tb.link_src.shape) == (R, P, 2)
    assert tuple(tb.port_ep.shape) == (R, 2 * P)
    assert (tb.port_ep[:, 1::2] == -1).all()  # endpoints attach at VC0
    assert (tb.ep_attach[:, 1] % 2 == 0).all()
    assert not tb.vc_out.any()  # a mesh has no dateline: all VC0
    plain = teng.make_tables(topo, device="cpu")
    assert plain.vc_out is None and plain.fork_out is None
    assert plain.n_groups == 0
    tb = teng.make_tables(topo, groups=[{"root": 0, "members": [1]}],
                          device="cpu")
    assert tb.n_groups == 1 and tb.fork_out.dtype == torch.bool
    assert tuple(tb.fork_out.shape) == (R, 1, P)
    # one fork slot per router on the route 0 -> 1, ejection included
    assert int(tb.fork_out.sum()) == topo.hops(0, 1)
    assert not (tb.red_need > 0).any()  # a multicast-only group


def _assert_fabric_equal(jst, tst, tag):
    for f in dataclasses.fields(tst):
        if getattr(tst, f.name) is None:  # no offload: no ALU state
            assert getattr(jst, f.name) is None, f"{tag}: {f.name}"
            continue
        np.testing.assert_array_equal(np.asarray(getattr(jst, f.name)),
                                      getattr(tst, f.name).numpy(),
                                      err_msg=f"{tag}: {f.name}")


def test_fabric_cycle_and_inject_match_jax_300_cycles():
    """300 cycles on the 4x2 mesh, 3 channels: per cycle a random endpoint
    ingress-space mask, then a random injection (multi-flit packets to
    random tiles, so wormholes lock and release). Deliveries, acceptances
    and the whole fabric state agree every cycle."""
    rng = np.random.default_rng(0)
    C, n = 3, 300
    jtopo, ttopo = jax_build_mesh(nx=4, ny=2), torch_build_mesh(nx=4, ny=2)
    E, nt = jtopo.n_endpoints, jtopo.meta["n_tiles"]
    jtb = jeng.make_tables(jtopo)
    ttb = teng.make_tables(ttopo, device="cpu")
    jst = jeng.init_fabric(jtopo, 2, 2, C)
    tst = teng.init_fabric(ttopo, 2, 2, C, device="cpu")

    @jax.jit
    def jcycle(st, space, flit, want):
        st, ep_flit, ep_valid = jeng.fabric_cycle(st, jtb, space,
                                                  fused_fifo=True)
        st, acc = jeng.inject(st, jtb, flit, want, scatter=True)
        return st, ep_flit, ep_valid, acc

    delivered = 0
    dst = rng.integers(0, nt, (C, E))  # a packet keeps its dst to its tail
    for cyc in range(n):
        space = rng.random((C, E)) < 0.8
        flit = rng.integers(0, 1000, (C, E, jeng.NF)).astype(np.int32)
        flit[..., jeng.F_DST] = dst
        flit[..., jeng.F_LAST] = rng.random((C, E)) < 0.5
        want = rng.random((C, E)) < 0.3
        jst, jf, jv, jacc = jcycle(jst, jnp.asarray(space), jnp.asarray(flit),
                                   jnp.asarray(want))
        tst, tf, tv = teng.fabric_cycle(tst, ttb, torch.as_tensor(space))
        tst, tacc = teng.inject(tst, ttb, torch.as_tensor(flit),
                                torch.as_tensor(want))
        tag = f"cycle {cyc}"
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy(), err_msg=tag)
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy(), err_msg=tag)
        np.testing.assert_array_equal(np.asarray(jacc), tacc.numpy(),
                                      err_msg=tag)
        _assert_fabric_equal(jst, tst, tag)
        delivered += int(tv.sum())
        done = tacc.numpy() & (flit[..., jeng.F_LAST] > 0)
        dst = np.where(done, rng.integers(0, nt, (C, E)), dst)
    assert delivered > 300, delivered  # the replay moved real traffic
