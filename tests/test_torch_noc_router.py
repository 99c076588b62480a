"""Router datapath parity: the port's plain PyTorch router functions
(``repro_torch.kernels.noc_router.ref``) and its channel-batched entry point
(``ops.router_cycle``) against the JAX reference and its Pallas kernel.

Inputs are random *consistent* snapshots made with numpy from a seed:
counts within depth, stale dead slots, several heads routed to one output
(round-robin contention), locked and free wormholes, full output buffers,
destinations outside the table. Everything is integer, so the tolerance is
exact equality on every output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.noc import collective_traffic as jax_ct
from repro.core.noc.engine import make_tables as jax_make_tables
from repro.core.noc.topology import build_mesh as jax_build_mesh
from repro.core.noc.topology import build_torus as jax_build_torus
from repro.kernels.noc_router import ops as jops
from repro.kernels.noc_router import ref as jref
from repro_torch.kernels.noc_router import ops as tops
from repro_torch.kernels.noc_router import ref as tref
from test_torch_cuda_kernels import P, _offload, _snapshot, _tables

NF = jref.NF

# the state tensors are small: one intra-op thread is fastest, and keeps
# parallel test workers from oversubscribing the cores
torch.set_num_threads(1)


def _mesh_tables(n_vcs=1):
    """The 8x4 mesh's tables, or at ``n_vcs > 1`` the 8x4 torus's (whose
    dateline table is not all VC0)."""
    if n_vcs == 1:
        tb = jax_make_tables(jax_build_mesh(nx=4, ny=8))
    else:
        tb = jax_make_tables(jax_build_torus(nx=4, ny=8), n_vcs=n_vcs)
    return {k: np.array(getattr(tb, k)) for k in
            ("route", "link_src", "link_dst", "port_ep", "ep_attach",
             "vc_out") if getattr(tb, k) is not None}


def _eq(a, b, tag=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=tag)


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


CASES = [(R, d, seed) for R in (1, 32) for d in (2, 4) for seed in (0, 1)]


@pytest.mark.parametrize("R,depth,seed", CASES)
def test_fifo_functions_match_jax(R, depth, seed):
    rng = np.random.default_rng(seed)
    E = 3 if R == 1 else 40
    s = _snapshot(rng, (), R, E, depth, depth)
    pop = rng.random((R, P)) < 0.5
    push = rng.random((R, P)) < 0.5
    flit = rng.integers(-9, 9, (R, P, NF)).astype(np.int32)
    j, t = _both(dict(buf=s["in_buf"], cnt=s["in_cnt"], pop=pop, push=push,
                      flit=flit))
    for a, b in zip(jref.fifo_pop(j["buf"], j["cnt"], j["pop"]),
                    tref.fifo_pop(t["buf"], t["cnt"], t["pop"])):
        _eq(a, b, "fifo_pop")
    for a, b in zip(jref.fifo_push(j["buf"], j["cnt"], j["push"], j["flit"]),
                    tref.fifo_push(t["buf"], t["cnt"], t["push"], t["flit"])):
        _eq(a, b, "fifo_push")
    # fifo_update: live and dead slots alike (states compare leaf for leaf);
    # callers never push into a full FIFO, so mask such pushes as they do
    ok = (s["in_cnt"] - pop) < depth
    j["push"], t["push"] = jnp.asarray(push & ok), torch.as_tensor(push & ok)
    for a, b in zip(
            jref.fifo_update(j["buf"], j["cnt"], j["pop"], j["push"], j["flit"]),
            tref.fifo_update(t["buf"], t["cnt"], t["pop"], t["push"], t["flit"])):
        _eq(a, b, "fifo_update")
    _eq(jref.heads(j["buf"]), tref.heads(t["buf"]), "heads")
    _eq(jref.empty_flits((R, 2)), tref.empty_flits((R, 2)), "empty_flits")
    _eq(jref.pack_flit(j["flit"][..., 0], 1, 2, j["flit"][..., 3], 0, 5, 6),
        tref.pack_flit(t["flit"][..., 0], 1, 2, t["flit"][..., 3], 0, 5, 6),
        "pack_flit")


@pytest.mark.parametrize("R,depth,seed", [c for c in CASES if c[2] == 0])
def test_decision_functions_match_jax(R, depth, seed):
    """arb_decisions, link_inputs, sent_mask, apply_cycle (fused and
    unfused) and router_cycle_reference, single channel."""
    rng = np.random.default_rng(100 + seed)
    E = 3 if R == 1 else 40
    tb = _tables(rng, R, E)
    s = _snapshot(rng, (), R, E, depth, depth)
    (js, ts), (jt, tt) = _both(s), _both(tb)
    args = lambda d, t: (d["in_buf"], d["in_cnt"], d["out_cnt"], d["rr_ptr"],
                         d["wh_lock"], t["route"])
    ja = jref.arb_decisions(*args(js, jt), depth_out=depth)
    ta = tref.arb_decisions(*args(ts, tt), depth_out=depth)
    for name, a, b in zip(ja._fields, ja, ta):
        _eq(a, b, f"arb_decisions.{name}")
    if R > 1:  # the random snapshot exercises both outcomes
        assert ta.granted.any() and (~ta.granted).any()

    jup, jacc = jref.link_inputs(jref.heads(js["out_buf"]), js["out_cnt"] > 0,
                                 jt["link_src"], ja.in_space)
    tup, tacc = tref.link_inputs(tref.heads(ts["out_buf"]), ts["out_cnt"] > 0,
                                 tt["link_src"], ta.in_space)
    _eq(jup, tup, "link_inputs.up_head")
    _eq(jacc, tacc, "link_inputs.accept")
    jsent = jref.sent_mask(js["out_cnt"] > 0, jt["link_dst"], jt["port_ep"],
                           ja.in_space, js["ep_space"])
    tsent = tref.sent_mask(ts["out_cnt"] > 0, tt["link_dst"], tt["port_ep"],
                           ta.in_space, ts["ep_space"])
    _eq(jsent, tsent, "sent_mask")
    for fused in (False, True):
        for a, b in zip(
                jref.apply_cycle(js["in_buf"], js["in_cnt"], js["out_buf"],
                                 js["out_cnt"], ja.arb_pop, ja.granted,
                                 ja.chosen, jacc, jup, jsent, fused=fused),
                tref.apply_cycle(ts["in_buf"], ts["in_cnt"], ts["out_buf"],
                                 ts["out_cnt"], ta.arb_pop, ta.granted,
                                 ta.chosen, tacc, tup, tsent, fused=fused)):
            _eq(a, b, f"apply_cycle fused={fused}")
        cyc = lambda ref, d, t: ref.router_cycle_reference(
            d["in_buf"], d["in_cnt"], d["out_buf"], d["out_cnt"], d["rr_ptr"],
            d["wh_lock"], t["route"], t["link_src"], t["link_dst"],
            t["port_ep"], t["ep_attach"], d["ep_space"], fused=fused)
        for i, (a, b) in enumerate(zip(cyc(jref, js, jt), cyc(tref, ts, tt))):
            _eq(a, b, f"router_cycle_reference[{i}] fused={fused}")


@pytest.mark.parametrize("R,seed", [(1, 0), (32, 1)])
def test_inject_endpoints_matches_jax(R, seed):
    rng = np.random.default_rng(200 + seed)
    E = 3 if R == 1 else 40
    tb = _tables(rng, R, E)
    s = _snapshot(rng, (), R, E, 2, 2)
    flit = rng.integers(-9, 9, (E, NF)).astype(np.int32)
    want = rng.random(E) < 0.6
    er, ep_p = tb["ep_attach"][:, 0], tb["ep_attach"][:, 1]
    j = jref.inject_endpoints(jnp.asarray(s["in_buf"]), jnp.asarray(s["in_cnt"]),
                              jnp.asarray(er), jnp.asarray(ep_p),
                              jnp.asarray(tb["port_ep"]), jnp.asarray(flit),
                              jnp.asarray(want))
    t = tref.inject_endpoints(torch.as_tensor(s["in_buf"]),
                              torch.as_tensor(s["in_cnt"]), torch.as_tensor(er),
                              torch.as_tensor(ep_p),
                              torch.as_tensor(tb["port_ep"]),
                              torch.as_tensor(flit), torch.as_tensor(want))
    for i, (a, b) in enumerate(zip(j, t)):
        _eq(a, b, f"inject_endpoints[{i}]")


@pytest.mark.parametrize("depth,tile,V", [(2, 8, 1), (4, 0, 1), (2, 8, 2)],
                         ids=["2-8", "4-0", "2-8-vc2"])
def test_ops_router_cycle_matches_pallas_interpret(depth, tile, V):
    """The channel-batched entry point on a [3, 32, 5 * V, ...] batch built
    on the 8x4 mesh tables (the 8x4 torus's at V = 2), against the JAX
    Pallas kernel run in interpret mode (fused FIFO datapath; 8 routers per
    program, or the whole fabric; ``_arb_kernel_vc`` at V = 2) and the
    vmapped jnp reference."""
    rng = np.random.default_rng(7 + depth + V)
    tb = _mesh_tables(V)
    E = tb["route"].shape[1]
    s = _snapshot(rng, (3,), 32, E, depth, depth, V)
    (js, ts), (jt, tt) = _both(s), _both(tb)
    args = lambda d, t: (d["in_buf"], d["in_cnt"], d["out_buf"], d["out_cnt"],
                         d["rr_ptr"], d["wh_lock"], t["route"], t["link_src"],
                         t["link_dst"], t["port_ep"], t["ep_attach"],
                         d["ep_space"])
    vc = lambda t: dict(vc_out=t.get("vc_out"), n_vcs=V)
    want_pallas = jops.router_cycle(*args(js, jt), backend="pallas",
                                    interpret=True, fused_fifo=True,
                                    router_tile=tile, **vc(jt))
    want_jnp = jops.router_cycle(*args(js, jt), backend="jnp", fused_fifo=True,
                                 **vc(jt))
    got = tops.router_cycle(*args(ts, tt), **vc(tt))
    for i, (a, c, b) in enumerate(zip(want_pallas, want_jnp, got)):
        _eq(a, b, f"router_cycle[{i}] vs pallas")
        _eq(c, b, f"router_cycle[{i}] vs jnp")


@pytest.mark.parametrize("V,offload", [(1, False), (2, False), (1, True), (2, True)],
                         ids=["v1", "v2", "offload-v1", "offload-v2"])
def test_ops_router_cycle_unfused_matches_pallas_interpret(V, offload):
    """``ops.router_cycle(fused_fifo=False)``, the naive step's two-step
    FIFO pop then push, on a [3, R, 5 * V, ...] batch at depth 2: the 8x4
    mesh's tables (the 8x4 torus's at V = 2), or with ``offload`` the 3x3
    mesh / torus with an in-fabric all-reduce's groups and random ALU
    state, against the JAX Pallas kernel's unfused mode in interpret mode
    (``_apply_kernel`` compiled with ``fused=False``) and the vmapped jnp
    reference, dead slots included. The unfused result differs from the
    fused one on this snapshot, so the mode is really taken."""
    rng = np.random.default_rng(31 + V + 10 * offload)
    if offload:
        jtopo = jax_build_torus(3, 3) if V > 1 else jax_build_mesh(3, 3, hbm_west=False)
        groups = jax_ct.all_reduce(jtopo, data_kb=1, streams=2,
                                   algo="infabric").meta["groups"]
        jt = jax_make_tables(jtopo, n_vcs=V, groups=groups)
        tb = {k: np.array(getattr(jt, k)) for k in
              ("route", "link_src", "link_dst", "port_ep", "ep_attach", "vc_out",
               "fork_out", "red_parent", "red_need") if getattr(jt, k) is not None}
        R, E = jtopo.n_routers, jtopo.n_endpoints
        s = _snapshot(rng, (3,), R, E, 2, 2, V)
        s.update(_offload(rng, s, R, E, len(groups), V)[1])
    else:
        tb = _mesh_tables(V)
        R, E = 32, tb["route"].shape[1]
        s = _snapshot(rng, (3,), R, E, 2, 2, V)
    (js, ts), (jt_, tt) = _both(s), _both(tb)

    def call(fn, d, t, **kw):
        off = {}
        if offload:
            off = dict(fork_out=t["fork_out"], red_parent=t["red_parent"],
                       red_need=t["red_need"], red_acc=d["red_acc"],
                       red_got=d["red_got"], n_endpoints=E)
        return fn(d["in_buf"], d["in_cnt"], d["out_buf"], d["out_cnt"], d["rr_ptr"],
                  d["wh_lock"], t["route"], t["link_src"], t["link_dst"],
                  t["port_ep"], t["ep_attach"], d["ep_space"],
                  vc_out=t.get("vc_out"), n_vcs=V, **off, **kw)

    want_pallas = call(jops.router_cycle, js, jt_, backend="pallas", interpret=True,
                       fused_fifo=False, router_tile=8)
    want_jnp = call(jops.router_cycle, js, jt_, backend="jnp", fused_fifo=False)
    got = call(tops.router_cycle, ts, tt, fused_fifo=False)
    assert len(got) == (10 if offload else 8)
    for i, (a, c, b) in enumerate(zip(want_pallas, want_jnp, got)):
        _eq(a, b, f"router_cycle[{i}] vs pallas")
        _eq(c, b, f"router_cycle[{i}] vs jnp")
    fused = call(tops.router_cycle, ts, tt)
    assert any(not torch.equal(a, b) for a, b in zip(fused[:4], got[:4]))


def test_ops_router_cycle_rejects_other_devices():
    meta = torch.empty((1, 1, P, 2, NF), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tops.router_cycle(meta, *([None] * 11))
