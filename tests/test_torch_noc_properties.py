"""Property-based differential harness on the port, mirroring
``tests/test_noc_properties.py`` (``_random_workload``, ``_expected_rx``,
``_counter_bounds_ok``, ``_run_case``).

Random small fabrics run random multi-stream DMA-write workloads (no gates,
so deadlock-free by construction). The draw is wider than the JAX
harness's: mesh, torus (``n_vcs=2``: random pairs need the dateline) and
stitched multi-die fabrics, 2x2-4x3 tiles, 3-5 channels, 1-3 streams,
``n_vcs`` 1-2 and ``fused_cycles`` 1 or 4. On every sample, on the port's
own state:

* **flit conservation / exactly-once** — after the horizon every
  (endpoint, stream) received exactly the beats and bursts the workload
  sent it, and every issued burst retired (``d_done == dma_txns``);
* **no queue overwrite** — every FIFO / queue counter inside its capacity,
  at the mid-point and at the end;
* **monotone accounting** — delivered-beat, burst and retire counters never
  decrease from the mid-point to the end;
* **differential** — the port's state equal to the JAX package's fast path
  leaf for leaf, dead slots included, with every ``stats`` entry, at the
  mid-point and at the end;
* **fast vs naive** — the JAX harness's leg: on the draws that step per
  cycle (``fused_cycles`` 1; the naive step has no super-steps) the port's
  naive step run to the same end reaches the fast state under
  ``canonical_state(scrub=True)``, and conserves.

A sweep leg runs shape-compatible random workloads on one fabric through
the port's ``run_sweep`` against the JAX package's, each configuration
equal and conserving (and, stepping per cycle, equal to the naive sweep
under ``canonical_state(scrub=True)``). The draw is a seeded numpy sweep
(12 cases, about 2.5 min serial). Integer state: exact equality.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.noc.params import NocParams as JParams
from repro_torch import convert
from repro_torch.core.noc import sim as TS
from test_torch_noc_naive import assert_fast_equals_naive
from test_torch_noc_sim import assert_states_equal, jax_state_dict
from torch_mirror import JAX, PORT, assert_same, build_both

torch.set_num_threads(1)


# ----------------------------------------------------------------------
# generators
# ----------------------------------------------------------------------
def _random_arrays(topo, streams, rng):
    """Random multi-stream DMA-write programme: every tile issues 0..2
    bursts of 1..4 beats per stream to distinct random tiles."""
    E = topo.n_endpoints
    nt = topo.meta["n_tiles"]
    K = 2
    dst = np.full((E, streams, K), -1, np.int32)
    bts = np.zeros((E, streams, K), np.int32)
    txns = np.zeros((E, streams), np.int32)
    for e in range(nt):
        for s in range(streams):
            txns[e, s] = int(rng.integers(0, 3))
            for k in range(K):
                d = int(rng.integers(0, nt - 1))
                dst[e, s, k] = d + (d >= e)  # anything but self
                bts[e, s, k] = int(rng.integers(1, 5))
    return dst, bts, txns


def _random_workload(epm, topo, arrays):
    """The programme as a Workload of one package (``epm``)."""
    dst, bts, txns = arrays
    wl = epm.idle_workload(topo.n_endpoints, topo.meta["n_tiles"],
                           streams=dst.shape[1])
    return dataclasses.replace(
        wl, dma_dst_seq=dst, dma_gate=np.zeros_like(dst), dma_beats_seq=bts,
        dma_txns=txns, dma_write=True)


def _expected_rx(wl):
    """Replay the workload: expected (beats, bursts) per (endpoint, stream)."""
    E, streams, K = wl.dma_dst_seq.shape
    beats = np.zeros((E, streams), np.int64)
    bursts = np.zeros((E, streams), np.int64)
    for e in range(E):
        for s in range(streams):
            for t in range(int(wl.dma_txns[e, s])):
                k = t % K
                d = int(wl.dma_dst_seq[e, s, k])
                beats[d, s] += int(wl.dma_beats_seq[e, s, k])
                bursts[d, s] += 1
    return beats, bursts


def _counter_bounds_ok(params, st):
    """Every queue counter within [0, capacity]: an overwrite or a lost
    credit would push one outside."""
    for arr, cap in ((st.fabric.in_cnt, params.depth_in),
                     (st.fabric.out_cnt, params.depth_out),
                     (st.eps.eg_cnt, params.egress_depth),
                     (st.eps.mq_cnt, params.memq_depth)):
        a = arr.numpy()
        assert a.min() >= 0 and a.max() <= cap, (a.min(), a.max(), cap)


def _conserved(st, wl):
    beats, bursts = _expected_rx(wl)
    np.testing.assert_array_equal(st.eps.beats_rcvd.numpy(), beats.sum(axis=1))
    np.testing.assert_array_equal(st.eps.rx_bursts.numpy(), bursts)
    np.testing.assert_array_equal(st.eps.d_done.numpy(), wl.dma_txns)


def _fabric(top, kind, nx, ny):
    if kind == "torus":
        return top.build_torus(nx, ny)
    if kind == "multi_die":
        return top.build_multi_die(n_dies=2, nx=nx, ny=ny, d2d=2)
    return top.build_mesh(nx, ny, hbm_west=False)


def _draw(i):
    """Case ``i`` of the seeded draw: fabric, channels, streams, VCs,
    super-step length and the workload's seed."""
    rng = np.random.default_rng(4000 + i)
    kind = ("mesh", "torus", "multi_die")[i % 3]
    nx = int(rng.integers(2, 5)) if kind != "multi_die" else int(rng.integers(1, 3))
    return dict(kind=kind, nx=nx, ny=int(rng.integers(2, 4)),
                n_channels=int(rng.integers(3, 6)), streams=int(rng.integers(1, 4)),
                n_vcs=2 if kind == "torus" else int(rng.integers(1, 3)),
                fused_cycles=(1, 4)[int(rng.integers(0, 2))],
                seed=int(rng.integers(0, 2**16)))


def _round_up(n, k):
    return -(-n // k) * k


# ----------------------------------------------------------------------
# the single-configuration profile
# ----------------------------------------------------------------------
@pytest.mark.parametrize("i", range(10))
def test_fabric_invariants_random(i):
    c = _draw(i)
    rng = np.random.default_rng(c["seed"])
    topo = _fabric(PORT.top, c["kind"], c["nx"], c["ny"])
    arrays = _random_arrays(topo, c["streams"], rng)
    make = lambda pkg: (_fabric(pkg.top, c["kind"], c["nx"], c["ny"]),
                        _random_workload(pkg.epm, topo, arrays))
    kw = dict(n_channels=c["n_channels"], n_vcs=c["n_vcs"],
              fused_cycles=c["fused_cycles"])
    sims = build_both(make, **kw)
    wl = sims[1].wl
    k = c["fused_cycles"]
    t_end = _round_up(400 + 8 * int(_expected_rx(wl)[0].sum()), 2 * k)
    t_mid = t_end // 2

    jmid = JAX.S.run(sims[0], t_mid)
    mid = TS.run(sims[1], t_mid)
    assert_same(sims, (jmid, mid), f"{c} mid")
    _counter_bounds_ok(sims[1].params, mid)
    counts = {f: getattr(mid.eps, f).clone()
              for f in ("beats_rcvd", "rx_bursts", "d_done")}
    jst = JAX.S.run(sims[0], t_end - t_mid, jmid)
    st = TS.run(sims[1], t_end - t_mid, mid)
    assert_same(sims, (jst, st), f"{c} end")
    _counter_bounds_ok(sims[1].params, st)
    for f, before in counts.items():
        assert (getattr(st.eps, f) >= before).all(), f
    _conserved(st, wl)
    if k == 1:  # the fast-vs-naive leg (scrubbed: stale scratch can't hide)
        simn = TS.build_sim(sims[1].topo,
                            dataclasses.replace(sims[1].params, step_impl="naive"),
                            wl, device="cpu")
        stn = TS.run(simn, t_end)
        assert_fast_equals_naive((sims[1], st), (simn, stn), f"{c} fast/naive")
        _conserved(stn, wl)


# ----------------------------------------------------------------------
# the sweep leg: random workloads of one fabric as one batched state
# ----------------------------------------------------------------------
@pytest.mark.parametrize("i", range(2))
def test_fabric_invariants_random_sweep(i):
    c = _draw(100 + i)
    rng = np.random.default_rng(c["seed"])
    topo = _fabric(PORT.top, c["kind"], c["nx"], c["ny"])
    jtopo = _fabric(JAX.top, c["kind"], c["nx"], c["ny"])
    programmes = [_random_arrays(topo, c["streams"], rng) for _ in range(3)]
    wls = [_random_workload(PORT.epm, topo, a) for a in programmes]
    jwls = [_random_workload(JAX.epm, jtopo, a) for a in programmes]
    jp = JParams(n_channels=c["n_channels"], n_vcs=c["n_vcs"],
                 fused_cycles=c["fused_cycles"])
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    n = 400 + 8 * max(int(_expected_rx(w)[0].sum()) for w in wls)
    want = JAX.S.run_sweep(JAX.S.build_sim(jtopo, jp, jwls[0]), jwls, n)
    got = TS.run_sweep(TS.build_sim(topo, tp, wls[0], device="cpu"), wls, n)
    naive = None
    if tp.fused_cycles == 1:  # the sweep steps per cycle: the naive leg
        tn = dataclasses.replace(tp, step_impl="naive")
        naive = TS.run_sweep(TS.build_sim(topo, tn, wls[0], device="cpu"), wls, n)
    for b, (wl, jst, st) in enumerate(zip(wls, want, got)):
        assert_states_equal(jax_state_dict(jst), convert.sim_state_to_numpy(st),
                            f"{c} config {b}")
        _counter_bounds_ok(tp, st)
        _conserved(st, wl)
        if naive is not None:
            sim_b = TS.build_sim(topo, tp, wl, device="cpu")
            assert_fast_equals_naive((sim_b, st), (sim_b, naive[b]), f"{c} config {b}")
