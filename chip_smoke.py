#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the FlooNoC simulator on one GPU.

    python3 chip_smoke.py

Builds the router-cycle CUDA kernels from ``src/repro_torch`` (``nvcc`` for
``sm_90a``), holds each kernel against its plain PyTorch version on the
card, drives the simulator's main path through the port's entry points
(``build_sim`` / ``run`` / ``stats``) and checks what comes out:

1. the card (``nvidia-smi``) and the kernels' build time;
2. the arb and apply kernels bit-identical to the plain version on random
   consistent snapshots at 8x4 (R=32) and 32x32 (R=1024), depths 2 and 4;
   the same at ``n_vcs=2`` on the 8x4 and 32x32 tori and Occamy (28
   slots); the fused window (N = 1, 4, 16; V = 1, 2) against N plain
   cycles with random circular egress queues;
3. the paper's 8x4 compute mesh: the GPU state after 1200 cycles equal,
   leaf for leaf, to the same run on the CPU; Fig. 7 (22 / 26 / 58
   cycles); the golden stat pins of the 4x2 mesh;
4. the 32x32 scaling point (uniform 8 kB x 4 DMA reads, 200 cycles): GPU
   state equal to CPU state, ms per simulated cycle, kernel and plain
   times, peak device memory;
   at both sizes also the router cycle's and the endpoint phases' share of
   a step, and the device's busy share under ``torch.profiler``;
5. super-steps: the 8x4 mesh at ``fused_cycles=4`` (GPU state equal to
   CPU state, one fused launch per 4 cycles, ms per cycle beside k = 1);
6. the 8x4 torus at ``n_vcs=2``, one cycle per step and at
   ``fused_cycles=4``: GPU state equal to CPU state, ms per cycle, the VC
   arb/apply kernels timed on the per-cycle run's state;
7. the 8x1 ring: wedged at ``n_vcs=1`` (nothing delivered in 4000
   cycles), drained at ``n_vcs=2`` with the GPU state equal to CPU state;
8. the 32x32 torus at ``n_vcs=2``, one cycle per step and at
   ``fused_cycles=4`` (200 cycles each): GPU state equal to CPU state, ms
   per cycle, peak device memory; VC and fused kernel times against their
   plain versions and bounds;
9. one JSON line listing every kernel and mode (launches on its main path,
   mismatch, times, bounds).

Each main path runs with the launch counts set to 0 just before it and
checked just after.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero; it exits non-zero without a CUDA device too.
Needs one card and the CUDA toolkit; imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the float32 rate outside
# the tensor cores, used as the ceiling for 32-bit scalar integer operations
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# stats() of the 4x2 mesh mixed uniform run, 1200 cycles (the JAX package's
# golden pins in tests/test_noc_channels.py)
GOLDEN = {
    "beats_rcvd": [64, 64, 64, 64, 64, 64, 64, 64, 0, 0],
    "dma_done": [4, 4, 4, 4, 4, 4, 4, 4, 0, 0],
    "narrow_lat_cnt": [58, 59, 59, 58, 58, 59, 59, 58],
    "narrow_lat_sum": [1574.0, 1498.0, 1500.0, 1529.0, 1600.0, 1496.0,
                       1513.0, 1625.0, 0.0, 0.0],
    "n_sent": [60, 60, 60, 60, 60, 60, 60, 60, 0, 0],
    "ni_stalls": [118, 73, 93, 99, 143, 120, 81, 181, 0, 0],
    "last_rx": [164, 128, 192, 143, 179, 164, 170, 202, 0, 0],
    "first_rx": [40, 18, 26, 22, 44, 22, 22, 40, -1, -1],
}


def check(cond, what):
    """Fail the run (non-zero exit) unless ``cond`` holds."""
    if not cond:
        raise AssertionError(what)


def phase(name, **fields):
    """One line of the phase's results."""
    print(f"[{name}] " + json.dumps(fields, default=float), flush=True)


# ---------------------------------------------------------------------------
# inputs


def random_snapshot(rng, tables, C, depth):
    """Random consistent channel-batched state on the given tables: counts
    within depth, stale dead slots, locked and free wormholes, full
    buffers, destinations past the table."""
    import numpy as np

    from repro_torch.kernels.noc_router.ref import F_DST, F_LAST, NF

    R, E = tables.route.shape
    P = tables.port_ep.shape[1]
    s = (C, R, P)

    def flits():
        f = rng.integers(-50, 50, s + (depth, NF)).astype(np.int32)
        f[..., F_DST] = rng.integers(-2, E + 2, s + (depth,))
        f[..., F_LAST] = rng.integers(0, 2, s + (depth,))
        return f

    wh = rng.integers(-1, P, s).astype(np.int32)
    wh[rng.random(s) < 0.5] = -1
    return dict(in_buf=flits(), in_cnt=rng.integers(0, depth + 1, s),
                out_buf=flits(), out_cnt=rng.integers(0, depth + 1, s),
                rr_ptr=rng.integers(0, P, s), wh_lock=wh,
                ep_space=rng.random((C, E)) < 0.7)


def to_device(d, dev):
    import numpy as np
    import torch

    return {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.int32),
                               device=dev) for k, v in d.items()}


def mesh_workload(TT, topo, transfer_kb, narrow_rate):
    """Uniform DMA reads plus uniform narrow requests on every tile."""
    import numpy as np

    wl = TT.dma_workload(topo, "uniform", transfer_kb=transfer_kb, n_txns=4)
    if narrow_rate:
        E, nt = topo.n_endpoints, topo.meta["n_tiles"]
        nr = np.zeros((E,), np.float32)
        nr[:nt] = narrow_rate
        nd = np.full((E,), -1, np.int32)
        nd[:nt] = -2
        wl = dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
    return wl


# ---------------------------------------------------------------------------
# the kernels against their plain version


def max_abs_err(want, got):
    """Largest |difference| over matching tensors (0 when bit-identical)."""
    err = 0
    for a, b in zip(want, got):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def compare_kernels(snap, tables):
    """Each kernel and the whole cycle against the plain version, on the
    card, in the tables' VC mode: ``{"arb": err, "apply": err, "cycle":
    err}``."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    s, t = snap, tables
    vc = dict(vc_out=t.vc_out, n_vcs=t.n_vcs)
    depth_out = s["out_buf"].shape[-2]
    arb_args = (s["in_buf"], s["in_cnt"], s["out_cnt"], s["rr_ptr"],
                s["wh_lock"], t.route)
    arb_k = K.arb_cuda(*arb_args, depth_out=depth_out, **vc)
    arb_p = ref.arb_decisions(*arb_args, depth_out=depth_out, **vc)
    app_args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"])
    tab = (t.link_src, t.link_dst, t.port_ep, s["ep_space"])
    app_k = K.apply_cuda(*app_args, arb_p, *tab, n_vcs=t.n_vcs)
    app_p = ref.apply_phase(*app_args, arb_p, *tab, fused=True, n_vcs=t.n_vcs)
    cyc_args = (*app_args, s["rr_ptr"], s["wh_lock"], t.route, t.link_src,
                t.link_dst, t.port_ep, t.ep_attach, s["ep_space"])
    cyc_k = K.router_cycle_cuda(*cyc_args, **vc)
    cyc_p = ref.router_cycle_reference(*cyc_args, fused=True, **vc)
    torch.cuda.synchronize()
    return {"arb": max_abs_err(arb_p, arb_k),
            "apply": max_abs_err(app_p, app_k),
            "cycle": max_abs_err(cyc_p, cyc_k)}


def random_egress(rng, C, E, Q, cycle0, N):
    """Random circular egress queues: counts 0..Q (empty and full), heads
    anywhere, ready stamps before, inside and after the window."""
    import numpy as np

    from repro_torch.kernels.noc_router.ref import F_DST, NF

    eg = rng.integers(-50, 50, (C, E, Q, NF)).astype(np.int32)
    eg[..., F_DST] = rng.integers(0, E, (C, E, Q))
    return dict(eg=eg,
                eg_ready=rng.integers(cycle0 - 3, cycle0 + N + 3, (C, E, Q)),
                eg_head=rng.integers(0, Q, (C, E)),
                eg_cnt=rng.integers(0, Q + 1, (C, E)))


STATE = ("in_buf", "in_cnt", "out_buf", "out_cnt", "rr_ptr", "wh_lock")
EGRESS = ("eg", "eg_ready", "eg_head", "eg_cnt")


def fused_args(state, egress, tables, ep_space, cycle0, N):
    """Positional arguments of ``router_cycles_fused_cuda`` and the plain
    ``router_cycles_scan``."""
    t = tables
    return (*(state[k] for k in STATE), *(egress[k] for k in EGRESS),
            t.route, t.link_src, t.link_dst, t.port_ep, t.ep_attach, ep_space,
            cycle0, N)


def compare_fused(snap, egress, tables, cycle0, N):
    """One launch of the fused kernel against N plain cycles on the card;
    also checks that the kernel leaves its inputs as they were."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    args = fused_args(snap, egress, tables, snap["ep_space"], cycle0, N)
    vc = dict(vc_out=tables.vc_out, n_vcs=tables.n_vcs)
    before = [a.clone() for a in args[:10]]
    got = K.router_cycles_fused_cuda(*args, **vc)
    want = ref.router_cycles_scan(*args, **vc)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(before, args)),
          "the fused kernel modified its inputs")
    return max_abs_err(want, got)


def graph_ms(fn, reps=50, rounds=7):
    """Device time of one ``fn()`` call: ``reps`` calls captured into a CUDA
    graph, replayed back to back, timed with CUDA events; median over
    ``rounds`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm up the allocator outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def eager_ms(fn, reps=200):
    """Wall time of one eager ``fn()`` call from Python, launch overhead
    included (CUDA events around a loop, after a warm-up)."""
    import torch

    for _ in range(5):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_bytes(st, tables, ep_space):
    """Bytes each per-cycle kernel must move on this state, each input read
    once and each output written once. The arb phase reads only the input
    heads and the route (and, with VCs, ``vc_out``) entries of the heads
    that are live; the link tables are physical."""
    C, R, P, Din, NF = st.in_buf.shape
    Dout = st.out_buf.shape[3]
    E = ep_space.shape[-1]
    V = tables.n_vcs
    n = C * R * P
    live_heads = int((st.in_cnt > 0).sum())
    arb = (n * NF * 4 + 4 * n * 4 + live_heads * 4 * (1 if V == 1 else 2)
           + 3 * n + n * NF * 4 + 2 * n * 4)  # pop/grant/space, chosen, rr/wh
    apply = (2 * n * (Din + Dout) * NF * 4  # both buffers read + rewritten
             + 4 * n * 4  # counts in and out
             + 3 * n + n * NF * 4  # arb scratch
             + R * (P // V) * 2 * 4 * 2 + R * P * 4 + C * E)  # tables, ep_space
    return {"arb": arb, "apply": apply}


def kernel_ops(st):
    """Scalar integer operations of each per-cycle kernel (counted
    generously): the arb thread scores P inputs for each of P outputs, the
    apply thread moves (Din + Dout) * NF words."""
    C, R, P, Din, NF = st.in_buf.shape
    Dout = st.out_buf.shape[3]
    return {"arb": C * R * (P * P * 12 + P * (NF + 12)),
            "apply": C * R * P * ((Din + Dout) * NF * 3 + 40)}


def fused_bytes(st, egress, tables, N):
    """Bytes of one fused window: state, queues and tables read once, state
    and the per-cycle outputs written once."""
    C, R, P, Din, NF = st.in_buf.shape
    Dout = st.out_buf.shape[3]
    _, E, Q, _ = egress["eg"].shape
    Pp = P // tables.n_vcs
    state = C * R * P * ((Din + Dout) * NF + 4) * 4
    queues = C * E * (Q * (NF + 1) + 2) * 4
    table = (R * E + R * Pp * 4 + R * P + E * 2) * 4 + C * E
    if tables.vc_out is not None:
        table += R * P * Pp * 4
    per_cycle = C * N * E * (NF * 4 + 2)
    return 2 * (state + queues) + table + per_cycle


def bound(nbytes, nops):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(st, tables, ep_space):
    """Per-cycle kernel and plain-version times on one state (device time
    per call), plus the least time the card could take."""
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    depth_out = st.out_buf.shape[-2]
    vc = dict(vc_out=tables.vc_out, n_vcs=tables.n_vcs)
    arb_args = (st.in_buf, st.in_cnt, st.out_cnt, st.rr_ptr, st.wh_lock,
                tables.route)
    arb = ref.arb_decisions(*arb_args, depth_out=depth_out, **vc)
    app_args = (st.in_buf, st.in_cnt, st.out_buf, st.out_cnt, arb,
                tables.link_src, tables.link_dst, tables.port_ep, ep_space)
    V = tables.n_vcs
    saved = dict(K.LAUNCHES)
    out = {
        "arb": {"ms": graph_ms(lambda: K.arb_cuda(*arb_args, depth_out=depth_out, **vc)),
                "plain_ms": graph_ms(lambda: ref.arb_decisions(*arb_args, depth_out=depth_out, **vc)),
                "eager_ms": eager_ms(lambda: K.arb_cuda(*arb_args, depth_out=depth_out, **vc))},
        "apply": {"ms": graph_ms(lambda: K.apply_cuda(*app_args, n_vcs=V)),
                  "plain_ms": graph_ms(lambda: ref.apply_phase(*app_args, fused=True, n_vcs=V)),
                  "eager_ms": eager_ms(lambda: K.apply_cuda(*app_args, n_vcs=V))},
    }
    K.LAUNCHES.update(saved)  # timing launches are not main-path launches
    nbytes, nops = kernel_bytes(st, tables, ep_space), kernel_ops(st)
    for k, v in out.items():
        b_ms, b_by = bound(nbytes[k], nops[k])
        v.update(bytes=nbytes[k], ops=nops[k], bound_ms=b_ms, bound_by=b_by)
    return out


def time_fused(st, eps, tables, ep_space, cycle0, N=4):
    """Device time of one fused window of N cycles (the main path's k) on
    a simulator state, its plain version's, and the bound; per launch and
    per simulated cycle."""
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    state = {k: getattr(st, k) for k in STATE}
    egress = {k: getattr(eps, k) for k in EGRESS}
    args = fused_args(state, egress, tables, ep_space, cycle0, N)
    vc = dict(vc_out=tables.vc_out, n_vcs=tables.n_vcs)
    saved = dict(K.LAUNCHES)
    ms = graph_ms(lambda: K.router_cycles_fused_cuda(*args, **vc), reps=20)
    plain = graph_ms(lambda: ref.router_cycles_scan(*args, **vc), reps=5)
    eager = eager_ms(lambda: K.router_cycles_fused_cuda(*args, **vc), reps=50)
    K.LAUNCHES.update(saved)
    nbytes = fused_bytes(st, egress, tables, N)
    nops = N * sum(kernel_ops(st).values())
    b_ms, b_by = bound(nbytes, nops)
    return {"n_cycles": N, "ms": ms, "plain_ms": plain, "eager_ms": eager,
            "ms_per_cycle": ms / N, "bytes": nbytes, "ops": nops,
            "bound_ms": b_ms, "bound_by": b_by}


def layer_times(eng, sim, st, n=100):
    """Host-clock ms of one router cycle alone and of one whole step on the
    card (each over ``n`` calls from state ``st``, synchronised at the
    end); the endpoint phases take the difference. Per-cycle steps only."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K

    saved = dict(K.LAUNCHES)
    space = torch.ones((sim.params.n_channels, sim.topo.n_endpoints),
                       dtype=torch.bool, device=sim.device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.fabric_cycle(st.fabric, sim.tables, space)
        torch.cuda.synchronize()
        fabric_ms = (time.perf_counter() - t0) / n * 1e3
        c0, s = int(st.cycle), st
        t0 = time.perf_counter()
        for i in range(n):
            s, _ = sim.step(s, c0 + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
    K.LAUNCHES.update(saved)
    return {"step_ms": step_ms, "router_cycle_ms": fabric_ms,
            "endpoint_phases_ms": step_ms - fabric_ms}


def device_profile(sim, st, step_ms, n=20):
    """Device activity of ``n`` (super-)steps under ``torch.profiler``:
    kernels per simulated cycle, device time per cycle, the busy share of
    an unprofiled step (``step_ms`` per simulated cycle) and the kernels
    that take most device time. ``None`` where the profiler reports no
    device activity."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.noc_router import noc_router as K

    saved = dict(K.LAUNCHES)
    cyc, s = int(st.cycle), st
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            s, _, k = sim._advance(s, cyc)
            cyc += k
        torch.cuda.synchronize()
    K.LAUNCHES.update(saved)
    cycles = cyc - int(st.cycle)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_events": 0, "busy_share": None}
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name[:60]] += e.time_range.elapsed_us()
    dev_us = sum(by_name.values()) / cycles
    return {"device_events_per_cycle": len(dev) / cycles,
            "device_us_per_cycle": dev_us,
            "busy_share": dev_us / (step_ms * 1e3),
            "top_us_per_cycle": {k: v / cycles for k, v in by_name.most_common(6)}}


# ---------------------------------------------------------------------------
# the main path


def states_equal(a, b):
    """Leaf-for-leaf equality of two port SimStates: the differing leaves."""
    import numpy as np

    from repro_torch import convert

    na, nb = convert.sim_state_to_numpy(a), convert.sim_state_to_numpy(b)
    check(set(na) == set(nb), "state leaves differ")
    return [k for k in na if na[k].dtype != nb[k].dtype
            or not np.array_equal(na[k], nb[k])]


def expected_launches(params, n):
    """Launches of each kernel and mode that ``n`` cycles must make: one
    arb and one apply per cycle, or one fused window per ``fused_cycles``,
    in the params' VC mode, and none of any other."""
    from repro_torch.kernels.noc_router import noc_router as K

    want = dict.fromkeys(K.LAUNCHES, 0)
    k, V = params.fused_cycles, params.n_vcs
    if k == 1:
        want.update({K.mode("arb", V): n, K.mode("apply", V): n})
    else:
        want[K.mode("fused", V)] = n // k
    return want


def run_counted(TS, sim, n, state=None):
    """``TS.run`` on the card with the launch counts set to 0 just before
    and read just after, held against ``expected_launches``."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K

    torch.cuda.synchronize()
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    t0 = time.perf_counter()
    st = TS.run(sim, n, state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = expected_launches(sim.params, n)
    check(launches == want, f"expected launches {want}, got {launches}")
    return st, dt, launches


def ring_workload(TT_epm, topo, beats=64):
    """Every tile of the 8x1 torus sends one write burst three hops east:
    the wrap ring's wormhole cycle (``tests/test_noc_vc.py``)."""
    import numpy as np

    E = topo.n_endpoints
    wl = TT_epm.idle_workload(E, n_tiles=E)
    dst = np.array([[(x + 3) % E] for x in range(E)], np.int32)
    return dataclasses.replace(wl, dma_dst=dst,
                               dma_txns=np.ones((E, 1), np.int32),
                               dma_beats=beats, dma_write=True)


def narrow_latency(TS, TT_epm, topo, src, dst, cycles=380):
    """Mean narrow round-trip latency src -> dst at zero load, on the card."""
    import numpy as np

    E = topo.n_endpoints
    wl = TT_epm.idle_workload(E, n_tiles=topo.meta["n_tiles"])
    nr = np.zeros((E,), np.float32)
    nr[src] = 0.02
    nd = np.full((E,), -1, np.int32)
    nd[src] = dst
    wl = dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
    sim = TS.build_sim(topo, TS.NocParams(), wl)
    st, _, _ = run_counted(TS, sim, cycles)
    out = TS.stats(sim, st)
    check(out["narrow_lat_cnt"][src] > 5, "too few narrow round trips")
    return float(out["narrow_lat_mean"][src])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import convert
    from repro_torch.core.noc import endpoints as epm
    from repro_torch.core.noc import engine as eng
    from repro_torch.core.noc import sim as TS
    from repro_torch.core.noc import traffic as TT
    from repro_torch.core.noc.engine import make_tables
    from repro_torch.core.noc.params import NocParams
    from repro_torch.core.noc.topology import build_mesh, build_occamy, build_torus
    from repro_torch.kernels.noc_router import noc_router as K

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card + build --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    fresh = not K.library_path().exists()
    t0 = time.perf_counter()
    so = K.build()
    build_s = time.perf_counter() - t0
    phase("card", nvidia_smi=card, torch=torch.__version__,
          cuda=torch.version.cuda, library=str(so.relative_to(ROOT)),
          built_now=fresh, build_s=build_s)

    # ---- 2. kernels vs plain on random snapshots --------------------------
    errs = dict.fromkeys(K.LAUNCHES, 0)
    rng = np.random.default_rng(0)
    for nx, ny in ((4, 8), (32, 32)):
        tables = make_tables(build_mesh(nx=nx, ny=ny), device=dev)
        for depth in (2, 4):
            snap = to_device(random_snapshot(rng, tables, 3, depth), dev)
            e = compare_kernels(snap, tables)
            phase("kernels_vs_plain", mesh=f"{nx}x{ny}",
                  R=int(tables.route.shape[0]), depth=depth, max_abs_err=e)
            check(max(e.values()) == 0, f"kernel disagrees with plain: {e}")
            errs["arb"] = max(errs["arb"], e["arb"], e["cycle"])
            errs["apply"] = max(errs["apply"], e["apply"], e["cycle"])

    # ---- 2b. the VC modes (V = 2): tori 8x4, 32x32 and 8x1, Occamy's 28 slots
    vc_cases = [(f"torus {nx}x{ny}", build_torus(nx=nx, ny=ny), depth)
                for nx, ny in ((4, 8), (32, 32), (8, 1)) for depth in (2, 4)]
    vc_cases.append(("occamy", build_occamy(), 2))
    for name, vtopo, depth in vc_cases:
        tables = make_tables(vtopo, n_vcs=2, device=dev)
        snap = to_device(random_snapshot(rng, tables, 3, depth), dev)
        e = compare_kernels(snap, tables)
        phase("kernels_vs_plain_vc", fabric=name, R=int(tables.route.shape[0]),
              slots=int(tables.port_ep.shape[1]), depth=depth, max_abs_err=e)
        check(max(e.values()) == 0, f"VC kernel disagrees with plain: {e}")
        errs["arb_vc"] = max(errs["arb_vc"], e["arb"], e["cycle"])
        errs["apply_vc"] = max(errs["apply_vc"], e["apply"], e["cycle"])

    # ---- 2c. the fused window against N plain cycles ------------------------
    Q = NocParams().egress_depth
    for nx, ny in ((4, 8), (32, 32)):
        for V in (1, 2):
            ftopo = (build_mesh if V == 1 else build_torus)(nx=nx, ny=ny)
            tables = make_tables(ftopo, n_vcs=V, device=dev)
            for N in (1, 4, 16):
                snap = to_device(random_snapshot(rng, tables, 3, 2), dev)
                egress = to_device(random_egress(rng, 3, ftopo.n_endpoints, Q,
                                                 1000, N), dev)
                err = compare_fused(snap, egress, tables, 1000, N)
                phase("fused_vs_plain", fabric=ftopo.name,
                      n_vcs=V, n_cycles=N, max_abs_err=err)
                check(err == 0, f"fused kernel disagrees with plain: {err}")
                key = K.mode("fused", V)
                errs[key] = max(errs[key], err)

    # ---- 3. main path on the paper's 8x4 mesh -----------------------------
    topo = build_mesh(nx=4, ny=8)
    wl = mesh_workload(TT, topo, transfer_kb=8, narrow_rate=0.05)
    sim = TS.build_sim(topo, NocParams(), wl)
    st_gpu, dt, main_launches = run_counted(TS, sim, 1200)
    out = TS.stats(sim, st_gpu)
    check(out["beats_rcvd"].sum() > 0 and out["narrow_lat_cnt"].sum() > 0,
          "8x4 main path moved no traffic")
    sim_cpu = TS.build_sim(topo, NocParams(), wl, device="cpu")
    t0 = time.perf_counter()
    st_cpu = TS.run(sim_cpu, 1200)
    dt_cpu = time.perf_counter() - t0
    bad = states_equal(st_gpu, st_cpu)
    check(not bad, f"8x4 GPU state differs from CPU state in {bad}")
    ms_8x4 = dt / 1200 * 1e3
    phase("main_8x4", cycles=1200, launches=main_launches,
          gpu_ms_per_cycle=ms_8x4, cpu_ms_per_cycle=dt_cpu / 1200 * 1e3,
          gpu_state_equals_cpu=True, wide_util=float(out["wide_util"]),
          narrow_lat_mean=float(out["narrow_lat_mean"].mean()))
    timing_8x4 = time_kernels(st_gpu.fabric, sim.tables,
                              torch.ones((3, topo.n_endpoints), dtype=torch.bool,
                                         device=dev))
    phase("kernel_times_8x4", **timing_8x4)
    layers_8x4 = layer_times(eng, sim, st_gpu)
    phase("layers_8x4", **layers_8x4)
    phase("profile_8x4", **device_profile(sim, st_gpu, layers_8x4["step_ms"]))

    lat = {d: narrow_latency(TS, epm, topo, 0, d) for d in (1, 2, 3, 31)}
    phase("fig7_8x4", latency=lat)
    check(lat[1] == 22.0 and lat[31] == 58.0, f"Fig. 7 latencies {lat}")
    check(lat[2] - lat[1] == 4.0 and lat[3] - lat[2] == 4.0,
          f"Fig. 7 per-hop step {lat}")

    gtopo = build_mesh(nx=4, ny=2)
    gsim = TS.build_sim(gtopo, NocParams(),
                        mesh_workload(TT, gtopo, transfer_kb=1,
                                      narrow_rate=0.05))
    gst, _, _ = run_counted(TS, gsim, 1200)
    gout = TS.stats(gsim, gst)
    got = {"beats_rcvd": gout["beats_rcvd"],
           "dma_done": gout["dma_done"].sum(axis=-1),
           "narrow_lat_cnt": gout["narrow_lat_cnt"],
           "narrow_lat_sum": gst.eps.lat_sum.cpu().numpy(),
           "n_sent": gst.eps.n_sent.cpu().numpy(),
           "ni_stalls": gout["ni_stalls"], "last_rx": gout["last_rx"],
           "first_rx": gout["first_rx"]}
    wrong = [k for k, v in GOLDEN.items()
             if not np.array_equal(np.asarray(got[k]), np.asarray(v, got[k].dtype))]
    phase("golden_4x2", cycles=1200, pins=len(GOLDEN), wrong=wrong)
    check(not wrong, f"golden pins differ: {wrong}")

    # ---- 4. the 32x32 scaling point ----------------------------------------
    btopo = build_mesh(nx=32, ny=32)
    bwl = mesh_workload(TT, btopo, transfer_kb=8, narrow_rate=0.0)
    bsim = TS.build_sim(btopo, NocParams(), bwl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bst, bdt, big_launches = run_counted(TS, bsim, 200)
    peak = torch.cuda.max_memory_allocated()
    bsim_cpu = TS.build_sim(btopo, NocParams(), bwl, device="cpu")
    t0 = time.perf_counter()
    bst_cpu = TS.run(bsim_cpu, 200)
    bdt_cpu = time.perf_counter() - t0
    bad = states_equal(bst, bst_cpu)
    check(not bad, f"32x32 GPU state differs from CPU state in {bad}")
    bout = TS.stats(bsim, bst)
    check(bout["beats_rcvd"].sum() > 0, "32x32 run moved no wide beats")
    state_bytes = sum(v.nbytes for v in
                      convert.sim_state_to_numpy(bst).values())
    phase("scale_32x32", cycles=200, launches=big_launches,
          gpu_ms_per_cycle=bdt / 200 * 1e3, cpu_ms_per_cycle=bdt_cpu / 200 * 1e3,
          gpu_state_equals_cpu=True, state_bytes=state_bytes,
          peak_device_bytes=peak, beats_rcvd=int(bout["beats_rcvd"].sum()))
    timing_32 = time_kernels(bst.fabric, bsim.tables,
                             torch.ones((3, btopo.n_endpoints),
                                        dtype=torch.bool, device=dev))
    phase("kernel_times_32x32", **timing_32)
    layers_32 = layer_times(eng, bsim, bst, n=50)
    phase("layers_32x32", **layers_32)
    phase("profile_32x32", **device_profile(bsim, bst, layers_32["step_ms"]))

    # ---- 5. super-steps: the 8x4 mesh at fused_cycles=4 ------------------
    sp = NocParams(fused_cycles=4)
    ssim = TS.build_sim(topo, sp, wl)
    sst, sdt, super_launches = run_counted(TS, ssim, 1200)
    sst_cpu = TS.run(TS.build_sim(topo, sp, wl, device="cpu"), 1200)
    bad = states_equal(sst, sst_cpu)
    check(not bad, f"super_8x4 GPU state differs from CPU state in {bad}")
    sout = TS.stats(ssim, sst)
    check(sout["beats_rcvd"].sum() > 0, "super_8x4 moved no wide beats")
    ms_super = sdt / 1200 * 1e3
    phase("super_8x4", cycles=1200, fused_cycles=4, launches=super_launches,
          gpu_ms_per_cycle=ms_super, k1_gpu_ms_per_cycle=ms_8x4,
          gpu_state_equals_cpu=True, wide_util=float(sout["wide_util"]))
    # k = 1 against k = 4 in turns (k1, k4, k4, k1), 400 cycles each from a
    # fresh state: the host's speed drifts within a call
    turns = []
    for s_ in (sim, ssim, ssim, sim):
        _, t_, _ = run_counted(TS, s_, 400)
        turns.append(t_ / 400 * 1e3)
    phase("k1_vs_k4_8x4", order="k1,k4,k4,k1", gpu_ms_per_cycle=turns)
    phase("profile_super_8x4", **device_profile(ssim, sst, ms_super, n=10))
    ones = lambda T: torch.ones((3, T.n_endpoints), dtype=torch.bool, device=dev)
    fused_8x4 = time_fused(sst.fabric, sst.eps, ssim.tables, ones(topo), 1200)
    phase("kernel_times_fused_8x4", **fused_8x4)
    fused_32 = time_fused(bst.fabric, bst.eps, bsim.tables, ones(btopo), 200)
    phase("kernel_times_fused_32x32", **fused_32)

    # ---- 6. the 8x4 torus with dateline VCs, per cycle and in super-steps --
    ttopo = build_torus(nx=4, ny=8)
    twl = mesh_workload(TT, ttopo, transfer_kb=8, narrow_rate=0.05)
    vp = NocParams(n_vcs=2)
    vsim = TS.build_sim(ttopo, vp, twl)
    vst, vdt, vc_launches = run_counted(TS, vsim, 1200)
    vst_cpu = TS.run(TS.build_sim(ttopo, vp, twl, device="cpu"), 1200)
    bad = states_equal(vst, vst_cpu)
    check(not bad, f"torus_vc_8x4 GPU state differs from CPU state in {bad}")
    vout = TS.stats(vsim, vst)
    check(vout["beats_rcvd"].sum() > 0 and vout["narrow_lat_cnt"].sum() > 0,
          "torus_vc_8x4 moved no traffic")
    ms_vc = vdt / 1200 * 1e3
    phase("torus_vc_8x4", cycles=1200, n_vcs=2, fused_cycles=1,
          launches=vc_launches, gpu_ms_per_cycle=ms_vc,
          gpu_state_equals_cpu=True, wide_util=float(vout["wide_util"]),
          narrow_lat_mean=float(vout["narrow_lat_mean"].mean()))
    layers_vc = layer_times(eng, vsim, vst)
    phase("layers_torus_vc_8x4", **layers_vc)
    vc_8x4 = time_kernels(vst.fabric, vsim.tables, ones(ttopo))
    phase("kernel_times_vc_8x4", **vc_8x4)

    tp = NocParams(n_vcs=2, fused_cycles=4)
    tsim = TS.build_sim(ttopo, tp, twl)
    tst, tdt, torus_launches = run_counted(TS, tsim, 1200)
    tst_cpu = TS.run(TS.build_sim(ttopo, tp, twl, device="cpu"), 1200)
    bad = states_equal(tst, tst_cpu)
    check(not bad, f"torus_8x4 GPU state differs from CPU state in {bad}")
    tout = TS.stats(tsim, tst)
    check(tout["beats_rcvd"].sum() > 0 and tout["narrow_lat_cnt"].sum() > 0,
          "torus_8x4 moved no traffic")
    ms_torus = tdt / 1200 * 1e3
    phase("torus_8x4", cycles=1200, n_vcs=2, fused_cycles=4,
          launches=torus_launches, gpu_ms_per_cycle=ms_torus,
          gpu_state_equals_cpu=True, wide_util=float(tout["wide_util"]),
          narrow_lat_mean=float(tout["narrow_lat_mean"].mean()))
    phase("profile_torus_8x4", **device_profile(tsim, tst, ms_torus, n=10))
    fused_vc_8x4 = time_fused(tst.fabric, tst.eps, tsim.tables, ones(ttopo),
                              1200)
    phase("kernel_times_fused_vc_8x4", **fused_vc_8x4)

    # ---- 7. the 8x1 ring: wedged without VCs, drained with two ------------
    rtopo = build_torus(nx=8, ny=1)
    rwl = ring_workload(epm, rtopo)
    rsim1 = TS.build_sim(rtopo, NocParams(), rwl)
    rst, _, _ = run_counted(TS, rsim1, 2000)
    mid = int(rst.eps.beats_rcvd.sum())
    rst, _, _ = run_counted(TS, rsim1, 2000, rst)
    wedged = (int(rst.eps.rx_bursts.sum()) == 0
              and int(rst.eps.beats_rcvd.sum()) == mid)
    check(wedged, "the VC-less 8x1 ring did not wedge")
    rsim2 = TS.build_sim(rtopo, NocParams(n_vcs=2), rwl)
    rsim2_cpu = TS.build_sim(rtopo, NocParams(n_vcs=2), rwl, device="cpu")
    rst2 = rst2_cpu = None
    ring_launches, ring_s = dict.fromkeys(K.LAUNCHES, 0), 0.0
    for _ in range(8):  # up to 4000 cycles, in steps of 500
        rst2, dt, got = run_counted(TS, rsim2, 500, rst2)
        rst2_cpu = TS.run(rsim2_cpu, 500, rst2_cpu)
        ring_launches = {k: ring_launches[k] + got[k] for k in got}
        ring_s += dt
        if int(rst2.eps.rx_bursts.sum()) == rtopo.n_endpoints:
            break
    ring_cycles = int(rst2.cycle)
    bad = states_equal(rst2, rst2_cpu)
    check(not bad, f"ring_8x1 (n_vcs=2) GPU state differs from CPU state in {bad}")
    drained = (int(rst2.eps.rx_bursts.sum()) == rtopo.n_endpoints
               and int(rst2.eps.beats_rcvd.sum())
               == rtopo.n_endpoints * rwl.dma_beats)
    phase("ring_8x1", vc1_cycles=4000, vc1_beats_rcvd=mid,
          vc1_rx_bursts=int(rst.eps.rx_bursts.sum()), vc1_wedged=wedged,
          vc2_cycles=ring_cycles, vc2_rx_bursts=int(rst2.eps.rx_bursts.sum()),
          vc2_drained=drained, vc2_launches=ring_launches,
          vc2_gpu_state_equals_cpu=True,
          vc2_gpu_ms_per_cycle=ring_s / ring_cycles * 1e3)
    check(drained, "the 8x1 ring with n_vcs=2 did not drain")

    # ---- 8. the 32x32 torus with dateline VCs, per cycle and in super-steps
    gtor = build_torus(nx=32, ny=32)
    gwl = mesh_workload(TT, gtor, transfer_kb=8, narrow_rate=0.0)
    gsim_v = TS.build_sim(gtor, vp, gwl)
    gst_v, gvdt, gv_launches = run_counted(TS, gsim_v, 200)
    gst_v_cpu = TS.run(TS.build_sim(gtor, vp, gwl, device="cpu"), 200)
    bad = states_equal(gst_v, gst_v_cpu)
    check(not bad, f"32x32 torus (k=1) GPU state differs from CPU state in {bad}")
    check(TS.stats(gsim_v, gst_v)["beats_rcvd"].sum() > 0,
          "32x32 torus (k=1) moved no wide beats")
    phase("scale_32x32_torus_vc", cycles=200, n_vcs=2, fused_cycles=1,
          launches=gv_launches, gpu_ms_per_cycle=gvdt / 200 * 1e3,
          gpu_state_equals_cpu=True)
    vc_32 = time_kernels(gst_v.fabric, gsim_v.tables, ones(gtor))
    phase("kernel_times_vc_32x32", **vc_32)
    del gsim_v, gst_v  # out of the k = 4 run's peak device memory

    gsim_t = TS.build_sim(gtor, tp, gwl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gst_t, gdt, gt_launches = run_counted(TS, gsim_t, 200)
    gpeak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    gst_cpu = TS.run(TS.build_sim(gtor, tp, gwl, device="cpu"), 200)
    gdt_cpu = time.perf_counter() - t0
    bad = states_equal(gst_t, gst_cpu)
    check(not bad, f"32x32 torus GPU state differs from CPU state in {bad}")
    gout = TS.stats(gsim_t, gst_t)
    check(gout["beats_rcvd"].sum() > 0, "32x32 torus moved no wide beats")
    ms_gtor = gdt / 200 * 1e3
    phase("scale_32x32_torus", cycles=200, n_vcs=2, fused_cycles=4,
          launches=gt_launches, gpu_ms_per_cycle=ms_gtor,
          cpu_ms_per_cycle=gdt_cpu / 200 * 1e3, gpu_state_equals_cpu=True,
          peak_device_bytes=gpeak, beats_rcvd=int(gout["beats_rcvd"].sum()))
    phase("profile_32x32_torus", **device_profile(gsim_t, gst_t, ms_gtor, n=5))
    fused_vc_32 = time_fused(gst_t.fabric, gst_t.eps, gsim_t.tables,
                             ones(gtor), 200)
    phase("kernel_times_fused_vc_32x32", **fused_vc_32)

    # ---- 9. the kernels line -----------------------------------------------
    src = "src/repro_torch/kernels/noc_router/csrc/noc_router.cu"
    tpu = "src/repro/kernels/noc_router/noc_router.py:"
    rows = [  # (LAUNCHES key, kernel, TPU kernel line, main-path launches,
              #  8x4 timing, 32x32 timing, 8x4 shape)
        ("arb", "noc_arb_kernel", 72, main_launches, timing_8x4["arb"],
         timing_32["arb"], "8x4 mesh, C=3, R=32, P=5, D=2"),
        ("apply", "noc_apply_kernel", 172, main_launches, timing_8x4["apply"],
         timing_32["apply"], "8x4 mesh, C=3, R=32, P=5, D=2"),
        ("arb_vc", "noc_arb_kernel[n_vcs=2]", 93, vc_launches,
         vc_8x4["arb"], vc_32["arb"], "8x4 torus, C=3, R=32, P=10 slots, D=2"),
        ("apply_vc", "noc_apply_kernel[n_vcs=2]", 172, vc_launches,
         vc_8x4["apply"], vc_32["apply"],
         "8x4 torus, C=3, R=32, P=10 slots, D=2"),
        ("fused", "noc_fused_kernel", 414, super_launches, fused_8x4,
         fused_32, "8x4 mesh, C=3, R=32, P=5, D=2, window N=4"),
        ("fused_vc", "noc_fused_kernel[n_vcs=2]", 419, torus_launches,
         fused_vc_8x4, fused_vc_32,
         "8x4 torus, C=3, R=32, P=10 slots, D=2, window N=4"),
    ]
    kernels = []
    for key, name, line, launches, t8, t32, shape in rows:
        check(launches[key] > 0, f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{tpu}{line}", "launches": launches[key],
            "max_abs_err": errs[key], "ms": t8["ms"], "plain_ms": t8["plain_ms"],
            "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
            "library_ms": None, "shape": shape,
            "scale_32x32": {"ms": t32["ms"], "plain_ms": t32["plain_ms"],
                            "bound_ms": t32["bound_ms"],
                            "bound_by": t32["bound_by"]},
        })
    phase("total", seconds=time.perf_counter() - t_start)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
