"""Explore the cycle-accurate FlooNoC simulator on the port: traffic
patterns, ordering schemes, the FlooNoC-vs-Occamy comparison (paper Figs.
8, 10, 11), physical-channel-count sweeps (PATRONoC-style parallel wide
channels), collectives on the fabric, the topology zoo (mesh / torus /
multi-die / Occamy), the batched multi-config sweep engine and the
FabricSpec design-space exploration.

The counterpart of the JAX package's ``examples/noc_explore.py``, mode for
mode, on the card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.noc_explore [--pattern uniform]
    PYTHONPATH=src python -m repro_torch.noc_explore --channels 3 4 5
    PYTHONPATH=src python -m repro_torch.noc_explore --collectives
    PYTHONPATH=src python -m repro_torch.noc_explore --sweep
    PYTHONPATH=src python -m repro_torch.noc_explore --topology torus --collectives
    PYTHONPATH=src python -m repro_torch.noc_explore --workload moe
    PYTHONPATH=src python -m repro_torch.noc_explore --workload ddp
    PYTHONPATH=src python -m repro_torch.noc_explore --dse --json frontier.json

``--dse --json`` writes the frontier artifact with ``json.dump(...,
indent=1, sort_keys=True)``, as the JAX script does, so the two files of
one grid are equal byte for byte. ``--workload`` compiles the demo
model ``llama4-scout-17b-a16e`` (reduced); the ddp gradient bytes are its
parameter count.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core.noc import collective_traffic as CT
from repro_torch.core.noc import ml_traffic as ML
from repro_torch.core.noc import sim as S
from repro_torch.core.noc import traffic as T
from repro_torch.core.noc.spec import preset
from repro_torch.core.noc.topology import TOPOLOGIES
from repro_torch.device import resolve_device

# every demo fabric is a declarative FabricSpec: spec.preset(name, big=...)
# and .lower() hand back the (Topology, NocParams) pair of the hand-built zoo


def make_topo(name: str, big: bool = False):
    return preset(name, big=big).build_topology()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pattern_sweep(pattern: str, topology: str = "mesh", device=None):
    """Utilization vs transfer size, all sizes batched through one
    ``run_sweep`` (one state, the router kernels launched once a cycle)."""
    topo, params = preset(topology, big=True).lower()
    if topo.tile_coord is None:
        raise SystemExit(f"{topology} has no grid coordinates; "
                         "use --collectives for the Occamy demos")
    print(f"== {pattern} on {topo.name}: wide-link utilization vs transfer size ==")
    sizes = (1, 4, 16, 32)
    wls = [T.dma_workload(topo, pattern, transfer_kb=kb, n_txns=4)
           for kb in sizes]
    sim = S.build_sim(topo, params, wls[0], device=device)
    sts = S.run_sweep(sim, wls, 3000 + 1200 * max(sizes))
    nt = topo.meta["n_tiles"]
    for kb, st in zip(sizes, sts):
        out = S.stats(sim, st)
        beats = out["beats_rcvd"][:nt].astype(float)
        util = (beats / np.maximum(out["last_rx"][:nt], 1)).mean()
        done = out["dma_done"][:nt].sum()
        print(f"  {kb:3d} kB: util={util:5.1%}  transfers done={done}/{nt*4}")


def collectives_demo(topology: str = "mesh", device=None):
    """Collective schedules lowered onto the fabric: measured completion
    cycle vs the simulator-calibrated analytical model, and the effective
    collective bandwidth at paper frequency. Works on every zoo topology;
    Occamy (no grid coordinates) runs the 1-D ring family over its
    clusters instead of the 2-D dimension-ordered schedule."""
    topo, params = preset(topology).lower()
    n = topo.meta["n_tiles"]
    gridded = topo.tile_coord is not None and "nx" in topo.meta
    print(f"== collectives on {topo.name} ({n} tiles, 16 kB, wide links) ==")
    configs = [("all-gather", {}), ("reduce-scatter", {}),
               ("all-reduce", {}), ("all-reduce", dict(streams=2)),
               ("all-reduce-2d", {}), ("multicast", dict(streams=4)),
               ("barrier", {})]
    for name, kw in configs:
        if name == "all-reduce-2d" and not gridded:
            continue
        kw = dict(kw)
        if name not in ("barrier",):
            kw.setdefault("data_kb", 16)
        sched = CT.build(topo, name, **kw)
        sim = S.build_sim(topo, params, CT.to_workload(topo, sched),
                          device=device)
        out = S.stats(sim, S.run(sim, 4000))
        meas = CT.measured_cycles(out, topo)
        est = CT.analytical_cycles(sched, params, topo)
        bw = 16 * 1024 / (meas / params.freq_ghz) if name != "barrier" else 0
        tag = f"{name} (S={sched.n_streams})"
        extra = f"  {bw:6.1f} GB/s eff" if bw else " " * 15
        print(f"  {tag:24s} measured {meas:5d} cyc   model {est:7.1f} cyc "
              f"({(est - meas) / max(meas, 1):+5.1%}){extra}")
    order = "snake order" if gridded else "cluster order"
    print(f"  (ring = {n} tiles, {order}; edge hops walked on the routing "
          f"tables, model terms from FabricCollectiveModel.for_topology)")


def workload_demo(workload: str, topology: str = "mesh", device=None):
    """One compiled ML-parallelism phase (``repro_torch.core.noc.ml_traffic``)
    on the fabric: the training-step traffic of a real model config,
    measured against the calibrated model."""
    from repro_torch.configs import get_config

    if topology not in ("mesh", "torus"):
        raise SystemExit("--workload demos run on mesh or torus")
    topo, params = preset(topology).lower()
    cfg = get_config("llama4-scout-17b-a16e").reduced()
    par_kw, tokens = ML.DEMO_SPECS[workload]
    par = ML.ParallelismSpec(**par_kw)
    phases = ML.compile_traffic(cfg, par, topo, tokens_per_device=tokens,
                                sim_cap_kb=16, workloads=[workload])
    print(f"== {workload} traffic of {cfg.name} on {topo.name} "
          f"(dp={par.dp} tp={par.tp} pp={par.pp} ep={par.ep}) ==")
    for ph in phases:
        v = ML.validate_phase(topo, ph, params, device=device)
        meas, est = v["measured"], v["model"]
        print(f"  {ph.pattern:11s} measured {meas:5d} cyc   model {est:7.1f} "
              f"cyc ({(est - meas) / max(meas, 1):+5.1%})   "
              f"delivered={'yes' if v['delivered'] else 'NO'}")
        print(f"  {ph.note}")
        r = ML.step_report([ph], params, topo)[0]
        print(f"  full step: {r['count']}x {r['data_kb']} kB -> "
              f"{r['total_cycles']:.0f} cyc = {r['us_per_step']} us")


def sweep_demo(topology: str = "mesh", device=None):
    """The batched sweep engine: N pattern x size configs as one state,
    timed against running them one after another (the same final states)."""
    topo, params = preset(topology).lower()
    if topo.tile_coord is None:
        raise SystemExit(f"{topology} has no grid coordinates; "
                         "use --collectives for the Occamy demos")
    pats = ["uniform", "shuffle", "bit-complement", "transpose", "neighbor"]
    if topo.meta.get("n_hbm", 0):
        pats.append("tiled-matmul")
    configs = [(p, kb) for p in pats for kb in (1, 4)]
    wls = [T.dma_workload(topo, p, transfer_kb=kb, n_txns=4)
           for p, kb in configs]
    n_cycles = 2000
    sim = S.build_sim(topo, params, wls[0], device=device)
    _sync(sim.device)
    t0 = time.perf_counter()
    sts = S.run_sweep(sim, wls, n_cycles)
    _sync(sim.device)
    batched = time.perf_counter() - t0
    seq_params = dataclasses.replace(params, fused_cycles=1)
    t0 = time.perf_counter()
    for wl in wls:
        S.run(S.build_sim(topo, seq_params, wl, device=device), n_cycles)
    _sync(sim.device)
    sequential = time.perf_counter() - t0
    nt = topo.meta["n_tiles"]
    print(f"== batched sweep on {topo.name} ({sim.device}): {len(wls)} configs "
          f"x {n_cycles} cycles in {batched:.1f} s as one state, "
          f"{sequential:.1f} s one after another "
          f"({sequential / max(batched, 1e-9):.1f}x) ==")
    for (p, kb), st in zip(configs, sts):
        out = S.stats(sim, st)
        beats = out["beats_rcvd"][:nt].astype(float)
        util = (beats / np.maximum(out["last_rx"][:nt], 1)).mean()
        print(f"  {p:15s} {kb:2d} kB: util={util:5.1%}  "
              f"done={out['dma_done'][:nt].sum()}")


def ordering_demo(device=None):
    print("== end-to-end ordering (paper Sec. III/IV) ==")
    topo = make_topo("mesh")
    for name, (order, streams, alt, uniq) in {
        "RoB-less, 1 stream, alternating dst": ("robless", 1, True, False),
        "RoB-less, 2 streams (multi-stream DMA)": ("robless", 2, False, True),
        "RoB NI, 1 stream, alternating dst": ("rob", 1, True, False),
    }.items():
        wl = T.ordering_workload(topo, streams=streams, alternate=alt,
                                 unique_txn=uniq, n_txns=16, transfer_kb=1)
        params = preset("mesh", ni_order=order).params()
        sim = S.build_sim(topo, params, wl, device=device)
        out = S.stats(sim, S.run(sim, 4000))
        print(f"  {name:42s} done@cycle {out['last_rx'][0]:5d}  "
              f"NI stalls {out['ni_stalls'][0]:4d}")


def hbm_comparison(device=None):
    print("== full-load HBM utilization: FlooNoC mesh vs Occamy xbars ==")
    mesh, params = preset("mesh", big=True).lower()
    wl = T.hbm_workload(mesh, full_load=True, n_txns=8, transfer_kb=4)
    sim = S.build_sim(mesh, params, wl, device=device)
    out = S.stats(sim, S.run(sim, 16000))
    p = params
    agg_f = out["beats_rcvd"][:32].sum() / max(out["last_rx"][:32].max(), 1) / p.hbm_rate / 8

    from repro_torch.core.noc.endpoints import idle_workload

    occ, params_o = preset("occamy").lower()
    nt = occ.meta["n_clusters"]
    wlo = idle_workload(occ.n_endpoints, n_tiles=nt)
    dd = np.full((occ.n_endpoints, 1), -1, np.int32)
    dt = np.zeros((occ.n_endpoints, 1), np.int32)
    for e in range(nt):
        dd[e, 0] = nt + (e % 8); dt[e, 0] = 8
    wlo = dataclasses.replace(wlo, dma_dst=dd, dma_txns=dt, dma_beats=64)
    simo = S.build_sim(occ, dataclasses.replace(params_o, max_outstanding=4),
                       wlo, device=device)
    outo = S.stats(simo, S.run(simo, 16000))
    agg_o = outo["beats_rcvd"][:nt].sum() / max(outo["last_rx"][:nt].max(), 1) / p.hbm_rate / 8
    print(f"  FlooNoC 8x4 mesh: {agg_f:5.1%} of HBM peak (paper: ~100%)")
    print(f"  Occamy hierarchy: {agg_o:5.1%} of HBM peak (paper: ~60%)")


def channel_sweep(counts, pattern: str, device=None):
    """Sweep NocParams.n_channels: wide traffic stripes over the extra wide
    channels by TxnID, so multi-stream DMA gains wide-link bandwidth."""
    print(f"== {pattern}: n_channels sweep (2 DMA streams/tile, 8 kB reads) ==")
    topo = make_topo("mesh", big=True)
    nt = topo.meta["n_tiles"]
    for c in counts:
        wl = T.dma_workload(topo, pattern, transfer_kb=8, n_txns=4, streams=2)
        params = preset("mesh", big=True, n_channels=c).params()
        sim = S.build_sim(topo, params, wl, device=device)
        out = S.stats(sim, S.run(sim, 16000))
        beats = out["beats_rcvd"][:nt].astype(float)
        util = (beats / np.maximum(out["last_rx"][:nt], 1)).mean()
        done = out["dma_done"][:nt].sum()
        finish = out["last_rx"][:nt].max()
        print(f"  C={c} ({c - 2} wide): util={util:5.1%}  "
              f"done={done}/{nt * 2 * 4}  finished@cycle {finish}")


def dse_demo(smoke: bool = False, json_path: str | None = None,
             workers: int | None = None, device=None):
    """Design-space exploration over the default FabricSpec grid: every
    point scored with simulator cycles + Fig. 9 area/energy, Pareto
    frontier (perf/mm^2 vs pJ/B) emitted as a deterministic artifact."""
    from repro_torch.core.noc import dse

    specs = dse.default_grid(smoke=smoke)
    grid = "smoke" if smoke else "default"
    print(f"== DSE: {len(specs)} spec points ({grid} grid), "
          f"{len(dse.build_jobs(specs))} groups ==")
    t0 = time.perf_counter()
    results = dse.run_dse(specs, workers=workers, log=print, device=device)
    art = dse.frontier_artifact(results, grid=grid)
    dt = time.perf_counter() - t0
    print(f"  {art['n_points']} points scored in {dt:.1f}s "
          f"({art['n_delivered']} delivered, "
          f"{len(art['frontier'])} on the Pareto frontier)")
    print(f"  {'spec':12s} {'fabric':14s} {'workload':14s} "
          f"{'cyc':>6s} {'GB/s':>8s} {'GB/s/mm2':>9s} {'pJ/B':>6s}")
    for p in art["points"]:
        if not p["pareto"]:
            continue
        print(f"  {p['spec_hash']:12s} {p['fabric']:14s} {p['workload']:14s} "
              f"{p['cycles']:6d} {p['gbps']:8.1f} {p['gbps_per_mm2']:9.1f} "
              f"{p['pj_per_byte']:6.3f}")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(art, f, indent=1, sort_keys=True)
        print(f"  frontier artifact -> {json_path}")
    print(json.dumps({"dse_wall_s": dt, "points": art["n_points"],
                      "groups": len(dse.build_jobs(specs)),
                      "device": str(device)}))
    return art


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.noc_explore")
    ap.add_argument("--pattern", default="uniform", choices=T.PATTERNS)
    ap.add_argument("--topology", default="mesh", choices=TOPOLOGIES,
                    help="fabric shape for the pattern/collective/sweep "
                         "demos (occamy supports --collectives only)")
    ap.add_argument("--channels", type=int, nargs="*", default=None,
                    help="sweep physical channel counts (>= 3) instead of "
                         "the default demos")
    ap.add_argument("--collectives", action="store_true",
                    help="run the collectives-on-fabric demo")
    ap.add_argument("--workload", default=None, choices=ML.WORKLOADS,
                    help="run one compiled ML-parallelism phase "
                         "(ddp/tp/moe/pp) on the fabric")
    ap.add_argument("--sweep", action="store_true",
                    help="run the batched multi-config sweep demo")
    ap.add_argument("--dse", action="store_true",
                    help="run the FabricSpec design-space exploration and "
                         "print the Pareto frontier")
    ap.add_argument("--smoke", action="store_true",
                    help="with --dse: the small grid (4 points)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="with --dse: write the frontier artifact JSON")
    ap.add_argument("--workers", type=int, default=None,
                    help="with --dse on the CPU: process-pool width "
                         "(default: one per core, capped at the group count)")
    ap.add_argument("--device", default=None,
                    help="where the simulator runs (default cuda, which "
                         "raises without a card; cpu runs the plain "
                         "PyTorch version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.dse:
        dse_demo(smoke=args.smoke, json_path=args.json, workers=args.workers,
                 device=dev)
    elif args.channels:
        channel_sweep(args.channels, args.pattern, device=dev)
    elif args.workload:
        workload_demo(args.workload, args.topology, device=dev)
    elif args.collectives:
        collectives_demo(args.topology, device=dev)
    elif args.sweep:
        sweep_demo(args.topology, device=dev)
    elif args.topology != "mesh":
        pattern_sweep(args.pattern, args.topology, device=dev)
    else:
        pattern_sweep(args.pattern, device=dev)
        ordering_demo(device=dev)
        hbm_comparison(device=dev)


if __name__ == "__main__":
    main()
