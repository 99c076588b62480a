"""Design-space exploration over :class:`FabricSpec` grids.

``run_sweep`` batches N *workloads* of one fabric into one state;
:func:`run_dse` scales that to N *fabrics*: it groups spec points by shape
(``FabricSpec.group_key`` + the lowered workload's static signature), runs
each group through one ``sim.run_sweep``, and spreads the groups
round-robin over the cards (every CUDA device, or the one named). On the
CPU, ``workers > 1`` fans the groups out over a spawn-based process pool
instead (each worker re-runs :func:`run_dse` on its slice of the grid); on
a card ``workers > 1`` is refused. Results are bit-identical at every
width.

Every point is scored with **cycles** from the simulator and **area /
energy** from the Fig. 9 analytical models (``analytical.fabric_area_mm2``
/ ``noc_pj_per_byte``), yielding the perf-per-mm^2 vs pJ-per-B Pareto
frontier (:func:`frontier_artifact` — a deterministic, sorted-keys JSON
artifact; Table III methodology, see docs/FABRIC_SPEC.md).

The port's copy of ``repro.core.noc.dse``: for the same grid the artifact
is the JAX package's, byte for byte, when dumped with ``sort_keys=True``.
"""
from __future__ import annotations

import contextlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.noc import analytical as A
from repro_torch.core.noc import sim as S
from repro_torch.core.noc.spec import FabricSpec
from repro_torch.device import resolve_device

SCHEMA = "dse-frontier/v1"

# completion-cycle budget per point: base latency + cycles per injected
# wide beat at worst-case serialization (generous — points are checked
# for delivery and report it per row)
_CYCLES_BASE = 600
_CYCLES_PER_BEAT = 12


def _wl_signature(wl) -> tuple:
    """Static (compile-shape) signature of a lowered workload."""
    shape = lambda x: None if x is None else tuple(np.shape(x))
    return (wl.dma_write, wl.unique_txn_per_stream, wl.n_tiles, wl.n_streams,
            tuple((f, shape(getattr(wl, f))) for f in S.SWEEP_FIELDS))


def _wl_cycles_budget(wl) -> int:
    """Cycle budget from the workload's busiest endpoint."""
    if wl.dma_beats_seq is not None:
        total = int(np.maximum(np.asarray(wl.dma_beats_seq), 0)
                    .sum(axis=(1, 2)).max())
    elif wl.dma_txns is not None:
        per_ep = (np.maximum(np.asarray(wl.dma_txns), 0).sum(axis=1)
                  * int(np.asarray(wl.dma_beats)))
        total = int(per_ep.max())
    else:
        total = 0
    return _CYCLES_BASE + _CYCLES_PER_BEAT * total


def build_jobs(specs: list[FabricSpec]) -> list[tuple]:
    """Group spec points by compiled shape.

    Returns ``(topo, params, members)`` jobs where ``members`` is a list
    of ``(point_index, spec, workload)``; every member of a job batches
    through one ``run_sweep`` call.
    """
    groups: "OrderedDict[tuple, list[int]]" = OrderedDict()
    for i, sp in enumerate(specs):
        groups.setdefault(sp.group_key(), []).append(i)
    jobs = []
    for idxs in groups.values():
        topo, params = specs[idxs[0]].lower()
        wls = {i: specs[i].build_workload(topo) for i in idxs}
        # defensive refinement: run_sweep requires static agreement, so
        # split on the *lowered* signature too (group_key should already
        # guarantee it; a mismatch here must not poison the whole group)
        sub: "OrderedDict[tuple, list[int]]" = OrderedDict()
        for i in idxs:
            sub.setdefault(_wl_signature(wls[i]), []).append(i)
        for sidx in sub.values():
            jobs.append((topo, params,
                         [(i, specs[i], wls[i]) for i in sidx]))
    return jobs


def mean_hops(topo, pairs) -> float:
    """Mean router traversals over (src, dst) endpoint pairs (routing-table
    walk, ejection router included — matches ``Topology.hops``)."""
    pe = topo.port_ep
    if len(pairs) > 4096:  # deterministic subsample for huge fabrics
        pairs = pairs[:: len(pairs) // 2048]
    total = 0
    for s, d in pairs:
        cur = int(topo.ep_attach[s][0])
        n = 0
        while True:
            n += 1
            op = int(topo.route[cur, d])
            if pe[cur, op] == d:
                break
            cur = int(topo.link_to[cur, op, 0])
        total += n
    return total / max(len(pairs), 1)


def _score_point(spec: FabricSpec, topo, params, sim, wl, st,
                 n_cycles: int) -> dict:
    """One frontier row: simulator cycles + Fig. 9 area/energy scores."""
    out = S.stats(sim, st)
    cycles = int(out["last_rx"].max())
    done = int(out["dma_done"].sum())
    expect = (0 if wl.dma_txns is None
              else int(np.maximum(np.asarray(wl.dma_txns), 0).sum()))
    bytes_moved = int(out["beats_rcvd"].sum()) * 64
    hops = mean_hops(topo, spec.traffic_pairs(topo))
    area = A.fabric_area_mm2(topo, params)
    pj_b = A.noc_pj_per_byte(hops, n_vcs=params.n_vcs)
    # bytes/cycle x f[GHz] = GB/s of delivered wide payload
    gbps = bytes_moved / max(cycles, 1) * params.freq_ghz
    return {
        "spec": spec.to_dict(),
        "spec_hash": spec.spec_hash(),
        "fabric": topo.name,
        "workload": spec.workload,
        "n_cycles_run": n_cycles,
        "cycles": cycles,
        "delivered": bool(done == expect),
        "bytes": bytes_moved,
        "wide_util": round(float(out["wide_util"]), 6),
        "mean_hops": round(hops, 4),
        "area_mm2": round(area, 6),
        "pj_per_byte": round(pj_b, 6),
        "energy_uj": round(pj_b * bytes_moved * 1e-6, 6),
        "gbps": round(gbps, 3),
        "gbps_per_mm2": round(gbps / area, 3),
    }


def _devices(device) -> list[torch.device]:
    """The devices groups go round-robin over: every card for ``cuda``
    without an index, else the one device named."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())] or [dev]
    return [dev]


def run_dse(specs, *, n_cycles: int | None = None, workers: int | None = None,
            return_states: bool = False, log=None, device=None) -> list[dict]:
    """Score a grid of spec points; results align with ``specs`` order.

    Points are grouped by shape (:func:`build_jobs`) and each group runs
    through one batched ``sim.run_sweep`` — per-point results are
    bit-identical to running ``run_sweep`` on each point alone. Groups go
    round-robin over the cards (``device``: ``cuda`` unless the caller
    names another). On the CPU, ``workers > 1`` fans groups out over a
    spawn process pool; ``workers=None`` picks 1 process on a 1-core host
    and never spawns more workers than there are jobs. On a card
    ``workers`` must be 1 (or ``None``). ``n_cycles=None`` budgets each
    group from its busiest endpoint (``_wl_cycles_budget``).
    """
    specs = list(specs)
    for sp in specs:
        if sp.workload is None:
            raise ValueError(
                f"DSE point {sp.spec_hash()} has no workload binding; "
                "set FabricSpec.workload to score it")
    devices = _devices(device)
    on_cpu = devices[0].type == "cpu"
    if workers is not None and workers > 1 and not on_cpu:
        raise ValueError(
            f"workers={workers}: the process pool serves the CPU only; on "
            "a card run_dse spreads groups over the CUDA devices itself")
    jobs = build_jobs(specs)
    if workers is None:
        import os

        workers = max(1, min((os.cpu_count() or 1), len(jobs))) if on_cpu else 1
    if workers > 1 and len(jobs) > 1:
        if return_states:
            raise ValueError("return_states requires workers=1")
        return _run_dse_pool(specs, jobs, n_cycles, workers, log)

    done = []
    for j, (topo, params, members) in enumerate(jobs):
        budget = n_cycles or max(_wl_cycles_budget(wl) for _, _, wl in members)
        dev = devices[j % len(devices)]
        if log:
            log(f"[dse] group {j + 1}/{len(jobs)}: {topo.name} "
                f"C={params.n_channels} V={params.n_vcs} "
                f"x{len(members)} points, {budget} cycles on {dev}")
        # the kernels launch on the current device's stream: make it dev
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            sim = S.build_sim(topo, params, members[0][2], device=dev)
            finals = S.run_sweep(sim, [wl for _, _, wl in members], budget)
        done.append((sim, budget, finals))
    results: list = [None] * len(specs)
    for (topo, params, members), (sim, budget, finals) in zip(jobs, done):
        for (i, sp, wl), st in zip(members, finals):
            results[i] = _score_point(sp, topo, params, sim, wl, st, budget)
            if return_states:
                results[i]["state"] = st
    return results


def _pool_worker(spec_dicts: list[dict], n_cycles: int | None) -> list[dict]:
    """Process-pool entry: rebuild specs and score them in this process on
    the CPU (torch single-threaded: the state tensors are small)."""
    torch.set_num_threads(1)
    specs = [FabricSpec.from_dict(d) for d in spec_dicts]
    return run_dse(specs, n_cycles=n_cycles, workers=1, device="cpu")


def _run_dse_pool(specs, jobs, n_cycles, workers, log) -> list[dict]:
    """Shard whole jobs round-robin over a spawn-based process pool."""
    import concurrent.futures as cf
    import multiprocessing as mp

    shards: list[list[int]] = [[] for _ in range(min(workers, len(jobs)))]
    for j, (_, _, members) in enumerate(jobs):
        shards[j % len(shards)].extend(i for i, _, _ in members)
    if log:
        log(f"[dse] {len(jobs)} groups over {len(shards)} worker processes")
    results: list = [None] * len(specs)
    ctx = mp.get_context("spawn")
    with cf.ProcessPoolExecutor(max_workers=len(shards),
                                mp_context=ctx) as pool:
        futs = {
            pool.submit(_pool_worker,
                        [specs[i].to_dict() for i in shard], n_cycles): shard
            for shard in shards if shard
        }
        for fut in cf.as_completed(futs):
            for i, res in zip(futs[fut], fut.result()):
                results[i] = res
    return results


def pareto_mask(points: list[dict], maximize: str = "gbps_per_mm2",
                minimize: str = "pj_per_byte") -> list[bool]:
    """True where no other point is >= on ``maximize`` and <= on
    ``minimize`` with at least one strict inequality."""
    out = []
    for p in points:
        dominated = any(
            q[maximize] >= p[maximize] and q[minimize] <= p[minimize]
            and (q[maximize] > p[maximize] or q[minimize] < p[minimize])
            for q in points)
        out.append(not dominated)
    return out


def frontier_artifact(results: list[dict], *, grid: str = "custom") -> dict:
    """Deterministic Table-III-style artifact: points sorted by spec hash,
    Pareto membership marked, sorted keys when dumped with
    ``json.dump(..., sort_keys=True)``."""
    points = sorted((dict(r) for r in results), key=lambda r: r["spec_hash"])
    mask = pareto_mask(points)
    for p, m in zip(points, mask):
        p["pareto"] = bool(m)
    return {
        "schema": SCHEMA,
        "grid": grid,
        "n_points": len(points),
        "n_delivered": sum(bool(p["delivered"]) for p in points),
        "frontier": [p["spec_hash"] for p, m in zip(points, mask) if m],
        "points": points,
    }


# ----------------------------------------------------------------------
# the default exploration grid (python -m repro_torch.noc_explore --dse)
# ----------------------------------------------------------------------
def default_grid(smoke: bool = False) -> list[FabricSpec]:
    """The stock ``--dse`` grid: zoo fabrics x patterns x sizes.

    Full: 6 fabric variants (mesh at C=3, multi-stream C=3/C=4, span-2
    express, dateline-VC torus, stitched multi-die) x the Fig. 8 patterns
    x 2 transfer sizes x 2 transaction counts — >= 100 points in a
    handful of compile groups. Smoke: 2 fabrics x 2 patterns x 1 size
    (the CI ``dse-smoke`` lane).
    """
    fabrics: list[dict] = [
        dict(topology="mesh", nx=4, ny=4),
        dict(topology="torus", nx=4, ny=4, n_vcs=2),
    ]
    if not smoke:
        fabrics += [
            dict(topology="mesh", nx=4, ny=4, streams=2),
            dict(topology="mesh", nx=4, ny=4, streams=2, n_channels=4),
            dict(topology="mesh", nx=4, ny=4, express=2),
            dict(topology="multi_die", n_dies=2, nx=2, ny=4),
        ]
    sizes = [(1, 2)] if smoke else [(1, 2), (1, 4), (4, 2), (4, 4)]
    specs = []
    for fab in fabrics:
        patterns = ["uniform", "neighbor"] if smoke else [
            "uniform", "shuffle", "bit-complement", "transpose", "neighbor"]
        if fab["topology"] == "mesh" and not smoke:
            patterns.append("tiled-matmul")
        for pattern in patterns:
            for kb, txns in sizes:
                specs.append(FabricSpec(workload=pattern, transfer_kb=kb,
                                        n_txns=txns, **fab))
    return specs
