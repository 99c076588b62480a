"""Traffic patterns from the paper's Fig. 8 + HBM workloads (Fig. 11),
expressed as Workload programmes over the mesh tiles.

The port's own copy of ``repro.core.noc.traffic`` (numpy only, unchanged).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.noc.endpoints import Workload, idle_workload
from repro_torch.core.noc.topology import Topology


def _coords(topo: Topology):
    nt = topo.meta["n_tiles"]
    return topo.tile_coord[:nt], nt, topo.meta["nx"], topo.meta["ny"]


def pattern_dst(topo: Topology, pattern: str, seed: int = 7) -> np.ndarray:
    """Destination tile per source tile; -2 marks per-message uniform random."""
    coord, nt, nx, ny = _coords(topo)
    x, y = coord[:, 0], coord[:, 1]
    tid = lambda xx, yy: (yy % ny) * nx + (xx % nx)
    if pattern == "uniform":
        return np.full((nt,), -2, np.int32)
    if pattern == "neighbor":
        return tid(x + 1, y).astype(np.int32)
    if pattern == "bit-complement":
        return tid(nx - 1 - x, ny - 1 - y).astype(np.int32)
    if pattern == "transpose":
        # fold the (wider-than-tall) coordinate into a square-ish transpose
        n = int(np.ceil(np.sqrt(nt)))
        lin = y * nx + x
        r, c = lin // n, lin % n
        t = (c * n + r) % nt
        return t.astype(np.int32)
    if pattern == "shuffle":
        rng = np.random.RandomState(seed)
        perm = rng.permutation(nt)
        # avoid self-loops
        for i in range(nt):
            if perm[i] == i:
                j = (i + 1) % nt
                perm[i], perm[j] = perm[j], perm[i]
        return perm.astype(np.int32)
    if pattern == "tiled-matmul":
        # reads stream from the row's HBM channel (A/B tiles), few writes back
        if topo.meta.get("n_hbm", 0) == 0:
            raise ValueError(
                "tiled-matmul needs HBM endpoints; "
                f"topology {topo.name!r} has none")
        return (nt + y).astype(np.int32)  # HBM endpoint of this row
    raise ValueError(pattern)


PATTERNS = ["uniform", "shuffle", "bit-complement", "transpose", "neighbor", "tiled-matmul"]


def dma_workload(topo: Topology, pattern: str, *, transfer_kb: int = 32,
                 n_txns: int = 16, streams: int = 1, write: bool = False,
                 seed: int = 7) -> Workload:
    """Open-loop wide-DMA workload: every tile issues ``n_txns`` transfers
    of ``transfer_kb`` kB (reads by default, writes with ``write=True``)
    over ``streams`` DMA streams to ``pattern_dst`` destinations — the
    Fig. 8 traffic patterns."""
    coord, nt, nx, ny = _coords(topo)
    E = topo.n_endpoints
    beats = max(transfer_kb * 1024 // 64, 1)  # 64 B per wide beat
    wl = idle_workload(E, n_tiles=nt, streams=streams)
    dst = pattern_dst(topo, pattern, seed)
    dd = np.full((E, streams), -1, np.int32)
    dd[:nt] = dst[:, None]
    dt = np.zeros((E, streams), np.int32)
    dt[:nt] = n_txns
    return dataclasses.replace(
        wl, dma_dst=dd, dma_txns=dt, dma_beats=beats, dma_write=write
    )


def narrow_workload(topo: Topology, pattern: str, rate: float, seed: int = 7) -> Workload:
    """Narrow-channel load: each tile sends ``rate`` requests/cycle to its
    ``pattern_dst`` destination (Fig. 7 latency-vs-load experiments)."""
    coord, nt, nx, ny = _coords(topo)
    E = topo.n_endpoints
    wl = idle_workload(E, n_tiles=nt)
    nr = np.zeros((E,), np.float32)
    nr[:nt] = rate
    nd = np.full((E,), -1, np.int32)
    nd[:nt] = pattern_dst(topo, pattern, seed)
    return dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)


def hbm_workload(topo: Topology, *, full_load: bool, n_txns: int = 32,
                 transfer_kb: int = 4, streams: int = 1) -> Workload:
    """Fig. 11: each tile reads its row's HBM channel; zero-load = only one
    tile per channel (the column-0 tile), full-load = all tiles."""
    coord, nt, nx, ny = _coords(topo)
    E = topo.n_endpoints
    beats = max(transfer_kb * 1024 // 64, 1)
    wl = idle_workload(E, n_tiles=nt, streams=streams)
    dd = np.full((E, streams), -1, np.int32)
    dt = np.zeros((E, streams), np.int32)
    for e in range(nt):
        x, y = coord[e]
        if full_load or x == 0:
            dd[e] = nt + y  # row's HBM endpoint
            dt[e] = n_txns
    return dataclasses.replace(wl, dma_dst=dd, dma_txns=dt, dma_beats=beats)


def ordering_workload(topo: Topology, *, streams: int, alternate: bool,
                      unique_txn: bool, n_txns: int = 16,
                      transfer_kb: int = 1) -> Workload:
    """RoB-less ordering microbenchmark: tile 0 moves ``n_txns`` transfers
    total, alternating between a near and a far destination.

    Single TxnID + alternating dst => the RoB-less NI must serialize each
    round trip; multi-stream (one destination per backend, unique TxnIDs)
    => the same total traffic pipelines freely (paper Sec. III/IV)."""
    coord, nt, nx, ny = _coords(topo)
    E = topo.n_endpoints
    beats = max(transfer_kb * 1024 // 64, 1)
    wl = idle_workload(E, n_tiles=nt, streams=streams)
    dd = np.full((E, streams), -1, np.int32)
    da = np.full((E, streams), -1, np.int32)
    dt = np.zeros((E, streams), np.int32)
    # two distant destinations with different path lengths
    d_near, d_far = 1, nt - 1
    for s in range(streams):
        dd[0, s] = d_near if (s % 2 == 0) else d_far
        if alternate and streams == 1:
            da[0, s] = d_far
        dt[0, s] = n_txns // streams  # same TOTAL work regardless of streams
    return dataclasses.replace(
        wl, dma_dst=dd, dma_alt_dst=da, dma_txns=dt, dma_beats=beats,
        unique_txn_per_stream=unique_txn,
    )
