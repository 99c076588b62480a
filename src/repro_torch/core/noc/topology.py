"""Generic NoC topology: routers with ports, endpoint attachments, table-based
routing (the paper's router supports source/XY/table routing — table routing
subsumes XY on a mesh and also expresses the Occamy hierarchical-Xbar
baseline on the same engine).

Occamy-style multi-cycle links (spill registers) are modeled with repeater
nodes: 1-in/1-out passthrough routers, exactly like a spill register.

The port's own copy of ``repro.core.noc.topology`` (numpy only, unchanged),
so that ``repro_torch`` imports nothing of ``repro``.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Topology:
    """A routed fabric shape: router wiring, endpoint attachments, tables.

    Everything the engine needs is tabular (``link_to``, ``ep_attach``,
    ``route``), so one engine simulates every zoo member; ``meta`` carries
    builder-specific facts (tile counts, grid dims, HBM count).
    """

    n_routers: int
    n_ports: int  # max ports per router (padded)
    n_endpoints: int
    # wiring: for router r, port p: (dst_router, dst_port) or (-1, -1)
    link_to: np.ndarray  # [R, P, 2] int32
    # endpoint e attaches at (router, port): endpoint ingress/egress
    ep_attach: np.ndarray  # [E, 2] int32
    # routing table: out port for (router, dst_endpoint)
    route: np.ndarray  # [R, E] int32
    # metadata
    name: str = "mesh"
    tile_coord: np.ndarray | None = None  # [E, 2] for mesh endpoints (x, y)
    meta: dict = field(default_factory=dict)
    # VC-switching tables (None on acyclically-routed fabrics — all traffic
    # stays on VC0 regardless of NocParams.n_vcs; see docs/ROUTING.md):
    # port_dim[r, p] = routing dimension the port moves along (0 = X, 1 = Y,
    # 2 = local/endpoint); dateline[r, p] = True iff the out-link at (r, p)
    # is a ring's dateline (a torus wrap link) — traffic crossing it is
    # bumped to VC1, breaking the ring's channel-dependency cycle.
    port_dim: np.ndarray | None = None  # [R, P] int32
    dateline: np.ndarray | None = None  # [R, P] bool

    @property
    def port_ep(self) -> np.ndarray:
        """[R, P] endpoint id attached at that router port, or -1."""
        out = np.full((self.n_routers, self.n_ports), -1, np.int32)
        for e, (r, p) in enumerate(self.ep_attach):
            out[r, p] = e
        return out

    def hops(self, src_ep: int, dst_ep: int) -> int:
        """Router traversals from src endpoint to dst endpoint (for checks)."""
        pe = self.port_ep  # hoisted: the property rebuilds an [R, P] array
        r, p = self.ep_attach[src_ep]
        n = 0
        cur = r
        visited = 0
        while True:
            n += 1
            out_p = self.route[cur, dst_ep]
            if pe[cur, out_p] == dst_ep:
                return n
            nxt, _ = self.link_to[cur, out_p]
            assert nxt >= 0, "route leads off fabric"
            cur = nxt
            visited += 1
            assert visited < 10 * self.n_routers, "routing loop"


# ----------------------------------------------------------------------
# 2D mesh (FlooNoC compute mesh: ny rows x nx cols, XY routing,
# HBM endpoints on the west edge - one per row, paper Sec. IV-B)
# ----------------------------------------------------------------------
N, E, S, W, L = 0, 1, 2, 3, 4  # port ids
XE, XW, YN, YS = 5, 6, 7, 8  # express ports (span-`express` links), radix 9


def build_mesh(nx: int = 4, ny: int = 8, hbm_west: bool = True,
               express: int = 0) -> Topology:
    """2-D mesh with dimension-ordered (XY) table routing.

    ``express > 0`` raises the router radix from 5 to 9 by adding express
    links that span ``express`` columns/rows (a span-k flattened mesh):
    router (x, y) also links to (x+k, y) and (x, y+k) where those exist,
    and the tables take the express hop whenever the remaining distance in
    the dimension being routed is >= k. With ``express=0`` (the default)
    the builder is bit-identical to the classic radix-5 mesh. Chiplet-style
    partitions of the same grid are built by ``build_multi_die``.
    """
    R = nx * ny
    k = int(express)
    P = 9 if k > 0 else 5
    rid = lambda x, y: y * nx + x

    link_to = np.full((R, P, 2), -1, np.int32)
    for y in range(ny):
        for x in range(nx):
            r = rid(x, y)
            if y + 1 < ny:
                link_to[r, N] = (rid(x, y + 1), S)
            if y > 0:
                link_to[r, S] = (rid(x, y - 1), N)
            if x + 1 < nx:
                link_to[r, E] = (rid(x + 1, y), W)
            if x > 0:
                link_to[r, W] = (rid(x - 1, y), E)
            if k > 0:
                if x + k < nx:
                    link_to[r, XE] = (rid(x + k, y), XW)
                if x - k >= 0:
                    link_to[r, XW] = (rid(x - k, y), XE)
                if y + k < ny:
                    link_to[r, YN] = (rid(x, y + k), YS)
                if y - k >= 0:
                    link_to[r, YS] = (rid(x, y - k), YN)

    # endpoints: tiles 0..R-1 on local ports; HBM channels ny..: west edge
    eps = [(rid(x, y), L) for y in range(ny) for x in range(nx)]
    n_tiles = len(eps)
    if hbm_west:
        eps += [(rid(0, y), W) for y in range(ny)]
    ep_attach = np.array(eps, np.int32)
    Etot = len(eps)

    tile_coord = np.zeros((Etot, 2), np.int32)
    for e, (r, p) in enumerate(eps):
        tile_coord[e] = (r % nx, r // nx)

    # XY routing tables: route X first, then Y (paper: dimension-ordered);
    # express hops are taken while the remaining distance covers the span
    def _step_x(x, ex):
        if ex > x:
            return XE if k > 0 and ex - x >= k and x + k < nx else E
        return XW if k > 0 and x - ex >= k and x - k >= 0 else W

    def _step_y(y, ey):
        if ey > y:
            return YN if k > 0 and ey - y >= k and y + k < ny else N
        return YS if k > 0 and y - ey >= k and y - k >= 0 else S

    route = np.full((R, Etot), -1, np.int32)
    for r in range(R):
        x, y = r % nx, r // nx
        for e in range(Etot):
            er, ep_port = eps[e]
            ex, ey = er % nx, er // nx
            if e >= n_tiles and hbm_west:
                # HBM endpoint sits off the west port of (0, ey)
                if (x, y) == (0, ey):
                    route[r, e] = W
                    continue
                # route to its router via XY with target x = 0
                ex = 0
            if (x, y) == (ex, ey):
                route[r, e] = ep_port if e < n_tiles else W
            elif x != ex:
                route[r, e] = _step_x(x, ex)
            else:
                route[r, e] = _step_y(y, ey)
    return Topology(
        n_routers=R, n_ports=P, n_endpoints=Etot, link_to=link_to,
        ep_attach=ep_attach, route=route, name=f"mesh{nx}x{ny}",
        tile_coord=tile_coord,
        meta={"nx": nx, "ny": ny, "n_tiles": n_tiles,
              "n_hbm": ny if hbm_west else 0, "express": k},
    )


# ----------------------------------------------------------------------
# 2D torus (wrap links on every row/column ring; FlooNoC's table-routed
# router expresses it with the same engine — paper Sec. III)
# ----------------------------------------------------------------------
def build_torus(nx: int = 4, ny: int = 4) -> Topology:
    """2-D torus: the mesh plus wrap links closing every row and column.

    Routing is dimension-ordered shortest-direction: each router's table
    independently sends a flit the shorter way around the X ring (ties go
    East), then the Y ring (ties go North). Every hop strictly shrinks the
    remaining ring distance in the dimension being routed, so table walks
    terminate. No HBM endpoints: the edge W/S ports carry the wrap links.
    ``ny=1`` (or ``nx=1``) degenerates to a 1-D torus ring.

    The builder also emits the VC-switching tables: ``port_dim`` (E/W = 0,
    N/S = 1, L = 2) and ``dateline`` marking every wrap out-link (E at
    x = nx-1, W at x = 0, N at y = ny-1, S at y = 0). With
    ``NocParams.n_vcs >= 2`` the fabric bumps traffic crossing a dateline
    to VC1, which provably breaks each ring's channel-dependency cycle
    (docs/ROUTING.md) — multi-hop wormholes across wrap links then run
    deadlock-free. With the VC-less default the wrap cycles remain, which
    is why ``meta["wrap"]`` keeps gating schedule builders.
    """
    R = nx * ny
    P = 5
    rid = lambda x, y: y * nx + x

    link_to = np.full((R, P, 2), -1, np.int32)
    for y in range(ny):
        for x in range(nx):
            r = rid(x, y)
            if ny > 1:
                link_to[r, N] = (rid(x, (y + 1) % ny), S)
                link_to[r, S] = (rid(x, (y - 1) % ny), N)
            if nx > 1:
                link_to[r, E] = (rid((x + 1) % nx, y), W)
                link_to[r, W] = (rid((x - 1) % nx, y), E)

    eps = [(rid(x, y), L) for y in range(ny) for x in range(nx)]
    ep_attach = np.array(eps, np.int32)
    Etot = len(eps)
    tile_coord = np.zeros((Etot, 2), np.int32)
    for e, (r, p) in enumerate(eps):
        tile_coord[e] = (r % nx, r // nx)

    route = np.full((R, Etot), -1, np.int32)
    for r in range(R):
        x, y = r % nx, r // nx
        for e in range(Etot):
            er, ep_port = eps[e]
            ex, ey = er % nx, er // nx
            if (x, y) == (ex, ey):
                route[r, e] = ep_port
            elif x != ex:
                dx = (ex - x) % nx
                route[r, e] = E if dx <= nx - dx else W
            else:
                dy = (ey - y) % ny
                route[r, e] = N if dy <= ny - dy else S

    # VC-switching tables: each port's routing dimension, and the dateline
    # links — one per directed ring, sitting on the wrap edge (shortest-
    # direction routing crosses at most one wrap per dimension, so a single
    # dateline per ring suffices; docs/ROUTING.md carries the proof)
    port_dim = np.full((R, P), -1, np.int32)
    port_dim[:, [E, W]] = 0
    port_dim[:, [N, S]] = 1
    port_dim[:, L] = 2
    dateline = np.zeros((R, P), bool)
    for y in range(ny):
        for x in range(nx):
            r = rid(x, y)
            if nx > 1:
                dateline[r, E] = x == nx - 1
                dateline[r, W] = x == 0
            if ny > 1:
                dateline[r, N] = y == ny - 1
                dateline[r, S] = y == 0
    return Topology(
        n_routers=R, n_ports=P, n_endpoints=Etot, link_to=link_to,
        ep_attach=ep_attach, route=route, name=f"torus{nx}x{ny}",
        tile_coord=tile_coord, port_dim=port_dim, dateline=dateline,
        # wrap=True marks the cyclic channel dependencies of the wrap links:
        # with a VC-less fabric (n_vcs=1) multi-hop wormhole traffic around
        # a ring can deadlock, so schedule builders must stick to
        # neighbor-hop sends (all_to_all's store-and-forward ring fallback);
        # n_vcs >= 2 + the dateline tables above lift that restriction
        meta={"nx": nx, "ny": ny, "n_tiles": Etot, "n_hbm": 0, "wrap": True},
    )


# ----------------------------------------------------------------------
# Multi-die: K mesh dies side by side, stitched per row by die-to-die
# boundary links modeled as repeater chains (Occamy-style spill registers)
# ----------------------------------------------------------------------
def build_multi_die(n_dies: int = 2, nx: int = 4, ny: int = 4,
                    d2d: int = 3) -> Topology:
    """``n_dies`` nx x ny mesh dies stitched along X into one fabric.

    Each boundary row link runs through ``d2d`` repeater nodes (1-in/1-out
    passthrough routers, exactly like Occamy's spill-register chains), so a
    die crossing costs ``d2d`` extra router traversals. Tiles are numbered
    row-major over the *global* (n_dies*nx, ny) grid, and routing is global
    XY, so ring/2-D collective schedules map onto the stitched fabric
    unchanged — boundary crossings are priced by ``Topology.hops``.
    """
    NX = n_dies * nx
    R0 = NX * ny  # die routers, global row-major ids
    P = 5
    rid = lambda gx, y: y * NX + gx

    links: list[tuple[int, int, int, int]] = []  # (r1, p1, r2, p2) bidirectional
    routers = R0
    repeaters: list[int] = []
    rep_east_x: dict[int, int] = {}  # repeater -> first global column east of it

    for y in range(ny):
        for gx in range(NX):
            r = rid(gx, y)
            if y + 1 < ny:
                links.append((r, N, rid(gx, y + 1), S))
            if gx + 1 < NX and (gx + 1) % nx != 0:  # same-die east neighbour
                links.append((r, E, rid(gx + 1, y), W))
    for d in range(1, n_dies):
        bx = d * nx  # first column of die d
        for y in range(ny):
            prev, pp = rid(bx - 1, y), E
            chain = list(range(routers, routers + d2d))
            routers += d2d
            repeaters.extend(chain)
            for c in chain:
                rep_east_x[c] = bx
                links.append((prev, pp, c, 0))
                prev, pp = c, 1
            links.append((prev, pp, rid(bx, y), W))

    link_to = np.full((routers, P, 2), -1, np.int32)
    for r1, p1, r2, p2 in links:
        link_to[r1, p1] = (r2, p2)
        link_to[r2, p2] = (r1, p1)

    eps = [(rid(gx, y), L) for y in range(ny) for gx in range(NX)]
    ep_attach = np.array(eps, np.int32)
    Etot = len(eps)
    tile_coord = np.zeros((Etot, 2), np.int32)
    for e, (r, p) in enumerate(eps):
        tile_coord[e] = (r % NX, r // NX)

    route = np.full((routers, Etot), -1, np.int32)
    for r in range(R0):
        x, y = r % NX, r // NX
        for e in range(Etot):
            er, ep_port = eps[e]
            ex, ey = er % NX, er // NX
            if (x, y) == (ex, ey):
                route[r, e] = ep_port
            elif x != ex:
                route[r, e] = E if ex > x else W  # E/W may lead into a chain
            else:
                route[r, e] = N if ey > y else S
    # repeater routing: port 0 faces west, port 1 faces east; only X-phase
    # traffic crosses a chain, so the destination column decides the side
    for rep in repeaters:
        bx = rep_east_x[rep]
        for e, (er, _) in enumerate(eps):
            route[rep, e] = 1 if er % NX >= bx else 0
    return Topology(
        n_routers=routers, n_ports=P, n_endpoints=Etot, link_to=link_to,
        ep_attach=ep_attach, route=route, name=f"multi_die{n_dies}x{nx}x{ny}",
        tile_coord=tile_coord,
        meta={"nx": NX, "ny": ny, "n_tiles": Etot, "n_hbm": 0,
              "n_dies": n_dies, "die_nx": nx, "d2d": d2d,
              "repeaters": repeaters},
    )


def route_vcs(topo: Topology, links: list[tuple[int, int]]) -> list[int]:
    """VC occupied on each hop of a route (schedule-level mirror of the
    fabric's dateline rule in ``kernels.noc_router.ref``).

    ``links`` is a route's (router, out_port) hop sequence (e.g. from a
    schedule builder's link walker). Injection starts on VC0; crossing a
    dateline out-link bumps the flit to VC1; turning into a new routing
    dimension (X -> Y, or into the local/ejection port) resets it to VC0.
    On fabrics without VC tables every hop reports VC0 — matching the
    fabric, which keeps all traffic on VC0 when no table says otherwise.
    """
    if topo.port_dim is None or topo.dateline is None:
        return [0] * len(links)
    vcs = []
    v = 0
    prev_dim = None
    for r, p in links:
        d = int(topo.port_dim[r, p])
        if d != prev_dim:
            v = 0
        if bool(topo.dateline[r, p]):
            v = 1
        vcs.append(v)
        prev_dim = d
    return vcs


def die_of(topo: Topology, tile: int) -> int:
    """Die index of a tile on a multi-die fabric (column / die width)."""
    return int(topo.tile_coord[tile, 0]) // topo.meta["die_nx"]


def multi_die_crossings(topo: Topology, src_ep: int, dst_ep: int) -> int:
    """Die-to-die boundary chains an XY route between two tiles crosses."""
    return abs(die_of(topo, src_ep) - die_of(topo, dst_ep))


# ----------------------------------------------------------------------
# Occamy baseline: 6 groups x 4 clusters, two-level AXI4 Xbar hierarchy,
# spill-register repeater chains between levels (paper Sec. VII)
# ----------------------------------------------------------------------
def build_occamy(n_groups: int = 6, clusters_per_group: int = 4, n_hbm: int = 8,
                 spill: int = 4) -> Topology:
    """Routers: [0..n_groups) group xbars, n_groups = top xbar, then repeaters.
    Endpoints: clusters (group-attached), then HBM channels (top-attached)."""
    n_clusters = n_groups * clusters_per_group
    top = n_groups
    routers = n_groups + 1
    # ports: group xbar: clusters_per_group + 1 uplink (+pad)
    # top xbar: n_groups + n_hbm
    P = max(clusters_per_group + 1, n_groups + n_hbm)

    links: list[tuple[int, int, int, int]] = []  # (r1, p1, r2, p2) bidirectional
    repeaters: list[int] = []
    rep_group: dict[int, int] = {}  # repeater -> group whose chain it sits on

    def add_chain(r1, p1, r2, p2, k, group):
        """Connect r1.p1 <-> r2.p2 through k repeater nodes (spill registers).
        Repeater port 0 faces the group side (r1), port 1 the top side (r2)."""
        nonlocal routers
        if k == 0:
            links.append((r1, p1, r2, p2))
            return
        chain = list(range(routers, routers + k))
        repeaters.extend(chain)
        for c in chain:
            rep_group[c] = group
        routers += k
        prev, pp = r1, p1
        for c in chain:
            links.append((prev, pp, c, 0))
            prev, pp = c, 1
        links.append((prev, pp, r2, p2))

    for g in range(n_groups):
        add_chain(g, clusters_per_group, top, g, spill, g)

    link_to = None  # filled after routers count known

    eps = []
    for g in range(n_groups):
        for c in range(clusters_per_group):
            eps.append((g, c))
    for h in range(n_hbm):
        eps.append((top, n_groups + h))
    ep_attach = np.array(eps, np.int32)
    Etot = len(eps)

    Pmax = max(P, 2)
    link_to = np.full((routers, Pmax, 2), -1, np.int32)
    for r1, p1, r2, p2 in links:
        link_to[r1, p1] = (r2, p2)
        link_to[r2, p2] = (r1, p1)

    # routing tables
    route = np.full((routers, Etot), -1, np.int32)
    for e, (er, ep_port) in enumerate(eps):
        for r in range(routers):
            if r == er:
                route[r, e] = ep_port
            elif r < n_groups:  # group xbar -> uplink
                route[r, e] = clusters_per_group
            elif r == top:  # top xbar -> correct group downlink
                route[r, e] = er  # group g sits on top port g
            # repeaters handled below
    # repeater routing: port 0 faces the group, port 1 faces the top xbar.
    # Endpoints attached to this chain's group go toward the group; all
    # others (other groups, HBM) go toward the top.
    for rep in repeaters:
        g = rep_group[rep]
        for e, (er, _) in enumerate(eps):
            route[rep, e] = 0 if er == g else 1
    return Topology(
        n_routers=routers, n_ports=Pmax, n_endpoints=Etot, link_to=link_to,
        ep_attach=ep_attach, route=route, name="occamy",
        meta={
            "n_groups": n_groups, "clusters_per_group": clusters_per_group,
            "n_clusters": n_clusters, "n_tiles": n_clusters, "n_hbm": n_hbm,
            "spill": spill, "repeaters": repeaters,
        },
    )


# ----------------------------------------------------------------------
# factory
# ----------------------------------------------------------------------
TOPOLOGIES = ["mesh", "torus", "multi_die", "occamy"]


def topology_fields(name: str) -> tuple[str, ...]:
    """Keyword arguments the named topology's builder accepts."""
    builders = {"mesh": build_mesh, "torus": build_torus,
                "multi_die": build_multi_die, "occamy": build_occamy}
    if name not in builders:
        raise ValueError(f"unknown topology {name!r}; choose from {TOPOLOGIES}")
    return tuple(inspect.signature(builders[name]).parameters)


def build_topology(name: str, **kw) -> Topology:
    """Build a topology by name (the ``--topology`` axis of the sweeps).

    A keyword argument the named builder does not accept raises a
    ``ValueError`` naming the offending field(s) and the valid fields for
    that topology (rather than the raw ``TypeError`` of the bad call).
    """
    builders = {"mesh": build_mesh, "torus": build_torus,
                "multi_die": build_multi_die, "occamy": build_occamy}
    valid = topology_fields(name)  # also rejects unknown topology names
    bad = sorted(set(kw) - set(valid))
    if bad:
        raise ValueError(
            f"unknown field(s) {bad} for topology {name!r}; "
            f"valid fields: {sorted(valid)}")
    return builders[name](**kw)
