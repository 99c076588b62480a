"""Declarative fabric specification: one frozen, serializable object that
names a fabric (topology + shape + microarchitecture knobs + an optional
workload binding), validates it, and lowers it to ``(Topology, NocParams)``.

This is the FlooGen idea (YAML network description -> validated graph ->
routing tables) applied to the simulator stack: instead of ad-hoc builder
kwargs scattered across examples and benchmarks, a fabric is a
:class:`FabricSpec` everywhere —

* **validate** — ``FabricSpec(...)`` rejects bad configs at construction,
  *before* any engine state is built: unknown topologies, shape fields
  that don't belong to the chosen topology (named, with the valid field
  list), express spans that fit no link, channel counts below the
  req/rsp/wide minimum, and workload bindings whose routes need more
  virtual channels than the spec provides (the Dally-Seitz check of
  ``ml_traffic.required_vcs`` / ``required_vcs_for_pairs``).
* **serialize** — round-trips through plain dicts (:meth:`to_dict` /
  :meth:`from_dict`), JSON (:meth:`to_json` / :meth:`from_json`) and a
  flat ``key: value`` YAML subset (:meth:`to_yaml` / :meth:`from_yaml`,
  no external YAML dependency). :meth:`spec_hash` is a stable content
  hash used to key DSE artifact rows.
* **lower** — :meth:`lower` calls the same zoo builders
  (``topology.build_topology``) and ``NocParams`` with exactly the fields
  the spec sets, so a lowered spec is bit-identical to the hand-built
  equivalent.

The port's copy of ``repro.core.noc.spec``. The schema is the JAX
package's, field for field, so :meth:`to_json` and :meth:`spec_hash` are
byte-identical for the same spec and a DSE artifact keyed by the hash
compares across the packages. That includes the two Pallas dispatch knobs
``backend`` and ``router_tile``: they are validated as the JAX package
validates them and kept in the schema, but :meth:`params` does not pass
them on, because the port's ``NocParams`` has no such fields (the tensors'
device picks the kernels). ``step_impl`` takes both of the JAX package's
values: a ``"naive"`` spec lowers to the port's naive step and hashes as
the JAX package's does.

The design-space exploration over grids of specs lives in
``repro_torch.core.noc.dse``; the schema reference is
``docs/FABRIC_SPEC.md``.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from dataclasses import dataclass

from repro_torch.core.noc import ml_traffic as ML
from repro_torch.core.noc import topology as topo_mod
from repro_torch.core.noc import traffic as T
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import TOPOLOGIES, Topology

# shape fields per topology — mirrors the builder signatures, so a field
# set on a spec of the wrong topology is a named error instead of a
# TypeError deep inside the builder call
TOPO_FIELDS = {name: topo_mod.topology_fields(name) for name in TOPOLOGIES}
_SHAPE_FIELDS = tuple(sorted({f for fs in TOPO_FIELDS.values() for f in fs}))

# workload bindings: the Fig. 8 traffic patterns plus the personalized
# all-to-all collective (the MoE dispatch/combine pattern)
WORKLOADS = tuple(T.PATTERNS) + ("all-to-all",)

# spec fields whose change never changes the state's shapes — points that
# differ only here batch through ONE run_sweep (see group_key)
SWEEPABLE_FIELDS = ("workload", "transfer_kb", "n_txns", "seed")

# exact Dally-Seitz route-union check up to this many tiles; bigger wrap
# fabrics skip the construction-time check (the route walk is O(pairs x
# hops)) and rely on the schedule-level check at compile time
_VC_CHECK_MAX_TILES = 256


@functools.lru_cache(maxsize=64)
def _cached_topo(name: str, kw_items: tuple) -> Topology:
    """Validation-time topology cache (lower() always builds fresh)."""
    return topo_mod.build_topology(name, **dict(kw_items))


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


def _parse_scalar(s: str):
    s = s.strip()
    if s in ("null", "~", ""):
        return None
    if s in ("true", "True"):
        return True
    if s in ("false", "False"):
        return False
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


@dataclass(frozen=True)
class FabricSpec:
    """A declarative fabric: topology shape + knobs + workload binding.

    Shape fields (``nx`` .. ``spill``) default to ``None`` = "use the
    builder default"; only fields valid for ``topology`` may be set
    (``TOPO_FIELDS``). Microarchitecture knobs mirror the ``NocParams``
    fields the design space sweeps; everything else stays at the paper
    defaults. The workload binding (``workload`` + sizes) is optional —
    a spec without one lowers to a fabric and nothing else.
    """

    topology: str = "mesh"

    # -- topology shape (None = builder default; see TOPO_FIELDS) --
    nx: int | None = None
    ny: int | None = None
    hbm_west: bool | None = None  # mesh: one HBM endpoint per west-edge row
    express: int | None = None  # mesh: span-k express links (radix 9)
    n_dies: int | None = None  # multi_die
    d2d: int | None = None  # multi_die: die-to-die repeater chain length
    n_groups: int | None = None  # occamy
    clusters_per_group: int | None = None  # occamy
    n_hbm: int | None = None  # occamy
    spill: int | None = None  # occamy: spill-register chain length

    # -- microarchitecture knobs (NocParams; paper defaults) --
    n_channels: int = 3
    n_vcs: int = 1
    ni_order: str = "robless"  # "robless" | "rob"
    backend: str = "jnp"  # "jnp" | "pallas" (JAX package only; kept for the hash)
    step_impl: str = "fast"  # "fast" | "naive"
    router_tile: int = 8  # JAX package only; kept for the hash
    fused_cycles: int = 1
    collective_offload: bool = False  # in-fabric multicast + reduction ALU

    # -- workload binding (optional) --
    workload: str | None = None  # traffic.PATTERNS or "all-to-all"
    transfer_kb: int = 4
    n_txns: int = 4
    streams: int = 1
    write: bool = False
    seed: int = 7

    # ------------------------------------------------------------------
    # validation
    # ------------------------------------------------------------------
    def __post_init__(self):
        """Validate at construction: every FabricSpec instance is lowerable."""
        self.validate()

    def validate(self) -> None:
        """Raise ``ValueError`` (naming the offending field) on bad configs."""
        if self.topology not in TOPO_FIELDS:
            raise ValueError(
                f"unknown topology {self.topology!r}; choose from {TOPOLOGIES}")
        valid = TOPO_FIELDS[self.topology]
        bad = sorted(f for f in _SHAPE_FIELDS
                     if f not in valid and getattr(self, f) is not None)
        if bad:
            raise ValueError(
                f"field(s) {bad} do not apply to topology "
                f"{self.topology!r}; valid fields: {sorted(valid)}")
        for f, lo in (("nx", 1), ("ny", 1), ("n_dies", 1), ("d2d", 0),
                      ("express", 0), ("n_groups", 1),
                      ("clusters_per_group", 1), ("n_hbm", 0), ("spill", 0)):
            v = getattr(self, f)
            if v is not None and v < lo:
                raise ValueError(f"{f} must be >= {lo}, got {v}")
        if self.express:
            nx, ny = self._effective("nx"), self._effective("ny")
            if self.express >= max(nx, ny):
                raise ValueError(
                    f"express span {self.express} >= mesh dims {nx}x{ny}: "
                    "no express link fits; use 1 <= express < max(nx, ny)")
        if self.ni_order not in ("robless", "rob"):
            raise ValueError(
                f"ni_order must be 'robless' or 'rob', got {self.ni_order!r}")
        # the JAX package's NocParams validates the two Pallas knobs; the
        # port's has neither, so they are checked here with its messages
        if self.backend not in ("jnp", "pallas"):
            raise ValueError(
                f"backend must be 'jnp' or 'pallas', got {self.backend!r}")
        if self.router_tile < 0:
            raise ValueError("router_tile must be >= 0 (0 = whole fabric)")
        self.params()  # NocParams.__post_init__ validates the knob fields
        self._validate_workload()

    def _effective(self, f: str):
        """Field value with the topology builder's default filled in."""
        v = getattr(self, f)
        if v is not None:
            return v
        import inspect

        builders = {"mesh": topo_mod.build_mesh, "torus": topo_mod.build_torus,
                    "multi_die": topo_mod.build_multi_die,
                    "occamy": topo_mod.build_occamy}
        return inspect.signature(builders[self.topology]).parameters[f].default

    def _validate_workload(self) -> None:
        if self.workload is None:
            return
        if self.workload not in WORKLOADS:
            raise ValueError(
                f"unknown workload {self.workload!r}; choose from "
                f"{sorted(WORKLOADS)}")
        for f, lo in (("transfer_kb", 1), ("n_txns", 1), ("streams", 1)):
            if getattr(self, f) < lo:
                raise ValueError(
                    f"{f} must be >= {lo}, got {getattr(self, f)}")
        if self.workload != "all-to-all" and self.topology == "occamy":
            raise ValueError(
                "occamy has no grid coordinates, so traffic patterns "
                f"({self.workload!r}) cannot be placed on it; use "
                "workload='all-to-all' (runs over its clusters) or a "
                "gridded topology")
        if self.workload == "tiled-matmul" and not (
                self.topology == "mesh" and self.hbm_west is not False):
            raise ValueError(
                "workload 'tiled-matmul' needs HBM endpoints: topology "
                "'mesh' with hbm_west not disabled (got topology="
                f"{self.topology!r}, hbm_west={self.hbm_west})")
        # Dally-Seitz: on wrap topologies the workload's route union must
        # be breakable by this spec's VC count (docs/ROUTING.md)
        if self.topology == "torus":
            topo = _cached_topo(self.topology, tuple(self.topo_kwargs().items()))
            need = self.required_vcs(topo)
            if need > self.n_vcs:
                raise ValueError(
                    f"workload {self.workload!r} on {topo.name} closes a "
                    "wormhole channel-dependency cycle that n_vcs="
                    f"{self.n_vcs} cannot break; this spec needs n_vcs >= "
                    f"{need} (dateline VC-switching, docs/ROUTING.md)")

    def required_vcs(self, topo: Topology | None = None) -> int:
        """Minimum ``n_vcs`` the bound workload needs on this fabric
        (1 on non-wrap topologies; ``ml_traffic.required_vcs`` semantics).

        Exact up to ``_VC_CHECK_MAX_TILES`` tiles; above that the route
        walk is skipped and 1 is returned (the schedule-level check still
        runs when traffic is compiled).
        """
        if self.workload is None or self.topology != "torus":
            return 1
        if topo is None:
            topo = _cached_topo(self.topology,
                                tuple(self.topo_kwargs().items()))
        nt = topo.meta["n_tiles"]
        if nt > _VC_CHECK_MAX_TILES:
            return 1
        if self.workload == "all-to-all":
            # auto algo picks the torus-safe ring fallback when VC-less,
            # direct rotation otherwise — both fit the spec's n_vcs
            from repro_torch.core.noc import collective_traffic as CT

            sched = CT.all_to_all(topo, data_kb=self.transfer_kb,
                                  streams=self.streams, n_vcs=self.n_vcs)
            return ML.required_vcs(topo, sched)
        return ML.required_vcs_for_pairs(topo, self.traffic_pairs(topo))

    def traffic_pairs(self, topo: Topology) -> list[tuple[int, int]]:
        """(src, dst) endpoint pairs the bound workload can exercise
        ("uniform" and "all-to-all" may target every other tile)."""
        nt = topo.meta["n_tiles"]
        if self.workload is None or self.workload in ("uniform", "all-to-all"):
            return [(s, d) for s in range(nt) for d in range(nt) if s != d]
        dst = T.pattern_dst(topo, self.workload, self.seed)
        return [(s, int(dst[s])) for s in range(nt) if int(dst[s]) != s]

    # ------------------------------------------------------------------
    # lowering
    # ------------------------------------------------------------------
    def topo_kwargs(self) -> dict:
        """The shape fields this spec sets, as builder kwargs."""
        return {f: getattr(self, f) for f in TOPO_FIELDS[self.topology]
                if getattr(self, f) is not None}

    def build_topology(self) -> Topology:
        """Lower the shape to a fresh ``Topology`` (zoo builders)."""
        return topo_mod.build_topology(self.topology, **self.topo_kwargs())

    def params(self) -> NocParams:
        """Lower the knob fields to ``NocParams`` (paper defaults elsewhere;
        ``backend`` and ``router_tile`` have no port counterpart)."""
        return NocParams(
            n_channels=self.n_channels, n_vcs=self.n_vcs,
            ni_order=self.ni_order, step_impl=self.step_impl,
            fused_cycles=self.fused_cycles,
            collective_offload=self.collective_offload)

    def lower(self) -> tuple[Topology, NocParams]:
        """``(Topology, NocParams)`` — bit-identical to the hand-built zoo."""
        return self.build_topology(), self.params()

    def build_workload(self, topo: Topology | None = None):
        """Lower the workload binding to an ``endpoints.Workload``."""
        if self.workload is None:
            raise ValueError("spec has no workload binding (workload=None)")
        if topo is None:
            topo = self.build_topology()
        if self.workload == "all-to-all":
            from repro_torch.core.noc import collective_traffic as CT

            sched = CT.all_to_all(topo, data_kb=self.transfer_kb,
                                  streams=self.streams, n_vcs=self.n_vcs)
            return CT.to_workload(topo, sched)
        return T.dma_workload(
            topo, self.workload, transfer_kb=self.transfer_kb,
            n_txns=self.n_txns, streams=self.streams, write=self.write,
            seed=self.seed)

    # ------------------------------------------------------------------
    # serialization
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        """Plain-dict form (every field, JSON-serializable values)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FabricSpec":
        """Inverse of :meth:`to_dict`; unknown keys are a named error."""
        valid = {f.name for f in dataclasses.fields(cls)}
        bad = sorted(set(d) - valid)
        if bad:
            raise ValueError(
                f"unknown field(s) {bad} for FabricSpec; "
                f"valid fields: {sorted(valid)}")
        return cls(**d)

    def to_json(self) -> str:
        """Canonical JSON (sorted keys — the :meth:`spec_hash` preimage)."""
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FabricSpec":
        """Inverse of :meth:`to_json`."""
        return cls.from_dict(json.loads(s))

    def to_yaml(self) -> str:
        """Flat ``key: value`` YAML subset (one line per field)."""
        return "".join(f"{f.name}: {_yaml_scalar(getattr(self, f.name))}\n"
                       for f in dataclasses.fields(self))

    @classmethod
    def from_yaml(cls, s: str) -> "FabricSpec":
        """Parse the flat YAML subset: ``key: value`` lines, ``#`` comments
        and blank lines; scalars are null/bool/int/float/str."""
        d = {}
        for ln, line in enumerate(s.splitlines(), 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            key, sep, val = line.partition(":")
            if not sep:
                raise ValueError(
                    f"line {ln}: expected 'field: value', got {line!r}")
            d[key.strip()] = _parse_scalar(val)
        return cls.from_dict(d)

    def spec_hash(self) -> str:
        """Stable 12-hex content hash (keys DSE artifact rows)."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def group_key(self) -> tuple:
        """Hashable key grouping specs that compile to the same shapes.

        Two specs with equal keys differ only in ``SWEEPABLE_FIELDS``
        (the batch's workload rows), so their points batch through one
        ``run_sweep`` — the unit of sharding in ``dse.run_dse``. An
        "all-to-all" binding has schedule-shaped (gated) workload arrays,
        so it never groups with plain patterns.
        """
        d = self.to_dict()
        wl = d.pop("workload")
        for f in SWEEPABLE_FIELDS[1:]:
            d.pop(f)
        d["workload_class"] = (None if wl is None else
                               "a2a" if wl == "all-to-all" else "pattern")
        return tuple(sorted(d.items()))


# ----------------------------------------------------------------------
# presets (the demo fabrics of the explorer and the benchmarks, one source)
# ----------------------------------------------------------------------
_PRESET_DIMS: dict[str, tuple[dict, dict]] = {
    "mesh": (dict(nx=4, ny=4), dict(nx=4, ny=8)),
    "torus": (dict(nx=4, ny=4), dict(nx=4, ny=8)),
    "multi_die": (dict(n_dies=2, nx=2, ny=4), dict(n_dies=2, nx=2, ny=8)),
    "occamy": ({}, {}),
}


def preset(name: str, big: bool = False, **overrides) -> FabricSpec:
    """Demo-sized spec of each zoo topology (~16 tiles; ``big`` ~32).

    ``overrides`` replace any spec field (shape fields included), e.g.
    ``preset("torus", n_vcs=2, workload="uniform")``.
    """
    if name not in _PRESET_DIMS:
        raise ValueError(
            f"unknown preset {name!r}; choose from {sorted(_PRESET_DIMS)}")
    kw = {**_PRESET_DIMS[name][int(big)], **overrides}
    return FabricSpec(topology=name, **kw)
