"""Cycle-accurate FlooNoC simulator on PyTorch: topologies, fabric engine,
workloads.

Public surface: :class:`NocParams`, :class:`Topology` and the ``build_*``
builders behind :func:`build_topology`, the declarative :class:`FabricSpec`
(``repro_torch.core.noc.spec``: validate -> serialize -> lower, presets via
:func:`preset`) with the design-space exploration in
``repro_torch.core.noc.dse`` (``run_dse``), the simulator in
``repro_torch.core.noc.sim`` (``build_sim`` / ``run`` / ``run_trace`` /
``run_sweep`` / ``canonical_state`` / ``stats``), the workload builders in
``repro_torch.core.noc.traffic`` / ``collective_traffic`` and the
ML-parallelism traffic compiler in ``repro_torch.core.noc.ml_traffic``.
The router cycle runs on the CUDA kernels of
``repro_torch.kernels.noc_router`` for CUDA tensors and on their plain
PyTorch version for CPU tensors.
"""
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.spec import FabricSpec, preset
from repro_torch.core.noc.topology import (
    TOPOLOGIES,
    Topology,
    build_mesh,
    build_multi_die,
    build_occamy,
    build_topology,
    build_torus,
)

__all__ = ["FabricSpec", "NocParams", "TOPOLOGIES", "Topology", "build_mesh",
           "build_multi_die", "build_occamy", "build_topology", "build_torus",
           "preset"]
