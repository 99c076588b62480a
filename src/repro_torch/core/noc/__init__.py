"""Cycle-accurate FlooNoC simulator on PyTorch: topologies, fabric engine,
workloads.

Public surface: :class:`NocParams`, :class:`Topology` and the ``build_*``
builders behind :func:`build_topology`, the simulator in
``repro_torch.core.noc.sim`` (``build_sim`` / ``run`` / ``run_trace`` /
``canonical_state`` / ``stats``) and the workload builders in
``repro_torch.core.noc.traffic``. The router cycle runs on the CUDA kernels
of ``repro_torch.kernels.noc_router`` for CUDA tensors and on their plain
PyTorch version for CPU tensors.
"""
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.topology import (
    TOPOLOGIES,
    Topology,
    build_mesh,
    build_multi_die,
    build_occamy,
    build_topology,
    build_torus,
)

__all__ = ["NocParams", "TOPOLOGIES", "Topology", "build_mesh",
           "build_multi_die", "build_occamy", "build_topology", "build_torus"]
