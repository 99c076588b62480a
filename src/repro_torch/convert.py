"""Carry simulator state between the JAX package and the port.

The counterpart of carrying weights: state travels as flat dicts of numpy
arrays, so this module needs neither JAX nor ``repro``. A caller holding a
JAX ``SimState`` turns it into such a dict from its leaves (keys
``"fabric.<field>"``, ``"eps.<field>"`` and ``"cycle"``); the same keys come
back from :func:`sim_state_to_numpy`. The collective-offload leaves
(``fabric.red_acc`` / ``fabric.red_got``, ``fork_out`` / ``red_parent`` /
``red_need`` / ``n_groups`` of the tables) are present only when offload is
on, as JAX drops its ``None`` leaves. The tests use this to hand a JAX run
over to the port mid-run, and ``chip_smoke.py`` to hold a GPU state against
a CPU one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.noc import endpoints as epm
from repro_torch.core.noc import engine as eng
from repro_torch.core.noc.params import NocParams
from repro_torch.core.noc.sim import SimState

# NocParams fields of the JAX package that select a Pallas code path; the
# port's tensors' device decides instead, so they are dropped
DROPPED_PARAMS = ("backend", "router_tile")


def params_from_dict(fields: dict) -> NocParams:
    """The port's NocParams from a dict of the JAX NocParams' fields
    (``dataclasses.asdict``), both ``step_impl`` values included; the
    Pallas dispatch knobs (``DROPPED_PARAMS``) are dropped."""
    return NocParams(**{k: v for k, v in fields.items()
                        if k not in DROPPED_PARAMS})


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


def sim_state_to_numpy(st: SimState) -> dict:
    """Flat dict of numpy arrays: ``fabric.*``, ``eps.*`` and ``cycle``
    (``None`` leaves left out)."""
    out = {}
    for prefix, part in (("fabric", st.fabric), ("eps", st.eps)):
        for name in _fields(part):
            v = getattr(part, name)
            if v is not None:
                out[f"{prefix}.{name}"] = v.cpu().numpy()
    out["cycle"] = st.cycle.cpu().numpy()
    return out


def sim_state_from_numpy(arrays: dict, device) -> SimState:
    """A port SimState on ``device`` from a flat dict of numpy arrays
    (dtypes kept: int32 state, float32 buckets, bool flags; the offload
    leaves are optional)."""
    t = lambda a: torch.as_tensor(np.array(a), device=device)
    fabric = eng.FabricState(**{
        f.name: t(arrays[f"fabric.{f.name}"])
        for f in dataclasses.fields(eng.FabricState)
        if f"fabric.{f.name}" in arrays})
    eps = epm.EndpointState(**{
        f.name: t(arrays[f"eps.{f.name}"])
        for f in dataclasses.fields(epm.EndpointState)})
    return SimState(fabric=fabric, eps=eps,
                    cycle=t(np.asarray(arrays["cycle"], np.int32)))


def tables_to_numpy(tb: eng.FabricTables) -> dict:
    """FabricTables as a dict of numpy arrays keyed by field name
    (``n_vcs`` and, with offload, ``n_groups`` as 0-d arrays; ``None``
    tables left out)."""
    out = {name: getattr(tb, name).cpu().numpy() for name in _fields(tb)
           if isinstance(getattr(tb, name), torch.Tensor)}
    out["n_vcs"] = np.asarray(tb.n_vcs, np.int32)
    if tb.fork_out is not None:
        out["n_groups"] = np.asarray(tb.n_groups, np.int32)
    return out


def tables_from_numpy(arrays: dict, device) -> eng.FabricTables:
    """FabricTables on ``device`` from numpy arrays keyed by field name;
    ``vc_out`` and ``n_vcs`` are optional (a VC-less table), and so are
    the offload trees (``fork_out`` bool, ``red_parent``, ``red_need``,
    ``n_groups``)."""
    t = lambda a: torch.as_tensor(np.array(a, np.int32), device=device)
    opt = lambda name: None if name not in arrays else t(arrays[name])
    fork_out = arrays.get("fork_out")
    return eng.FabricTables(
        **{name: t(arrays[name]) for name in
           ("route", "link_src", "link_dst", "port_ep", "ep_attach")},
        vc_out=opt("vc_out"), n_vcs=int(arrays.get("n_vcs", 1)),
        fork_out=(None if fork_out is None else
                  torch.as_tensor(np.array(fork_out, bool), device=device)),
        red_parent=opt("red_parent"), red_need=opt("red_need"),
        n_groups=int(arrays.get("n_groups", 0)))

