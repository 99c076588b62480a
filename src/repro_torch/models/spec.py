"""Parameter schema plumbing.

A model is described once as a tree of ``PSpec`` (shape, logical axes,
dtype, init), as in ``repro.models.spec``. The JAX package stacks a
layer's leaves along a leading axis to scan over it; the port keeps one
module per layer instead (``Stacked`` -> ``nn.ModuleList``), so a layer's
weights keep the JAX per-layer layout (``wq`` [d, H, D], ``wo`` [H, D, d])
and a converted weight is a copy of one slice.

``init_tree`` materialises a schema as an ``nn.Module`` tree on a device,
drawing from an explicit ``torch.Generator``. Its numbers differ from
``jax.random``'s: tests carry JAX-initialised weights across with
``repro_torch.models.model.params_from_numpy`` instead.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch import nn

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "int32": torch.int32,
    "int8": torch.int8,
}


class PSpec(NamedTuple):
    """One parameter: shape, logical axes, dtype and initialiser."""

    shape: tuple[int, ...]
    axes: tuple[Any, ...]  # logical axis name (str) or None, one per dim
    dtype: str = "bfloat16"
    init: str = "normal"  # "normal" | "zeros" | "ones" | "scaled:<fan_in_dim>"
    scale: float = 0.02


class Stacked(NamedTuple):
    """``n`` copies of a layer schema (the JAX package's stacked layers)."""
    layer: dict
    n: int


class ParamTree(nn.Module):
    """A schema's dict level as a module: children are reached by key, as
    in the JAX pytree (``p["attn"]["wq"]``)."""

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._modules or key in self._parameters


def leaves(schema, prefix: str = ""):
    """``(path, PSpec)`` pairs in schema order; a ``Stacked`` level adds the
    layer index to the path (``blocks.0.attn.wq``)."""
    if isinstance(schema, PSpec):
        yield prefix, schema
    elif isinstance(schema, Stacked):
        for i in range(schema.n):
            yield from leaves(schema.layer, f"{prefix}.{i}")
    else:
        for k, v in schema.items():
            yield from leaves(v, f"{prefix}.{k}" if prefix else k)


def stacked_shapes(schema, prefix: str = "", lead: tuple[int, ...] = ()) -> dict:
    """Each leaf's path without layer indices (``superblocks.mixer.wz``)
    mapped to its shape with the ``Stacked`` levels above it as leading
    axes, the layout of the JAX package's stacked leaves."""
    if isinstance(schema, PSpec):
        return {prefix: lead + schema.shape}
    if isinstance(schema, Stacked):
        return stacked_shapes(schema.layer, prefix, lead + (schema.n,))
    out = {}
    for k, v in schema.items():
        out.update(stacked_shapes(v, f"{prefix}.{k}" if prefix else k, lead))
    return out


def layer_specs(schema, prefix: str = "") -> dict:
    """Each leaf's path without layer indices mapped to its (one layer's)
    ``PSpec``: the dtype of ``stacked_shapes``' stacked leaf."""
    if isinstance(schema, PSpec):
        return {prefix: schema}
    if isinstance(schema, Stacked):
        return layer_specs(schema.layer, prefix)
    out = {}
    for k, v in schema.items():
        out.update(layer_specs(v, f"{prefix}.{k}" if prefix else k))
    return out


def count_params_tree(schema) -> int:
    """Parameters in a schema."""
    return sum(math.prod(s.shape) for _, s in leaves(schema))


def _init_leaf(spec: PSpec, generator, device) -> torch.Tensor:
    dt = DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if spec.init.startswith("scaled"):
        # variance-scaled: 1/sqrt(fan_in), fan_in = shape[<dim>] (per layer)
        fan_in = spec.shape[int(spec.init.split(":")[1])] if ":" in spec.init else spec.shape[-2]
        return (x / math.sqrt(fan_in)).to(dt)
    return (x * spec.scale).to(dt)


def build_tree(schema, leaf_fn) -> nn.Module:
    """A module tree of ``schema`` whose leaves are ``leaf_fn(path, spec)``
    (tensors, wrapped as frozen parameters)."""

    def build(node, prefix):
        if isinstance(node, Stacked):
            return nn.ModuleList(build(node.layer, f"{prefix}.{i}")
                                 for i in range(node.n))
        mod = ParamTree()
        for k, v in node.items():
            path = f"{prefix}.{k}" if prefix else k
            if isinstance(v, PSpec):
                mod.register_parameter(
                    k, nn.Parameter(leaf_fn(path, v), requires_grad=False))
            else:
                mod.add_module(k, build(v, path))
        return mod

    return build(schema, "")


def init_tree(schema, generator: torch.Generator, device) -> nn.Module:
    """Materialise a schema with random values drawn in schema order from
    ``generator`` (which must live on ``device``)."""
    return build_tree(schema, lambda path, s: _init_leaf(s, generator, device))


def jax_key(name: str) -> str:
    """The JAX package's flat key of a port parameter name: the name
    without its layer indices (``blocks.3.attn.wq`` -> ``blocks.attn.wq``)."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def stack_layers(named: dict, shapes: dict, device="cpu") -> dict:
    """``{JAX key: tensor}`` with the stacked layer axes of ``shapes`` (the
    schema's ``stacked_shapes``) from ``named`` (``{port name: tensor}``,
    a stack's layers in order), copied to ``device``; a key with no tensor
    (a stack with no layers) gets a zero-size tensor of its stacked shape."""
    groups: dict = {}
    for name, t in named.items():
        groups.setdefault(jax_key(name), []).append(t.detach().to(device))
    out = {}
    for key, shape in shapes.items():
        ts = groups.get(key)
        if not ts:
            ref = next(iter(named.values()))
            out[key] = torch.zeros(shape, dtype=ref.dtype, device=device)
        elif len(ts) == 1 and tuple(ts[0].shape) == tuple(shape):
            out[key] = ts[0]
        else:
            out[key] = torch.stack(ts).reshape(shape)
    return out


@torch.no_grad()
def unstack_into(named: dict, stacked: dict) -> None:
    """Copy each JAX key's stacked tensor of ``stacked`` into the port's
    per-layer tensors of ``named`` (in place, cast to each one's dtype)."""
    groups: dict = {}
    for name, t in named.items():
        groups.setdefault(jax_key(name), []).append(t)
    for key, ts in groups.items():
        src = stacked[key]
        if len(ts) == 1 and tuple(ts[0].shape) == tuple(src.shape):
            ts[0].copy_(src)
            continue
        flat = src.reshape((len(ts),) + tuple(ts[0].shape))
        for t, s in zip(ts, flat):
            t.copy_(s)


def nest(flat: dict) -> dict:
    """``{"a.b.c": x}`` -> ``{"a": {"b": {"c": x}}}``."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def unnest(tree: dict, prefix: str = "") -> dict:
    """The inverse of ``nest``."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(unnest(v, key) if isinstance(v, dict) else {key: v})
    return out
